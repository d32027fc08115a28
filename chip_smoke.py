#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main paths on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

On one H100 80GB HBM3 it takes about three minutes (five with
``--profile``), the kernels' build included.

Phases, each fatal on failure (the script exits non-zero and prints no
result line):
  1. device  - requires CUDA; prints the card's name and power limit;
  2. build   - compiles the butterfly, flash-attention and RMSNorm kernels
               from src/repro_torch/csrc with nvcc for sm_90a, one nvcc per
               source, all at once, and prints the build seconds and ptxas
               report, and the restore kernels' launch plans (rows a block,
               blocks, dynamic shared memory) at the timed shapes;
  3. kernels - holds each kernel against its plain PyTorch version on the
               card: the butterfly kernels at both models' widths (d=4096,
               d_r=64 at 1 to 4,096 rows, both sides of reduce_quant's and
               dequant_restore's row-tile switches; d=3840, d_r=60; and the
               dense configs' d=5120, d_r=80 and d=3072, d_r=48 at 1, 128
               and 2,048 rows; bf16) and a small f32 shape, with
               reduce_quant's worst share of differing codes; flash
               attention at every head dim (32-256) in f32 (the CUDA-core
               kernel) and bf16 (the tensor-core kernel, whose bf16 weights
               give it its own bound: see _flash_excess), causal, windowed and
               not, with S < T, S > T and ragged S and T, and at the main
               paths' shapes;
  4. times   - median CUDA-event time of each kernel, of its plain version
               and, for flash attention, of one scaled_dot_product_attention
               call (a yardstick the port never calls; for the restore, three
               calls: (codes.to(bf16) @ w_restore) * scales), inputs cold in L2:
               the butterfly kernels at 1, 4, 128-1,024, 1,025 and 4,096 rows
               (d=4096), at gemma3-12b's 100 and 2,048 (d=3840), and at 1,
               128 and 2,048 rows of the d=5120 and d=3072 wires; flash at
               the paths' shapes, gemma-7b's MHA and qwen3-14b's included,
               beside the least time the card could take (bytes or
               operations over its data-sheet rates); for flash also its
               TFLOP/s and the host time of encoding its TMA tensor maps;
  5. serving - full-width qwen3-8b (36 layers, d_model 4096, bf16, random
               weights from seed 0) split after layer 4 with a d_r=64 int8
               butterfly: four requests prefill through edge_half -> host
               wire -> cloud_half and decode 16 tokens each in the serving
               engine (cache handoff); one more decodes 8 tokens streamed
               through edge_step/stream_step.  Both butterfly kernels'
               launch counts must grow on this path, and the cloud logits
               must stay within 5% of the reference forward's largest logit;
  7. pipeline - on the same qwen3-8b bank: the fused restore+norm and RMSNorm
               kernels against their plain versions (f32 and bf16, d 4096
               and 3840, d_r 16-1024, 1 to 4,096 rows), restore+norm's x
               against the restore kernel and its h against the RMSNorm
               kernel, bit for bit, and their times (phase 4's way, with
               one torch.nn.functional.rms_norm call as RMSNorm's
               yardstick); then the two-pod decode pipeline with both pods
               on this card, each on its own stream (see phase_pipeline),
               and the RMSNorm kernel through its ops.rmsnorm entry point;
  8. runtime - on the same qwen3-8b bank: the bincount kernel (reduce+quantize
               plus the codes' per-channel symbol histogram) against
               reduce_quant, bit for bit, and its plain version (bits 8 and
               4, f32 and bf16, d_r 16-1024, 1 to 4,096 rows) and its times;
               then the port's runtime simulator with numerics on this card
               at full width (4 devices on 3g, split 4, d_r 64, the entropy
               wire on cache handoff, streamed and progressive, the int8 wire
               on cache handoff; see phase_runtime); the bincount entry point
               on the full-width boundary activations of its prompts, whose
               size estimate must fall within 5% of the real encoder; and the
               runtime_sim launcher as a subprocess on the default device.
  6. kernel prefill - once the qwen3-8b model is freed, full-width
               gemma3-12b (48 layers, 40 with a 1024-token window, d_model
               3840, head_dim 256, bf16, random weights from seed 0) with a
               d_r=60 butterfly after layer 6: prompts of 100 and 2,048 byte
               tokens each go through forward_prefill(use_kernel=True) and
               forward_prefill(use_kernel=False), then 16 greedy
               forward_decode steps from caches padded to capacity (ring
               caches of exactly min(capacity, 1024) rows for the windowed
               layers, which wrap on the long prompt).  Each kernel prefill
               must launch the flash kernel 48 times, both butterfly kernels
               must launch, the logits must stay within 5% of the plain
               prefill's largest logit with the same greedy token, the last
               decode step must stay within 5% of a kernel prefill of the
               whole sequence, and the peak must fit the 80 GB card.
  9. qwen3-14b serving - once gemma3-12b is freed, full-width qwen3-14b (40
               layers, d_model 5120, 40/8 heads, bf16, seed 0) split after
               layer 5 with a d_r=80 int8 butterfly: phase 5's handoff path
               and checks on four prompts of 64-128 tokens and 8 decode
               tokens, with exactly S*80 + 4*S wire bytes a request;
 10. gemma-7b kernel prefill - phase 6 on full-width gemma-7b (28 layers,
               d_model 3072, MHA 16/16 at head_dim 256, GeGLU, tied
               embeddings, d_r=48 after layer 3): 28 flash launches a
               kernel prefill;
 11. resnet - the paper's ResNet-50 in f32 at 224x224 (no TF32), 16 seeded
               images, split after RB3, 7, 13 and 16 with the paper's least
               d_r (1, 2, 5, 10): the in-graph forward against
               edge_cloud_split, the wire's shape and exact bytes, the card
               against the port's CPU run on 2 images, no kernel launched
               (as in the reference); edge, cloud and in-graph times and
               images/s beside the f32 floor (see phase_resnet).
 12. qwen3-8b training - the training entry points (init_train_state,
               make_train_step: plain autograd through the straight-through
               wire, AdamW in place), as the JAX package trains: first a
               reduced f32 qwen3 with a butterfly and the rate term takes 8
               steps from one init on the card and on the CPU, whose losses
               and grad norms must agree; then qwen3-8b at its published
               widths cut to 8 of its 36 layers (bf16, butterfly after layer
               4 at d_r 64) takes 8 AdamW steps on one batch of 4 x 512
               tokens.  Losses and grad norms must be finite and the loss
               must fall, grads must reach both sides of the wire, the
               params stay bf16, no kernel launches; prints the step walls,
               tokens/s against the 6*N*tokens floor, and the peak;
 13. resnet50 training - the same for ResNet-50 through the training
               example's step: a reduced parity run, then the paper's model
               uncut at 224x224 (f32, no TF32, butterfly after RB3 at d_r 1)
               8 steps on 16 SyntheticImages; images/s against 3 x the
               forward's operations at 67 TFLOP/s.
 14. qwen3-moe serving - first a reduced f32 card-vs-CPU run (every expert
               id equal, logits within 1e-4); then qwen3-moe-235b-a22b at its
               published widths (d 4096, 64/4 heads, 128 experts top-8 of
               d_ff 1536, bf16, seed 0) cut from 94 to 8 layers, split after
               layer 4 at d_r 64: phase 5's handoff path on prompts of
               64-128 tokens and 8 decode tokens in a 4-slot engine, one
               streamed request equal to its one-slot handoff, the cloud
               half twice on one payload equal, exact wire bytes; routing
               against the reference (its share that agrees printed, the 5%
               bound held where every route agrees; see phase_moe_serving);
               then the two-pod decode pipeline on this bank (int8, kernels,
               pipelined == serial, restore_norm's launches exact);
 15. llama4 serving - the same parity run on a reduced interleaved llama4,
               then llama4-maverick-400b-a17b at published widths (d 5120,
               40/8 heads, 128 experts top-1 of d_ff 8192, a shared expert,
               MoE every 2nd layer) cut from 48 to 2 layers (one dense, one
               MoE), split after layer 1 at d_r 80: two prompts, 4 tokens;
 16. pixtral kernel prefill - phase 6 on pixtral-12b uncut (40 layers, d
               5120, 32/8 heads), 1,024 seeded patch embeddings before 100
               text tokens, butterfly after layer 4 at d_r 80: 40 causal
               flash launches at 1,124 x 1,124 a kernel prefill, 8 decode
               steps from position 1,124;
 17. whisper kernel prefill - phase 6 on whisper-base uncut (6 encoder and 6
               decoder layers, d 512, 8 heads at hd 64) over 1,500 seeded
               frame embeddings, a 32-token prompt, butterfly after decoder
               layer 3 at d_r 64: 12 flash launches a kernel prefill, the 6
               encoder ones non-causal at 1,500 x 1,500, and 16 decode steps
               through the cross_kv caches.
Each model's weights leave the card before the next one is built, and
each phase prints its peak device memory.
With ``--profile [DIR]`` it profiles one qwen3-8b prefill and 8 decode steps
and a short pipelined and serial decode pipeline after phase 8, and
gemma3-12b's kernel and plain prefills of the 2,048-token prompt and 8
decode steps after phase 6, one training step of each model in phases
12 and 13, one qwen3-moe prefill and 8 decode steps after phase 14, and
pixtral's and whisper's kernel and plain prefills and 8 decode steps in
phases 16 and 17 (torch.profiler: wall time, device-busy share, top kernels; the
operator tables go to DIR when one is given).  It then
prints the kernels' JSON line (launches by path, the paths of phases
9-17 included, the training paths with none; the times of flash attention and of the norm and bincount
kernels per launch, averaged over their path's launches; the two butterfly
kernels' at 128 rows; every timed shape under "by_shape") and, last, the
result line.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

# cuBLAS gives the same result on two streams only with a fixed workspace
# (phase 7 runs the pipeline's two pods on two streams); it reads this when
# its first handle is made, so it is set before anything touches the card
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

ROOT = Path(__file__).resolve().parent

# data-sheet rates of the H100 SXM (NVIDIA, dense): bytes/s of device memory
# and bf16 tensor-core FLOP/s (the kernels' inputs are bf16 at the timed shapes)
H100_RATES = (3.35e12, 989e12)
# f32 FLOP/s outside the tensor cores (the RMSNorm arithmetic)
H100_F32 = 67e12

D, D_R = 4096, 64
# reduce_quant's bf16 row tile is 16 rows up to 1,024 and 64 above;
# dequant_restore's 16 up to 128, 32 up to 256, 64 up to 512, 128 above
CHECK_ROWS = (1, 4, 8, 32, 33, 37, 64, 128, 129, 256, 257, 512, 513, 768, 1024,
              1025, 4096)
# gemma3-12b's butterfly: d_r = d_model // 64 = 60, padded to 64 channels
GEMMA_D, GEMMA_D_R = 3840, 60
GEMMA_ROWS = (1, 100, 2048, 2049)
# the butterfly kernels' timed rows at d=4096, d_r=64: a decode step and a
# pipeline tick (1, 4), prompts and prefill microbatches (128-1,024), and
# 1,025 beside 1,024, where the first reduce_quant design changed its tile
TIME_ROWS = (1, 4, 128, 256, 512, 768, 1024, 1025, 4096)
# and at gemma3-12b's d=3840, d_r=60: its 100- and 2,048-token prompts
GEMMA_TIME_ROWS = (100, 2048)
JSON_ROWS = 128          # a 128-token prompt's edge/cloud call on the main path
# the two dense configs of phases 9 and 10: qwen3-14b's bank (d=5120,
# d_r=80, reduce_quant pads it to 128 channels) and gemma-7b's in-graph
# wire (d=3072, d_r=48, padded to 64), at a decode row, a 128-token prompt
# and a 2,048-token prefill
DENSE_WIDTHS = ((5120, 80), (3072, 48))
DENSE_ROWS = (1, 128, 2048)


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


# --------------------------------------------------------------------------- 1
def phase_device():
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from a "
             f"checkout of the repository")
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, devices {torch.cuda.device_count()}")
    if "H100" not in name or "PCIe" in name:
        fail(f"the bounds use the H100 SXM's data-sheet rates, not {name!r}'s")
    sys.path.insert(0, str(ROOT / "src"))
    return name, smi, H100_RATES


# --------------------------------------------------------------------------- 2
def phase_build():
    import torch
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    built = build.compile_libraries()
    for name, (lib, log, secs) in built.items():
        build.load(name)
        print(f"build: {lib.name} in {secs:.1f} s (nvcc, sm_90a)")
        for line in log.splitlines():
            if "Compiling entry function" in line:
                print(f"  ptxas: entry {line.split(chr(39))[1][:100]}")
            elif "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")
    print(f"build: {len(built)} libraries in {time.perf_counter() - t0:.1f} s "
          f"(one nvcc per source, in parallel)")
    from repro_torch.kernels import butterfly_kernel as bk
    for T, d, d_r in _timed_shapes():
        plan = bk.restore_plan(T, d, d_r)
        print(f"build: dequant_restore bf16 T={T:5d} d={d} d_r={d_r}: "
              f"{plan['rows']}-row tiles, {plan['blocks']} blocks of 128 threads, "
              f"{plan['smem']} B dynamic shared memory a block")
    for d_r in (16, 60, 64, 1024):
        print(f"build: dequant_restore_norm d_r={d_r}: dynamic shared memory "
              f"{bk.restore_plan(1, D, d_r)['norm_smem']} B a block (bf16), "
              f"{bk.restore_plan(1, D, d_r, torch.float32)['norm_smem']} B (f32)")


# --------------------------------------------------------------------------- 3
def _inputs(T, d, d_r, dtype, seed):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((T, d), generator=g, device="cuda").to(dtype)
    w = (torch.randn((d, d_r), generator=g, device="cuda") / math.sqrt(d)).to(dtype)
    wr = (torch.randn((d_r, d), generator=g, device="cuda") / math.sqrt(d_r)).to(dtype)
    return x, w, wr


def phase_kernels():
    """Kernel vs plain version on the same inputs.  Codes may differ by 1 on
    at most 0.1% of entries (rounded up to a whole entry): the f32 sums run
    in another order than the plain product's.  Scales agree within rtol
    1e-5.  The restore agrees within one bf16 ulp (rtol 2**-7, atol 1e-3)
    in bf16, and within rtol 1e-5 (atol 1e-6) in f32."""
    import torch
    from repro_torch.kernels import butterfly_kernel as bk, ref
    worst = {"butterfly_reduce_quant": 0.0, "butterfly_dequant_restore": 0.0}
    worst_frac = (0.0, None)            # the largest share of codes that differ
    cases = [(T, D, D_R, torch.bfloat16) for T in CHECK_ROWS] + \
        [(T, GEMMA_D, GEMMA_D_R, torch.bfloat16) for T in GEMMA_ROWS] + \
        [(T, d, d_r, torch.bfloat16) for d, d_r in DENSE_WIDTHS
         for T in DENSE_ROWS] + \
        [(T, 256, 16, torch.float32) for T in (1, 37, 512)]
    for T, d, d_r, dtype in cases:
        x, w, wr = _inputs(T, d, d_r, dtype, seed=T)
        codes, scales = bk.reduce_quant(x, w, 8)
        codes_p, scales_p = ref.butterfly_reduce_quant_ref(x, w, 8)
        diff = (codes.int() - codes_p.int()).abs()
        n_diff, max_diff = int((diff > 0).sum()), int(diff.max())
        allowed = math.ceil(1e-3 * diff.numel())
        if max_diff > 1 or n_diff > allowed:
            fail(f"reduce_quant T={T} {dtype}: {n_diff} codes differ (max "
                 f"{max_diff}); allowed {allowed} by at most 1")
        torch.testing.assert_close(scales, scales_p, rtol=1e-5, atol=0)
        out = bk.dequant_restore(codes_p, scales_p, wr, dtype)
        out_p = ref.butterfly_dequant_restore_ref(codes_p, scales_p, wr, dtype)
        tol = dict(rtol=2 ** -7, atol=1e-3) if dtype == torch.bfloat16 else \
            dict(rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(out, out_p, **tol)
        err = float((out.float() - out_p.float()).abs().max())
        if n_diff / diff.numel() > worst_frac[0]:
            worst_frac = (n_diff / diff.numel(), (T, d, d_r, str(dtype)[6:]))
        worst["butterfly_reduce_quant"] = max(worst["butterfly_reduce_quant"], max_diff)
        worst["butterfly_dequant_restore"] = max(worst["butterfly_dequant_restore"], err)
        print(f"kernels: T={T:5d} d={d} d_r={d_r} {str(dtype)[6:]:8s} codes "
              f"differ {n_diff}/{diff.numel()} (max {max_diff}), restore max "
              f"|err| {err:.3g}")
    torch.cuda.synchronize()
    print(f"kernels: reduce_quant's worst share of codes differing from the "
          f"plain version {worst_frac[0]:.5%} at (T, d, d_r, dtype) "
          f"{worst_frac[1]} (limit 0.1%)")
    return worst


# flash attention at the main paths' shapes, (B, S, N, K, hd, window) with
# T = S, causal unless in FLASH_FULL: gemma3-12b's global and windowed
# layers on the 2,048- and 100-token prompts, qwen3-8b on a 128-token
# prompt, gemma-7b's MHA (one query head a key head) on phase 10's prompts,
# qwen3-14b's five query heads a key head on a 128-token prompt,
# qwen3-moe's sixteen (64/4 heads) on 128, pixtral-12b's 1,024 patches +
# 100 tokens (phase 16), and whisper-base's encoder over 1,500 frames (not
# causal) and its decoder on a 32-token prompt (phase 17)
FLASH_PATH = {
    "gemma3 S=2048 global": (1, 2048, 16, 8, 256, None),
    "gemma3 S=2048 window": (1, 2048, 16, 8, 256, 1024),
    "gemma3 S=100": (1, 100, 16, 8, 256, None),
    "qwen3 S=128": (1, 128, 32, 8, 128, None),
    "gemma-7b S=2048": (1, 2048, 16, 16, 256, None),
    "gemma-7b S=100": (1, 100, 16, 16, 256, None),
    "qwen3-14b S=128": (1, 128, 40, 8, 128, None),
    "qwen3-moe S=128": (1, 128, 64, 4, 128, None),
    "pixtral S=1124": (1, 1124, 32, 8, 128, None),
    "whisper enc S=1500": (1, 1500, 8, 8, 64, None),
    "whisper dec S=32": (1, 32, 8, 8, 64, None),
}
FLASH_FULL = {"whisper enc S=1500"}
# the 2,048-token gemma3-12b prefill's 48 flash launches, by shape
FLASH_JSON = {"gemma3 S=2048 window": 40, "gemma3 S=2048 global": 8}


def _qkv(B, S, T, N, K, hd, dtype, seed):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=g, device="cuda").to(dtype)
            for shape in ((B, S, N, hd), (B, T, K, hd), (B, T, K, hd))]


def _flash_excess(out, q, k, v, causal, window) -> float:
    """The largest |error| over its tolerance (pass: <= 1).  f32: against
    the plain version within rtol/atol 2e-5 (f32 sums in another order).
    bf16: against the plain version's f32 result o within 2**-7 |o| + 2**-7
    sum_t w_t |v_t - o|, w the plain softmax weights of the row: the
    tensor-core kernel rounds each weight to bf16 and normalises by the sum
    of the rounded weights (ref.flash_attention_bf16_bound derives it)."""
    import torch
    from repro_torch.kernels import ref
    if out.dtype == torch.float32:
        want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
        return float(((out - want).abs() / (2e-5 + 2e-5 * want.abs())).max())
    o, bound = ref.flash_attention_bf16_bound(q, k, v, causal=causal, window=window)
    return float(((out.float() - o).abs() / bound).max())


def phase_flash_checks():
    """Flash kernel vs its plain version: every head dim in f32 and bf16,
    causal, windowed, not causal and not causal with a window, on S < T,
    S > T (rows that see no key) and ragged S and T; then the paths' shapes
    in bf16 (see _flash_excess for the tolerances).  Returns the largest
    |error| at the paths' shapes."""
    import torch
    from repro_torch.kernels import flash_attention as fa, ops, ref
    shapes = [(2, 128, 128, 4, 2), (1, 37, 53, 4, 2), (1, 130, 65, 2, 2),
              (1, 1, 77, 8, 2), (2, 200, 200, 8, 1)]
    masks = [(True, None), (True, 16), (False, None), (False, 16)]
    n = 0
    for hd in fa.HEAD_DIMS:
        for dtype in (torch.float32, torch.bfloat16):
            worst, worst_x = 0.0, 0.0
            for B, S, T, N, K in shapes:
                q, k, v = _qkv(B, S, T, N, K, hd, dtype, seed=S * T + hd)
                for causal, window in masks:
                    out = ops.flash_attention(q, k, v, causal=causal, window=window)
                    want = ref.flash_attention_ref(q, k, v, causal=causal,
                                                   window=window)
                    excess = _flash_excess(out, q, k, v, causal, window)
                    if excess > 1:
                        fail(f"flash hd={hd} {dtype} B,S,T,N,K={B, S, T, N, K} "
                             f"causal={causal} window={window}: out of tolerance")
                    worst = max(worst, float((out.float() - want.float()).abs().max()))
                    worst_x = max(worst_x, excess)
                    n += 1
            print(f"flash: hd={hd:3d} {str(dtype)[6:]:8s} {len(shapes)} shapes x "
                  f"{len(masks)} masks, max |err| {worst:.3g}, max |err| / "
                  f"tolerance {worst_x:.4f}")
    worst = 0.0
    for label, (B, S, N, K, hd, window) in FLASH_PATH.items():
        causal = label not in FLASH_FULL
        q, k, v = _qkv(B, S, S, N, K, hd, torch.bfloat16, seed=S + hd)
        out = ops.flash_attention(q, k, v, causal=causal, window=window)
        want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
        excess = _flash_excess(out, q, k, v, causal, window)
        if excess > 1:
            fail(f"flash {label} bf16: out of tolerance")
        err = float((out.float() - want.float()).abs().max())
        worst = max(worst, err)
        n += 1
        print(f"flash: {label:22s} bf16 max |err| {err:.3g}, max |err| / "
              f"bound {excess:.4f}")
    torch.cuda.synchronize()
    print(f"flash: {n} checks against the plain version passed")
    return worst


# --------------------------------------------------------------------------- 4
def _device_ms(fn, reps: int = 30) -> float:
    """Median device time of ``fn`` in ms.  A sleep kernel holds the queue
    while the host enqueues every launch, so host overhead is not timed, and
    a 128 MB write before each launch leaves its inputs cold in L2."""
    import torch
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    torch.cuda._sleep(int(2e8))
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def _timed_shapes():
    """The wire kernels' timed (T, d, d_r): qwen3-8b's and gemma3-12b's
    widths, then the two dense configs' (DENSE_WIDTHS at DENSE_ROWS)."""
    return [(T, D, D_R) for T in TIME_ROWS] + \
        [(T, GEMMA_D, GEMMA_D_R) for T in GEMMA_TIME_ROWS] + \
        [(T, d, d_r) for d, d_r in DENSE_WIDTHS for T in DENSE_ROWS]


def _bounds(rates, T, d, d_r):
    """(reduce_quant, dequant_restore) least times in ms at bf16, each as
    (ms, "bytes" | "operations")."""
    bw, bf16_ops = rates
    rq_bytes = T * d * 2 + d * d_r * 2 + T * d_r + T * 4
    dr_bytes = T * d_r + T * 4 + d_r * d * 2 + T * d * 2
    ops = 2 * T * d * d_r

    def pick(nbytes):
        tb, to = nbytes / bw * 1e3, ops / bf16_ops * 1e3
        return (tb, "bytes") if tb >= to else (to, "operations")
    return pick(rq_bytes), pick(dr_bytes)


def _visible_pairs(S: int, T: int, causal: bool, window) -> int:
    """(query, key) pairs the masks leave visible, summed over query rows;
    a row that sees no key averages all T values."""
    total = 0
    for i in range(S):
        qpos = i + T - S
        lo = max(0, qpos - window + 1) if window else 0
        hi = min(T - 1, qpos) if causal else T - 1
        total += hi - lo + 1 if hi >= lo else T
    return total


def phase_flash_times(rates):
    """Kernel, plain version and one scaled_dot_product_attention call at
    the paths' shapes, bf16, against the bound: the larger of FLOPs (4 * hd
    per visible pair and query head) over the bf16 tensor-core rate and the
    bytes of q, k, v and the output over the memory rate.  Also the kernel's
    TFLOP/s and the host time a call spends encoding its four TMA tensor
    maps (mean of 1,000 encodings)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa, ops, ref
    bw, bf16_ops = rates
    out = {}
    for label, (B, S, N, K, hd, window) in FLASH_PATH.items():
        causal = label not in FLASH_FULL
        q, k, v = _qkv(B, S, S, N, K, hd, torch.bfloat16, seed=S + hd)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))   # SDPA's layout
        if window:
            pos = torch.arange(S, device=q.device)
            mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
            library = lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True)
        else:
            library = lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True)
        lib_out = library().transpose(1, 2)
        want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
        lib_err = float((lib_out.float() - want.float()).abs().max())
        ms = _device_ms(lambda: ops.flash_attention(q, k, v, causal=causal,
                                                    window=window))
        plain_ms = _device_ms(lambda: ref.flash_attention_ref(
            q, k, v, causal=causal, window=window))
        library_ms = _device_ms(library)
        flops = 4 * B * N * hd * _visible_pairs(S, S, causal, window)
        nbytes = 2 * (2 * B * S * N * hd + 2 * B * S * K * hd)
        tb, to = nbytes / bw * 1e3, flops / bf16_ops * 1e3
        bound_ms, bound_by = (tb, "bytes") if tb >= to else (to, "operations")
        encode_us = fa.encode_ns(q, k, v, torch.empty_like(q)) / 1e3
        out[label] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                          bound_ms=bound_ms, bound_by=bound_by,
                          tflops=flops / ms / 1e9, encode_us=encode_us)
        print(f"times: flash_attention {label:22s} kernel {ms:.4f} ms  plain "
              f"{plain_ms:.4f} ms  sdpa {library_ms:.4f} ms (max |err| vs plain "
              f"{lib_err:.3g})  bound {bound_ms:.4f} ms ({bound_by}; bytes "
              f"{tb:.4f} ms)  {flops / ms / 1e9:.1f} TFLOP/s  (sdpa "
              f"{flops / library_ms / 1e9:.1f})  tensor maps {encode_us:.2f} us "
              f"of host time a call")
    return out


def phase_times(rates):
    """reduce_quant and dequant_restore, and their plain versions, at
    TIME_ROWS (d=4096, d_r=64), GEMMA_TIME_ROWS (d=3840, d_r=60) and
    DENSE_ROWS at DENSE_WIDTHS (d=5120, d_r=80; d=3072, d_r=48), bf16,
    against the bound (_bounds); for dequant_restore also three PyTorch
    calls, ``(codes.to(bf16) @ w_restore) * scales`` (a yardstick the port
    never calls: no one call computes the function, so its library_ms stays
    None).  Where d_r is not a channel width the reduce kernel computes
    (60, 80, 48), its wrapper pads w_reduce with zero columns on every call;
    reduce_quant is then also timed on a w_reduce padded beforehand, which
    shows what the pad costs.  Returns {(name, T, d): times}."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import build, butterfly_kernel as bk, ref
    width = build.load("butterfly").butterfly_reduce_width
    out = {}
    for T, d, d_r in _timed_shapes():
        x, w, wr = _inputs(T, d, d_r, torch.bfloat16, seed=T)
        codes, scales = ref.butterfly_reduce_quant_ref(x, w)
        rows = {
            "butterfly_reduce_quant": (
                lambda: bk.reduce_quant(x, w, 8),
                lambda: ref.butterfly_reduce_quant_ref(x, w, 8)),
            "butterfly_dequant_restore": (
                lambda: bk.dequant_restore(codes, scales, wr, torch.bfloat16),
                lambda: ref.butterfly_dequant_restore_ref(codes, scales, wr,
                                                          torch.bfloat16)),
        }
        bounds = dict(zip(rows, _bounds(rates, T, d, d_r)))
        for name, (kern, plain) in rows.items():
            ms, plain_ms = _device_ms(kern), _device_ms(plain)
            bound_ms, bound_by = bounds[name]
            out[(name, T, d)] = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                                     bound_ms=bound_ms, bound_by=bound_by)
            three = ""
            if name == "butterfly_reduce_quant" and width(d_r) != d_r:
                w_pad = F.pad(w, (0, width(d_r) - d_r))
                pre_ms = _device_ms(lambda: bk.reduce_quant(x, w_pad, 8))
                out[(name, T, d)]["prepadded_ms"] = pre_ms
                three = f"  on a w_reduce padded to {width(d_r)} beforehand " \
                    f"{pre_ms:.4f} ms"
            if name == "butterfly_dequant_restore":
                three_ms = _device_ms(lambda: (codes.to(torch.bfloat16) @ wr) * scales)
                out[(name, T, d)]["three_calls_ms"] = three_ms
                three = f"  three calls {three_ms:.4f} ms"
            print(f"times: {name:26s} T={T:5d} d={d} d_r={d_r} kernel {ms:.4f} ms"
                  f"  plain {plain_ms:.4f} ms{three}  bound {bound_ms:.6f} ms "
                  f"({bound_by})")
    return out


# --------------------------------------------------------------------------- 5
def _wrappers():
    from repro_torch.kernels import butterfly_kernel as bk, flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    return {"butterfly_reduce_quant": bk.reduce_quant,
            "butterfly_dequant_restore": bk.dequant_restore,
            "flash_attention": fa.flash_attention,
            "butterfly_dequant_restore_norm": bk.dequant_restore_norm,
            "rmsnorm": rn.rmsnorm,
            "butterfly_reduce_quant_bincount": bk.reduce_quant_bincount}


def _counts():
    return {name: fn.launches for name, fn in _wrappers().items()}


def _zero_counts():
    for fn in _wrappers().values():
        fn.launches = 0


def _prompts(n: int, lengths):
    from repro_torch.data import tokenizer
    words = ("edge", "cloud", "butterfly", "wire", "split", "layer", "token",
             "reduce", "restore", "quantize", "decode", "prefill")
    out = []
    for i, length in zip(range(n), lengths):
        text, j = "", i
        while len(text) < length - 1:
            text += words[j % len(words)] + " "
            j += 7
        out.append(tokenizer.encode(text[:length - 1]))
    return out


def _serve_handoff(runner, engine, prompts, new_tokens):
    """Cache handoff: each prompt prefills through edge_half -> host wire ->
    cloud_half and joins the engine, which then decodes them together.
    ``wire`` holds each request's bytes on the wire (codes + scales)."""
    import torch
    params = runner.params
    reqs, logits_out, prefill_ms, wire = [], [], [], []
    raw = 0
    for toks in prompts:
        torch.cuda.synchronize()
        t = time.perf_counter()
        payload, scales, c0 = runner.edge_half(params, toks[None])
        payload_h, scales_h = payload.cpu(), scales.cpu()          # the wire
        logits, c1 = runner.cloud_half(params, payload_h.cuda(), scales_h.cuda())
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t) * 1e3)
        wire.append(payload_h.numel() * payload_h.element_size() +
                    scales_h.numel() * scales_h.element_size())
        raw += len(toks) * runner.cfg.d_model * 2
        logits_out.append(logits[0])
        reqs.append(engine.submit_prefilled(len(toks), [c0, c1], logits[0],
                                            max_new_tokens=new_tokens))
    steps0 = engine.decode_steps
    t = time.perf_counter()
    engine.run()
    torch.cuda.synchronize()
    steps = engine.decode_steps - steps0
    step_ms = (time.perf_counter() - t) * 1e3 / max(steps, 1)
    return reqs, logits_out, prefill_ms, wire, raw, step_ms, steps


def _serve_streamed(runner, engine, toks, new_tokens, max_len):
    """Streamed transport: the edge keeps its cache and ships one wire row
    per token; the cloud applies each row through the engine."""
    import torch
    params = runner.params
    S = len(toks)
    payload, scales, c0 = runner.edge_half(params, toks[None])
    logits, c1 = runner.cloud_half(params, payload.cpu().cuda(), scales.cpu().cuda())
    c0 = runner.pad_decode_cache(c0, 0, max_len)
    c1 = runner.pad_decode_cache(c1, 1, max_len)
    req = engine.submit_streamed(S, logits[0], max_new_tokens=new_tokens)
    torch.cuda.synchronize()
    t = time.perf_counter()
    pos = S
    while not req.done:
        payload, scales, c0 = runner.edge_step(params, [[req.generated[-1]]],
                                               c0, [pos])
        _, c1 = runner.stream_step(engine, req, c1, payload.cpu(),
                                   scales.cpu(), pos)
        pos += 1
    torch.cuda.synchronize()
    return req, (time.perf_counter() - t) * 1e3 / max(len(req.generated) - 1, 1)


def phase_serving(arch: str = "qwen3-8b", new_tokens: int = 16,
                  streamed: bool = True, label: str = "serving"):
    """``arch`` at full width through the bank's split path (phases 5 and
    9): prompts of 64, 80, 100 and 128 tokens prefill one at a time through
    edge_half -> host wire -> cloud_half and decode ``new_tokens`` together
    in the engine (cache handoff); with ``streamed`` one more 96-token
    prompt decodes 8 tokens through edge_step/stream_step.  Returns the
    launches and the runner."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.runtime.split_exec import SplitModelBank

    cfg = get_config(arch)
    split, d_r = cfg.num_layers // 8, max(16, cfg.d_model // 64)
    t0 = time.perf_counter()
    bank = SplitModelBank(cfg, d_r, wire_mode="int8", seed=0, device="cuda")
    runner = bank.runner(split)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(runner.params))
    print(f"{label}: {cfg.name} {cfg.num_layers} layers d_model {cfg.d_model} "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads {cfg.dtype}, "
          f"{n_params / 1e9:.3f} B params, split {split}, d_r {d_r}, int8 "
          f"wire; init {time.perf_counter() - t0:.1f} s")
    max_len = 256
    n = 4
    prompts = _prompts(n + 1, (64, 80, 100, 128, 96))
    engine = runner.make_engine(max_batch=n, max_len=max_len, seed=0)
    # warm-up at the same shapes, so the timed run pays no first-call costs
    # (cuBLAS heuristics, allocator growth)
    t0 = time.perf_counter()
    _serve_handoff(runner, engine, prompts[:n], 2)
    if streamed:
        _serve_streamed(runner, engine, prompts[n], 2, max_len)
    print(f"{label}: warm-up {time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()

    _zero_counts()
    reqs, cloud_logits, prefill_ms, wire, raw_bytes, decode_ms, \
        decode_steps = _serve_handoff(runner, engine, prompts[:n], new_tokens)
    sreq = None
    if streamed:
        sreq, stream_ms = _serve_streamed(runner, engine, prompts[n], 8, max_len)
    launches = _counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # the bank's attention is the plain one: only the butterfly kernels run
    print(f"{label}: launches on the main path {launches}")
    if min(launches["butterfly_reduce_quant"],
           launches["butterfly_dequant_restore"]) <= 0:
        fail(f"a kernel was not launched on the {arch} split path: {launches}")
    done = reqs + ([sreq] if streamed else [])
    for r in done:
        if not r.done:
            fail(f"request {r.uid} did not finish")
    if [len(r.generated) for r in reqs] != [new_tokens] * n or \
            (streamed and len(sreq.generated) != 8):
        fail("wrong number of generated tokens")
    # the int8 wire: S codes of d_r bytes and S f32 scales a request
    want_wire = [len(toks) * (d_r + 4) for toks in prompts[:n]]
    if wire != want_wire:
        fail(f"wire bytes {wire} per request, expected S * {d_r} + 4 * S = "
             f"{want_wire}")
    if peak_gb >= 80:
        fail(f"peak device memory {peak_gb:.2f} GB does not fit the card")

    # the reference rounds x @ w_reduce to bf16 before quantizing, so the
    # check is a bound, not equality
    agree = 0
    for toks, lg in zip(prompts[:n], cloud_logits):
        ref, _ = runner.reference_prefill(toks[None])
        ref = ref[0, -1]
        if not (torch.isfinite(lg).all() and lg.shape == ref.shape
                and lg.shape[-1] == cfg.vocab_size):
            fail("cloud logits are not finite or of the wrong shape")
        delta = float((lg - ref).abs().max())
        limit = 0.05 * float(ref.abs().max())
        if delta > limit:
            fail(f"cloud logits differ from the reference by {delta} > {limit}")
        agree += int(torch.argmax(lg) == torch.argmax(ref))
        print(f"{label}: S={len(toks)} max|logits - reference| {delta:.4g} "
              f"(limit {limit:.4g})")
    for r, lg in zip(reqs, cloud_logits):
        if r.generated[0] != int(torch.argmax(lg)):
            fail("the first token is not the greedy token of the cloud logits")
    print(f"{label}: greedy first-token agreement with the reference "
          f"{agree}/{n}")
    print(f"{label}: wire {wire} B a request (codes + scales, S * {d_r} + "
          f"4 * S each) for {raw_bytes} B of raw bf16 boundary activations "
          f"({raw_bytes / sum(wire):.1f}x)")
    print(f"{label}: prefill (edge + wire + cloud) ms per request "
          f"{[round(v, 3) for v in prefill_ms]}, median "
          f"{statistics.median(prefill_ms):.3f}")
    weight_gb = n_params * 2 / 1e9
    print(f"{label}: handoff decode {decode_ms:.3f} ms per step of {n} slots "
          f"({decode_steps} steps, {decode_ms / n:.3f} ms per token)"
          + (f"; streamed decode {stream_ms:.3f} ms per token" if streamed else "")
          + f"; weight-read floor {weight_gb / 3.35:.2f} ms a step "
          f"({weight_gb:.2f} GB at 3.35 TB/s)")
    print(f"{label}: peak device memory {peak_gb:.2f} GB")
    print(f"{label}: tokens {[r.generated for r in reqs]}"
          + (f" streamed {sreq.generated}" if streamed else ""))
    return launches, runner


def _leaves(tree):
    from repro_torch.tree import tree_leaves
    return tree_leaves(tree)


# --------------------------------------------------------------------------- 6
def _positions(batch) -> int:
    """Positions a prompt takes: its tokens, after a VLM's patches."""
    return batch["tokens"].shape[1] + (batch["patches"].shape[1]
                                       if "patches" in batch else 0)


def _serve_prompt(params, built, batch, new_tokens):
    """One prompt (a batch dict: tokens, and patches or frames where the
    model takes them): kernel prefill, plain prefill, pad the caches to
    capacity, greedy decode.  Returns what came out and what it measured."""
    import torch
    from repro_torch.models import model as M
    S = _positions(batch)
    n0 = _counts()["flash_attention"]
    torch.cuda.synchronize()
    t = time.perf_counter()
    logits, caches = M.forward_prefill(params, built, batch, use_kernel=True)
    torch.cuda.synchronize()
    kernel_ms = (time.perf_counter() - t) * 1e3
    flash_kernel = _counts()["flash_attention"] - n0
    t = time.perf_counter()
    ref, _ = M.forward_prefill(params, built, batch)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t) * 1e3
    cap = S + new_tokens
    caches = M.pad_decode_caches(built, caches, cap)
    tok = logits[:, -1].argmax(-1, keepdim=True)
    generated = [tok]
    torch.cuda.synchronize()
    t = time.perf_counter()
    for pos in range(S, cap):
        step_logits, caches = M.forward_decode(params, built, tok, caches, pos,
                                               use_kernel=True)
        tok = step_logits[:, -1].argmax(-1, keepdim=True)
        generated.append(tok)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t) * 1e3 / new_tokens
    return dict(S=S, cap=cap, logits=logits, ref=ref, caches=caches,
                step_logits=step_logits, generated=generated,
                flash_kernel=flash_kernel,
                flash_rest=_counts()["flash_attention"] - n0 - flash_kernel,
                kernel_ms=kernel_ms, plain_ms=plain_ms, decode_ms=decode_ms)


def _check_prompt(params, built, batch, r):
    """Hold one prompt's results from :func:`_serve_prompt` to the phase's
    limits: one flash launch an attention layer (the encoder's included),
    the 5% logit bound and equal greedy tokens, the decode caches' lengths.
    Its whole-sequence prefill is a check, so it runs after the path's
    launches were read."""
    import torch
    from repro_torch.models import model as M
    cfg = built.cfg
    S, cap, logits, ref, caches, step_logits, generated = (
        r[k] for k in ("S", "cap", "logits", "ref", "caches", "step_logits",
                       "generated"))
    flash = r["flash_kernel"]
    layers = cfg.num_layers + cfg.encoder_layers
    if flash != layers or r["flash_rest"] != 0:
        fail(f"S={S}: the kernel prefill launched the flash kernel {flash} "
             f"times, the plain prefill and decode {r['flash_rest']}; "
             f"expected {layers} and 0")
    if not (torch.isfinite(logits).all() and logits.shape == (1, 1, cfg.vocab_size)):
        fail(f"S={S}: kernel prefill logits are not finite or of the wrong shape")
    delta = float((logits - ref).abs().max())
    limit = 0.05 * float(ref.abs().max())
    if delta > limit:
        fail(f"S={S}: kernel prefill logits differ from the plain prefill's by "
             f"{delta} > {limit}")
    if int(logits.argmax()) != int(ref.argmax()):
        fail(f"S={S}: the kernel and plain prefills disagree on the greedy token")
    windowed = {d.window for segs in built.stages for seg in segs for d in seg.unit}
    want_lengths = {cap if w is None else min(cap, w) for w in windowed}
    if cfg.is_encdec:                 # the cross_kv caches: one row a frame
        want_lengths.add(batch["frames"].shape[1])
    lengths = {leaf.shape[2] for leaf in _leaves(caches)}
    if lengths != want_lengths:
        fail(f"S={S}: decode cache lengths {sorted(lengths)}, expected "
             f"{sorted(want_lengths)}")
    # the last decode step against a kernel prefill of the whole sequence,
    # whose windowed layers see the same 1024 positions the rings hold
    seq = dict(batch, tokens=torch.cat([batch["tokens"]] + generated[:-1], dim=1))
    whole, _ = M.forward_prefill(params, built, seq, use_kernel=True)
    d_delta = float((step_logits - whole).abs().max())
    d_limit = 0.05 * float(whole.abs().max())
    if not torch.isfinite(step_logits).all() or d_delta > d_limit:
        fail(f"S={S}: the last decode step differs from a prefill of the "
             f"whole sequence by {d_delta} > {d_limit}")
    tokens = [int(x) for x in torch.cat(generated[1:], dim=1)[0].tolist()]
    print(f"kernel prefill: S={S:5d} prefill kernel {r['kernel_ms']:.3f} ms, "
          f"plain {r['plain_ms']:.3f} ms; flash launches {flash}; max|logits - plain| "
          f"{delta:.4g} (limit {limit:.4g}), greedy token {int(ref.argmax())} "
          f"both")
    print(f"kernel prefill: S={S:5d} decode {r['decode_ms']:.3f} ms per token "
          f"over {cap - S} steps; cache rows {sorted(lengths)}; last step vs "
          f"whole-sequence prefill {d_delta:.4g} (limit {d_limit:.4g}), greedy "
          f"{'same' if int(step_logits.argmax()) == int(whole.argmax()) else 'differs'}")
    print(f"kernel prefill: S={S:5d} tokens {tokens}")
    return tokens


def _family_prompts(cfg, lengths, seed: int = 0):
    """Prompts as batches: byte-tokenized text of ``lengths`` tokens, with
    pixtral's NUM_PATCHES seeded patch embeddings before them and
    whisper's seeded frame embeddings (stand-ins for the stubbed vision and
    audio frontends, N(0, 1) as in the JAX package's tests)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    dtype = getattr(torch, cfg.dtype)
    out = []
    for p in _prompts(len(lengths), lengths):
        batch = {"tokens": torch.tensor(p, dtype=torch.int64, device="cuda")[None]}
        if cfg.num_patches:
            batch["patches"] = torch.randn((1, cfg.num_patches, cfg.d_model),
                                           generator=g, device="cuda").to(dtype)
        if cfg.is_encdec:
            batch["frames"] = torch.randn((1, cfg.encoder_frames, cfg.d_model),
                                          generator=g, device="cuda").to(dtype)
        out.append(batch)
    return out


def phase_kernel_prefill(arch: str = "gemma3-12b", profile: bool = False,
                         out_dir: Optional[Path] = None, lengths=(100, 2048),
                         butterfly=None, new_tokens: int = 16,
                         label: str = "kernel prefill"):
    """``arch`` at full width through forward_prefill(use_kernel=True) and
    greedy forward_decode (phases 6, 10, 16, 17; see the module docstring):
    one prompt of each of ``lengths`` tokens (and the model's patches or
    frames), the butterfly after ``butterfly = (layer, d_r)`` (by default
    an eighth of the way, d_r = d_model / 64).  With ``profile`` it then
    profiles the last prompt's kernel and plain prefills and 8 decode
    steps.  Returns the launches, the tokens and the flash calls' (S, T,
    causal) of one kernel prefill of the last prompt."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa, ops
    from repro_torch.models import model as M

    base = get_config(arch)
    layer, d_r = butterfly or (base.num_layers // 8, max(16, base.d_model // 64))
    cfg = base.with_butterfly(layer, d_r)
    built = M.build(cfg)
    t0 = time.perf_counter()
    params = M.init_model(torch.Generator(device="cuda").manual_seed(0), built,
                          device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(params))
    extra = (f", {cfg.num_patches} patches" if cfg.num_patches else "") + \
        (f", {cfg.encoder_layers} encoder layers over {cfg.encoder_frames} frames"
         if cfg.is_encdec else "")
    print(f"{label}: {cfg.name} {cfg.num_layers} layers d_model "
          f"{cfg.d_model} {cfg.num_heads}/{cfg.num_kv_heads} heads head_dim "
          f"{cfg.resolved_head_dim} window {cfg.sliding_window}{extra} {cfg.dtype}, "
          f"{n_params / 1e9:.3f} B params, butterfly after layer "
          f"{cfg.butterfly.layer} d_r {cfg.butterfly.d_r}; init "
          f"{time.perf_counter() - t0:.1f} s; weight-read floor "
          f"{n_params * 2 / 1e9 / 3.35:.2f} ms ({n_params * 2 / 1e9:.2f} GB at "
          f"3.35 TB/s)")
    prompts = _family_prompts(cfg, lengths)
    if [p["tokens"].shape[1] for p in prompts] != list(lengths):
        fail(f"the prompts are not {lengths} tokens long")
    # warm-up at the same shapes, so the timed run pays no first-call costs
    t0 = time.perf_counter()
    for batch in prompts:
        _serve_prompt(params, built, batch, 2)
    print(f"{label}: warm-up {time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()

    _zero_counts()
    served = [_serve_prompt(params, built, batch, new_tokens) for batch in prompts]
    launches = _counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"{label}: launches on the path {launches}")
    if min(launches[k] for k in ("butterfly_reduce_quant",
                                 "butterfly_dequant_restore",
                                 "flash_attention")) <= 0:
        fail(f"a kernel was not launched on the kernel-prefill path: {launches}")
    if peak_gb >= 80:
        fail(f"peak device memory {peak_gb:.2f} GB does not fit the card")
    results = [_check_prompt(params, built, batch, r)
               for batch, r in zip(prompts, served)]
    del served
    # which flash calls one kernel prefill makes: (S, T, causal) a launch,
    # read at the entry point the attention layers call
    calls, entry = [], ops.flash_attention

    def recording(q, k, v, *, causal=True, window=None):
        n = fa.flash_attention.launches
        out = entry(q, k, v, causal=causal, window=window)
        calls.extend([(q.shape[1], k.shape[1], causal)] * (fa.flash_attention.launches - n))
        return out
    ops.flash_attention = recording
    try:
        M.forward_prefill(params, built, prompts[-1], use_kernel=True)
    finally:
        ops.flash_attention = entry
    print(f"{label}: one kernel prefill's flash calls (S, T, causal): "
          f"{sorted(set(calls))}, {len(calls)} in all")
    print(f"{label}: peak device memory {peak_gb:.2f} GB")
    if profile:
        batch = prompts[-1]
        S = _positions(batch)
        tag = arch.split("-")[0]
        _profiled(f"{tag}_kernel_prefill", lambda: M.forward_prefill(
            params, built, batch, use_kernel=True), out_dir)
        _profiled(f"{tag}_plain_prefill", lambda: M.forward_prefill(
            params, built, batch), out_dir)
        logits, caches = M.forward_prefill(params, built, batch, use_kernel=True)
        caches = M.pad_decode_caches(built, caches, S + 8)
        tok = logits[:, -1].argmax(-1, keepdim=True)

        def decode():
            for pos in range(S, S + 8):
                M.forward_decode(params, built, tok, caches, pos, use_kernel=True)
        _profiled(f"{tag}_decode", decode, out_dir)
    return launches, results, calls


# --------------------------------------------------------------------------- 7
# the fused restore+norm and RMSNorm kernels: checked at both models' widths,
# every compiled channel width and 1 to 4,096 rows, in f32 and bf16
NORM_D = (4096, 3840)
NORM_D_R = (16, 60, 64, 1024)
NORM_ROWS = (1, 4, 128, 512, 1025, 4096)
# the pipeline's shapes: a 4-row decode tick and a 4 x 128-token prefill
# microbatch; per kernel run 30 ticks and 2 prefills (PIPE below)
PIPE = dict(Mmb=2, mb=4, S=128, T=16)
PIPE_ROWS = {4: PIPE["Mmb"] * (PIPE["T"] - 1), 512: PIPE["Mmb"]}
RMSNORM_ROWS = {4: 1, 512: 1}         # the ops.rmsnorm entry point's calls


def _restore_inputs(T, d, d_r, dtype, seed):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    codes = torch.randint(-127, 128, (T, d_r), generator=g, device="cuda",
                          dtype=torch.int8)
    scales = torch.rand((T, 1), generator=g, device="cuda") * 0.09 + 0.01
    wr = (torch.randn((d_r, d), generator=g, device="cuda") / math.sqrt(d_r)).to(dtype)
    nw = (0.1 * torch.randn((d,), generator=g, device="cuda")).to(dtype)
    return codes, scales, wr, nw


def _restore_err(x, codes, scales, wr):
    """max |x - plain restore|, failing unless it is within one bf16 ulp
    (rtol 2**-7, atol 1e-3) in bf16, or in f32 within the f32 summation
    bound of an f64 product, n*u*sum|a_k b_k| (n = d_r, u = 2**-24), as the
    plain version must be too: codes span [-127, 127], so a sum can cancel
    to near zero, where a relative tolerance says nothing."""
    import torch
    from repro_torch.kernels import ref
    plain = ref.butterfly_dequant_restore_ref(codes, scales, wr, x.dtype)
    if x.dtype == torch.float32:
        r64 = (codes.float() * scales).double()
        exact = r64 @ wr.double()
        bound = 1.01 * codes.shape[1] * 2 ** -24 * (r64.abs() @ wr.double().abs())
        for o in (x, plain):
            if not bool(((o.double() - exact).abs() <= bound).all()):
                return None
    elif not torch.allclose(x.float(), plain.float(), rtol=2 ** -7, atol=1e-3):
        return None
    return float((x.float() - plain.float()).abs().max())


def _norm_err(h, x, nw, eps):
    """max |h - plain RMSNorm of x|, failing unless within rtol 1e-5 (atol
    1e-6) in f32 (the mean of squares sums in another order) and one bf16
    ulp (rtol 2**-7, atol 1e-3) in bf16 (both round one f32 value)."""
    import torch
    from repro_torch.kernels import ref
    plain = ref.rms_norm_ref(x, nw, eps)
    tol = dict(rtol=1e-5, atol=1e-6) if h.dtype == torch.float32 else \
        dict(rtol=2 ** -7, atol=1e-3)
    if not torch.allclose(h.float(), plain.float(), **tol):
        return None
    return float((h.float() - plain.float()).abs().max())


def phase_norm_kernels():
    """butterfly_dequant_restore_norm and rmsnorm against their plain
    versions on the card, and against each other: the fused kernel's x
    equals dequant_restore's and its h equals rmsnorm of that x, bit for
    bit.  The fused kernel's plain version is the plain restore followed by
    the plain norm: x is held to the plain restore, h to the plain norm of
    the kernel's x (see _restore_err, _norm_err).  Returns the largest
    |error| of each kernel."""
    import torch
    from repro_torch.kernels import butterfly_kernel as bk, ref, rmsnorm as rn
    worst = {"butterfly_dequant_restore_norm": 0.0, "rmsnorm": 0.0}
    eps = 1e-6
    n = 0
    for dtype in (torch.bfloat16, torch.float32):
        for d in NORM_D:
            for d_r in NORM_D_R:
                for T in NORM_ROWS:
                    codes, scales, wr, nw = _restore_inputs(T, d, d_r, dtype,
                                                            seed=T + d + d_r)
                    x, h = bk.dequant_restore_norm(codes, scales, wr, nw, eps,
                                                   dtype)
                    if not torch.equal(x, bk.dequant_restore(codes, scales, wr,
                                                             dtype)):
                        fail(f"restore_norm T={T} d={d} d_r={d_r} {dtype}: x "
                             f"differs from dequant_restore's")
                    if not torch.equal(h, rn.rmsnorm(x, nw, eps)):
                        fail(f"restore_norm T={T} d={d} d_r={d_r} {dtype}: h "
                             f"differs from rmsnorm of its x")
                    xe, he = _restore_err(x, codes, scales, wr), _norm_err(h, x, nw, eps)
                    if xe is None or he is None:
                        fail(f"restore_norm T={T} d={d} d_r={d_r} {dtype}: "
                             f"x err {xe}, h err {he} (None: out of tolerance)")
                    worst["butterfly_dequant_restore_norm"] = max(
                        worst["butterfly_dequant_restore_norm"], xe, he)
                    n += 1
                print(f"norm kernels: restore_norm d={d} d_r={d_r:4d} "
                      f"{str(dtype)[6:]:8s} rows {NORM_ROWS}: x == dequant_restore, "
                      f"h == rmsnorm(x), bitwise; max |err| vs plain so far "
                      f"{worst['butterfly_dequant_restore_norm']:.3g}")
            for T in NORM_ROWS:
                g = torch.Generator(device="cuda").manual_seed(T + d)
                xr = torch.randn((T, d), generator=g, device="cuda").to(dtype)
                nw = (0.1 * torch.randn((d,), generator=g, device="cuda")).to(dtype)
                err = _norm_err(rn.rmsnorm(xr, nw, eps), xr, nw, eps)
                if err is None:
                    fail(f"rmsnorm T={T} d={d} {dtype}: out of tolerance")
                worst["rmsnorm"] = max(worst["rmsnorm"], err)
                n += 1
            print(f"norm kernels: rmsnorm d={d} {str(dtype)[6:]:8s} rows "
                  f"{NORM_ROWS}: max |err| vs plain so far {worst['rmsnorm']:.3g}")
    torch.cuda.synchronize()
    print(f"norm kernels: {n} checks against the plain versions passed; "
          f"restore_norm runs {bk.restore_norm_wave(D_R)} clusters of 8 blocks "
          f"in one wave at d_r={D_R} (one 16-row tile a cluster up to "
          f"{16 * bk.restore_norm_wave(D_R)} rows)")
    return worst


def phase_norm_times(rates):
    """Kernel and plain version of both norm kernels at d=4096, d_r=64,
    bf16, and for rmsnorm one torch.nn.functional.rms_norm call (a
    yardstick the port never calls; ``1 + w`` made beforehand in bf16),
    against the
    bound: the larger of the bytes (inputs read once, outputs written once)
    over the memory rate and the operations (2*T*d*d_r multiply-adds at the
    bf16 tensor-core rate, 4 f32 operations an element of the norm at the
    f32 rate) over the card's rates."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import butterfly_kernel as bk, ref, rmsnorm as rn
    bw, bf16_ops = rates
    eps = 1e-6
    out = {}

    def bound(nbytes, seconds_of_ops):
        tb, to = nbytes / bw * 1e3, seconds_of_ops * 1e3
        return (tb, "bytes") if tb >= to else (to, "operations")

    for T in NORM_ROWS:
        codes, scales, wr, nw = _restore_inputs(T, D, D_R, torch.bfloat16, seed=T)
        x = ref.butterfly_dequant_restore_ref(codes, scales, wr, torch.bfloat16)
        w1 = 1.0 + nw           # in bf16, so rms_norm takes its fused path
        rows = {
            "butterfly_dequant_restore_norm": (
                lambda: bk.dequant_restore_norm(codes, scales, wr, nw, eps,
                                                torch.bfloat16),
                lambda: ref.butterfly_restore_norm_ref(codes, scales, wr, nw,
                                                       eps, torch.bfloat16),
                None,
                bound(T * D_R + T * 4 + D_R * D * 2 + D * 2 + 2 * T * D * 2,
                      2 * T * D * D_R / bf16_ops + 4 * T * D / H100_F32)),
            "rmsnorm": (
                lambda: rn.rmsnorm(x, nw, eps),
                lambda: ref.rms_norm_ref(x, nw, eps),
                lambda: F.rms_norm(x, (D,), w1, eps),
                bound(2 * T * D * 2 + D * 2, 4 * T * D / H100_F32)),
        }
        for name, (kern, plain, library, (bound_ms, bound_by)) in rows.items():
            ms, plain_ms = _device_ms(kern), _device_ms(plain)
            library_ms = _device_ms(library) if library else None
            out[(name, T)] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                                  bound_ms=bound_ms, bound_by=bound_by)
            lib = f"  library {library_ms:.4f} ms" if library else ""
            print(f"times: {name:30s} T={T:5d} kernel {ms:.4f} ms  plain "
                  f"{plain_ms:.4f} ms{lib}  bound {bound_ms:.6f} ms ({bound_by})")
    return out


def _launch_mean(times, weights):
    """A kernel's times and bound per launch, averaged over a path's
    launches (``weights``: shape -> launches, ``times``: shape -> times);
    bound by what bounds the larger share of the summed bound."""
    n = sum(weights.values())
    out = {}
    for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
        vals = [times[shape][key] for shape in weights]
        out[key] = None if None in vals else \
            sum(w * v for w, v in zip(weights.values(), vals)) / n
    share: dict = {}
    for shape, w in weights.items():
        t = times[shape]
        share[t["bound_by"]] = share.get(t["bound_by"], 0.0) + w * t["bound_ms"]
    out["bound_by"] = max(share, key=share.get)
    return out


def phase_pipeline(runner):
    """The two-pod decode pipeline on the qwen3-8b bank of phase 5, both
    pods on this card with their own streams: 8 byte-tokenized 128-token
    prompts as 2 microbatches of 4, 16 greedy tokens each.  Runs int8
    pipelined and serial with the kernels, int8 pipelined without them, and
    int4 pipelined and serial with them (a second bank on the same weights).
    Each kernel run must launch reduce_quant and restore_norm exactly
    Mmb + Mmb*(T-1) = 32 times (one per prefill microbatch, one per decode
    tick), dequant_restore and flash never; the plain run none of them.
    Pipelined ids must equal serial ids, bit for bit, and column 0 of the
    int8 kernel run the greedy tokens of the bank's edge_half -> cloud_half
    on the same microbatches.  Returns the path's launches."""
    import numpy as np
    import torch
    from repro_torch.runtime.split_exec import SplitModelBank
    from repro_torch.serving.pipeline import wire_stats
    bank, split = runner.bank, runner.split
    Mmb, mb, S, T = PIPE["Mmb"], PIPE["mb"], PIPE["S"], PIPE["T"]
    prompts = _prompts(Mmb * mb, (S,) * (Mmb * mb))
    if {len(p) for p in prompts} != {S}:
        fail(f"the pipeline's prompts are not {S} tokens long")
    toks = torch.tensor(np.stack(prompts), dtype=torch.int64, device="cuda")
    bank4 = SplitModelBank(bank.base_cfg, bank.d_r, wire_mode="int4",
                           device="cuda", params=bank.params,
                           butterfly={split: bank.butterfly_params(split)})
    runners = {"int8": runner, "int4": bank4.runner(split)}
    settings = [("int8", True, True), ("int8", False, True),
                ("int8", True, False), ("int4", True, True),
                ("int4", False, True)]
    per_run = Mmb + Mmb * (T - 1)

    def run_fn(wire, pipelined, use_kernel, new_tokens):
        return runners[wire].decode_pipeline(None, Mmb, S, mb, new_tokens,
                                             pipelined=pipelined,
                                             use_kernel=use_kernel)

    t0 = time.perf_counter()
    for wire, pipelined, use_kernel in settings:      # the same shapes, 2 tokens
        run_fn(wire, pipelined, use_kernel, 2)(toks)
    torch.cuda.synchronize()
    print(f"pipeline: qwen3-8b, split {split}, d_r {bank.d_r}, Mmb {Mmb} x mb "
          f"{mb}, S {S}, T {T}, both pods on {torch.cuda.get_device_name(0)} "
          f"(two streams); warm-up {time.perf_counter() - t0:.1f} s")
    for wire, bits in (("int8", 8), ("int4", 4)):
        tick = wire_stats(runner.cfg, mb, 1, bits)
        pre = wire_stats(runner.cfg, mb, S, bits)
        print(f"pipeline: {wire} wire {tick['wire_bytes']} B a decode tick "
              f"({tick['compression']:.1f}x fewer than {tick['raw_boundary_bytes']} "
              f"B raw bf16), {pre['wire_bytes']} B a prefill microbatch")

    launches = {k: 0 for k in _counts()}
    ids = {}
    for wire, pipelined, use_kernel in settings:
        run = run_fn(wire, pipelined, use_kernel, T)
        timings: dict = {}
        _zero_counts()
        out = run(toks, timings)
        torch.cuda.synchronize()
        got = _counts()
        n = per_run if use_kernel else 0
        want = dict.fromkeys(got, 0)
        want["butterfly_reduce_quant"] = want["butterfly_dequant_restore_norm"] = n
        if got != want:
            fail(f"pipeline {wire} pipelined={pipelined} use_kernel="
                 f"{use_kernel}: launches {got}, expected {want}")
        for k, v in got.items():
            launches[k] += v
        if out.shape != (Mmb * mb, T) or out.dtype != torch.int32 or \
                int(out.min()) < 0 or int(out.max()) >= runner.cfg.vocab_size:
            fail(f"pipeline ids of shape {tuple(out.shape)} {out.dtype} are "
                 f"not (Mmb*mb, T) int32 tokens of the vocabulary")
        ids[wire, pipelined, use_kernel] = out
        print(f"pipeline: {wire} {'pipelined' if pipelined else 'serial   '} "
              f"use_kernel={str(use_kernel):5s} prefill "
              f"{timings['prefill_ms'] / Mmb:.3f} ms a microbatch, decode "
              f"{timings['decode_ms'] / timings['ticks']:.3f} ms a tick "
              f"({timings['ticks']} ticks); launches {got}")
    for wire in ("int8", "int4"):
        if not torch.equal(ids[wire, True, True], ids[wire, False, True]):
            fail(f"pipeline {wire}: pipelined ids differ from serial ids")
    kernel8 = ids["int8", True, True]
    for k in range(Mmb):
        mb_toks = toks[k * mb:(k + 1) * mb]
        payload, scales, _ = runner.edge_half(runner.params, mb_toks)
        logits, _ = runner.cloud_half(runner.params, payload, scales)
        if not torch.equal(logits.argmax(-1).int(), kernel8[k * mb:(k + 1) * mb, 0]):
            fail(f"pipeline microbatch {k}: column 0 {kernel8[k * mb:(k + 1) * mb, 0].tolist()} "
                 f"is not cloud_half's greedy tokens {logits.argmax(-1).tolist()}")
    agree = lambda a, b: float((ids[a] == ids[b]).float().mean())
    print(f"pipeline: pipelined == serial, bitwise, for int8 and int4 with the "
          f"kernels; column 0 == cloud_half's greedy tokens")
    print(f"pipeline: token agreement int8 kernel vs plain "
          f"{agree(('int8', True, True), ('int8', True, False)):.3f}, int4 vs "
          f"int8 {agree(('int4', True, True), ('int8', True, True)):.3f}")
    print(f"pipeline: int8 kernel tokens {kernel8.tolist()}")
    print(f"pipeline: launches on the path {launches}")
    return launches


def phase_rmsnorm_entry():
    """The RMSNorm kernel's one caller is the ``ops.rmsnorm`` entry point:
    drive it at the pipeline's boundary shapes (a 4-row tick, a 512-row
    prefill microbatch; d=4096, bf16) and read its launches."""
    import torch
    from repro_torch.kernels import ops
    g = torch.Generator(device="cuda").manual_seed(7)
    inputs = [(torch.randn((T, D), generator=g, device="cuda").to(torch.bfloat16),
               (0.1 * torch.randn((D,), generator=g, device="cuda")).to(torch.bfloat16))
              for T in RMSNORM_ROWS]
    _zero_counts()
    outs = [ops.rmsnorm(x, w, eps=1e-6) for x, w in inputs]
    torch.cuda.synchronize()
    launches = _counts()
    if launches["rmsnorm"] != len(inputs) or sum(launches.values()) != len(inputs):
        fail(f"ops.rmsnorm launched {launches}, expected {len(inputs)} rmsnorm")
    for o, (x, _) in zip(outs, inputs):
        if o.shape != x.shape or not bool(torch.isfinite(o).all()):
            fail("ops.rmsnorm output is not finite or of the wrong shape")
    print(f"rmsnorm entry point: launches {launches}")
    return launches


# ------------------------------------------------------------------------- 8
# the bincount kernel: channel widths of reduce_quant (d_r 16, 60 at gemma3's
# d, 64, 1024), both sides of its bf16 16-row/64-row tile switch, both code
# widths, f32 and bf16; timed at d=4096, d_r=64, bf16
BINCOUNT_D_R = {16: 4096, 60: 3840, 64: 4096, 1024: 4096}
BINCOUNT_ROWS = (1, 4, 32, 33, 100, 1024, 1025, 4096)
BINCOUNT_TIME_ROWS = (1, 128, 1024, 4096)
# phase 8's cells: 8 requests of 128 tokens from 4 devices on 3g
RUNTIME = dict(S=128, requests=8, devices=4, handoff_tokens=16,
               streamed_requests=4, streamed_tokens=8)
# the bincount entry point's calls: one per phase-8 prompt, then all eight
BINCOUNT_ENTRY_ROWS = {RUNTIME["S"]: RUNTIME["requests"],
                       RUNTIME["S"] * RUNTIME["requests"]: 1}


def phase_bincount_kernels():
    """butterfly_reduce_quant_bincount against butterfly_reduce_quant and
    its plain version: codes and scales bit for bit reduce_quant's; counts
    exactly the plain histogram of those codes (ref.symbol_counts), summing
    to T*d_r; against the whole plain version (whose codes may differ by 1
    on 0.1% of entries, f32 sums in another order) within 2 counts per
    differing code.  Returns the largest count difference from the whole
    plain version."""
    import torch
    from repro_torch.kernels import butterfly_kernel as bk, ref
    n = same = worst = 0
    for bits in (8, 4):
        for dtype in (torch.bfloat16, torch.float32):
            for d_r, d in BINCOUNT_D_R.items():
                for T in BINCOUNT_ROWS:
                    x, w, _ = _inputs(T, d, d_r, dtype, seed=T + d_r + bits)
                    codes, scales, counts = bk.reduce_quant_bincount(x, w, bits)
                    codes_q, scales_q = bk.reduce_quant(x, w, bits)
                    label = f"bincount T={T} d={d} d_r={d_r} {dtype} bits={bits}"
                    if not (torch.equal(codes, codes_q) and torch.equal(scales, scales_q)):
                        fail(f"{label}: codes or scales differ from reduce_quant's")
                    if counts.shape != (d_r, 1 << bits) or counts.dtype != torch.int32:
                        fail(f"{label}: counts {tuple(counts.shape)} {counts.dtype}")
                    if not torch.equal(counts, ref.symbol_counts(codes, bits)):
                        fail(f"{label}: counts differ from the histogram of the codes")
                    if int(counts.sum()) != T * d_r:
                        fail(f"{label}: counts sum to {int(counts.sum())}, not {T * d_r}")
                    codes_p, _, counts_p = ref.butterfly_reduce_quant_bincount_ref(
                        x, w, bits)
                    n_diff = int((codes != codes_p).sum())
                    off = int((counts - counts_p).abs().sum())
                    if off > 2 * n_diff or n_diff > math.ceil(1e-3 * codes.numel()):
                        fail(f"{label}: counts {off} from the plain version's with "
                             f"{n_diff} codes differing")
                    worst = max(worst, off)
                    same += off == 0
                    n += 1
            print(f"bincount: bits {bits} {str(dtype)[6:]:8s} d_r {list(BINCOUNT_D_R)} "
                  f"rows {BINCOUNT_ROWS}: codes/scales == reduce_quant, counts == "
                  f"histogram of the codes")
    torch.cuda.synchronize()
    print(f"bincount: {n} checks passed; counts equal the whole plain version's "
          f"in {same}/{n}, at most {worst} apart")
    return worst


def phase_bincount_times(rates):
    """The bincount kernel, its plain version and, for the atomics' cost,
    reduce_quant at d=4096, d_r=64, bf16; bound: the bytes of x, w, codes,
    scales and counts over the memory rate (the 2*T*d*d_r multiply-adds at
    the bf16 tensor-core rate are below it)."""
    import torch
    from repro_torch.kernels import butterfly_kernel as bk, ref
    bw, bf16_ops = rates
    out = {}
    for T in BINCOUNT_TIME_ROWS:
        x, w, _ = _inputs(T, D, D_R, torch.bfloat16, seed=T)
        ms = _device_ms(lambda: bk.reduce_quant_bincount(x, w, 8))
        plain_ms = _device_ms(lambda: ref.butterfly_reduce_quant_bincount_ref(x, w, 8))
        rq_ms = _device_ms(lambda: bk.reduce_quant(x, w, 8))
        nbytes = T * D * 2 + D * D_R * 2 + T * D_R + T * 4 + D_R * 256 * 4
        tb, to = nbytes / bw * 1e3, 2 * T * D * D_R / bf16_ops * 1e3
        bound_ms, bound_by = (tb, "bytes") if tb >= to else (to, "operations")
        out[T] = dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms,
                      bound_by=bound_by, reduce_quant_ms=rq_ms)
        print(f"times: butterfly_reduce_quant_bincount T={T:5d} kernel {ms:.4f} ms  "
              f"plain {plain_ms:.4f} ms  reduce_quant {rq_ms:.4f} ms (counting "
              f"adds {ms - rq_ms:+.4f} ms)  bound {bound_ms:.6f} ms ({bound_by})")
    return out


def _sim_ids(sim):
    return [[int(t) for t in r.engine_req.generated] for r in sim.requests]


def _run_sim(cfg, arrivals, wire, transport, new_tokens, record=None):
    """One phase-8 simulation on the card; returns (telemetry, ids, host
    wall ms).  Its bank is built from seed 0, as phase 5's was."""
    import torch
    from repro_torch.runtime.simulator import SimConfig, Simulation
    sim = Simulation(SimConfig(
        cfg=cfg, wire_mode=wire, transport=transport, network="3g",
        num_devices=RUNTIME["devices"], num_requests=len(arrivals),
        prompt_len=RUNTIME["S"], max_new_tokens=new_tokens, d_r=D_R,
        initial_split=cfg.num_layers // 8, seed=0, arrivals=arrivals,
        device="cuda"))
    if record is not None:
        sim.record_trace(str(record))
    torch.cuda.synchronize()
    t = time.perf_counter()
    tel = sim.run()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3
    ids = _sim_ids(sim)
    del sim
    gc.collect()
    torch.cuda.empty_cache()
    return tel, ids, wall_ms


def phase_runtime(runner):
    """Phase 8: the port's runtime simulator with numerics on the card, at
    full width (qwen3-8b as phase 5: 36 layers, bf16, seed 0, split 4, d_r
    64), 4 devices on 3g, the entropy wire: cache handoff (8 requests of 128
    tokens, 16 new tokens each), streamed and progressive (one request per
    device, 8 new tokens), and the int8 wire's cache handoff on the same
    arrivals; the streamed run is recorded and replayed.  Checks: ids equal
    between the entropy and int8 wires and equal to what phase 5's bank
    serves for the same prompts (alone, through the same halves and an
    engine of the simulator's shape); each entropy request's coded_bytes is
    min(len(encode(codes, default prior)) + 4*S, S*d_r + 4*S) of phase 5's
    edge codes; the replay's telemetry JSON is byte-identical.  Returns the
    path's launches and the prompts."""
    import tempfile
    import torch
    from repro_torch.core import wire_codec
    from repro_torch.runtime.simulator import poisson_arrivals, trace_arrivals
    cfg, split = runner.bank.base_cfg, runner.split
    S, T, Ts = RUNTIME["S"], RUNTIME["handoff_tokens"], RUNTIME["streamed_tokens"]
    arrivals = poisson_arrivals(num_devices=RUNTIME["devices"],
                                num_requests=RUNTIME["requests"], arrival_rate=20.0,
                                prompt_len=S, vocab_size=cfg.vocab_size, seed=0)
    firsts = {}                      # each device's first request
    for i, a in enumerate(arrivals):
        firsts.setdefault(a.device, i)
    streamed_idx = list(firsts.values())[:RUNTIME["streamed_requests"]]
    streamed = [arrivals[i] for i in streamed_idx]
    prompts = [a.tokens for a in arrivals]

    # what phase 5's bank serves for these prompts, one at a time
    params = runner.params
    want_handoff, want_streamed, want_coded, raw_coded = [], [], [], []
    prior = wire_codec.WirePrior.default(D_R, 8)
    eng = runner.make_engine(max_batch=8, max_len=S + T + 2, seed=0)
    for p in prompts:
        payload, scales, c0 = runner.edge_half(params, p[None])
        codes = payload[0].cpu().numpy()
        raw_coded.append(len(wire_codec.encode(codes, prior)) + 4 * S)
        want_coded.append(min(raw_coded[-1], S * D_R + 4 * S))
        logits, c1 = runner.cloud_half(params, payload, scales)
        req = eng.submit_prefilled(S, [c0, c1], logits[0], max_new_tokens=T)
        eng.run()
        want_handoff.append(req.generated)
    eng = runner.make_engine(max_batch=8, max_len=S + Ts + 2, seed=0)
    for a in streamed:
        req, _ = _serve_streamed(runner, eng, a.tokens, Ts, S + Ts + 2)
        want_streamed.append(req.generated)
    torch.cuda.synchronize()

    _zero_counts()
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        trace = Path(tmp) / "streamed.jsonl"
        for key, arr, wire, transport, n_new, record in (
                ("entropy cache_handoff", arrivals, "entropy", "cache_handoff", T, None),
                ("int8 cache_handoff", arrivals, "int8", "cache_handoff", T, None),
                ("entropy streamed", streamed, "entropy", "streamed", Ts, trace),
                ("entropy progressive", streamed, "entropy", "progressive", Ts, None),
                ("entropy streamed, replayed", None, "entropy", "streamed", Ts, None)):
            if arr is None:
                arr = trace_arrivals(str(trace))
            runs[key] = _run_sim(cfg, arr, wire, transport, n_new, record)
    launches = _counts()

    for key, (tel, ids, wall_ms) in runs.items():
        s = tel.summary()
        c = tel.counters
        print(f"runtime: {key:28s} host wall {wall_ms:9.1f} ms; engine decode steps "
              f"{c['engine_decode_steps']:.0f}, bank cache entries "
              f"{c['bank_jit_cache_entries']:.0f} (hits {c['bank_jit_cache_hits']:.0f}, "
              f"misses {c['bank_jit_cache_misses']:.0f}); simulated (virtual clock, "
              f"Jetson TX2 edge / GTX 1080Ti cloud cost model): latency p50 "
              f"{s['latency_p50_ms']:.1f} ms, ttft p50 {s['ttft_p50_ms']:.1f} ms, "
              f"mean mobile energy {s['mean_mobile_energy_mj']:.1f} mJ, mean wire "
              f"{s['mean_wire_kb']:.2f} kB")
        if s["n_done"] != len(ids) or any(
                len(g) != (T if "handoff" in key else Ts) for g in ids):
            fail(f"runtime {key}: not every request finished with its tokens")
    if runs["entropy cache_handoff"][1] != runs["int8 cache_handoff"][1]:
        fail("runtime: the entropy wire's ids differ from the int8 wire's")
    if runs["entropy cache_handoff"][1] != want_handoff:
        fail(f"runtime: cache-handoff ids {runs['entropy cache_handoff'][1]} differ "
             f"from phase 5's bank's {want_handoff}")
    for key in ("entropy streamed", "entropy progressive"):
        if runs[key][1] != want_streamed:
            fail(f"runtime: {key} ids {runs[key][1]} differ from phase 5's bank's "
                 f"streamed ids {want_streamed}")
    coded_streamed = [want_coded[i] for i in streamed_idx]
    for key, want in (("entropy cache_handoff", want_coded),
                      ("entropy streamed", coded_streamed),
                      ("entropy progressive", coded_streamed)):
        got = [t.coded_bytes for t in sorted(runs[key][0].traces, key=lambda t: t.uid)]
        if got != want:
            fail(f"runtime {key}: coded_bytes {got}, the encoder gives {want}")
    if runs["entropy streamed"][0].to_json() != \
            runs["entropy streamed, replayed"][0].to_json():
        fail("runtime: the replayed run's telemetry differs from the recorded run's")
    if min(launches["butterfly_reduce_quant"], launches["butterfly_dequant_restore"]) <= 0:
        fail(f"runtime: a butterfly kernel was not launched: {launches}")
    print(f"runtime: ids entropy == int8 == phase 5's bank (cache handoff), streamed "
          f"and progressive == phase 5's streamed serving; coded_bytes == encoder "
          f"(uncapped {raw_coded} B vs raw int8 {S * D_R + 4 * S} B a request); "
          f"replay byte-identical")
    print(f"runtime: launches on the path {launches}")
    print(f"runtime: tokens {runs['entropy cache_handoff'][1]}")
    return launches, prompts


def phase_bincount_entry(runner, prompts):
    """The bincount kernel's entry point, ops.butterfly_reduce_quant_bincount,
    on the full-width split-4 boundary activations of phase 8's prompts
    (each prompt's 128 rows, then all 1,024 rows, d=4096, bf16): a prior
    from its counts (WirePrior.from_counts) and estimate_coded_bytes within
    5% of the real encoder under that prior (the bound of
    tests/test_wire_codec.py)."""
    import numpy as np
    import torch
    from repro_torch.core import wire_codec
    from repro_torch.kernels import ops, ref
    bank, params = runner.bank, runner.params
    toks = torch.tensor(np.stack(prompts), dtype=torch.int64, device="cuda")
    # the edge half's layers, as edge_half runs them, up to the boundary
    x, _ = bank._layers(params, bank._embed(params, toks), 0, runner.split,
                        "prefill", None, None)
    w = params["butterfly"]["w_reduce"]
    batches = [x[i:i + 1] for i in range(len(prompts))] + [x]
    torch.cuda.synchronize()
    _zero_counts()
    outs = [ops.butterfly_reduce_quant_bincount(xb, w, bits=8) for xb in batches]
    torch.cuda.synchronize()
    launches = _counts()
    if launches["butterfly_reduce_quant_bincount"] != len(batches) or \
            sum(launches.values()) != len(batches):
        fail(f"bincount entry point launched {launches}, expected {len(batches)}")
    worst = 0.0
    for xb, (codes, scales, counts) in zip(batches, outs):
        codes_q, scales_q = ops.butterfly_reduce_quant(xb, w, bits=8)
        if not (torch.equal(codes, codes_q) and torch.equal(scales, scales_q)):
            fail("bincount entry point: codes or scales differ from reduce_quant's")
        flat = codes.reshape(-1, D_R)
        if not torch.equal(counts, ref.symbol_counts(flat, 8)):
            fail("bincount entry point: counts differ from the codes' histogram")
        counts_h, codes_h = counts.cpu().numpy(), flat.cpu().numpy()
        prior = wire_codec.WirePrior.from_counts(counts_h, 8)
        est = wire_codec.estimate_coded_bytes(counts_h, prior)
        actual = len(wire_codec.encode(codes_h, prior))
        rel = abs(est - actual) / actual
        worst = max(worst, rel)
        if rel >= 0.05:
            fail(f"bincount entry point: estimate {est} B vs encoder {actual} B "
                 f"({rel:.2%}) at T={flat.shape[0]}")
        if xb is x:
            bits = wire_codec.expected_bits_per_symbol(counts_h, prior)
            print(f"bincount entry point: T={flat.shape[0]} d={D} d_r={D_R} bf16: "
                  f"estimate {est} B, encoder {actual} B ({rel:.3%}), "
                  f"{bits:.3f} bits a symbol under its own prior; raw int8 "
                  f"{codes_h.size} B; default prior "
                  f"{wire_codec.coded_nbytes(codes_h)} B")
    print(f"bincount entry point: {len(batches)} calls, estimate within "
          f"{worst:.3%} of the encoder (limit 5%); launches {launches}")
    return launches


def phase_runtime_cli():
    """The launcher as a user runs it, on the default device (the card):
    the reduced model, the entropy wire, the progressive transport, 8
    requests, --json.  It must exit 0 and write 8 requests' telemetry."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "runtime.json"
        cmd = [sys.executable, "-m", "repro_torch.launch.runtime_sim",
               "--wire-mode", "entropy", "--transport", "progressive",
               "--requests", "8", "--json", str(out)]
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        t = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                              text=True, timeout=600)
        wall = time.perf_counter() - t
        if proc.returncode != 0:
            fail(f"runtime_sim exited {proc.returncode}:\n{proc.stderr[-3000:]}")
        doc = json.loads(out.read_text())
    n = doc["summary"]["n_requests"]
    if n != 8 or doc["summary"]["n_done"] != 8:
        fail(f"runtime_sim served {n} requests, {doc['summary']['n_done']} done")
    head = proc.stdout.splitlines()[0]
    print(f"runtime cli: {' '.join(cmd[1:4])} ... exited 0 in {wall:.1f} s "
          f"(process start and build check included): {head}")


# -------------------------------------------------------------------------- 11
# the paper's Fig. 7 split points, each with its least d_r for <2% accuracy
# loss (PAPER_MIN_DR), and the batch of images the cloud serves at once
RESNET_SPLITS = (3, 7, 13, 16)
RESNET_BATCH = 16
RESNET_CPU_IMAGES = 2


def _resnet_flops(cfg, d_r: int) -> int:
    """Multiply-adds x 2 of one image's convs (every conv at its own input
    and output size; the butterfly's reduce and restore) and head."""
    n = cfg.image_size // 2                        # the 7x7/2 stem's output
    flops = 2 * n * n * 49 * 3 * cfg.stem_channels
    n = -(-n // 2)                                 # the 3x3/2 max pool
    cin = cfg.stem_channels
    for si, (blocks, cout) in enumerate(cfg.stages):
        for bi in range(blocks):
            stride = 2 if (bi == 0 and si > 0) else 1
            mid, m = cout // 4, -(-n // stride)
            flops += 2 * (n * n * cin * mid + m * m * 9 * mid * mid
                          + m * m * mid * cout)
            if cin != cout or stride != 1:
                flops += 2 * m * m * cin * cout
            cin, n = cout, m
    c, sp = cfg.block_channels()[cfg.butterfly.layer - 1], \
        cfg.block_spatial()[cfg.butterfly.layer - 1]
    return flops + 2 * 2 * sp * sp * c * d_r + 2 * cin * cfg.num_classes


def _host_ms(fn, reps: int = 5) -> float:
    """Median host wall of ``fn`` in ms, each run ending in a synchronize."""
    import torch
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def phase_resnet(smi: str):
    """Full ResNet-50 in f32 at 224x224 (no TF32), random weights from seed
    0, a batch of RESNET_BATCH seeded images, split after each of
    RESNET_SPLITS with the paper's least d_r.  At each split: the in-graph
    forward (fake_quant) against edge_cloud_split within rtol = atol = 1e-4
    (the JAX test's tolerance); int8 codes of shape (B, H, W, d_r) and
    exactly B*H*W*d_r + 4*B*H*W bytes on the wire; the card's codes against
    the port's CPU run of the same weights on RESNET_CPU_IMAGES images (at
    most 1 apart on at most 0.1% of entries, scales within rtol 1e-5 and an
    atol of 1e-5 of the largest scale), and the card's cloud half on the
    CPU's wire against the CPU's logits within 1e-4.  The ResNet path, like
    the reference, reaches no kernel: every launch count must stay 0.
    Prints edge-half, cloud-half and in-graph ms, images/s beside the f32
    floor (the convs' operations over 67 TFLOP/s), and the peak memory."""
    import torch
    from repro_torch.configs.resnet50 import PAPER_MIN_DR, resnet50
    from repro_torch.models import resnet as R
    from repro_torch.tree import tree_map

    base = resnet50()
    B, size = RESNET_BATCH, base.image_size
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    backbone = R.init_resnet(gen, base, device="cuda")
    images = torch.randn((B, size, size, 3), generator=gen, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(backbone))
    print(f"resnet: {base.name} {base.num_blocks} blocks, stages "
          f"{base.stages}, {base.dtype} (no TF32), {n_params / 1e6:.3f} M "
          f"params, {B} images of {size}x{size}; init "
          f"{time.perf_counter() - t0:.1f} s; card {smi}")
    cpu_backbone = tree_map(lambda t: t.cpu(), backbone)
    cpu_images = images[:RESNET_CPU_IMAGES].cpu()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    for split in RESNET_SPLITS:
        d_r = PAPER_MIN_DR[split]
        cfg = base.with_butterfly(split, d_r)
        c, sp = cfg.block_channels()[split - 1], cfg.block_spatial()[split - 1]
        params = dict(backbone, butterfly=R.init_butterfly_conv(
            gen, c, d_r, "cuda"))
        logits, wire = R.edge_cloud_split(params, images, cfg)
        ingraph = R.forward_resnet(params, images, cfg)
        codes, scales = wire["codes"], wire["scales"]
        if codes.dtype != torch.int8 or tuple(codes.shape) != (B, sp, sp, d_r) \
                or tuple(scales.shape) != (B, sp, sp, 1):
            fail(f"RB{split}: wire codes {codes.dtype} {tuple(codes.shape)}, "
                 f"scales {tuple(scales.shape)}; expected int8 "
                 f"{(B, sp, sp, d_r)} and {(B, sp, sp, 1)}")
        nbytes = codes.numel() * codes.element_size() + \
            scales.numel() * scales.element_size()
        if nbytes != B * sp * sp * d_r + 4 * B * sp * sp:
            fail(f"RB{split}: {nbytes} B on the wire")
        if not (torch.isfinite(logits).all() and logits.shape == (B, cfg.num_classes)):
            fail(f"RB{split}: logits are not finite or of the wrong shape")
        gap = float((ingraph - logits).abs().max())
        if not torch.allclose(ingraph, logits, rtol=1e-4, atol=1e-4):
            fail(f"RB{split}: the in-graph forward differs from "
                 f"edge_cloud_split by {gap}")
        # the port's CPU run of the same weights on the first images
        cpu_params = dict(cpu_backbone, butterfly=tree_map(
            lambda t: t.cpu(), params["butterfly"]))
        cpu_wire = R.edge_half(cpu_params, cpu_images, cfg)
        cpu_logits = R.cloud_half(cpu_params, cpu_wire, cfg, torch.float32)
        diff = (codes[:RESNET_CPU_IMAGES].cpu().int() - cpu_wire["codes"].int()).abs()
        n_diff, allowed = int((diff > 0).sum()), math.ceil(1e-3 * diff.numel())
        if int(diff.max()) > 1 or n_diff > allowed:
            fail(f"RB{split}: {n_diff} codes differ from the CPU's (max "
                 f"{int(diff.max())}); allowed {allowed} by at most 1")
        cpu_scales = cpu_wire["scales"]
        torch.testing.assert_close(
            scales[:RESNET_CPU_IMAGES].cpu(), cpu_scales, rtol=1e-5,
            atol=1e-5 * float(cpu_scales.abs().max()))
        card_logits = R.cloud_half(params, {k: v.cuda() for k, v in cpu_wire.items()},
                                   cfg, torch.float32).cpu()
        cpu_gap = float((card_logits - cpu_logits).abs().max())
        if not torch.allclose(card_logits, cpu_logits, rtol=1e-4, atol=1e-4):
            fail(f"RB{split}: the card's cloud half differs from the CPU's by "
                 f"{cpu_gap}")
        # times: the edge half to its wire on the host, the cloud half from
        # the wire on the card, and the in-graph forward
        edge_ms = _host_ms(lambda: {k: v.cpu() for k, v in
                                    R.edge_half(params, images, cfg).items()})
        host_wire = {k: v.cpu() for k, v in wire.items()}
        cloud_ms = _host_ms(lambda: R.cloud_half(
            params, {k: v.cuda() for k, v in host_wire.items()}, cfg,
            torch.float32))
        ingraph_ms = _host_ms(lambda: R.forward_resnet(params, images, cfg))
        flops = _resnet_flops(cfg, d_r)
        floor_ms = B * flops / H100_F32 * 1e3
        print(f"resnet: RB{split:2d} d_r {d_r:2d}: wire {nbytes // B} B an image "
              f"(codes {tuple(codes.shape)} int8 + f32 scales; raw f32 "
              f"{sp * sp * c * 4} B); in-graph vs split max|d logits| "
              f"{gap:.3g}; card vs CPU codes differ {n_diff}/{diff.numel()}, "
              f"cloud logits {cpu_gap:.3g}")
        print(f"resnet: RB{split:2d} d_r {d_r:2d}: edge half {edge_ms:.3f} ms, "
              f"cloud half {cloud_ms:.3f} ms, {B / (edge_ms + cloud_ms) * 1e3:.1f} "
              f"images/s split; in-graph {ingraph_ms:.3f} ms "
              f"({B / ingraph_ms * 1e3:.1f} images/s); f32 floor "
              f"{floor_ms:.3f} ms ({flops / 1e9:.3f} GFLOP an image at 67 "
              f"TFLOP/s, {B / floor_ms * 1e3:.1f} images/s)")
    launches = _counts()
    if any(launches.values()):
        fail(f"the ResNet path launched a kernel: {launches}")
    print(f"resnet: launches on the path {launches} (none: the wire "
          f"quantizes in plain PyTorch, as the reference does)")
    print(f"resnet: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return launches


# -------------------------------------------------------------------- 12, 13
# training, as the JAX package trains: plain autograd through the
# straight-through wire (its Pallas kernels have no backward), AdamW in place.
# Parity: a reduced model takes the same steps from one init on the card and
# on the CPU; losses and grad norms agree within TRAIN_RTOL at every step.
# f32 without TF32 on both, but sums run in another order: the gap starts
# near 1e-7 and grows as wire codes flip (the qwen3 run's worst was 1.9e-4
# after 8 steps on an H100; the CPU port against JAX, 1.2e-5 to 1.5e-4
# after 10 by thread count). A bf16 forward, or a wrong gradient, moves a
# loss by 1e-2 or more.
TRAIN_RTOL = 1e-3
# full width: qwen3-8b cut to 8 of its 36 layers, since all 36 need 8.19 B x
# 12 B = 98 GB of bf16 params and grads and f32 moments, more than the card
# holds; the butterfly after layer 4 at d_r 64 (phase 5's wire); 8 steps on
# one fixed batch of 4 x 512 tokens at a constant learning rate
LM_TRAIN = dict(layers=8, split=4, d_r=64, batch=4, seq=512, steps=8, lr=3e-4)
# ResNet-50 uncut at 224x224, 100 classes, f32 without TF32, the butterfly
# after RB3 at d_r 1 (the paper's least), 8 steps on one fixed batch of 16
# images at the example's weight decay.  At the example's lr of 1e-3 the
# loss rose above its first value for steps 2-5 (5.04 -> 6.71 on an H100);
# at 3e-4 it stayed under it (5.04 -> 2.77)
RESNET_TRAIN = dict(split=3, d_r=1, batch=16, steps=8, lr=3e-4,
                    weight_decay=1e-4)


def _lm_step(built, ocfg):
    """The training entry point's step, as (params, opt, loss, grad norm)."""
    from repro_torch.training import make_train_step
    step = make_train_step(built, ocfg)

    def run(params, opt, batch):
        params, opt, m = step(params, opt, batch)
        return params, opt, m["loss"], m["grad_norm"]
    return run


def _run_steps(step, params, opt, batches):
    """One ``step`` a batch; returns (losses, grad norms, host wall ms of
    each step, which ends in a synchronize on the card)."""
    import torch
    losses, gnorms, walls = [], [], []
    cuda = _leaves(params)[0].is_cuda
    for batch in batches:
        t = time.perf_counter()
        params, opt, loss, gnorm = step(params, opt, batch)
        if cuda:
            torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
        losses.append(float(loss))
        gnorms.append(float(gnorm))
    return losses, gnorms, walls


def _step_parts(vg, args, ocfg, params, opt):
    """Host wall ms of one more step, in its two parts: the forward and
    backward (``vg(params, *args)``) and the AdamW update."""
    import torch
    from repro_torch.training import adamw_update
    torch.cuda.synchronize()
    t = time.perf_counter()
    _, grads = vg(params, *args)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    adamw_update(ocfg, params, grads, opt)
    torch.cuda.synchronize()
    return (t1 - t) * 1e3, (time.perf_counter() - t1) * 1e3


def _train_parity(label: str, step, params_cpu, batches_cpu):
    """The same steps from ``params_cpu`` on the card and on the CPU."""
    from repro_torch.training import adamw_init
    from repro_torch.tree import tree_map
    to_card = lambda tree: tree_map(lambda t: t.cuda(), tree)
    card = to_card(params_cpu)          # before the CPU steps update in place
    lc, gc, _ = _run_steps(step, card, adamw_init(card),
                           [to_card(b) for b in batches_cpu])
    lh, gh, _ = _run_steps(step, params_cpu, adamw_init(params_cpu), batches_cpu)
    worst = max(abs(a - b) / abs(b) for a, b in zip(lc + gc, lh + gh))
    print(f"{label}: parity, {len(lc)} steps card vs CPU: losses "
          f"{[round(x, 6) for x in lc]} vs {[round(x, 6) for x in lh]}; grad "
          f"norms {[round(x, 5) for x in gc]} vs {[round(x, 5) for x in gh]}; "
          f"worst relative gap {worst:.3g} (limit {TRAIN_RTOL:g})")
    if not worst <= TRAIN_RTOL:
        fail(f"{label}: the card's training differs from the CPU's by {worst:.3g}")


def _check_training(label: str, losses, gnorms, params, opt, dtype, grad_leaves):
    """Finite and falling losses, finite grad norms, params still in
    ``dtype``, non-zero first moments (so non-zero grads) at ``grad_leaves``
    (paths into the params tree), and no kernel launched."""
    import torch
    if not all(math.isfinite(x) for x in losses + gnorms):
        fail(f"{label}: a loss or grad norm is not finite: {losses} {gnorms}")
    if not losses[-1] < losses[0]:
        fail(f"{label}: the loss did not fall: {losses}")
    dtypes = {str(t.dtype) for t in _leaves(params)}
    if dtypes != {str(dtype)}:
        fail(f"{label}: params are {dtypes}, not {dtype}")
    for path in grad_leaves:
        mu = opt["mu"]
        for k in path:
            mu = mu[k]
        if not bool(torch.any(mu != 0)):
            fail(f"{label}: no gradient reached {'/'.join(map(str, path))}")
    launches = _counts()
    if any(launches.values()):
        fail(f"{label}: training launched a kernel: {launches}")
    return launches


def phase_train_qwen(smi: str, profile: bool = False,
                     profile_dir: Optional[Path] = None):
    """Phase 12.  Parity: the reduced f32 qwen3 (vocab 64) with a d_r=16
    butterfly after layer 1 and the rate term (rate_weight 0.01) takes 8
    steps on lm_batches from one init, card against CPU.  Full width:
    qwen3-8b's published widths at LM_TRAIN's depth, bf16, random weights
    from seed 0, 8 AdamW steps on one batch; see _check_training.  Prints
    each step's loss, grad norm and wall, the median wall after the first
    step, tokens/s, the share of the 6*N*tokens floor at 989 TFLOP/s (N
    without the embedding lookup) and the peak memory."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import lm_batches
    from repro_torch.models import model as M
    from repro_torch.training import (AdamWConfig, constant_schedule,
                                      cosine_schedule, init_train_state,
                                      make_loss_fn)
    from repro_torch.training.train_loop import value_and_grad

    small = dataclasses.replace(get_config("qwen3-8b").reduced(), vocab_size=64)
    small = M.build(small.with_butterfly(1, 16, rate_weight=0.01))
    stream = lm_batches(64, 64, 4, seed=1)
    batches = [{k: torch.from_numpy(v) for k, v in next(stream).items()}
               for _ in range(8)]
    params, _ = init_train_state(torch.Generator().manual_seed(0), small,
                                 device="cpu")
    _train_parity("qwen3-8b training",
                  _lm_step(small, AdamWConfig(lr=cosine_schedule(1e-3, 3, 8))),
                  params, batches)

    c = LM_TRAIN
    cfg = dataclasses.replace(get_config("qwen3-8b"), num_layers=c["layers"])
    built = M.build(cfg.with_butterfly(c["split"], c["d_r"]))
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    params, opt = init_train_state(torch.Generator(device="cuda").manual_seed(0),
                                   built, device="cuda")
    raw = next(lm_batches(cfg.vocab_size, c["seq"], c["batch"], seed=0))
    batch = {k: torch.from_numpy(v).cuda() for k, v in raw.items()}
    torch.cuda.synchronize()
    n_all = sum(p.numel() for p in _leaves(params))
    n = n_all - params["embed"].numel()
    print(f"qwen3-8b training: {c['layers']} of 36 layers at full width "
          f"(d_model {cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads, hd "
          f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"{cfg.dtype}), butterfly after layer {c['split']} at d_r {c['d_r']}; "
          f"{n_all / 1e9:.3f} B params ({n / 1e9:.3f} B without the embedding); "
          f"init {time.perf_counter() - t0:.1f} s; constant lr {c['lr']:g}; "
          f"card {smi}")
    ocfg = AdamWConfig(lr=constant_schedule(c["lr"]))
    step = _lm_step(built, ocfg)
    losses, gnorms, walls = _run_steps(step, params, opt, [batch] * c["steps"])
    launches = _check_training(
        "qwen3-8b training", losses, gnorms, params, opt, torch.bfloat16,
        [("butterfly", "w_reduce"), ("stages", 0, 0, 0, "mixer", "wq")])
    fwd_bwd, update = _step_parts(value_and_grad(make_loss_fn(built)), (batch,),
                                  ocfg, params, opt)
    if profile:
        _profiled("train_qwen3_8b", lambda: step(params, opt, batch), profile_dir)
    tokens = c["batch"] * c["seq"]
    wall = statistics.median(walls[1:])
    floor_ms = 6 * n * tokens / H100_RATES[1] * 1e3
    for i, (l, g, w) in enumerate(zip(losses, gnorms, walls)):
        print(f"qwen3-8b training: step {i} loss {l:.4f} gnorm {g:.4f} "
              f"wall {w:.1f} ms")
    print(f"qwen3-8b training: median step {wall:.1f} ms after the first "
          f"(one more step: forward and backward {fwd_bwd:.1f} ms, AdamW "
          f"update {update:.1f} ms), "
          f"{tokens / wall * 1e3:,.0f} tokens/s; 6*N*tokens floor "
          f"{floor_ms:.1f} ms at 989 TFLOP/s ({floor_ms / wall:.1%} of it); "
          f"launches {launches} (none); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; card {smi}")
    return launches


def phase_train_resnet(smi: str, profile: bool = False,
                       profile_dir: Optional[Path] = None):
    """Phase 13.  Parity: the reduced ResNet (2 blocks at 32x32) with a d_r=2
    butterfly after RB1 takes 5 steps of 8 image_batches images from one
    init, card against CPU.  Full size: RESNET_TRAIN, through the example's
    step (train_resnet_butterfly.make_resnet_step); see _check_training.
    Prints each step, the median wall after the first, images/s beside the
    floor of 3 x the forward's operations an image at 67 TFLOP/s, and the
    peak memory."""
    import numpy as np
    import torch
    from repro_torch.configs.resnet50 import resnet50
    from repro_torch.data import ImageTaskConfig, SyntheticImages, image_batches
    from repro_torch.examples.train_resnet_butterfly import (make_resnet_step,
                                                            resnet_loss)
    from repro_torch.models import resnet as R
    from repro_torch.training import AdamWConfig, adamw_init, constant_schedule
    from repro_torch.training.train_loop import value_and_grad

    c = RESNET_TRAIN
    ocfg = AdamWConfig(lr=constant_schedule(c["lr"]),
                       weight_decay=c["weight_decay"])
    small = resnet50().reduced().with_butterfly(1, 2)
    stream = image_batches(8, ImageTaskConfig(num_classes=small.num_classes,
                                              image_size=small.image_size))
    batches = [tuple(torch.from_numpy(a) for a in next(stream)) for _ in range(5)]
    step = make_resnet_step(small, ocfg)
    _train_parity("resnet50 training",
                  lambda p, o, b: step(p, o, *b),
                  R.init_resnet(torch.Generator().manual_seed(0), small,
                                device="cpu"), batches)

    cfg = resnet50().with_butterfly(c["split"], c["d_r"])
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    params = R.init_resnet(torch.Generator(device="cuda").manual_seed(0), cfg,
                           device="cuda")
    task = SyntheticImages(ImageTaskConfig(num_classes=cfg.num_classes,
                                           image_size=cfg.image_size))
    batch = tuple(torch.from_numpy(a).cuda()
                  for a in task.batch(c["batch"], np.random.default_rng(0)))
    print(f"resnet50 training: {cfg.name} uncut, {cfg.image_size}x"
          f"{cfg.image_size}, {cfg.num_classes} classes, {cfg.dtype} (no TF32), "
          f"butterfly after RB{c['split']} at d_r {c['d_r']}; "
          f"{sum(p.numel() for p in _leaves(params)) / 1e6:.3f} M params; "
          f"{c['batch']} SyntheticImages; constant lr {c['lr']:g}, weight decay "
          f"{c['weight_decay']:g}; card {smi}")
    step, opt = make_resnet_step(cfg, ocfg), adamw_init(params)
    losses, gnorms, walls = _run_steps(lambda p, o, b: step(p, o, *b), params,
                                       opt, [batch] * c["steps"])
    launches = _check_training(
        "resnet50 training", losses, gnorms, params, opt, torch.float32,
        [("butterfly", "reduce"), ("stem",)])
    fwd_bwd, update = _step_parts(value_and_grad(resnet_loss), batch + (cfg,),
                                  ocfg, params, opt)
    if profile:
        _profiled("train_resnet50", lambda: step(params, opt, *batch), profile_dir)
    wall = statistics.median(walls[1:])
    floor_ms = c["batch"] * 3 * _resnet_flops(cfg, c["d_r"]) / H100_F32 * 1e3
    for i, (l, g, w) in enumerate(zip(losses, gnorms, walls)):
        print(f"resnet50 training: step {i} loss {l:.4f} gnorm {g:.4f} "
              f"wall {w:.1f} ms")
    print(f"resnet50 training: median step {wall:.1f} ms after the first "
          f"(one more step: forward and backward {fwd_bwd:.1f} ms, AdamW "
          f"update {update:.1f} ms), "
          f"{c['batch'] / wall * 1e3:.1f} images/s; floor {floor_ms:.2f} ms "
          f"(3 x {_resnet_flops(cfg, c['d_r']) / 1e9:.3f} GFLOP an image at 67 "
          f"TFLOP/s, {c['batch'] / floor_ms * 1e3:.1f} images/s; "
          f"{floor_ms / wall:.1%} of it); launches {launches} (none); peak "
          f"device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; "
          f"card {smi}")
    return launches


# -------------------------------------------------------------------- 14, 15
# the MoE family at published widths, cut in depth only (bf16): qwen3-moe-
# 235b-a22b's 94 layers of 4.97 GB (128 experts of 3 x 4096 x 1536) would
# take about 470 GB, so 8 layers (42.3 GB) split after layer 4 at d_r 64;
# llama4-maverick's MoE layer alone is 32.2 GB (128 x 3 x 5120 x 8192), so
# one dense and one MoE layer (its every-2nd pattern once, about 37 GB)
# split after layer 1 at d_r 80
MOE_SERVING = {
    "qwen3-moe-235b-a22b": dict(label="qwen3-moe serving", layers=8, split=4,
                                d_r=64, lengths=(64, 80, 100, 128),
                                new_tokens=8, streamed=96),
    "llama4-maverick-400b-a17b": dict(label="llama4 serving", layers=2,
                                      split=1, d_r=80, lengths=(80, 128),
                                      new_tokens=4, streamed=None),
}
# the decode pipeline on the qwen3-moe bank: phase 7's microbatches of 4 x
# 128 tokens, 4 tokens (6 ticks)
MOE_PIPE = dict(Mmb=2, mb=4, S=128, T=4)
# card vs CPU at f32 without TF32, from one init: f32 sums in another order
MOE_PARITY_RTOL = 1e-4


class _Routes:
    """Records the expert ids (and the dropped choices) of every MoE layer
    run inside the block, by wrapping ``models.moe.route``; the wrapper
    comes off on exit."""

    def __enter__(self):
        from repro_torch.models import moe
        self._moe, self._route = moe, moe.route
        self.eids, self.dropped = [], []

        def route(x_flat, router, mcfg, capacity):
            out = self._route(x_flat, router, mcfg, capacity)
            self.eids.append(out[3])
            self.dropped.append(out[4] >= capacity)
            return out
        moe.route = route
        return self

    def __exit__(self, *exc):
        self._moe.route = self._route


def _moe_parity(arch: str, label: str):
    """The reduced config in f32 (llama4 at 4 layers, MoE every 2nd, as
    published) from one CPU init: forward_train on the card and on the CPU
    routes every (token, layer, choice) to the same expert, and the logits
    and aux losses agree within MOE_PARITY_RTOL."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.tree import tree_map
    cfg = get_config(arch).reduced()
    if cfg.moe.shared_expert_ff:
        cfg = dataclasses.replace(cfg, num_layers=4,
                                  moe=dataclasses.replace(cfg.moe, every=2))
    built = M.build(cfg)
    params = M.init_model(torch.Generator().manual_seed(0), built, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 64)))
    runs = []
    for dev in ("cpu", "cuda"):
        p = params if dev == "cpu" else tree_map(lambda t: t.cuda(), params)
        with _Routes() as r:
            logits, aux = M.forward_train(p, built, {"tokens": toks.to(dev)})
        runs.append((r, logits.cpu(), {k: float(v) for k, v in aux.items()
                                       if k != "wire_rate_bits"}))
    (rc, lc, ac), (rg, lg, ag) = runs
    if len(rc.eids) != len(rg.eids) or not all(
            torch.equal(a, b.cpu()) for a, b in zip(rc.eids, rg.eids)):
        fail(f"{label}: the card routes a choice to another expert than the CPU")
    torch.testing.assert_close(lg, lc, rtol=MOE_PARITY_RTOL, atol=1e-5)
    for k in ac:
        if not math.isclose(ag[k], ac[k], rel_tol=MOE_PARITY_RTOL):
            fail(f"{label}: aux {k} {ag[k]} on the card, {ac[k]} on the CPU")
    n = sum(e.numel() for e in rc.eids)
    print(f"{label}: parity, reduced {cfg.name} ({cfg.num_layers} layers, "
          f"{cfg.moe.num_experts} experts top-{cfg.moe.top_k}, f32, no TF32) card "
          f"vs CPU: {n} (token, layer, choice) routes equal, "
          f"{sum(int(d.sum()) for d in rc.dropped)} dropped on both; logits max "
          f"|d| {float((lg - lc).abs().max()):.3g}; aux {ag} vs {ac}")


def _moe_reference(runner, toks):
    """The single-model forward with the reference wire (unfused, bf16
    rounding before the quantize), at the bank's padded shape (whose pad
    rows compete for expert capacity, as in the bank's halves), read at the
    prompt's last position."""
    bank, params = runner.bank, runner.params
    S = toks.shape[1]
    x, _ = bank._layers(params, bank._embed(params, bank._pad_toks(
        toks, *bank._buckets(1, S))), 0, runner.split, "prefill", None, None)
    x = bank._wire_ingraph(params["butterfly"], x, use_kernel=False)
    x, _ = bank._layers(params, x, runner.split, bank.base_cfg.num_layers,
                        "prefill", None, None)
    return bank._head(params, x[:, S - 1:S])[0, 0]


def phase_moe_serving(arch: str, smi: str):
    """Phases 14 and 15: ``arch`` at published widths cut to MOE_SERVING's
    depth, bf16, seed 0, through the bank's split path as phase 5 (edge_half
    -> host wire -> cloud_half, then the engine decodes together: cache
    handoff), after a reduced card-vs-CPU parity run.  Checks: both wire
    kernels launch, wire bytes exactly S*d_r + 4*S, the cloud half run twice
    on one payload gives the same logits, bit for bit.  Routing is
    discontinuous, so the reference (its wire rounds x @ w_reduce to bf16)
    is held to phase 5's 5% bound only on prompts whose every (token,
    layer, choice) routes as the kernel path's; the share that agrees is
    printed.  With ``streamed`` one more prompt decodes streamed, and the
    same prompt alone in a one-slot engine (cache handoff, the same batch of
    one in every MoE layer) must give the same ids.  Returns the launches
    and the runner."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.runtime.split_exec import SplitModelBank

    c = MOE_SERVING[arch]
    label = c["label"]
    _moe_parity(arch, label)
    base = get_config(arch)
    cfg = dataclasses.replace(base, num_layers=c["layers"])
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    bank = SplitModelBank(cfg, c["d_r"], wire_mode="int8", seed=0, device="cuda")
    runner = bank.runner(c["split"])
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(runner.params))
    init_peak = torch.cuda.max_memory_allocated() / 1e9
    m = cfg.moe
    print(f"{label}: {cfg.name} cut to {cfg.num_layers} of {base.num_layers} "
          f"layers (ffn {[d.ffn for d in bank._defs]}), d_model {cfg.d_model}, "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads, {m.num_experts} experts "
          f"top-{m.top_k} of d_ff {m.d_ff_expert}, shared {m.shared_expert_ff}, "
          f"{cfg.dtype}, {n_params / 1e9:.3f} B params ({n_params * 2 / 1e9:.2f} "
          f"GB), split {c['split']}, d_r {c['d_r']}, int8 wire; init "
          f"{time.perf_counter() - t0:.1f} s, peak {init_peak:.2f} GB; card {smi}")
    max_len = 256
    n = len(c["lengths"])
    prompts = _prompts(n, c["lengths"])
    engine = runner.make_engine(max_batch=n, max_len=max_len, seed=0)
    t0 = time.perf_counter()
    _serve_handoff(runner, engine, prompts, 2)          # warm-up, same shapes
    print(f"{label}: warm-up {time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()

    _zero_counts()
    reqs, cloud_logits, prefill_ms, wire, raw_bytes, decode_ms, decode_steps = \
        _serve_handoff(runner, engine, prompts, c["new_tokens"])
    sreq = None
    if c["streamed"]:
        (stoks,) = _prompts(n + 1, c["lengths"] + (c["streamed"],))[n:]
        sreq, stream_ms = _serve_streamed(runner, engine, stoks, 8, max_len)
    launches = _counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"{label}: launches on the main path {launches}")
    if min(launches["butterfly_reduce_quant"],
           launches["butterfly_dequant_restore"]) <= 0:
        fail(f"a kernel was not launched on the {arch} split path: {launches}")
    if any(not r.done for r in reqs) or \
            [len(r.generated) for r in reqs] != [c["new_tokens"]] * n:
        fail("a request did not finish with its tokens")
    want_wire = [len(t) * (c["d_r"] + 4) for t in prompts]
    if wire != want_wire:
        fail(f"wire bytes {wire} per request, expected S * {c['d_r']} + 4 * S = "
             f"{want_wire}")
    if peak_gb >= 80 or init_peak >= 80:
        fail(f"peak device memory {max(peak_gb, init_peak):.2f} GB does not fit the card")
    for r, lg in zip(reqs, cloud_logits):
        if r.generated[0] != int(torch.argmax(lg)):
            fail("the first token is not the greedy token of the cloud logits")

    # exactness: the cloud half twice on one payload
    params = runner.params
    toks = torch.tensor(prompts[0], device="cuda")[None]
    payload, scales, _ = runner.edge_half(params, toks)
    once, _ = runner.cloud_half(params, payload, scales)
    twice, _ = runner.cloud_half(params, payload, scales)
    if not torch.equal(once, twice):
        fail("the cloud half gave two results on one payload")
    if sreq is not None:
        solo = runner.make_engine(max_batch=1, max_len=max_len, seed=0)
        (h,), *_ = _serve_handoff(runner, solo, [stoks], 8)
        if h.generated != sreq.generated:
            fail(f"streamed ids {sreq.generated} differ from the same prompt's "
                 f"one-slot cache handoff {h.generated}")

    # routing: the kernel path's halves against the reference, per prompt
    agree = total = cloud_agree = cloud_total = held = 0
    moe_at = [i for i, d in enumerate(bank._defs) if d.ffn == "moe"]
    for t, lg in zip(prompts, cloud_logits):
        toks = torch.tensor(t, device="cuda")[None]
        S = toks.shape[1]
        with _Routes() as kr:
            payload, scales, _ = runner.edge_half(params, toks)
            kl, _ = runner.cloud_half(params, payload, scales)
        with _Routes() as rr:
            ref = _moe_reference(runner, toks)
        if not torch.equal(kl[0], lg):
            fail("the cloud half's logits moved between two runs of one prompt")
        same = [bool(torch.equal(a[:S], b[:S])) for a, b in zip(kr.eids, rr.eids)]
        eq = [int((a[:S] == b[:S]).sum()) for a, b in zip(kr.eids, rr.eids)]
        agree += sum(eq)
        total += sum(a[:S].numel() for a in kr.eids)
        for li, e, a in zip(moe_at, eq, kr.eids):
            if li >= c["split"]:
                cloud_agree += e
                cloud_total += a[:S].numel()
        dropped = sum(int(d[:S].sum()) for d in kr.dropped)
        delta = float((lg - ref).abs().max())
        limit = 0.05 * float(ref.abs().max())
        if not (torch.isfinite(lg).all() and lg.shape == ref.shape
                and lg.shape[-1] == cfg.vocab_size):
            fail("cloud logits are not finite or of the wrong shape")
        if all(same):
            held += 1
            if delta > limit:
                fail(f"S={S}: routing agrees, and the cloud logits differ from "
                     f"the reference by {delta} > {limit}")
        print(f"{label}: S={S} routes equal to the reference's in "
              f"{sum(same)}/{len(same)} MoE layers ({sum(eq)}/"
              f"{sum(a[:S].numel() for a in kr.eids)} choices), {dropped} "
              f"choices dropped at capacity; max|logits - reference| "
              f"{delta:.4g} (5% limit {limit:.4g}, "
              f"{'held' if all(same) else 'not held: routing differs'}); greedy "
              f"{'same' if int(lg.argmax()) == int(ref.argmax()) else 'differs'}")
    print(f"{label}: routing agreement with the reference {agree}/{total} = "
          f"{agree / total:.4%} of (token, layer, choice); cloud layers "
          f"{cloud_agree}/{cloud_total} = {cloud_agree / max(cloud_total, 1):.4%}; "
          f"5% logit bound held on {held}/{n} prompts")
    print(f"{label}: wire {wire} B a request (S * {c['d_r']} + 4 * S) for "
          f"{raw_bytes} B of raw bf16 boundary activations "
          f"({raw_bytes / sum(wire):.1f}x)")
    print(f"{label}: prefill (edge + wire + cloud) ms per request "
          f"{[round(v, 3) for v in prefill_ms]}, median "
          f"{statistics.median(prefill_ms):.3f}")
    weight_gb = n_params * 2 / 1e9
    print(f"{label}: handoff decode {decode_ms:.3f} ms per step of {n} slots "
          f"({decode_steps} steps)"
          + (f"; streamed decode {stream_ms:.3f} ms per token" if sreq else "")
          + f"; weight-read floor {weight_gb / 3.35:.2f} ms a step "
          f"({weight_gb:.2f} GB at 3.35 TB/s: every expert GEMM reads all its "
          f"experts, as the reference does); card {smi}")
    print(f"{label}: peak device memory {max(peak_gb, init_peak):.2f} GB (init "
          f"{init_peak:.2f}, serving {peak_gb:.2f})")
    print(f"{label}: tokens {[r.generated for r in reqs]}"
          + (f" streamed {sreq.generated} (== one-slot handoff)" if sreq else ""))
    return launches, runner


def phase_moe_pipeline(runner):
    """Phase 14's decode pipeline on the qwen3-moe bank, both pods on this
    card with their own streams: MOE_PIPE's 2 microbatches of 4 x 128
    tokens, int8 with the kernels, pipelined and serial.  Each run must
    launch reduce_quant and restore_norm exactly Mmb + Mmb*(T-1) times,
    dequant_restore and flash never, and the pipelined ids must equal the
    serial ids, bit for bit.  Column 0's agreement with cloud_half's greedy
    tokens is printed, not held: the pipeline's first cloud layer reads
    restore_norm's RMSNorm, the bank's the plain one, and one bit there can
    move a route.  Returns the path's launches."""
    import numpy as np
    import torch
    Mmb, mb, S, T = (MOE_PIPE[k] for k in ("Mmb", "mb", "S", "T"))
    toks = torch.tensor(np.stack(_prompts(Mmb * mb, (S,) * (Mmb * mb))),
                        dtype=torch.int64, device="cuda")
    per_run = Mmb + Mmb * (T - 1)
    runs = {p: runner.decode_pipeline(None, Mmb, S, mb, T, pipelined=p,
                                      use_kernel=True) for p in (True, False)}
    for run in runs.values():                                 # warm-up
        run(toks)
    torch.cuda.synchronize()
    launches = dict.fromkeys(_counts(), 0)
    ids = {}
    for pipelined, run in runs.items():
        timings: dict = {}
        _zero_counts()
        ids[pipelined] = run(toks, timings)
        torch.cuda.synchronize()
        got = _counts()
        want = dict.fromkeys(got, 0)
        want["butterfly_reduce_quant"] = want["butterfly_dequant_restore_norm"] = per_run
        if got != want:
            fail(f"moe pipeline pipelined={pipelined}: launches {got}, expected {want}")
        for k, v in got.items():
            launches[k] += v
        out = ids[pipelined]
        if out.shape != (Mmb * mb, T) or int(out.min()) < 0 or \
                int(out.max()) >= runner.cfg.vocab_size:
            fail(f"moe pipeline ids {tuple(out.shape)} are not (Mmb*mb, T) tokens")
        print(f"moe pipeline: {'pipelined' if pipelined else 'serial   '} prefill "
              f"{timings['prefill_ms'] / Mmb:.3f} ms a microbatch, decode "
              f"{timings['decode_ms'] / timings['ticks']:.3f} ms a tick "
              f"({timings['ticks']} ticks); launches {got}")
    if not torch.equal(ids[True], ids[False]):
        fail("moe pipeline: pipelined ids differ from serial ids")
    col0 = 0
    for k in range(Mmb):
        payload, scales, _ = runner.edge_half(runner.params, toks[k * mb:(k + 1) * mb])
        logits, _ = runner.cloud_half(runner.params, payload, scales)
        col0 += int((logits.argmax(-1).int() == ids[True][k * mb:(k + 1) * mb, 0]).sum())
    print(f"moe pipeline: pipelined == serial, bitwise; column 0 == cloud_half's "
          f"greedy token on {col0}/{Mmb * mb} rows; tokens {ids[True].tolist()}")
    print(f"moe pipeline: launches on the path {launches}")
    return launches


# --------------------------------------------------------------------- profile
def _profiled(label: str, fn, out_dir: Optional[Path]):
    """Run ``fn`` twice: once bare for its host wall time, once under
    torch.profiler for the device time its kernels and copies take (the
    union of their intervals; the profiler's own host overhead does not
    stretch them).  Prints both, their ratio (the device-busy share), the
    device launches and the kernels that took the most device time; the
    operator table goes to ``out_dir/profile_<label>.txt`` if a directory
    is given."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    busy_us, end = 0.0, float("-inf")
    by_name: dict = {}
    for e in dev:
        s, f = e.time_range.start, e.time_range.end
        busy_us += max(0.0, f - max(s, end))
        end = max(end, f)
        by_name[e.name] = by_name.get(e.name, 0.0) + (f - s)
    print(f"profile: {label}: wall {wall_ms:.3f} ms, device busy "
          f"{busy_us / 1e3:.3f} ms ({busy_us / 1e3 / wall_ms:.1%}), "
          f"{len(dev)} device launches")
    for kname, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"profile: {label}:   {us / 1e3:8.3f} ms  {kname[:90]}")
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / f"profile_{label}.txt").write_text(prof.key_averages().table(
            sort_by="self_device_time_total", row_limit=40))


def phase_profile(runner, out_dir: Optional[Path], tag: str = ""):
    """Where the time goes (``--profile``): one 128-token request's prefill
    (edge + host wire + cloud) and 8 handoff decode steps of 4 slots, after
    a warm-up; ``tag`` prefixes the labels."""
    params = runner.params
    prompts = _prompts(4, (128,) * 4)
    engine = runner.make_engine(max_batch=4, max_len=256, seed=0)

    def prefill(toks):
        payload, scales, c0 = runner.edge_half(params, toks[None])
        logits, c1 = runner.cloud_half(params, payload.cpu().cuda(),
                                       scales.cpu().cuda())
        return [c0, c1], logits[0]

    for toks in prompts:
        engine.submit_prefilled(len(toks), *prefill(toks), max_new_tokens=64)
    engine.step()
    _profiled(f"{tag}prefill", lambda: prefill(prompts[0]), out_dir)
    _profiled(f"{tag}decode", lambda: [engine.step() for _ in range(8)], out_dir)


def phase_profile_pipeline(runner, out_dir: Optional[Path]):
    """Where the pipeline's time goes (``--profile``): one int8 kernel run
    of 2 microbatches of 4 x 128-token prompts and 4 tokens, pipelined and
    serial (2 prefills and 6 decode ticks each)."""
    import numpy as np
    import torch
    Mmb, mb, S = PIPE["Mmb"], PIPE["mb"], PIPE["S"]
    toks = torch.tensor(np.stack(_prompts(Mmb * mb, (S,) * (Mmb * mb))),
                        dtype=torch.int64, device="cuda")
    for pipelined in (True, False):
        run = runner.decode_pipeline(None, Mmb, S, mb, 4, pipelined=pipelined,
                                     use_kernel=True)
        run(toks)
        _profiled(f"pipeline_{'pipelined' if pipelined else 'serial'}",
                  lambda: run(toks), out_dir)


def _free():
    """Hand the last phase's freed device memory back to the card."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser(description="Run the port's main path on "
                                 "one NVIDIA GPU (see the module docstring).")
    ap.add_argument("--profile", nargs="?", const="", metavar="DIR",
                    help="profile prefills and 8 decode steps of the serving "
                         "models and a training step of each trained model; "
                         "write the operator tables to DIR if given")
    args = ap.parse_args()
    name, smi, rates = phase_device()
    import torch
    # the plain versions' f32 products in full f32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    worst = phase_kernels()
    worst["flash_attention"] = phase_flash_checks()
    times = phase_times(rates)
    flash_times = phase_flash_times(rates)
    paths = {}
    paths["qwen3-8b split serving"], runner = phase_serving()
    worst.update(phase_norm_kernels())
    norm_times = phase_norm_times(rates)
    paths["qwen3-8b decode pipeline"] = phase_pipeline(runner)
    paths["ops.rmsnorm entry point"] = phase_rmsnorm_entry()
    worst["butterfly_reduce_quant_bincount"] = phase_bincount_kernels()
    bincount_times = phase_bincount_times(rates)
    paths["qwen3-8b runtime simulator"], prompts = phase_runtime(runner)
    paths["bincount entry point"] = phase_bincount_entry(runner, prompts)
    phase_runtime_cli()
    profile_dir = Path(args.profile) if args.profile else None
    if args.profile is not None:
        phase_profile(runner, profile_dir)
        phase_profile_pipeline(runner, profile_dir)
    del runner                       # the qwen3-8b weights leave the card
    _free()
    paths["gemma3-12b kernel prefill"], _, _ = phase_kernel_prefill(
        "gemma3-12b", args.profile is not None, profile_dir)
    # each model's weights leave the card before the next one is built
    _free()
    print(f"qwen3-14b serving: card {smi}")
    paths["qwen3-14b split serving"], runner = phase_serving(
        "qwen3-14b", new_tokens=8, streamed=False, label="qwen3-14b serving")
    del runner
    _free()
    print(f"kernel prefill: card {smi}")
    paths["gemma-7b kernel prefill"], _, _ = phase_kernel_prefill("gemma-7b")
    _free()
    paths["resnet50 split inference"] = phase_resnet(smi)
    _free()
    paths["qwen3-8b training"] = phase_train_qwen(smi, args.profile is not None,
                                                  profile_dir)
    _free()
    paths["resnet50 training"] = phase_train_resnet(smi, args.profile is not None,
                                                    profile_dir)
    _free()
    paths["qwen3-moe split serving"], runner = phase_moe_serving(
        "qwen3-moe-235b-a22b", smi)
    paths["qwen3-moe decode pipeline"] = phase_moe_pipeline(runner)
    if args.profile is not None:
        phase_profile(runner, profile_dir, "qwen3_moe_")
    del runner
    _free()
    paths["llama4 split serving"], runner = phase_moe_serving(
        "llama4-maverick-400b-a17b", smi)
    del runner
    _free()
    print(f"pixtral kernel prefill: card {smi}")
    paths["pixtral-12b kernel prefill"], _, calls = phase_kernel_prefill(
        "pixtral-12b", args.profile is not None, profile_dir, lengths=(100,),
        butterfly=(4, 80), new_tokens=8, label="pixtral kernel prefill")
    if calls != [(1124, 1124, True)] * 40:
        fail(f"pixtral's kernel prefill made flash calls {sorted(set(calls))}, "
             f"{len(calls)} in all; expected 40 causal at 1124 x 1124")
    _free()
    print(f"whisper kernel prefill: card {smi}")
    paths["whisper-base kernel prefill"], _, calls = phase_kernel_prefill(
        "whisper-base", args.profile is not None, profile_dir, lengths=(32,),
        butterfly=(3, 64), new_tokens=16, label="whisper kernel prefill")
    if sorted(calls) != sorted([(1500, 1500, False)] * 6 + [(32, 32, True)] * 6):
        fail(f"whisper's kernel prefill made flash calls {calls}; expected 6 "
             f"non-causal at 1500 x 1500 (the encoder) and 6 causal at 32 x 32")

    # flash over the 2,048-token gemma3-12b prefill's 48 launches, the norm
    # and bincount kernels over their path's launches; every timed shape
    # under by_shape
    flash = dict(_launch_mean(flash_times, FLASH_JSON), by_shape=flash_times)
    norms = {}
    for kname, weights in (("butterfly_dequant_restore_norm", PIPE_ROWS),
                           ("rmsnorm", RMSNORM_ROWS)):
        by_rows = {T: norm_times[(kname, T)] for T in NORM_ROWS}
        norms[kname] = dict(_launch_mean(by_rows, weights), by_shape={
            f"T={T}": t for T, t in by_rows.items()})
    bincount = dict(_launch_mean(bincount_times, BINCOUNT_ENTRY_ROWS), by_shape={
        f"T={T}": t for T, t in bincount_times.items()})
    # the two butterfly kernels: ms at T=128 (comparable across PRs), every
    # timed shape under by_shape
    wire = {}
    for kname in ("butterfly_reduce_quant", "butterfly_dequant_restore"):
        wire[kname] = dict(times[(kname, JSON_ROWS, D)], by_shape={
            f"T={T}" + ("" if d == D else f" d={d}"): t
            for (k, T, d), t in times.items() if k == kname})
    rows = [("butterfly_reduce_quant", "src/repro_torch/csrc/butterfly.cu",
             "src/repro/kernels/butterfly_kernel.py:38",
             wire["butterfly_reduce_quant"]),
            ("butterfly_dequant_restore", "src/repro_torch/csrc/butterfly.cu",
             "src/repro/kernels/butterfly_kernel.py:188",
             wire["butterfly_dequant_restore"]),
            ("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:75", flash),
            ("butterfly_dequant_restore_norm", "src/repro_torch/csrc/butterfly.cu",
             "src/repro/kernels/butterfly_kernel.py:146",
             norms["butterfly_dequant_restore_norm"]),
            ("rmsnorm", "src/repro_torch/csrc/rmsnorm.cu",
             "src/repro/kernels/rmsnorm.py:25", norms["rmsnorm"]),
            ("butterfly_reduce_quant_bincount", "src/repro_torch/csrc/butterfly.cu",
             "src/repro/kernels/butterfly_kernel.py:93", bincount)]
    kernels = []
    for kname, source, replaces, t in rows:
        by_path = {path: counts[kname] for path, counts in paths.items()}
        kernels.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path, "max_abs_err": worst[kname],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t.get("library_ms")})
        if "by_shape" in t:
            kernels[-1]["by_shape"] = t["by_shape"]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
