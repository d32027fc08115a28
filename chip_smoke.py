#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main paths on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

On one H100 80GB HBM3 it takes about seven minutes (eleven with
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
               and 3840, d_r 16-1024, 1 to 4,096 rows; restore+norm also at
               zamba2's d 3584 / d_r 56 and xLSTM's 768 / 48), restore+norm's x
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
               half twice on one payload equal, exact wire bytes; the 5%
               bound against the reference on every prompt, the reference
               taking the kernel path's routes (the share of routes the
               unforced reference agrees on printed; see phase_moe_serving);
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
 18. zamba2-7b - first a reduced f32 card-vs-CPU run (kernel prefill and 8
               decode steps: logits and recurrent states within 1e-4); then
               zamba2-7b uncut (81 layers: 68 Mamba2, 13 shared-attention
               layers reading one shared block; d 3584, bf16, seed 0) split
               after layer 4, inside its first 6-layer unit, at d_r 56:
               phase 5's handoff path on prompts of 64, 96 and 128 tokens
               (16 tokens in a 4-slot engine) and one streamed request, the
               decode pipeline on this bank (2 microbatches of 4 x 128
               tokens, int8, kernels; pipelined == serial, ids and final
               states), and phase 6's kernel prefill of 100 and 2,048 tokens
               (13 flash launches at hd 112 a prefill); in bf16 the cloud
               half twice on one payload and the streamed ids against a
               one-slot handoff are exact, and the logit bounds (against
               the reference wire, the plain prefill and a whole-sequence
               prefill) are held at 5% in f32 on the same weights and in
               bf16 at 5% or, where it is larger, the witness: how far
               bf16 rounding moves the plain path from f32 (see _limit);
 19. xlstm-125m - the same reduced run, then xlstm-125m uncut (12 layers,
               sLSTM every 3rd; d 768) split after layer 4 at d_r 48:
               serving on prompts of 32, 64 and 128 tokens, one streamed,
               the reference bound held as zamba2's, the pipeline,
               and the sLSTM layers' share of a 128-token prefill (a
               sequential loop over S, as in the reference).
 20. split pipeline - after phase 8, on phase 5's qwen3-8b bank: the
               paper's prefill pipeline (make_split_pipeline) with both pods
               on this card, each on its own stream, 4 microbatches of 4 x
               128 tokens, in every wire (raw, reduced, int8, int4,
               entropy): pipelined == serial on one stream, bit for bit;
               entropy == int8; int8 within 5% of forward_train's last
               position with the same greedy tokens; exact crossings; no
               kernel launched, as in the reference (see
               phase_split_pipeline);
 21. dry run and launchers - the dry run's FLOPs and bytes of a qwen3-8b
               plain prefill of 1 x 128 tokens on meta equal those counted
               on the card, beside the prefill's wall; then serve (engine
               and --split), split_serving, dryrun and dryrun
               --both-meshes (rank 0 of the 16x16 and 2x16x16 grids in a
               fake world) as subprocesses on
               the card, while the reduced f32 split pipeline runs on the
               card and on the CPU (gemma3, qwen3-moe, zamba2, xLSTM; see
               phase_launchers).
 22. model axis - once phase 5's bank is freed (its degree-1 split
               pipeline, decode pipeline and served requests kept on the
               host first), two spawned model ranks share this card over
               gloo, each holding half of both pods' heads, kv heads and
               d_ff columns of qwen3-8b at full width: the reduced f32
               card-vs-CPU run at (pod=2, model=2) for dense qwen3,
               qwen3-moe and zamba2; the split pipeline (int8, 2 x 4 x 128)
               within phase 5's bound of degree 1; the decode pipeline with
               the kernels (pipelined == serial, overlap_psum on == off,
               16 + 16 launches a rank a run); the bank at edge_mp=1,
               cloud_mp=2 serving 4 prompts of 64-128 tokens, 8 tokens
               each, held step by step to degree 1 (see phase_model_axis);
               a gloo all_reduce's time, degree 2's walls beside degree
               1's, each rank's peak.
 23. automatic - four spawned ranks share this card over gloo at (data=2,
               model=2), each holding full-width qwen3-moe cut to 2 of 94
               layers (butterfly after layer 1 at d_r 64) and running its
               shards: half the heads, 64 of the 128 experts, half of each
               expert's d_ff (all-gathered over data a layer at a time).
               A kernel prefill of 4 x 128 tokens, 2 a data block
               (shard_batch), each block within phase 5's 5% of a
               one-process run of its 2 prompts alone; 8 decode steps with
               the decode broadcast held to a one-process decode of all 4,
               and 2 with it off (the weight gather) to each block's; exact
               launches a rank; first the reduced f32 card-vs-CPU run at
               (data=2, model=2) (prefill, decode, 4 training steps) and
               (pod=2, data=1, model=2) with experts over the pod axis
               (see phase_automatic).
 24. seq decode - the dry run's production layout: four spawned ranks
               share this card over gloo at (data=2, model=2), each holding
               only its shards of full-width qwen3-8b (36 layers, butterfly
               after layer 4 at d_r 64): a kernel prefill of 4 x 128 tokens
               into caches sharded on "model" (REPRO_PREFILL_CACHE_SHARDED)
               and 8 decode steps at capacity 256, then one of 1 x 1,024
               into caches sharded on ("data", "model") and 8 steps at
               2,048, each step within phase 5's 5% of degree 1 with its
               greedy tokens; exact launches a rank; each rank's counts of
               one plain decode step equal its meta trace in a fake world
               (parallel.fake_world) exactly; first the reduced f32
               card-vs-CPU run (kv replicated, attention replicated, a
               ring, whisper; see phase_seq_decode).
Each model's weights leave the card before the next one is built, and
each phase prints its peak device memory.
With ``--profile [DIR]`` it profiles one qwen3-8b prefill and 8 decode steps
and a short pipelined and serial decode pipeline after phase 8, and
gemma3-12b's kernel and plain prefills of the 2,048-token prompt and 8
decode steps after phase 6, one training step of each model in phases
12 and 13, one qwen3-moe prefill and 8 decode steps after phase 14, and
pixtral's and whisper's kernel and plain prefills and 8 decode steps in
phases 16 and 17, and zamba2's and xLSTM's serving, zamba2's kernel and plain
prefills and decode in phases 18 and 19 (torch.profiler: wall time,
device-busy share, top kernels; the
operator tables go to DIR when one is given).  It then
prints the kernels' JSON line (launches by path, the paths of phases
9-24 included (phases 22's, 23's and 24's summed over their ranks), the training and
split-pipeline paths with none; the
times of flash attention and of the norm and bincount kernels per launch, averaged over their path's launches; the two butterfly
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
# the recurrent families' wires (phases 18 and 19): zamba2-7b's d=3584 at
# d_r=56 and xlstm-125m's d=768 at d_r=48 (both padded to 64 channels), at
# a decode row and a 128-token prompt
RECURRENT_WIDTHS = ((3584, 56), (768, 48))
RECURRENT_ROWS = (1, 128)


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
        [(T, d, d_r, torch.bfloat16) for d, d_r in RECURRENT_WIDTHS
         for T in RECURRENT_ROWS] + \
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
# 100 tokens (phase 16), whisper-base's encoder over 1,500 frames (not
# causal) and its decoder on a 32-token prompt (phase 17), and zamba2-7b's
# shared attention (32/32 heads at hd 112) on its 2,048- and 100-token
# prompts (phase 18)
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
    "zamba2 S=2048": (1, 2048, 32, 32, 112, None),
    "zamba2 S=100": (1, 100, 32, 32, 112, None),
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
    widths, then the two dense configs' (DENSE_WIDTHS at DENSE_ROWS) and the
    recurrent families' (RECURRENT_WIDTHS at RECURRENT_ROWS)."""
    return [(T, D, D_R) for T in TIME_ROWS] + \
        [(T, GEMMA_D, GEMMA_D_R) for T in GEMMA_TIME_ROWS] + \
        [(T, d, d_r) for d, d_r in DENSE_WIDTHS for T in DENSE_ROWS] + \
        [(T, d, d_r) for d, d_r in RECURRENT_WIDTHS for T in RECURRENT_ROWS]


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
                  streamed_len: Optional[int] = 96, label: str = "serving",
                  split: Optional[int] = None, d_r: Optional[int] = None,
                  lengths=(64, 80, 100, 128), f32_check: bool = False):
    """``arch`` at full width through the bank's split path (phases 5, 9, 18
    and 19): prompts of ``lengths`` tokens prefill one at a time through
    edge_half -> host wire -> cloud_half and decode ``new_tokens`` together
    in a 4-slot engine (cache handoff); with ``streamed_len`` one more
    prompt of that length decodes 8
    tokens through edge_step/stream_step.  The split is after ``split``
    layers at ``d_r`` (by default an eighth of the way, d_model / 64).
    ``f32_check`` adds exact checks (the cloud half twice on one payload;
    the streamed request's ids equal its one-slot handoff's), holds the 5%
    reference bound in f32 on the same weights (:func:`_serving_f32`), and
    takes the f32 reference as the bf16 bound's witness (:func:`_limit`).
    Returns the launches and the runner."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.runtime.split_exec import SplitModelBank

    cfg = get_config(arch)
    split = split or cfg.num_layers // 8
    d_r = d_r or max(16, cfg.d_model // 64)
    streamed = streamed_len is not None
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
    n = len(lengths)
    prompts = _prompts(n + streamed,
                       tuple(lengths) + ((streamed_len,) if streamed else ()))
    engine = runner.make_engine(max_batch=4, max_len=max_len, seed=0)
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
    refs = [runner.reference_prefill(toks[None])[0][0, -1] for toks in prompts[:n]]
    witness = [None] * n
    if f32_check:
        params = runner.params
        toks = torch.tensor(prompts[0], device="cuda")[None]
        payload, scales, _ = runner.edge_half(params, toks)
        once, _ = runner.cloud_half(params, payload, scales)
        twice, _ = runner.cloud_half(params, payload, scales)
        if not torch.equal(once, twice):
            fail(f"{label}: the cloud half gave two results on one payload")
        if streamed:
            solo = runner.make_engine(max_batch=1, max_len=max_len, seed=0)
            (h,), *_ = _serve_handoff(runner, solo, [prompts[n]], 8)
            if h.generated != sreq.generated:
                fail(f"{label}: streamed ids {sreq.generated} differ from the same "
                     f"prompt's one-slot cache handoff {h.generated}")
        print(f"{label}: the cloud half twice on one payload equal"
              + (", streamed ids == one-slot handoff" if streamed else "")
              + ", bit for bit")
        witness = [float((ref - r32).abs().max()) for ref, r32 in
                   zip(refs, _serving_f32(runner, prompts[:n], label))]
    agree = 0
    for toks, lg, ref, w in zip(prompts[:n], cloud_logits, refs, witness):
        if not (lg.shape == ref.shape and lg.shape[-1] == cfg.vocab_size):
            fail("cloud logits are of the wrong shape")
        delta, limit = _hold_logits(f"{label}: S={len(toks)} cloud logits vs the "
                                    f"reference", lg, ref, w)
        agree += int(torch.argmax(lg) == torch.argmax(ref))
        print(f"{label}: S={len(toks)} max|logits - reference| {delta:.4g} (limit "
              f"{limit:.4g}" + ("" if w is None else
                                f"; bf16 witness {w:.4g}, {delta / w:.2f}x") + ")")
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
    print(f"{label}: handoff decode {decode_ms:.3f} ms per step of "
          f"{engine.max_batch} slots, {n} busy ({decode_steps} steps, "
          f"{decode_ms / n:.3f} ms per token)"
          + (f"; streamed decode {stream_ms:.3f} ms per token" if streamed else "")
          + f"; weight-read floor {weight_gb / 3.35:.2f} ms a step "
          f"({weight_gb:.2f} GB at 3.35 TB/s)")
    print(f"{label}: peak device memory {peak_gb:.2f} GB")
    print(f"{label}: tokens {[r.generated for r in reqs]}"
          + (f" streamed {sreq.generated}" if streamed else ""))
    return launches, runner


def _serving_f32(runner, prompts, label: str):
    """Phase 5's reference check on the same weights in f32 (a second bank,
    no TF32): each prompt through edge_half -> cloud_half (the f32 wire
    kernels) against reference_prefill, within the 5% bound and with the
    same greedy token (in f32 both wires quantize one product).  Returns
    the f32 reference logits, the bf16 check's witness."""
    import dataclasses
    import torch
    from repro_torch.runtime.split_exec import SplitModelBank
    from repro_torch.tree import tree_map
    bank = runner.bank
    f32 = lambda tree: tree_map(lambda t: t.float(), tree)
    r32 = SplitModelBank(
        dataclasses.replace(bank.base_cfg, dtype="float32"), bank.d_r,
        wire_mode=bank.wire_mode, seed=bank.seed, device="cuda",
        params=f32(bank.params),
        butterfly={runner.split: f32(runner.params["butterfly"])}).runner(runner.split)
    p32 = r32.params
    refs = []
    for toks in prompts:
        toks = torch.tensor(toks, device="cuda")[None]
        payload, scales, _ = r32.edge_half(p32, toks)
        lg, _ = r32.cloud_half(p32, payload, scales)
        ref = r32.reference_prefill(toks)[0][0, -1]
        delta, limit = _hold_logits(f"{label}: S={toks.shape[1]} f32 cloud logits "
                                    f"vs the reference", lg[0], ref, greedy=True)
        print(f"{label}: S={toks.shape[1]} f32: max|logits - reference| {delta:.4g} "
              f"(limit {limit:.4g}), greedy same")
        refs.append(ref)
    del r32, p32
    return refs


# bf16 bounds with a witness.  A deep model can amplify bf16 roundings past
# phase 5's 5% of max|logit|: zamba2's plain prefill in bf16 lies further
# from the same weights' f32 prefill than its kernel and plain paths lie
# from each other (PERF.md section 2).  Where that witness is measured,
# w = max|bf16 - f32| of the path a check compares with (the reference
# wire, the plain prefill, the whole-sequence prefill) on the same input,
# the bf16 path is held to w if that is larger than 5%: the two may differ
# by no more than bf16 rounding alone moves the one compared with.  The f32
# run itself holds 5%.
def _limit(want, witness=None) -> float:
    """5% of max|want|, or ``witness`` where that is larger."""
    limit = 0.05 * float(want.abs().max())
    return limit if witness is None else max(limit, witness)


def _hold_logits(what: str, got, want, witness=None, greedy: bool = False):
    """Fail unless ``got`` is finite and within :func:`_limit` of ``want``;
    with ``greedy`` also unless their greedy tokens agree (given a witness,
    only where want's top two are further apart than the limit: nearer,
    the rounding the limit allows can swap them).  Returns (max|got -
    want|, the limit)."""
    import torch
    delta = float((got.float() - want.float()).abs().max())
    limit = _limit(want, witness)
    if not torch.isfinite(got).all() or delta > limit:
        fail(f"{what}: not finite, or they differ by {delta} > {limit}")
    if greedy and int(got.argmax()) != int(want.argmax()):
        top = want.float().flatten().topk(2).values
        if witness is None or float(top[0] - top[1]) > limit:
            fail(f"{what}: the greedy tokens differ")
    return delta, limit


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


def _check_prompt(params, built, batch, r, f32=None):
    """Hold one prompt's results from :func:`_serve_prompt` to the phase's
    limits: one flash launch an attention layer (the encoder's included),
    the 5% logit bound and equal greedy tokens, the decode caches' lengths,
    and the last decode step against a kernel prefill of the whole sequence.
    ``f32``, the same prompt's f32 logits from :func:`_prefill_f32`, makes
    the two logit bounds' witnesses (:func:`_limit`).  Its whole-sequence
    prefill is a check, so it runs after the path's launches were read."""
    import torch
    from repro_torch.models import model as M
    cfg = built.cfg
    S, cap, logits, ref, caches, step_logits, generated = (
        r[k] for k in ("S", "cap", "logits", "ref", "caches", "step_logits",
                       "generated"))
    flash = r["flash_kernel"]
    layers = sum(d.mixer == "attn" for segs in built.stages for seg in segs
                 for d in seg.unit for _ in range(seg.repeats)) + cfg.encoder_layers
    if flash != layers or r["flash_rest"] != 0:
        fail(f"S={S}: the kernel prefill launched the flash kernel {flash} "
             f"times, the plain prefill and decode {r['flash_rest']}; "
             f"expected {layers} and 0")
    if logits.shape != (1, 1, cfg.vocab_size):
        fail(f"S={S}: kernel prefill logits are of the wrong shape")
    # the last decode step against a kernel prefill of the whole sequence,
    # whose windowed layers see the same 1024 positions the rings hold (a
    # recurrent layer's state carries the whole sequence)
    seq = dict(batch, tokens=torch.cat([batch["tokens"]] + generated[:-1], dim=1))
    whole, _ = M.forward_prefill(params, built, seq, use_kernel=True)
    w_plain, w_whole = (None, None) if f32 is None else (
        float((ref - f32["plain"]).abs().max()),
        float((whole - f32["whole"]).abs().max()))
    delta, limit = _hold_logits(f"S={S}: kernel vs plain prefill logits", logits,
                                ref, w_plain, greedy=True)
    windowed = {d.window for segs in built.stages for seg in segs for d in seg.unit}
    want_lengths = {cap if w is None else min(cap, w) for w in windowed}
    if cfg.is_encdec:                 # the cross_kv caches: one row a frame
        want_lengths.add(batch["frames"].shape[1])
    lengths = _kv_rows(caches)
    if lengths != want_lengths:
        fail(f"S={S}: decode cache lengths {sorted(lengths)}, expected "
             f"{sorted(want_lengths)}")
    d_delta, d_limit = _hold_logits(f"S={S}: the last decode step vs a prefill of "
                                    f"the whole sequence", step_logits, whole, w_whole)
    witness = lambda w, d: "" if w is None else f"; bf16 witness {w:.4g}, {d / w:.2f}x"
    tokens = [int(x) for x in torch.cat(generated[1:], dim=1)[0].tolist()]
    print(f"kernel prefill: S={S:5d} prefill kernel {r['kernel_ms']:.3f} ms, "
          f"plain {r['plain_ms']:.3f} ms; flash launches {flash}; max|logits - plain| "
          f"{delta:.4g} (limit {limit:.4g}{witness(w_plain, delta)}), greedy token "
          f"{int(logits.argmax())} kernel, {int(ref.argmax())} plain")
    print(f"kernel prefill: S={S:5d} decode {r['decode_ms']:.3f} ms per token "
          f"over {cap - S} steps; cache rows {sorted(lengths)}; last step vs "
          f"whole-sequence prefill {d_delta:.4g} (limit {d_limit:.4g}"
          f"{witness(w_whole, d_delta)}), greedy "
          f"{'same' if int(step_logits.argmax()) == int(whole.argmax()) else 'differs'}")
    print(f"kernel prefill: S={S:5d} tokens {tokens}")
    return tokens


def _prefill_f32(params, built, batch, r, label: str):
    """:func:`_check_prompt`'s logit checks on the same weights cast to f32
    (no TF32): the kernel prefill (the f32 flash kernel) against the plain
    prefill, within the 5% bound and with the same greedy token; the decode
    steps fed the bf16 run's greedy tokens, the last against a kernel
    prefill of the whole sequence, within the 5% bound.  Returns the plain
    and whole-sequence f32 logits, the bf16 checks' witnesses."""
    import dataclasses
    import torch
    from repro_torch.models import model as M
    from repro_torch.tree import tree_map
    built32 = M.build(dataclasses.replace(built.cfg, dtype="float32"))
    p32 = tree_map(lambda t: t.float(), params)
    S, generated = r["S"], r["generated"]
    torch.cuda.synchronize()
    t = time.perf_counter()
    logits, caches = M.forward_prefill(p32, built32, batch, use_kernel=True)
    plain, _ = M.forward_prefill(p32, built32, batch)
    delta, limit = _hold_logits(f"S={S}: f32 kernel vs plain prefill logits",
                                logits, plain, greedy=True)
    caches = M.pad_decode_caches(built32, caches, r["cap"])
    for tok, pos in zip(generated, range(S, r["cap"])):
        step, caches = M.forward_decode(p32, built32, tok, caches, pos,
                                        use_kernel=True)
    seq = dict(batch, tokens=torch.cat([batch["tokens"]] + generated[:-1], dim=1))
    whole, _ = M.forward_prefill(p32, built32, seq, use_kernel=True)
    w_delta, w_limit = _hold_logits(f"S={S}: f32 last decode step vs a prefill of "
                                    f"the whole sequence", step, whole)
    torch.cuda.synchronize()
    print(f"{label}: S={S:5d} f32: kernel vs plain prefill {delta:.4g} "
          f"(limit {limit:.4g}), greedy same; last of {r['cap'] - S} decode "
          f"steps vs whole-sequence kernel prefill {w_delta:.4g} (limit "
          f"{w_limit:.4g}), greedy "
          f"{'same' if int(step.argmax()) == int(whole.argmax()) else 'differs'}; "
          f"{(time.perf_counter() - t):.1f} s")
    del p32, caches
    return dict(plain=plain, whole=whole)


def _kv_rows(caches) -> set:
    """The row counts of a cache tree's attention caches (``kv`` and
    ``cross_kv``); recurrent state has no rows."""
    if isinstance(caches, dict):
        return set().union(*({a.shape[2] for a in v.values()} if k in ("kv", "cross_kv")
                             else _kv_rows(v) for k, v in caches.items()))
    if isinstance(caches, (list, tuple)):
        return set().union(set(), *(_kv_rows(c) for c in caches))
    return set()


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
                         label: str = "kernel prefill", f32_check: bool = False):
    """``arch`` at full width through forward_prefill(use_kernel=True) and
    greedy forward_decode (phases 6, 10, 16, 17, 18; see the module
    docstring): one prompt of each of ``lengths`` tokens (and the model's
    patches or frames), the butterfly after ``butterfly = (layer, d_r)`` (by
    default an eighth of the way, d_r = d_model / 64); ``new_tokens`` decode
    steps, or a tuple of them, one a prompt.  ``f32_check`` holds the
    logit checks in f32 on the same weights too, and takes their f32 logits
    as the bf16 bounds' witnesses (:func:`_prefill_f32`).  With ``profile`` it then
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
    steps = new_tokens if isinstance(new_tokens, tuple) else \
        (new_tokens,) * len(prompts)
    served = [_serve_prompt(params, built, batch, n)
              for batch, n in zip(prompts, steps)]
    launches = _counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"{label}: launches on the path {launches}")
    if min(launches[k] for k in ("butterfly_reduce_quant",
                                 "butterfly_dequant_restore",
                                 "flash_attention")) <= 0:
        fail(f"a kernel was not launched on the kernel-prefill path: {launches}")
    if peak_gb >= 80:
        fail(f"peak device memory {peak_gb:.2f} GB does not fit the card")
    results = [_check_prompt(params, built, batch, r, _prefill_f32(
        params, built, batch, r, label) if f32_check else None)
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
    # the dense widths, then zamba2's and xLSTM's (their decode pipelines
    # launch it at 4 and 512 rows, both in NORM_ROWS)
    pairs = [(d, d_r) for d in NORM_D for d_r in NORM_D_R] + list(RECURRENT_WIDTHS)
    for dtype in (torch.bfloat16, torch.float32):
        for d, d_r in pairs:
            for T in NORM_ROWS:
                codes, scales, wr, nw = _restore_inputs(T, d, d_r, dtype,
                                                        seed=T + d + d_r)
                x, h = bk.dequant_restore_norm(codes, scales, wr, nw, eps, dtype)
                if not torch.equal(x, bk.dequant_restore(codes, scales, wr, dtype)):
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
        for d in NORM_D:
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
    params, _, _ = init_train_state(torch.Generator().manual_seed(0), small,
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
    params, opt, _ = init_train_state(
        torch.Generator(device="cuda").manual_seed(0), built, device="cuda")
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
    """Records the expert ids and slots (and the dropped choices) of every
    MoE layer run inside the block, by wrapping ``models.moe.route``; the
    wrapper comes off on exit.  Given ``forced``, another run's recorded
    ``_Routes``, each layer takes that run's routes, in call order
    (``route``'s ``forced``)."""

    def __init__(self, forced: Optional["_Routes"] = None):
        self._forced = None if forced is None else list(zip(forced.eids, forced.pos))

    def __enter__(self):
        from repro_torch.models import moe
        self._moe, self._route = moe, moe.route
        self.eids, self.pos, self.dropped = [], [], []

        def route(x_flat, router, mcfg, capacity, forced=None):
            if self._forced is not None:
                forced = self._forced[len(self.eids)]
            out = self._route(x_flat, router, mcfg, capacity, forced)
            self.eids.append(out[3])
            self.pos.append(out[4])
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
    discontinuous, and the reference's wire rounds x @ w_reduce to bf16,
    so the reference is run with the kernel path's routes forced on every
    MoE layer (``_Routes(forced=...)``) and held to phase 5's 5% bound on
    every prompt; the share of routes the unforced reference agrees on is
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
    agree = total = cloud_agree = cloud_total = 0
    moe_at = [i for i, d in enumerate(bank._defs) if d.ffn == "moe"]
    for t, lg in zip(prompts, cloud_logits):
        toks = torch.tensor(t, device="cuda")[None]
        S = toks.shape[1]
        with _Routes() as kr:
            payload, scales, _ = runner.edge_half(params, toks)
            kl, _ = runner.cloud_half(params, payload, scales)
        with _Routes() as rr:
            free_ref = _moe_reference(runner, toks)
        with _Routes(forced=kr):
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
        if delta > limit:
            fail(f"S={S}: the cloud logits differ from the reference on the "
                 f"same routes by {delta} > {limit}")
        free_delta = float((lg - free_ref).abs().max())
        print(f"{label}: S={S} max|logits - reference on the kernel path's "
              f"routes| {delta:.4g} (5% limit {limit:.4g}, held); greedy "
              f"{'same' if int(lg.argmax()) == int(ref.argmax()) else 'differs'}; "
              f"the unforced reference routes as the kernel path in "
              f"{sum(same)}/{len(same)} MoE layers ({sum(eq)}/"
              f"{sum(a[:S].numel() for a in kr.eids)} choices), max|logits - "
              f"it| {free_delta:.4g}; {dropped} choices dropped at capacity")
    print(f"{label}: routing agreement of the unforced reference {agree}/{total} = "
          f"{agree / total:.4%} of (token, layer, choice); cloud layers "
          f"{cloud_agree}/{cloud_total} = {cloud_agree / max(cloud_total, 1):.4%}; "
          f"5% logit bound held on all {n} prompts (forced routes)")
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


def phase_bank_pipeline(runner, label: str = "moe pipeline", pipe=MOE_PIPE):
    """The decode pipeline on a phase's bank (phases 14, 18 and 19), both
    pods on this card with their own streams: ``pipe``'s microbatches (2 of
    4 x 128 tokens), int8 with the kernels, pipelined and serial.  Each run
    must launch reduce_quant and restore_norm exactly Mmb + Mmb*(T-1)
    times, dequant_restore and flash never, and the pipelined ids and final
    stage caches (KV and recurrent state) must equal the serial ones, bit
    for bit.  Column 0's agreement with cloud_half's greedy tokens is
    printed, not held: the pipeline's first cloud layer reads restore_norm's
    RMSNorm, the bank's the plain one, and one bit there can move a route or
    an argmax.  Returns the path's launches."""
    import numpy as np
    import torch
    Mmb, mb, S, T = (pipe[k] for k in ("Mmb", "mb", "S", "T"))
    toks = torch.tensor(np.stack(_prompts(Mmb * mb, (S,) * (Mmb * mb))),
                        dtype=torch.int64, device="cuda")
    per_run = Mmb + Mmb * (T - 1)
    runs = {p: runner.decode_pipeline(None, Mmb, S, mb, T, pipelined=p,
                                      use_kernel=True) for p in (True, False)}
    for run in runs.values():                                 # warm-up
        run(toks)
    torch.cuda.synchronize()
    launches = dict.fromkeys(_counts(), 0)
    ids, states = {}, {}
    for pipelined, run in runs.items():
        timings: dict = {}
        states[pipelined] = {}
        _zero_counts()
        ids[pipelined] = run(toks, timings, states[pipelined])
        torch.cuda.synchronize()
        got = _counts()
        want = dict.fromkeys(got, 0)
        want["butterfly_reduce_quant"] = want["butterfly_dequant_restore_norm"] = per_run
        if got != want:
            fail(f"{label} pipelined={pipelined}: launches {got}, expected {want}")
        for k, v in got.items():
            launches[k] += v
        out = ids[pipelined]
        if out.shape != (Mmb * mb, T) or int(out.min()) < 0 or \
                int(out.max()) >= runner.cfg.vocab_size:
            fail(f"{label} ids {tuple(out.shape)} are not (Mmb*mb, T) tokens")
        print(f"{label}: {'pipelined' if pipelined else 'serial   '} prefill "
              f"{timings['prefill_ms'] / Mmb:.3f} ms a microbatch, decode "
              f"{timings['decode_ms'] / timings['ticks']:.3f} ms a tick "
              f"({timings['ticks']} ticks); launches {got}")
    if not torch.equal(ids[True], ids[False]):
        fail(f"{label}: pipelined ids differ from serial ids")
    if not all(torch.equal(a, b) for a, b in zip(_leaves(states[True]),
                                                  _leaves(states[False]))):
        fail(f"{label}: pipelined and serial runs leave other stage caches")
    col0 = 0
    for k in range(Mmb):
        payload, scales, _ = runner.edge_half(runner.params, toks[k * mb:(k + 1) * mb])
        logits, _ = runner.cloud_half(runner.params, payload, scales)
        col0 += int((logits.argmax(-1).int() == ids[True][k * mb:(k + 1) * mb, 0]).sum())
    print(f"{label}: pipelined == serial, ids and final stage caches, bitwise; "
          f"column 0 == cloud_half's greedy token on {col0}/{Mmb * mb} rows; "
          f"tokens {ids[True].tolist()}")
    print(f"{label}: launches on the path {launches}")
    return launches


# -------------------------------------------------------------------- 18, 19
# the recurrent families at published widths and depths, uncut (bf16):
# zamba2-7b (81 layers: 68 Mamba2, 13 shared-attention at i % 6 == 5, one
# shared block; 5.6 B params) and xlstm-125m (12 layers, sLSTM at i % 3 ==
# 2), each split after layer 4, inside its first repeat unit, so the bank
# peels.  Prompt lengths keep S % min(chunk, S) == 0 (chunks 128 and 64),
# as the chunked forms require; the zamba2 kernel prefill of 2,048 tokens
# decodes 128 steps, so that the whole sequence its last step is checked
# against (2,176 tokens) is whole chunks too.  Both hold their bf16 logit
# bounds with f32 witnesses (_limit).
RECURRENT = {
    "zamba2-7b": dict(label="zamba2", split=4, d_r=56, lengths=(64, 96, 128),
                      streamed=96, parity_layers=6,
                      kernel_lengths=(100, 2048), kernel_steps=(8, 128)),
    "xlstm-125m": dict(label="xlstm", split=4, d_r=48, lengths=(32, 64, 128),
                       streamed=64, parity_layers=4),
}
# the decode pipeline on their banks: 2 microbatches of 4 x 128 tokens, 8
# tokens (14 ticks)
RECURRENT_PIPE = dict(Mmb=2, mb=4, S=128, T=8)
# card vs CPU at f32 without TF32, from one init: f32 sums in another order
RECURRENT_PARITY_RTOL = 1e-4


def _recurrent_parity(arch: str, label: str):
    """The reduced config in f32 (zamba2 at 6 layers, [mamba, shared attn]
    three times; xLSTM at 4, [mLSTM, sLSTM] twice) with a butterfly after
    layer 1, from one CPU init: the kernel prefill of 2 x 32 tokens and 8
    decode steps fed the CPU's greedy tokens, on the card and on the CPU;
    every step's logits and the final caches (KV and recurrent state) agree
    within RECURRENT_PARITY_RTOL (atol 1e-5)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.tree import tree_map
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              num_layers=RECURRENT[arch]["parity_layers"])
    built = M.build(cfg.with_butterfly(1, 16))
    params = M.init_model(torch.Generator().manual_seed(0), built, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 32)))
    runs, fed = [], []
    for dev in ("cpu", "cuda"):
        p = params if dev == "cpu" else tree_map(lambda t: t.cuda(), params)
        logits, caches = M.forward_prefill(p, built, {"tokens": toks.to(dev)},
                                           use_kernel=True)
        caches = M.pad_decode_caches(built, caches, 40)
        out = [logits.cpu()]
        for i, pos in enumerate(range(32, 40)):
            if dev == "cpu":
                fed.append(logits[:, -1].argmax(-1, keepdim=True))
            logits, caches = M.forward_decode(p, built, fed[i].to(dev), caches,
                                              pos, use_kernel=True)
            out.append(logits.cpu())
        runs.append((out, [t.cpu() for t in _leaves(caches)]))
    (lc, cc), (lg, cg) = runs
    for a, b in zip(lg + cg, lc + cc):
        torch.testing.assert_close(a, b, rtol=RECURRENT_PARITY_RTOL, atol=1e-5)
    print(f"{label}: parity, reduced {cfg.name} ({cfg.num_layers} layers, f32, no "
          f"TF32, kernel prefill of 2 x 32 tokens and 8 decode steps) card vs CPU: "
          f"logits max |d| {max(float((a - b).abs().max()) for a, b in zip(lg, lc)):.3g}, "
          f"{len(cg)} cache leaves max |d| "
          f"{max(float((a - b).abs().max()) for a, b in zip(cg, cc)):.3g}")


def _slstm_share(runner, toks):
    """One prefill of ``toks`` through edge_half -> host wire -> cloud_half:
    its wall, then the share of a second, instrumented run that the sLSTM
    layers take (each layer synchronised and timed on the host clock; a
    sequential loop of S steps, as in the JAX package's lax.scan)."""
    import torch
    from repro_torch.models import xlstm
    params = runner.params

    def prefill():
        payload, scales, _ = runner.edge_half(params, toks[None])
        runner.cloud_half(params, payload.cpu().cuda(), scales.cpu().cuda())
        torch.cuda.synchronize()
    prefill()
    t = time.perf_counter()
    prefill()
    wall = (time.perf_counter() - t) * 1e3
    spent, full = [], xlstm.slstm_fullseq

    def timed(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = full(*args, **kw)
        torch.cuda.synchronize()
        spent.append((time.perf_counter() - t0) * 1e3)
        return out
    xlstm.slstm_fullseq = timed
    try:
        t = time.perf_counter()
        prefill()
        timed_wall = (time.perf_counter() - t) * 1e3
    finally:
        xlstm.slstm_fullseq = full
    print(f"xlstm: prefill S={len(toks)} wall {wall:.3f} ms; the {len(spent)} sLSTM "
          f"layers take {sum(spent):.3f} ms of an instrumented {timed_wall:.3f} ms "
          f"({sum(spent) / timed_wall:.1%}), {sum(spent) / len(spent) / len(toks) * 1e3:.1f} "
          f"us a layer-step")


def phase_recurrent(arch: str, smi: str, profile: bool = False,
                    out_dir: Optional[Path] = None) -> dict:
    """Phases 18 (zamba2-7b) and 19 (xlstm-125m), uncut: the reduced
    card-vs-CPU parity, then phase 5's split serving on the bank (prompts
    of RECURRENT's lengths, 16 tokens in a 4-slot engine, one streamed
    request; with the exact and f32 checks of ``f32_check``), the decode
    pipeline on that bank, and for zamba2 phase 6's kernel prefill (13
    flash launches a prefill, all causal at S x S; its logit checks held in
    f32); for xLSTM the sLSTM layers' share of a 128-token prefill.
    Returns the launches by path."""
    c = RECURRENT[arch]
    label = c["label"]
    print(f"{label}: card {smi}")
    _recurrent_parity(arch, label)
    paths = {}
    paths[f"{arch} split serving"], runner = phase_serving(
        arch, new_tokens=16, streamed_len=c["streamed"], label=f"{label} serving",
        split=c["split"], d_r=c["d_r"], lengths=c["lengths"],
        f32_check=True)
    paths[f"{arch} decode pipeline"] = phase_bank_pipeline(
        runner, f"{label} pipeline", RECURRENT_PIPE)
    if arch == "xlstm-125m":
        _slstm_share(runner, _prompts(1, (128,))[0])
    if profile:
        phase_profile(runner, out_dir, f"{label}_")
    del runner
    _free()
    if "kernel_lengths" in c:
        launches, _, calls = phase_kernel_prefill(
            arch, profile, out_dir, lengths=c["kernel_lengths"],
            butterfly=(c["split"], c["d_r"]), new_tokens=c["kernel_steps"],
            label=f"{label} kernel prefill", f32_check=True)
        from repro_torch.configs import get_config
        from repro_torch.models.transformer import build_layer_defs
        S = c["kernel_lengths"][-1]
        n_attn = sum(d.mixer == "attn" for d in build_layer_defs(get_config(arch)))
        if calls != [(S, S, True)] * n_attn:
            fail(f"{arch}'s kernel prefill made flash calls {sorted(set(calls))}, "
                 f"{len(calls)} in all; expected {n_attn} causal at {S} x {S}, "
                 f"one a shared-attention layer")
        paths[f"{arch} kernel prefill"] = launches
        _free()
    return paths


# -------------------------------------------------------------------- 20, 21
# the paper's prefill pipeline (serving.pipeline.make_split_pipeline) on
# phase 5's qwen3-8b bank, both pods on this card: 4 microbatches of 4 x 128
# tokens through every wire
SPLIT_PIPE = dict(Mmb=4, mb=4, S=128)
SPLIT_WIRES = ("raw", "reduced", "int8", "int4", "entropy")
# the reduced f32 card-vs-CPU run of the same pipeline, butterfly after
# layer 1 at d_r 16, 3 microbatches of 2 x 32 tokens
SPLIT_PARITY = {"gemma3-12b": dict(num_layers=4, global_every=2, sliding_window=4),
                "qwen3-moe-235b-a22b": dict(num_layers=3),
                "zamba2-7b": dict(num_layers=4), "xlstm-125m": dict(num_layers=4)}
SPLIT_PARITY_RTOL = 1e-4
# a quantized code whose |r / scale| lies this near a half may round the
# other way where the f32 sums that make r add in another order
TIE = 1e-3


class _Wire:
    """Records the wire of every split-pipeline microbatch run inside the
    block (``serving.pipeline.quantize``: r, its codes and scales).  Given
    ``forced``, another run's recorded ``_Wire``, each microbatch takes that
    run's codes and scales, which must equal its own but for codes rounded
    the other way at a rounding tie (counted in ``ties``), scales within
    SPLIT_PARITY_RTOL; the wrapper comes off on exit."""

    def __init__(self, forced: Optional["_Wire"] = None):
        self._forced = forced

    def __enter__(self):
        from repro_torch.serving import pipeline
        self._mod, self._quantize = pipeline, pipeline.quantize
        self.calls, self.ties = [], 0

        def quantize(r, bits=8):
            import torch
            codes, scales = self._quantize(r, bits)
            if self._forced is not None:
                _, fc, fs = self._forced.calls[len(self.calls)]
                fc, fs = fc.to(codes.device), fs.to(scales.device)
                torch.testing.assert_close(scales, fs, rtol=SPLIT_PARITY_RTOL,
                                           atol=0)
                q = (r.float() / scales).abs()
                tie = ((q - q.floor()) - 0.5).abs() < TIE
                diff = codes != fc
                if bool((diff & ~tie).any()) or \
                        int((codes.int() - fc.int()).abs().max()) > 1:
                    fail("split parity: a wire code differs from the CPU's away "
                         "from a rounding tie")
                self.ties += int(diff.sum())
                codes, scales = fc, fs
            self.calls.append((r, codes, scales))
            return codes, scales
        pipeline.quantize = quantize
        return self

    def __exit__(self, *exc):
        self._mod.quantize = self._quantize


def _split_parity():
    """The reduced f32 pipeline (no TF32) from one CPU init on two CPU pods
    and on two streams of the card, every wire, for windowed gemma3 (4
    layers), qwen3-moe (3), zamba2 and xLSTM (4): every MoE route equal,
    and the card's logits within SPLIT_PARITY_RTOL (atol 1e-5) of the CPU's
    with the card's wire taken from the CPU run (``_Wire``: equal but for
    codes at rounding ties, which are counted)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serving.pipeline import make_split_pipeline
    from repro_torch.tree import tree_map
    Mmb, mb, S = 3, 2, 32
    for arch, over in SPLIT_PARITY.items():
        cfg = dataclasses.replace(get_config(arch).reduced(), **over)
        built = M.build(cfg.with_butterfly(1, 16))
        params = M.init_model(torch.Generator().manual_seed(0), built, device="cpu")
        pg = tree_map(lambda t: t.cuda(), params)
        toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (Mmb * mb, S))
        worst, ties, routes = 0.0, 0, 0
        for wm in SPLIT_WIRES:
            out = []
            for dev, p in (("cpu", params), ("cuda", pg)):
                fn = make_split_pipeline(built, (dev, dev), Mmb, S, mb, wm)
                with _Wire(None if dev == "cpu" else out[0][2]) as w, \
                        _Routes() as r:
                    logits = fn(p, toks).cpu()
                out.append((logits, r, w))
            (lc, rc, _), (lg, rg, wg) = out
            if len(rc.eids) != len(rg.eids) or not all(
                    torch.equal(a, b.cpu()) for a, b in zip(rc.eids, rg.eids)):
                fail(f"split parity {arch} {wm}: the card routes a choice to "
                     f"another expert than the CPU")
            torch.testing.assert_close(lg, lc, rtol=SPLIT_PARITY_RTOL, atol=1e-5)
            worst = max(worst, float((lg - lc).abs().max()))
            ties += wg.ties
            routes += sum(e.numel() for e in rc.eids)
        print(f"split parity: reduced {cfg.name} ({cfg.num_layers} layers, f32, "
              f"no TF32), {Mmb} x {mb} x {S} tokens, {len(SPLIT_WIRES)} wires: "
              f"card vs CPU logits max |d| {worst:.3g}, {routes} routes equal, "
              f"{ties} codes at rounding ties taken from the CPU")


def phase_split_pipeline(runner):
    """Phase 20: ``make_split_pipeline`` on phase 5's qwen3-8b bank (36
    layers, bf16, the int8 butterfly after layer 4 at d_r 64; nothing new
    loaded) with both pods on this card, each on its own stream, at
    SPLIT_PIPE, in every wire.  Each wire's pipelined logits equal a serial
    run on one stream, bit for bit; entropy's equal int8's (rANS is
    lossless over the codes); int8's lie within phase 5's 5% of the
    single-model forward_train's last position on the same tokens, with the
    same greedy tokens; raw, reduced and int4 have no such oracle and print
    their gap to int8's.  Each run crosses Mmb wires, their dtype and bytes
    those of wire_stats, and Mmb logit rows back, and launches no kernel,
    as in the reference.  Returns the path's launches (all 0)."""
    import numpy as np
    import torch
    from repro_torch.models import model as M
    from repro_torch.serving.pipeline import make_split_pipeline, wire_stats
    Mmb, mb, S = SPLIT_PIPE["Mmb"], SPLIT_PIPE["mb"], SPLIT_PIPE["S"]
    built, params = runner.stage_view()
    cfg = built.cfg
    prompts = _prompts(Mmb * mb, (S,) * (Mmb * mb))
    toks = torch.tensor(np.stack(prompts), dtype=torch.int64, device="cuda")
    runs = {(wm, p): make_split_pipeline(built, ("cuda", "cuda"), Mmb, S, mb, wm,
                                         pipelined=p)
            for wm in SPLIT_WIRES for p in (True, False)}
    t0 = time.perf_counter()
    for fn in runs.values():                         # warm-up at the same shapes
        fn(params, toks)
    torch.cuda.synchronize()
    print(f"split pipeline: {cfg.name}, split {cfg.butterfly.layer}, d_r "
          f"{cfg.butterfly.d_r}, Mmb {Mmb} x mb {mb}, S {S}, both pods on "
          f"{torch.cuda.get_device_name(0)} (two streams); warm-up "
          f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    out, walls, crossed = {}, {}, {}
    for key, fn in runs.items():
        crossings = []
        torch.cuda.synchronize()
        t = time.perf_counter()
        out[key] = fn(params, toks, crossings)
        torch.cuda.synchronize()
        walls[key] = (time.perf_counter() - t) * 1e3
        crossed[key] = crossings
    launches = _counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if any(launches.values()):
        fail(f"split pipeline: kernels launched {launches}; the reference's "
             f"pipeline reaches none")
    act = 2 if cfg.dtype == "bfloat16" else 4
    for (wm, p), logits in out.items():
        if logits.shape != (Mmb * mb, cfg.vocab_size) or \
                logits.dtype != torch.float32 or not torch.isfinite(logits).all():
            fail(f"split pipeline {wm}: logits {tuple(logits.shape)} "
                 f"{logits.dtype}, not finite f32 (Mmb*mb, V)")
        stats = wire_stats(cfg, mb, S, 4 if wm == "int4" else None)
        dt = getattr(torch, cfg.dtype)
        want = {"raw": (dt, stats["raw_boundary_bytes"]),
                "reduced": (dt, mb * S * cfg.butterfly.d_r * act)}.get(
            wm, (torch.int8, stats["wire_bytes"]))
        wires = [c for c in crossed[wm, p] if c[0] == "edge->cloud"]
        back = [c for c in crossed[wm, p] if c[0] == "cloud->edge"]
        if len(wires) != Mmb or len(back) != Mmb or \
                any((c[1], c[3]) != want for c in wires) or \
                any(c[3] != mb * cfg.vocab_size * 4 for c in back):
            fail(f"split pipeline {wm}: crossings {crossed[wm, p]}, expected "
                 f"{Mmb} wires of {want} and {Mmb} logit rows")
    for wm in SPLIT_WIRES:
        if not torch.equal(out[wm, True], out[wm, False]):
            fail(f"split pipeline {wm}: pipelined logits differ from serial")
    if not torch.equal(out["entropy", True], out["int8", True]):
        fail("split pipeline: the entropy wire's logits differ from int8's")
    ref = M.forward_train(params, built, {"tokens": toks})[0][:, -1]
    delta, limit = _hold_logits("split pipeline int8 vs forward_train",
                                out["int8", True], ref)
    agree = int((out["int8", True].argmax(-1) == ref.argmax(-1)).sum())
    if agree != Mmb * mb:
        fail(f"split pipeline: int8's greedy tokens agree with forward_train's "
             f"on {agree} of {Mmb * mb} rows")
    print(f"split pipeline: pipelined == serial (one stream), bit for bit, in "
          f"every wire; entropy == int8; int8 vs forward_train max|d| "
          f"{delta:.4g} (limit {limit:.4g}), greedy {agree}/{Mmb * mb}; "
          f"crossings {Mmb} wires + {Mmb} logit rows a run; launches {launches}")
    for wm in ("raw", "reduced", "int4"):
        print(f"split pipeline: {wm} vs int8 logits max|d| "
              f"{float((out[wm, True] - out['int8', True]).abs().max()):.4g} "
              f"(no oracle, no bound)")
    for wm in SPLIT_WIRES:
        c = crossed[wm, True][0]
        print(f"split pipeline: {wm:8s} wire {c[3]} B a microbatch "
              f"({str(c[1]).replace('torch.', '')} {c[2]}); prefill wall "
              f"{walls[wm, True] / Mmb:.3f} ms a microbatch pipelined, "
              f"{walls[wm, False] / Mmb:.3f} serial")
    print(f"split pipeline: peak device memory {peak_gb:.2f} GB")
    return launches


def phase_dryrun_counts(runner, smi: str):
    """Phase 21a: the dry run's counts of a full-width qwen3-8b plain
    prefill of 1 x 128 tokens (phase 5's bank: 36 layers, bf16, no
    butterfly) on meta tensors equal those under the same counting mode on
    the card; its roofline terms beside the prefill's wall on the card
    (median of 5) and the peak device memory."""
    import torch
    from repro_torch.configs import InputShape
    from repro_torch.launch import dryrun, roofline
    from repro_torch.models import model as M
    bank = runner.bank
    shape = InputShape("prefill_128", 128, 1, "prefill")
    meta, meta_mem = dryrun.count_step(bank.built, shape, "meta")
    card, card_mem = dryrun.count_step(bank.built, shape, "cuda",
                                       params=bank.params)
    if (meta.flops, meta.bytes) != (card.flops, card.bytes):
        fail(f"dry run: meta counts {meta.flops} FLOPs {meta.bytes} B, on the "
             f"card {card.flops} FLOPs {card.bytes} B")
    rep = roofline.analyze(bank.base_cfg.name, shape.name, meta,
                           dryrun.model_flops(bank.base_cfg, shape), meta_mem)
    batch = dryrun.make_batch(bank.built, shape, torch.device("cuda"))
    M.forward_prefill(bank.params, bank.built, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(5):
        t = time.perf_counter()
        M.forward_prefill(bank.params, bank.built, batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    print(f"dry run: qwen3-8b plain prefill 1 x 128: meta == card counts, "
          f"{meta.flops} FLOPs, {meta.bytes} B over {meta.ops} aten ops "
          f"({card.ops} on the card)")
    print(f"dry run: roofline compute {rep.compute_s * 1e3:.4f} ms, memory "
          f"{rep.memory_s * 1e3:.4f} ms ({rep.bottleneck}), useful "
          f"{rep.useful_ratio:.3f}; measured wall {statistics.median(walls):.3f} "
          f"ms (median of 5, {smi}); traced peak "
          f"{meta_mem['peak_memory_in_bytes'] / 1e9:.2f} GB, the card's "
          f"max_memory_allocated {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")


def phase_launchers(smi: str):
    """Phase 21b: the launchers as a user runs them, as subprocesses on the
    default device (the card), all at once: ``launch.serve`` in engine mode
    and with ``--split`` on checkpoints saved here from the reduced
    config's weights (seed 5), ``examples.split_serving`` and
    ``launch.dryrun --arch qwen3-8b --shape decode_32k``, and the same with
    ``--both-meshes`` (rank 0 of the 16x16 and 2x16x16 grids in a fake
    world, records with collectives); meanwhile the
    reduced card-vs-CPU run of the split pipeline (``_split_parity``).
    Each must exit 0; serve prints one line a prompt, and --split's ids are
    the greedy tokens of the single-model forward_train on the same
    weights; split_serving's max |err| < 5e-3 (the JAX example test's
    bound) with int8 crossings."""
    import dataclasses
    import tempfile
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import tokenizer as tok
    from repro_torch.models import model as M
    from repro_torch.training.checkpoint import save_checkpoint
    prompts = ["the quick brown fox", "once upon a time", "edge and cloud",
               "butterfly wire"]
    cfg = get_config("qwen3-8b").reduced()
    cfg = dataclasses.replace(cfg, vocab_size=max(cfg.vocab_size, tok.VOCAB_SIZE))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    py = [sys.executable, "-m"]
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = {}
        for name, c in (("engine", cfg), ("split", cfg.with_butterfly(1, 32))):
            built = M.build(c)
            params = M.init_model(torch.Generator(device="cuda").manual_seed(5),
                                  built, device="cuda")
            ckpt[name] = save_checkpoint(f"{tmp}/{name}", params, step=1,
                                         metadata={"arch": c.name})
        cmds = {
            "serve": py + ["repro_torch.launch.serve", "--checkpoint",
                           ckpt["engine"], "--max-new-tokens", "8",
                           "--prompts", *prompts],
            "serve --split": py + ["repro_torch.launch.serve", "--split",
                                   "--checkpoint", ckpt["split"],
                                   "--prompts", *prompts],
            "split_serving": py + ["repro_torch.examples.split_serving"],
            "dryrun": py + ["repro_torch.launch.dryrun", "--arch", "qwen3-8b",
                            "--shape", "decode_32k", "--out", f"{tmp}/dryrun"],
            "dryrun --both-meshes": py + [
                "repro_torch.launch.dryrun", "--arch", "qwen3-8b", "--shape",
                "decode_32k", "--both-meshes", "--out", f"{tmp}/dryrun"],
        }
        t = time.perf_counter()
        procs = {k: subprocess.Popen(cmd, cwd=ROOT, env=env, text=True,
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE)
                 for k, cmd in cmds.items()}
        try:
            _split_parity()
            outs = {k: p.communicate(timeout=600) for k, p in procs.items()}
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t
        for k, p in procs.items():
            if p.returncode != 0:
                fail(f"launcher {k} exited {p.returncode}:\n{outs[k][1][-3000:]}")
        for mesh in ("1", "16-16", "2-16-16"):
            rec = Path(f"{tmp}/dryrun/qwen3-8b_decode_32k_{mesh}.json")
            if not rec.is_file():
                fail(f"the dry run wrote no record for mesh {mesh}")
            if mesh != "1":
                coll = json.loads(rec.read_text())["collectives"]
                if not coll["all-reduce"] or not coll["all-gather"]:
                    fail(f"the dry run's {mesh} record counts collectives {coll}")
    lines = {k: o[0].splitlines() for k, o in outs.items()}
    for k in ("serve", "serve --split"):
        rows = [l for l in lines[k] if " -> " in l]
        if len(rows) != len(prompts) or not lines[k][0].startswith("restored"):
            fail(f"launcher {k} printed {lines[k]}")
    ids = [int(l.split()[-1]) for l in lines["serve --split"] if " -> " in l]
    built = M.build(cfg.with_butterfly(1, 32))
    params = M.init_model(torch.Generator(device="cuda").manual_seed(5), built,
                          device="cuda")
    toks = torch.tensor(np.stack([np.resize(tok.encode(p), 32) for p in prompts]),
                        device="cuda")
    want = M.forward_train(params, built, {"tokens": toks})[0][:, -1].argmax(-1)
    if ids != want.tolist():
        fail(f"serve --split ids {ids}, forward_train's greedy tokens "
             f"{want.tolist()}")
    err = float(next(l for l in lines["split_serving"] if "max |err|" in l).split()[-1])
    n_int8 = int(next(l for l in lines["split_serving"]
                      if "int8 crossings" in l).split()[-1])
    if not (err < 5e-3 and n_int8 >= 1):
        fail(f"split_serving: max |err| {err}, {n_int8} int8 crossings")
    print(f"launchers: serve (engine), serve --split, split_serving and dryrun "
          f"as subprocesses on {smi}, all exited 0 in {wall:.1f} s together "
          f"(the split parity run included)")
    print(f"launchers: serve {lines['serve'][1:]}")
    print(f"launchers: serve --split ids {ids} == forward_train's greedy tokens")
    print(f"launchers: split_serving max |err| {err:.3g}, {n_int8} int8 "
          f"crossings; dryrun: {lines['dryrun'][0]}")
    for line in lines["dryrun --both-meshes"][:2]:
        print(f"launchers: dryrun --both-meshes: {line}")


# -------------------------------------------------------------------------- 22
# the model axis inside a pod: two model ranks, one process each, share this
# card over gloo (NCCL refuses two ranks on one device); each holds both
# pods' shards of its rank, and the wire crosses inside the process
MODEL_AXIS = dict(mp=2, Mmb=2, mb=4, S=128, T=8, lengths=(64, 80, 100, 128),
                  new_tokens=8)
# the reduced card-vs-CPU run at (pod=2, model=2): f32, no TF32
MODEL_AXIS_PARITY = dict(Mmb=2, mb=2, S=32, T=4, rtol=1e-4, atol=1e-5)


def _checksum(params) -> list:
    """Sums in f64 of the embedding's first rows and the last layer's wq and
    w_down (drawn after every other layer): the same seed gives the same
    weights in every process."""
    stage = params["stages"][0][0][0]
    return [float(a.double().sum()) for a in
            (params["embed"][:4096], stage["mixer"]["wq"][-1],
             stage["ffn"]["w_down"][-1])]


def _serve_recorded(runner, engine, prompts, new_tokens):
    """Phase 5's cache handoff, each request recording its per-step logits:
    (cloud logits, ids, per-step logits, wire bytes) per prompt."""
    import torch
    reqs, cloud, wire = [], [], []
    for toks in prompts:
        payload, scales, c0 = runner.edge_half(runner.params, toks[None])
        payload_h, scales_h = payload.cpu(), scales.cpu()          # the wire
        logits, c1 = runner.cloud_half(runner.params, payload_h.cuda(),
                                       scales_h.cuda())
        wire.append(payload_h.numel() * payload_h.element_size() +
                    scales_h.numel() * scales_h.element_size())
        cloud.append(logits[0].float().cpu().clone())
        reqs.append(engine.submit_prefilled(len(toks), [c0, c1], logits[0],
                                            max_new_tokens=new_tokens,
                                            record_logits=True))
    engine.run()
    torch.cuda.synchronize()
    return [dict(cloud=c, ids=list(r.generated),
                 steps=[torch.tensor(h) for h in r.logits_history], wire=w)
            for r, c, w in zip(reqs, cloud, wire)]


def model_axis_references(runner):
    """Phase 22's degree-1 side, on phase 5's qwen3-8b bank in this process:
    the split pipeline's int8 logits and its prefill wall a microbatch, the
    decode pipeline's ids (kernels, pipelined) and its tick, and the bank's
    served requests, all at phase 22's shapes; host copies."""
    import numpy as np
    import torch
    from repro_torch.serving.pipeline import make_split_pipeline
    c = MODEL_AXIS
    Mmb, mb, S, T = c["Mmb"], c["mb"], c["S"], c["T"]
    prompts = _prompts(Mmb * mb, (S,) * (Mmb * mb))
    toks = torch.tensor(np.stack(prompts), dtype=torch.int64, device="cuda")
    built, params = runner.stage_view()
    split = make_split_pipeline(built, ("cuda", "cuda"), Mmb, S, mb, "int8")
    split(params, toks)
    torch.cuda.synchronize()
    t = time.perf_counter()
    logits = split(params, toks)
    torch.cuda.synchronize()
    split_ms = (time.perf_counter() - t) * 1e3 / Mmb
    decode = runner.decode_pipeline(None, Mmb, S, mb, T, use_kernel=True)
    decode(toks)
    timings: dict = {}
    ids = decode(toks, timings)
    serve = _prompts(len(c["lengths"]), c["lengths"])
    engine = runner.make_engine(max_batch=4, max_len=256, seed=0)
    _serve_recorded(runner, engine, serve, 2)                      # warm-up
    served = _serve_recorded(runner, engine, serve, c["new_tokens"])
    return dict(prompts=prompts, serve=serve, checksum=_checksum(runner.params),
                d_r=runner.bank.d_r,
                split=logits.cpu(), split_ms=split_ms, ids=ids.cpu(),
                tick_ms=timings["decode_ms"] / timings["ticks"],
                prefill_ms=timings["prefill_ms"] / Mmb, served=served)


def _collective_ms(group, rows: int, reps: int = 20) -> float:
    """Median wall of one gloo all_reduce of a (rows, 4096) bf16 tensor on
    the card, the host synchronised around each call."""
    import torch
    import torch.distributed as dist
    x = torch.ones((rows, D), dtype=torch.bfloat16, device="cuda")
    times = []
    for i in range(reps + 3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        dist.all_reduce(x, group=group)
        torch.cuda.synchronize()
        if i >= 3:
            times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def _axis_family(kind: str):
    """Phase 22's reduced f32 configs: dense qwen3, qwen3-moe at 4 experts
    top-2, zamba2 at 4 layers (its shared block sharded)."""
    import dataclasses
    from repro_torch.configs import get_config
    if kind == "moe":
        cfg = get_config("qwen3-moe-235b-a22b").reduced()
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, num_experts=4, top_k=2))
    elif kind == "zamba2":
        cfg = dataclasses.replace(get_config("zamba2-7b").reduced(), num_layers=4)
    else:
        cfg = get_config("qwen3-8b").reduced()
    return dataclasses.replace(cfg, dtype="float32").with_butterfly(1, 16)


def _model_axis_parity(mp: int) -> list:
    """The reduced families at (pod=2, model=mp) on the card and on the CPU
    from one CPU init: split-pipeline logits, decode-pipeline ids (kernels
    on the card, their plain versions on the CPU) and every MoE route."""
    import numpy as np
    import torch
    from repro_torch.models import model as M
    from repro_torch.serving.pipeline import (make_decode_pipeline,
                                              make_split_pipeline)
    from repro_torch.tree import tree_map
    c = MODEL_AXIS_PARITY
    out = []
    for kind in ("dense", "moe", "zamba2"):
        built = M.build(_axis_family(kind))
        params = M.init_model(torch.Generator().manual_seed(0), built,
                              device="cpu")
        toks = np.random.default_rng(1).integers(
            0, built.cfg.vocab_size, (c["Mmb"] * c["mb"], c["S"]))
        runs = {}
        for dev in ("cpu", "cuda"):
            pods = ((f"{dev}:0" if dev == "cuda" else dev,) * mp,) * 2
            p = params if dev == "cpu" else tree_map(lambda t: t.cuda(), params)
            with _Routes() as r:
                logits = make_split_pipeline(built, pods, c["Mmb"], c["S"],
                                             c["mb"])(p, toks)
                ids = make_decode_pipeline(built, pods, c["Mmb"], c["S"],
                                           c["mb"], c["T"], use_kernel=True)(p, toks)
            runs[dev] = (logits.cpu(), ids.cpu(), [e.cpu() for e in r.eids])
        (lc, ic, ec), (lg, ig, eg) = runs["cpu"], runs["cuda"]
        torch.testing.assert_close(lg, lc, rtol=c["rtol"], atol=c["atol"])
        if not torch.equal(ig, ic):
            raise AssertionError(f"{kind}: decode ids {ig.tolist()} on the card, "
                                 f"{ic.tolist()} on the CPU")
        if len(ec) != len(eg) or not all(torch.equal(a, b) for a, b in zip(ec, eg)):
            raise AssertionError(f"{kind}: the card routes a choice to another "
                                 f"expert than the CPU")
        out.append(dict(kind=kind, max_err=float((lg - lc).abs().max()),
                        routes=sum(e.numel() for e in ec)))
    return out


def _model_axis_rank(rank, device, refs):
    """One model rank of phase 22 (spawned; see phase_model_axis)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import parallel
    from repro_torch.runtime.split_exec import SplitModelBank
    from repro_torch.serving.pipeline import make_pods, make_split_pipeline
    c = MODEL_AXIS
    mp, Mmb, mb, S, T = c["mp"], c["Mmb"], c["mb"], c["S"], c["T"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"parity": _model_axis_parity(mp)}
    cfg = get_config("qwen3-8b")
    t0 = time.perf_counter()
    bank = SplitModelBank(cfg, max(16, cfg.d_model // 64), wire_mode="int8",
                          seed=0, device="cuda")
    runner = bank.runner(cfg.num_layers // 8)
    torch.cuda.synchronize()
    out.update(init_s=time.perf_counter() - t0, checksum=_checksum(bank.params))
    peak = {"bank": torch.cuda.max_memory_allocated() / 1e9}
    pods = ((f"cuda:{torch.cuda.current_device()}",) * mp,) * 2
    toks = torch.tensor(np.stack(refs["prompts"]), dtype=torch.int64,
                        device="cuda")

    # the split (prefill) pipeline, int8: no kernel, as in the reference
    built, params = runner.stage_view()
    split = make_split_pipeline(built, pods, Mmb, S, mb, "int8")
    split(params, toks)
    _zero_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    out["split"] = split(params, toks).cpu()
    torch.cuda.synchronize()
    out["split_ms"] = (time.perf_counter() - t) * 1e3 / Mmb
    out["split_launches"] = _counts()
    peak["split pipeline"] = torch.cuda.max_memory_allocated() / 1e9

    # the decode pipeline with the kernels, pipelined and serial, overlap_psum
    # off and on
    runner.decode_pipeline(pods, Mmb, S, mb, 2, use_kernel=True)(toks)
    out["decode"] = {}
    for pipelined in (True, False):
        for overlap in (False, True):
            run = runner.decode_pipeline(pods, Mmb, S, mb, T,
                                         pipelined=pipelined, use_kernel=True,
                                         overlap_psum=overlap)
            timings: dict = {}
            _zero_counts()
            ids = run(toks, timings)
            torch.cuda.synchronize()
            out["decode"][pipelined, overlap] = dict(
                ids=ids.cpu(), launches=_counts(),
                tick_ms=timings["decode_ms"] / timings["ticks"],
                prefill_ms=timings["prefill_ms"] / Mmb)

    peak["decode pipeline"] = torch.cuda.max_memory_allocated() / 1e9

    # the bank, edge at degree 1 and cloud at degree mp, through the engine
    hetero = bank.runner(runner.split, edge_mp=1, cloud_mp=mp)
    engine = hetero.make_engine(max_batch=4, max_len=256, seed=0)
    serve = [np.asarray(p) for p in refs["serve"]]
    _serve_recorded(hetero, engine, serve, 2)                      # warm-up
    _zero_counts()
    out["served"] = _serve_recorded(hetero, engine, serve, c["new_tokens"])
    out["served_launches"] = _counts()
    out["served_steps"] = c["new_tokens"] - 1

    group = make_pods(pods)[1].pctx.group
    out["all_reduce_ms"] = {rows: _collective_ms(group, rows)
                            for rows in (mb, mb * S)}
    peak["bank serving"] = torch.cuda.max_memory_allocated() / 1e9
    out.update(peak_gb=peak, held_gb=torch.cuda.memory_allocated() / 1e9)
    out["kv_heads"] = engine.cache[1][0][0]["kv"]["k"].shape[3]
    return out


def _hold_served(what: str, got: dict, want: dict) -> int:
    """Degree mp's served request against degree 1's: each step's logits
    within 5% of the reference's largest while the ids agree, and the ids
    equal unless the reference's top two at a step lie within that bound
    (then the rest is not compared).  Returns the steps compared."""
    import torch
    # the first row is the cloud half's logits, which give id 0
    rows = list(zip(got["steps"], want["steps"]))
    for j, (g, w) in enumerate(rows):
        _hold_logits(f"{what} step {j}", g, w)
        if got["ids"][j] != want["ids"][j]:
            top = w.float().topk(2).values
            if float(top[0] - top[1]) > _limit(w):
                fail(f"{what}: id {j} is {got['ids'][j]}, degree 1's "
                     f"{want['ids'][j]}, whose top two are further apart "
                     f"than the bound")
            return j + 1
    return len(rows)


def phase_model_axis(refs, smi: str):
    """Phase 22: the model axis inside a pod on one card.  Two model ranks,
    one spawned process each, share the card over gloo; each builds phase
    5's qwen3-8b bank from seed 0 (the same weights, checked) and runs at
    (pod=2, model=2), half the heads, kv heads and d_ff columns of both
    pods a rank:
      * the split pipeline, int8, 2 microbatches of 4 x 128: logits within
        phase 5's 5% of degree 1's largest, the same greedy tokens unless
        degree 1's top two lie within that bound, equal on both ranks;
      * the decode pipeline with the kernels, 2 x 4 x 128, T = 8, pipelined
        and serial, overlap_psum off and on: pipelined ids == serial ids and
        overlap_psum on == off, bit for bit, on both ranks, and exactly
        Mmb + Mmb * (T - 1) launches of reduce_quant and restore_norm per
        rank a run;
      * the bank at edge_mp=1, cloud_mp=2: 4 prompts of 64-128 tokens
        through edge_half -> host wire -> cloud_half into the engine, 8
        tokens each, held step by step to degree 1's (see _hold_served),
        exact wire bytes, reduce_quant and dequant_restore once a prefill
        and once a decode step per rank;
    and first the reduced card-vs-CPU run (see _model_axis_parity).  Prints
    one gloo all_reduce at a decode row and a prefill microbatch, the tick
    and microbatch walls beside degree 1's, and each rank's peak.  Returns
    the launches summed over the ranks."""
    import torch
    from repro_torch.models import parallel
    c = MODEL_AXIS
    mp, Mmb, mb, T = c["mp"], c["Mmb"], c["mb"], c["T"]
    t0 = time.perf_counter()
    ranks = parallel.spawn(_model_axis_rank, mp, (refs,),
                           devices=f"cuda:{torch.cuda.current_device()}")
    wall = time.perf_counter() - t0
    print(f"model axis: (pod=2, model={mp}), {mp} ranks on {smi} over gloo; "
          f"{wall:.1f} s with the spawn; qwen3-8b init {ranks[0]['init_s']:.1f} s "
          f"a rank")
    for r, out in enumerate(ranks):
        if out["checksum"] != refs["checksum"]:
            fail(f"model axis: rank {r}'s weights {out['checksum']} are not "
                 f"degree 1's {refs['checksum']}")
    for row in ranks[0]["parity"]:
        print(f"model axis: reduced {row['kind']} f32 card vs CPU at (2, {mp}): "
              f"split logits max|d| {row['max_err']:.3g} (rtol "
              f"{MODEL_AXIS_PARITY['rtol']}), decode ids equal, "
              f"{row['routes']} MoE routes equal")
    launches = {k: 0 for k in _counts()}
    per_run = Mmb + Mmb * (T - 1)
    for r, out in enumerate(ranks):
        if any(out["split_launches"].values()):
            fail(f"model axis: the split pipeline launched {out['split_launches']}")
        got = out["split"]
        if not torch.equal(got, ranks[0]["split"]):
            fail("model axis: the ranks' split-pipeline logits differ")
        for k in range(Mmb * mb):
            _hold_logits(f"model axis: split pipeline row {k} vs degree 1",
                         got[k], refs["split"][k], witness=0.0, greedy=True)
        runs = out["decode"]
        base = runs[True, False]["ids"]
        for key, run in runs.items():
            want = dict.fromkeys(run["launches"], 0)
            want["butterfly_reduce_quant"] = want["butterfly_dequant_restore_norm"] = per_run
            if run["launches"] != want:
                fail(f"model axis rank {r}: decode pipeline {key} launched "
                     f"{run['launches']}, expected {want}")
            if not torch.equal(run["ids"], base) or \
                    not torch.equal(run["ids"], ranks[0]["decode"][True, False]["ids"]):
                fail(f"model axis rank {r}: decode pipeline (pipelined, "
                     f"overlap_psum) = {key} ids differ from (True, False)'s")
            for name, v in run["launches"].items():
                launches[name] += v
        steps = out["served_steps"]
        want = dict.fromkeys(out["served_launches"], 0)
        want["butterfly_reduce_quant"] = want["butterfly_dequant_restore"] = \
            len(c["lengths"]) + steps
        if out["served_launches"] != want:
            fail(f"model axis rank {r}: the bank launched "
                 f"{out['served_launches']}, expected {want}")
        for name, v in out["served_launches"].items():
            launches[name] += v
        for i, (s, g, w) in enumerate(zip(refs["serve"], out["served"],
                                          refs["served"])):
            if g["wire"] != len(s) * (refs["d_r"] + 4):
                fail(f"model axis: {g['wire']} wire bytes for S={len(s)}")
            if g["ids"] != ranks[0]["served"][i]["ids"]:
                fail("model axis: the ranks' served ids differ")
            n = _hold_served(f"model axis rank {r}: S={len(s)}", g, w)
            if r == 0:
                print(f"model axis: bank edge_mp=1 cloud_mp={mp} S={len(s)} ids "
                      f"{g['ids']} (degree 1 {w['ids']}), {n} steps held to "
                      f"degree 1's logits")
    split_d = float((ranks[0]["split"] - refs["split"]).abs().max())
    agree = float((ranks[0]["decode"][True, False]["ids"] == refs["ids"]).float().mean())
    print(f"model axis: split pipeline int8 max|degree 2 - degree 1| "
          f"{split_d:.4g} (limit {_limit(refs['split']):.4g}); decode ids "
          f"pipelined == serial and overlap_psum on == off on both ranks, "
          f"{agree:.3f} of them equal to degree 1's; kv heads a rank "
          f"{ranks[0]['kv_heads']}")
    print(f"model axis: launches a rank a decode run {per_run} reduce_quant + "
          f"{per_run} restore_norm; bank {len(c['lengths'])} + "
          f"{ranks[0]['served_steps']} reduce_quant and dequant_restore")
    for key, run in ranks[0]["decode"].items():
        print(f"model axis: decode pipeline pipelined={key[0]} overlap_psum="
              f"{key[1]}: {run['tick_ms']:.3f} ms a tick, prefill "
              f"{run['prefill_ms']:.3f} ms a microbatch")
    print(f"model axis: degree 2 vs degree 1 on {smi}: decode tick "
          f"{ranks[0]['decode'][True, False]['tick_ms']:.3f} vs "
          f"{refs['tick_ms']:.3f} ms, decode-pipeline prefill "
          f"{ranks[0]['decode'][True, False]['prefill_ms']:.3f} vs "
          f"{refs['prefill_ms']:.3f} ms a microbatch, split-pipeline "
          f"microbatch {ranks[0]['split_ms']:.3f} vs {refs['split_ms']:.3f} ms")
    for rows, ms in ranks[0]["all_reduce_ms"].items():
        print(f"model axis: gloo all_reduce of ({rows}, {D}) bf16 on the card: "
              f"{ms:.3f} ms (rank 0, median of 20)")
    for r, out in enumerate(ranks):
        print(f"model axis: rank {r} peak device memory after "
              + ", ".join(f"{k} {v:.2f}" for k, v in out["peak_gb"].items())
              + f" GB; {out['held_gb']:.2f} GB held at the end (the whole "
              f"backbone: the degree-1 edge needs it, the shards are views)")
    return launches


# -------------------------------------------------------------------------- 23
# the automatic regime: qwen3-moe-235b-a22b at its published widths cut to 2
# of its 94 layers (12.44 GB: 9.66 of experts, 0.29 of attention, 2.49 of
# embedding and head; 4 layers would need about 90 GB for four ranks), with
# the butterfly after layer 1 at d_r 64, as 4 ranks at (data=2, model=2)
# sharing the card over gloo.  Each rank holds the whole model and runs views
# of its shards: half the heads and kv heads, 64 of the 128 experts, half of
# each expert's d_ff (all-gathered over data a layer at a time, 2.4 GB)
AUTO = dict(layers=2, d_r=64, prompts=4, S=128, steps=8, gather_steps=2)
AUTO_GRID = ((2, 2), ("data", "model"))
# the reduced f32 card-vs-CPU run on the same ranks, and its grid with experts
# over the pod axis (prefill only)
AUTO_PARITY = dict(B=4, S=32, T=4, train_steps=4, rtol=1e-4, atol=1e-5)
AUTO_POD_GRID = ((2, 1, 2), ("pod", "data", "model"))


def _auto_cfg():
    import dataclasses
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("qwen3-moe-235b-a22b"),
                              num_layers=AUTO["layers"])
    return cfg.with_butterfly(1, AUTO["d_r"])


def _auto_parity_cfg(butterfly: bool):
    """Reduced qwen3-moe in f32 with 8 heads and 4 kv heads (4 experts,
    top-2, the default capacity factor 1.25)."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("qwen3-moe-235b-a22b").reduced(),
                              num_heads=8, num_kv_heads=4, dtype="float32")
    return cfg.with_butterfly(1, 16) if butterfly else cfg


def _auto_checksum(params) -> list:
    """f64 sums of slices drawn first and last: the same seed gives the
    same weights in every process."""
    ffn = params["stages"][1][0][0]["ffn"]
    return [float(a.double().sum()) for a in
            (params["embed"][:4096], ffn["wd"][-1, -1], params["head"][-4096:])]


def _auto_serve(params, built, pctx, toks, T):
    """Kernel prefill of ``toks`` and T greedy kernel decode steps under
    ``pctx``, every MoE route recorded: (prefill logits, decode logits,
    ids, routes), on the host."""
    import torch
    from repro_torch.models import model as M
    with _Routes() as r:
        logits, caches = M.forward_prefill(params, built, {"tokens": toks}, pctx,
                                           use_kernel=True)
        caches = M.pad_decode_caches(built, caches, toks.shape[1] + T, pctx)
        tok, steps, ids = logits[:, -1].argmax(-1, keepdim=True), [], []
        for i in range(T):
            lg, caches = M.forward_decode(params, built, tok, caches,
                                          toks.shape[1] + i, pctx, use_kernel=True)
            tok = lg[:, -1].argmax(-1, keepdim=True)
            steps.append(lg[:, 0].cpu())
            ids.append(tok[:, 0].cpu())
    return (logits[:, 0].cpu(), torch.stack(steps), torch.stack(ids),
            [e.cpu() for e in r.eids])


def _same_routes(what: str, a: list, b: list) -> int:
    import torch
    if len(a) != len(b) or not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError(f"{what}: the card routes a choice to another "
                             f"expert than the CPU")
    return sum(x.numel() for x in a)


def _auto_parity() -> dict:
    """Phase 23's check 4 on this rank: reduced qwen3-moe in f32 (no TF32)
    from one CPU init, on the card and on the CPU over the same gloo world:
    at (data=2, model=2) a kernel prefill, 4 greedy kernel decode steps and
    4 training steps (no butterfly); at (pod=2, data=1, model=2) with
    experts over the pod axis a kernel prefill.  Logits rtol 1e-4 (atol
    1e-5), ids and every route equal, losses and grad norms rtol 1e-4;
    raises (and so fails the spawn) otherwise."""
    import numpy as np
    import torch
    from repro_torch.data import shard_batch
    from repro_torch.models import model as M
    from repro_torch.models import moe, parallel
    from repro_torch.training import (AdamWConfig, adamw_init, cosine_schedule,
                                      make_train_step)
    from repro_torch.tree import tree_map
    c = AUTO_PARITY
    close = lambda a, b: torch.testing.assert_close(a, b, rtol=c["rtol"],
                                                    atol=c["atol"])
    out = {}
    rng = np.random.default_rng(1)
    built = M.build(_auto_parity_cfg(True))
    params = M.init_model(torch.Generator().manual_seed(0), built, device="cpu")
    toks = rng.integers(0, built.cfg.vocab_size, (c["B"], c["S"] + 1))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:].copy()}
    batch["targets"][0, :5] = -1
    tb = M.build(_auto_parity_cfg(False))
    tparams = M.init_model(torch.Generator().manual_seed(0), tb, device="cpu")
    grid = parallel.RankGrid(*AUTO_GRID)
    pctx = parallel.make_context(grid)
    runs = {}
    for dev in ("cpu", "cuda"):
        mine = tree_map(lambda t: t.to(dev), parallel.shard_grid(
            params, M.param_specs(built, grid), grid))
        served = _auto_serve(mine, built, pctx, shard_batch(
            {"t": batch["tokens"]}, pctx, device=dev)["t"], c["T"])
        step = make_train_step(tb, AdamWConfig(lr=cosine_schedule(1e-3, 2, c["train_steps"])),
                               pctx)
        tp = tree_map(lambda t: t.to(dev, copy=True), parallel.shard_grid(
            tparams, M.param_specs(tb, grid), grid))
        opt = adamw_init(tp)
        b = shard_batch(batch, pctx, device=dev)
        metrics = []
        with _Routes() as r:
            for _ in range(c["train_steps"]):
                tp, opt, m = step(tp, opt, b)
                metrics.append((float(m["loss"]), float(m["grad_norm"])))
        runs[dev] = served + (metrics, [e.cpu() for e in r.eids])
    (pc, dc, ic, rc, mc, tc), (pg, dg, ig, rg, mg, tg) = runs["cpu"], runs["cuda"]
    close(pg, pc)
    close(dg, dc)
    if not torch.equal(ig, ic):
        raise AssertionError(f"reduced decode ids {ig.tolist()} on the card, "
                             f"{ic.tolist()} on the CPU")
    out["routes"] = _same_routes("reduced prefill and decode", rg, rc)
    out["train_routes"] = _same_routes("reduced training", tg, tc)
    for (lg_, ng), (lc_, nc) in zip(mg, mc):
        if not (math.isclose(lg_, lc_, rel_tol=c["rtol"]) and
                math.isclose(ng, nc, rel_tol=c["rtol"])):
            raise AssertionError(f"reduced training: loss, grad norm {lg_}, {ng} "
                                 f"on the card, {lc_}, {nc} on the CPU")
    out["losses"] = [m[0] for m in mg]
    out["err"] = max(float((pg - pc).abs().max()), float((dg - dc).abs().max()))
    # experts over the pod axis, (pod=2, data=1, model=2): a prefill
    over = moe.EXPERTS_OVER_POD
    moe.EXPERTS_OVER_POD = True
    try:
        grid = parallel.RankGrid(*AUTO_POD_GRID)
        pctx = parallel.make_context(grid)
        pod = {}
        for dev in ("cpu", "cuda"):
            mine = tree_map(lambda t: t.to(dev), parallel.shard_grid(
                params, M.param_specs(built, grid), grid))
            with _Routes() as r:
                logits, _ = M.forward_prefill(mine, built, shard_batch(
                    {"tokens": batch["tokens"]}, pctx, device=dev), pctx,
                    use_kernel=True)
            pod[dev] = (logits.cpu(), [e.cpu() for e in r.eids])
    finally:
        moe.EXPERTS_OVER_POD = over
    close(pod["cuda"][0], pod["cpu"][0])
    out["pod_routes"] = _same_routes("reduced experts over pod", pod["cuda"][1],
                                     pod["cpu"][1])
    out["pod_err"] = float((pod["cuda"][0] - pod["cpu"][0]).abs().max())
    return out


def _gather_ms(group, shape, reps: int = 3) -> float:
    """Median wall of one gloo all_gather over ``group`` of a bf16 tensor of
    ``shape`` on the card (an expert weight's d_ff block), the host
    synchronised around each call."""
    import torch
    from repro_torch.models import parallel
    x = torch.ones(shape, dtype=torch.bfloat16, device="cuda")
    times = []
    for i in range(reps + 1):
        torch.cuda.synchronize()
        t = time.perf_counter()
        parallel.all_gather(x, len(shape) - 1, group)
        torch.cuda.synchronize()
        if i:
            times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def _auto_decode(params, built, pctx, caches, first, n):
    """n greedy kernel decode steps from ``first``: each step's logits,
    input tokens, routes and wall on the host."""
    import torch
    from repro_torch.models import model as M
    S = AUTO["S"]
    tok, steps, inputs, ms = first, [], [], []
    with _Routes() as r:
        for i in range(n):
            inputs.append(tok.cpu())
            torch.cuda.synchronize()
            t = time.perf_counter()
            lg, caches = M.forward_decode(params, built, tok, caches, S + i, pctx,
                                          use_kernel=True)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
            steps.append(lg[:, 0].float().cpu())
            tok = lg[:, -1].argmax(-1, keepdim=True)
    return dict(steps=steps, inputs=inputs, ms=ms,
                routes=[(e.cpu(), p.cpu()) for e, p in zip(r.eids, r.pos)])


def _auto_rank(rank, device):
    """One rank of phase 23 (spawned; see phase_automatic)."""
    import numpy as np
    import torch
    from repro_torch.data import shard_batch
    from repro_torch.models import model as M
    from repro_torch.models import moe, parallel
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(2)          # four ranks share the host's eight cores
    c = AUTO
    t_parity = time.perf_counter()
    out = {"parity": _auto_parity()}
    out["parity_s"] = time.perf_counter() - t_parity
    grid = parallel.RankGrid(*AUTO_GRID)
    pctx = parallel.make_context(grid)
    built = M.build(_auto_cfg())
    t0 = time.perf_counter()
    params = M.init_model(torch.Generator(device="cuda").manual_seed(0), built,
                          device="cuda")
    torch.cuda.synchronize()
    out.update(init_s=time.perf_counter() - t0, checksum=_auto_checksum(params))
    mine = parallel.shard_grid(params, M.param_specs(built, grid), grid)
    prompts = np.stack(_prompts(c["prompts"], (c["S"],) * c["prompts"]))
    toks = shard_batch({"tokens": prompts}, pctx)["tokens"]
    M.forward_prefill(mine, built, {"tokens": toks}, pctx, use_kernel=True)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    with _Routes() as r:
        logits, caches = M.forward_prefill(mine, built, {"tokens": toks}, pctx,
                                           use_kernel=True)
    torch.cuda.synchronize()
    out["prefill_ms"] = (time.perf_counter() - t) * 1e3
    out["prefill"] = logits[:, 0].float().cpu()
    out["prefill_routes"] = [(e.cpu(), p.cpu()) for e, p in zip(r.eids, r.pos)]
    out["prefill_launches"] = _counts()
    first = logits[:, -1].argmax(-1, keepdim=True)
    L = c["S"] + c["steps"]
    out["decode"] = _auto_decode(mine, built, pctx,
                                 M.pad_decode_caches(built, caches, L, pctx),
                                 first, c["steps"])
    broadcast = moe.DECODE_BROADCAST
    moe.DECODE_BROADCAST = False                  # the weight-gather path at S == 1
    try:
        out["gather"] = _auto_decode(mine, built, pctx,
                                     M.pad_decode_caches(built, caches, L, pctx),
                                     first, c["gather_steps"])
    finally:
        moe.DECODE_BROADCAST = broadcast
    torch.cuda.synchronize()
    out["launches"] = _counts()
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["kv_heads"] = caches[0][0][0]["kv"]["k"].shape[3]
    E, d, F = built.cfg.moe.num_experts, built.cfg.d_model, built.cfg.moe.d_ff_expert
    out["all_gather_ms"] = _gather_ms(grid.group("data"), (E // 2, d, F // 2))
    out["all_reduce_ms"] = {rows: _collective_ms(pctx.group, rows)
                            for rows in (c["prompts"] // 2, c["prompts"] // 2 * c["S"])}
    return out


def _forced(routes, device="cuda"):
    """A recorded run's (eids, pos) per MoE call, as ``_Routes(forced=)``
    takes them."""
    import types
    return types.SimpleNamespace(eids=[e.to(device) for e, _ in routes],
                                 pos=[p.to(device) for _, p in routes])


def _auto_ref_decode(params, built, caches, inputs, routes):
    """The one-process decode, teacher-forced with the sharded run's
    inputs and taking its routes: each step's logits and its wall."""
    import torch
    from repro_torch.models import model as M
    steps, ms = [], []
    with _Routes(forced=_forced(routes)):
        for i, tok in enumerate(inputs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            lg, caches = M.forward_decode(params, built, tok.cuda(), caches,
                                          AUTO["S"] + i, use_kernel=True)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
            steps.append(lg[:, 0].float().cpu())
    return steps, ms


def phase_automatic(smi: str):
    """Phase 23: the automatic regime on one card.  Four ranks, one spawned
    process each, share the card over gloo at (data=2, model=2); each
    builds full-width qwen3-moe cut to 2 layers from seed 0 (the same
    weights, checked), takes its shards and its data block of 4 prompts of
    128 tokens (2 a block, ``shard_batch``), and runs:
      1. a kernel prefill: each block's last-position logits within phase
         5's 5% of a one-process run of that block's 2 prompts alone (the
         same weights and kernels, and the per-shard capacity the automatic
         branch has), taking the sharded run's routes (the unforced
         agreement printed); the greedy tokens equal unless the
         reference's top two lie within the bound; the block's two model
         ranks bit for bit;
      2. 8 greedy kernel decode steps from the padded prefill caches, all 4
         sequences in each step across the data ranks (the decode
         broadcast): each step's logits held as above to a one-process
         decode of the whole batch of 4 (the same global capacity) from
         the reference's prefill caches, fed the sharded run's tokens and
         taking its routes; then 2 steps with the broadcast off (the
         weight gather at S == 1), held the same way to each block's
         one-process decode;
      3. launches a rank exactly: 2 flash (one an attention layer of the
         prefill, on the rank's 32 q and 2 kv heads), and reduce_quant and
         dequant_restore once a prefill and once a decode step;
      4. first, the reduced f32 card-vs-CPU run (see _auto_parity).
    Prints each rank's peak, the prefill wall and the decode wall a step
    beside the one-process run's, one gloo all_gather of an expert's d_ff
    block and one all_reduce at a decode row and a prefill block, and the
    phase's seconds.  Returns the launches summed over the ranks."""
    import numpy as np
    import torch
    from repro_torch.models import model as M
    from repro_torch.tree import tree_map
    c = AUTO
    t0 = time.perf_counter()
    from repro_torch.models import parallel
    ranks = parallel.spawn(_auto_rank, 4, (),
                           devices=f"cuda:{torch.cuda.current_device()}")
    wall = time.perf_counter() - t0
    p = ranks[0]["parity"]
    print(f"automatic: 4 ranks at (data=2, model=2) on {smi} over gloo, "
          f"{wall:.1f} s with the spawn; reduced f32 card vs CPU "
          f"({ranks[0]['parity_s']:.1f} s): logits max|d| {p['err']:.3g}, "
          f"{p['routes']} prefill/decode and {p['train_routes']} training "
          f"routes equal, decode ids equal, 4 training steps' losses "
          f"{[round(x, 4) for x in p['losses']]} and grad norms within rtol "
          f"{AUTO_PARITY['rtol']}; (pod=2, data=1, model=2) experts over pod "
          f"prefill max|d| {p['pod_err']:.3g}, {p['pod_routes']} routes equal")
    built = M.build(_auto_cfg())
    params = M.init_model(torch.Generator(device="cuda").manual_seed(0), built,
                          device="cuda")
    want_sum = _auto_checksum(params)
    for r, out in enumerate(ranks):
        if out["checksum"] != want_sum:
            fail(f"automatic: rank {r}'s weights {out['checksum']} are not the "
                 f"reference's {want_sum}")
    # launches, exact a rank
    want = dict.fromkeys(ranks[0]["launches"], 0)
    want["flash_attention"] = c["layers"]
    want["butterfly_reduce_quant"] = want["butterfly_dequant_restore"] = \
        1 + c["steps"] + c["gather_steps"]
    launches = dict.fromkeys(want, 0)
    for r, out in enumerate(ranks):
        if out["launches"] != want:
            fail(f"automatic rank {r}: launched {out['launches']}, expected {want}")
        for k, v in out["launches"].items():
            launches[k] += v
    prompts = np.stack(_prompts(c["prompts"], (c["S"],) * c["prompts"]))
    toks = torch.tensor(prompts, device="cuda")
    half = c["prompts"] // 2
    # 1. prefill: each data block against its 2 prompts alone
    ref_caches, agree, total = [], 0, 0
    prefill_d = 0.0
    for blk in range(2):
        q = blk * 2                          # the block's model rank 0
        for m in (0, 1):
            if not torch.equal(ranks[q + m]["prefill"], ranks[q]["prefill"]):
                fail(f"automatic: block {blk}'s model ranks give different "
                     f"prefill logits")
        rows = toks[blk * half:(blk + 1) * half]
        with _Routes(forced=_forced(ranks[q]["prefill_routes"])):
            lf, cf = M.forward_prefill(params, built, {"tokens": rows},
                                       use_kernel=True)
        with _Routes() as ru:
            lu, _ = M.forward_prefill(params, built, {"tokens": rows},
                                      use_kernel=True)
        for (e, _), eu in zip(ranks[q]["prefill_routes"], ru.eids):
            agree += int((e == eu.cpu()).sum())
            total += e.numel()
        ref_caches.append(cf)
        for i in range(half):
            dlt, limit = _hold_logits(f"automatic prefill block {blk} row {i}",
                                      ranks[q]["prefill"][i], lf[i, 0].float().cpu(),
                                      witness=0.0, greedy=True)
            prefill_d = max(prefill_d, dlt)
        unforced = float((ranks[q]["prefill"] - lu[:, 0].float().cpu()).abs().max())
    # the one-process prefill of all 4 prompts, timed warm
    M.forward_prefill(params, built, {"tokens": toks}, use_kernel=True)
    torch.cuda.synchronize()
    t = time.perf_counter()
    M.forward_prefill(params, built, {"tokens": toks}, use_kernel=True)
    torch.cuda.synchronize()
    one_prefill_ms = (time.perf_counter() - t) * 1e3
    print(f"automatic: kernel prefill 4 x {c['S']} tokens, each data block within "
          f"{prefill_d:.4g} of its 2 prompts alone (limit {limit:.4g}, the "
          f"sharded run's routes), greedy tokens held; unforced, "
          f"{agree / total:.4f} of {total} routes agree (last block max|d| "
          f"{unforced:.4g}); model ranks bit for bit")
    # 2. decode broadcast against the whole batch of 4
    L = c["S"] + c["steps"]
    whole = tree_map(lambda a, b: torch.cat([a, b], dim=1), *ref_caches)
    inputs = [torch.cat([ranks[0]["decode"]["inputs"][i],
                         ranks[2]["decode"]["inputs"][i]])
              for i in range(c["steps"])]
    ref, ref_ms = _auto_ref_decode(params, built, M.pad_decode_caches(built, whole, L),
                                   inputs, ranks[0]["decode"]["routes"])
    decode_d = 0.0
    for blk in range(2):
        q = blk * 2
        for i in range(c["steps"]):
            got = ranks[q]["decode"]["steps"][i]
            if not torch.equal(got, ranks[q + 1]["decode"]["steps"][i]):
                fail(f"automatic: block {blk}'s model ranks decode differently")
            for j in range(half):
                dlt, _ = _hold_logits(f"automatic decode step {i} block {blk} row {j}",
                                      got[j], ref[i][blk * half + j],
                                      witness=0.0, greedy=True)
                decode_d = max(decode_d, dlt)
    # the weight gather at S == 1 against each block alone
    gather_d = 0.0
    for blk in range(2):
        q = blk * 2
        g = ranks[q]["gather"]
        steps, _ = _auto_ref_decode(params, built,
                                    M.pad_decode_caches(built, ref_caches[blk], L),
                                    g["inputs"], g["routes"])
        for i, want_i in enumerate(steps):
            for j in range(half):
                dlt, _ = _hold_logits(f"automatic gather-decode step {i} block "
                                      f"{blk} row {j}", g["steps"][i][j], want_i[j],
                                      witness=0.0, greedy=True)
                gather_d = max(gather_d, dlt)
    ms = ranks[0]["decode"]["ms"][1:]
    print(f"automatic: decode broadcast {c['steps']} steps of 4 sequences, max|d| "
          f"{decode_d:.4g} from the whole batch's one-process decode; broadcast "
          f"off ({c['gather_steps']} steps, the weight gather) max|d| "
          f"{gather_d:.4g} from each block's; launches a rank {want}")
    print(f"automatic on {smi}: prefill {ranks[0]['prefill_ms']:.1f} ms (4 ranks, "
          f"2 prompts a block) vs {one_prefill_ms:.1f} ms one process; decode "
          f"{statistics.median(ms):.1f} ms a step (median of {len(ms)}) vs "
          f"{statistics.median(ref_ms[1:]):.1f} ms one process; broadcast off "
          f"{statistics.median(ranks[0]['gather']['ms']):.1f} ms a step")
    ar = ranks[0]["all_reduce_ms"]
    print(f"automatic: gloo all_gather of an expert d_ff block "
          f"({built.cfg.moe.num_experts // 2}, {built.cfg.d_model}, "
          f"{built.cfg.moe.d_ff_expert // 2}) bf16 over data "
          f"{ranks[0]['all_gather_ms']:.1f} ms; all_reduce over model "
          + ", ".join(f"({rows}, {D}) {v:.3f} ms" for rows, v in ar.items())
          + " (rank 0, medians)")
    for r, out in enumerate(ranks):
        print(f"automatic: rank {r} init {out['init_s']:.1f} s, kv heads "
              f"{out['kv_heads']}, peak {out['peak_gb']:.2f} GB")
    print(f"automatic: phase {time.perf_counter() - t0:.1f} s")
    return launches


# -------------------------------------------------------------------------- 24
# the dry run's production layout on the card: qwen3-8b at its published
# widths and depth (36 layers; the butterfly after layer 4 at d_r 64, phase
# 5's wire), four ranks at (data=2, model=2) sharing the card over gloo,
# each holding only its shards (16 of 32 q heads, 4 of 8 kv heads, half of
# d_ff; 9.4 GB), decoding over caches whose length shards as the JAX dry
# run's decode_state_specs(seq_axis=) lays it out
SEQ = {"m": dict(B=4, S=128, cap=256, axis="model"),
       "dm": dict(B=1, S=1024, cap=2048, axis=("data", "model"))}
SEQ_STEPS = 8
SEQ_GRID = ((2, 2), ("data", "model"))
# the reduced f32 card-vs-CPU run at the same grid: kv replicated, attention
# replicated, a windowed ring, whisper's cross attention
SEQ_PARITY = dict(cases={"kv replicated": ("qwen3-8b", {"num_kv_heads": 1}),
                         "attention replicated": ("qwen3-8b", {"num_heads": 3,
                                                               "num_kv_heads": 1}),
                         "ring": ("gemma3-12b", {"sliding_window": 16}),
                         "whisper": ("whisper-base", {})},
                  S=20, cap=32, T=3, rtol=1e-4, atol=1e-5)


def _seq_cfg():
    from repro_torch.configs import get_config
    return get_config("qwen3-8b").with_butterfly(4, 64)


def _seq_kinds():
    from repro_torch.configs import InputShape
    return {k: InputShape(f"decode_{c['cap']}", c["cap"], c["B"], "decode")
            for k, c in SEQ.items()}


def _seq_serve(params, built, pctx, batch, cap, steps, inputs=None):
    """Kernel prefill of ``batch`` under ``pctx`` into sequence-sharded
    caches (on "model" through REPRO_PREFILL_CACHE_SHARDED=1 at a batch
    above one, under for_cache(("data", "model")) at a batch of one), the
    caches padded to ``cap``, and ``steps`` kernel decode steps, greedy or
    fed ``inputs`` (teacher-forced): the prefill logits, each step's logits
    and greedy ids, and the walls, on the host."""
    import torch
    from repro_torch.models import model as M
    torch.cuda.synchronize()
    t = time.perf_counter()
    if batch["tokens"].shape[0] > 1:
        os.environ["REPRO_PREFILL_CACHE_SHARDED"] = "1"
        try:
            logits, caches = M.forward_prefill(params, built, batch, pctx,
                                               use_kernel=True)
        finally:
            del os.environ["REPRO_PREFILL_CACHE_SHARDED"]
        pctx = pctx.for_cache("model")
    else:
        pctx = pctx.for_cache(("data", "model"))
        logits, caches = M.forward_prefill(params, built, batch, pctx,
                                           use_kernel=True)
    caches = M.pad_decode_caches(built, caches, cap, pctx)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t) * 1e3
    S = batch["tokens"].shape[1]
    tok = logits[:, -1].argmax(-1, keepdim=True)
    out, ids, ms = [], [], []
    for i in range(steps):
        if inputs is not None:
            tok = inputs[i].to(logits.device)
        torch.cuda.synchronize()
        t = time.perf_counter()
        lg, caches = M.forward_decode(params, built, tok, caches, S + i, pctx,
                                      use_kernel=True)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        out.append(lg[:, 0].float().cpu())
        tok = lg[:, -1].argmax(-1, keepdim=True)
        ids.append(tok[:, 0].cpu())
    return dict(prefill=logits[:, 0].float().cpu(), steps=out, ids=ids,
                prefill_ms=prefill_ms, ms=ms)


def _seq_parity() -> dict:
    """Phase 24's reduced f32 card-vs-CPU run on this rank: each case of
    SEQ_PARITY from one CPU init, its shards on the card and on the CPU
    over the same gloo world, a kernel prefill of S tokens and T greedy
    kernel decode steps over caches sharded on "model" (a batch of 4) and
    on ("data", "model") (a batch of 1).  Logits rtol 1e-4 (atol 1e-5),
    ids equal; raises (and so fails the spawn) otherwise."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import shard_batch
    from repro_torch.models import model as M
    from repro_torch.models import parallel
    from repro_torch.tree import tree_map
    c = SEQ_PARITY
    grid = parallel.RankGrid(*SEQ_GRID)
    base = parallel.make_context(grid)
    err, n = 0.0, 0
    for label, (arch, over) in c["cases"].items():
        cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                                  **over)
        built = M.build(cfg)
        params = M.init_model(torch.Generator().manual_seed(0), built, device="cpu")
        mine = parallel.shard_grid(params, M.param_specs(built, grid), grid)
        rng = np.random.default_rng(2)
        for B in (4, 1):
            batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, c["S"]))}
            if cfg.is_encdec:
                batch["frames"] = rng.standard_normal(
                    (B, cfg.encoder_frames, cfg.d_model)).astype(np.float32)
            pctx = base.for_batch(B)
            runs = {dev: _seq_serve(tree_map(lambda t: t.to(dev), mine), built,
                                    pctx, shard_batch(batch, pctx, device=dev),
                                    c["cap"], c["T"])
                    for dev in ("cpu", "cuda")}
            got, want = runs["cuda"], runs["cpu"]
            for g, w in zip([got["prefill"]] + got["steps"],
                            [want["prefill"]] + want["steps"]):
                torch.testing.assert_close(g, w, rtol=c["rtol"], atol=c["atol"])
                err = max(err, float((g - w).abs().max()))
            for g, w in zip(got["ids"], want["ids"]):
                if not torch.equal(g, w):
                    raise AssertionError(f"seq-sharded {label}, batch {B}: ids "
                                         f"{g.tolist()} on the card, "
                                         f"{w.tolist()} on the CPU")
            n += 1
    return {"err": err, "runs": n}


def _seq_rank(rank, device, refs):
    """One rank of phase 24 (spawned; see phase_seq_decode)."""
    import torch
    import torch.distributed as dist
    from repro_torch.data import shard_batch
    from repro_torch.launch import dryrun
    from repro_torch.models import model as M
    from repro_torch.models import parallel
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(2)          # four ranks share the host's eight cores
    t0 = time.perf_counter()
    out = {"parity": _seq_parity()}
    out["parity_s"] = time.perf_counter() - t0
    grid = parallel.RankGrid(*SEQ_GRID)
    base = parallel.make_context(grid)
    built = M.build(_seq_cfg())
    # one rank at a time holds the whole model while it takes its shards
    t0 = time.perf_counter()
    for r in range(grid.size):
        if r == rank:
            params = M.init_model(torch.Generator(device="cuda").manual_seed(0),
                                  built, device="cuda")
            out["checksum"] = _checksum(params)
            mine = dryrun._owned(parallel.shard_grid(
                params, M.param_specs(built, grid), grid))
            del params
            gc.collect()
            torch.cuda.empty_cache()
        dist.barrier()
    out["init_s"] = time.perf_counter() - t0
    out["held_gb"] = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    for kind, c in SEQ.items():
        pctx = base.for_batch(c["B"])
        toks = shard_batch({"tokens": refs[kind]["prompts"]}, pctx)
        rows = toks["tokens"].shape[0]
        lo = pctx.data_rank * rows if c["B"] > 1 else 0
        inputs = [t[lo:lo + rows] for t in refs[kind]["inputs"]]
        if kind == "m":                    # warm-up (libraries, handles)
            _seq_serve(mine, built, pctx, toks, c["cap"], 1, inputs)
        _zero_counts()
        out[kind] = _seq_serve(mine, built, pctx, toks, c["cap"], SEQ_STEPS,
                               inputs)
        out[kind]["launches"] = _counts()
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    # the dry run's premise: this rank's counts of one plain decode step
    out["counts"] = {}
    for kind, shape in _seq_kinds().items():
        counter, memory = dryrun.count_step(built, shape, "cuda", grid=grid,
                                            shards=mine)
        out["counts"][kind] = (counter.flops, counter.bytes,
                               dict(counter.collectives),
                               memory["argument_size_in_bytes"])
    return out


def seq_decode_references():
    """Phase 24's degree-1 side, in this process before the ranks start:
    full-width qwen3-8b from seed 0, a kernel prefill and 8 greedy kernel
    decode steps for each layout's prompts (SEQ), on the host: the
    prompts, each step's input tokens, logits and walls."""
    import numpy as np
    import torch
    from repro_torch.models import model as M
    built = M.build(_seq_cfg())
    params = M.init_model(torch.Generator(device="cuda").manual_seed(0), built,
                          device="cuda")
    refs = {"checksum": _checksum(params)}
    for kind, c in SEQ.items():
        prompts = np.stack(_prompts(c["B"], (c["S"],) * c["B"]))
        toks = torch.tensor(prompts, device="cuda")
        M.forward_prefill(params, built, {"tokens": toks}, use_kernel=True)
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, caches = M.forward_prefill(params, built, {"tokens": toks},
                                           use_kernel=True)
        caches = M.pad_decode_caches(built, caches, c["cap"])
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t) * 1e3
        tok, inputs, steps, ms = logits[:, -1].argmax(-1, keepdim=True), [], [], []
        for i in range(SEQ_STEPS):
            inputs.append(tok.cpu())
            torch.cuda.synchronize()
            t = time.perf_counter()
            lg, caches = M.forward_decode(params, built, tok, caches, c["S"] + i,
                                          use_kernel=True)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
            steps.append(lg[:, 0].float().cpu())
            tok = lg[:, -1].argmax(-1, keepdim=True)
        refs[kind] = dict(prompts=prompts, inputs=inputs, steps=steps, ms=ms,
                          prefill=logits[:, 0].float().cpu(), prefill_ms=prefill_ms)
        del caches
    del params
    return refs


def phase_seq_decode(smi: str):
    """Phase 24: the dry run's production layout on the card.  After the
    degree-1 references (seq_decode_references), four ranks, one spawned
    process each, share the card over gloo at (data=2, model=2); each
    builds full-width qwen3-8b from seed 0 in turn (the same weights,
    checked), keeps its shards, and runs:
      1. 4 prompts of 128 tokens (2 a data block): a kernel prefill under
         REPRO_PREFILL_CACHE_SHARDED=1 (the caches come out seq -> model),
         the caches padded to 256 (128 positions a rank), 8 kernel decode
         steps over caches sharded on "model";
      2. 1 prompt of 1,024 tokens: a kernel prefill under caches sharded
         on ("data", "model"), padded to 2,048 (512 a rank), 8 steps;
         each step teacher-forced with degree 1's tokens: prefill and step
         logits within phase 5's 5% of degree 1's, the greedy tokens equal
         unless degree 1's top two lie within the bound;
      3. launches a rank exactly: 36 flash (the prefill's attention layers,
         on the rank's 16 q and 4 kv heads) and reduce_quant and
         dequant_restore once a prefill and once a decode step;
      4. the dry run's premise: the rank's roofline.CostCounter over one
         plain decode step at each layout (capacity 256 and 2,048) equals,
         exactly, the meta trace of the same rank in a fake world of the
         same grid: FLOPs, bytes, collective bytes by kind, argument bytes;
      5. first, the reduced f32 card-vs-CPU run (see _seq_parity).
    Prints the walls beside degree 1's, each rank's peak and the phase's
    seconds.  Returns the launches summed over the ranks."""
    import torch
    from repro_torch.launch import dryrun
    from repro_torch.models import model as M
    from repro_torch.models import parallel
    t0 = time.perf_counter()
    refs = seq_decode_references()
    _free()
    ref_s = time.perf_counter() - t0
    ranks = parallel.spawn(_seq_rank, 4, (refs,),
                           devices=f"cuda:{torch.cuda.current_device()}")
    wall = time.perf_counter() - t0
    p = ranks[0]["parity"]
    print(f"seq decode: 4 ranks at (data=2, model=2) on {smi} over gloo, "
          f"{wall:.1f} s with the references ({ref_s:.1f} s) and the spawn; "
          f"reduced f32 card vs CPU ({ranks[0]['parity_s']:.1f} s): "
          f"{p['runs']} runs (kv replicated, attention replicated, ring, "
          f"whisper; caches on model and on (data, model)), logits max|d| "
          f"{p['err']:.3g}, ids equal")
    for r, out in enumerate(ranks):
        if out["checksum"] != refs["checksum"]:
            fail(f"seq decode: rank {r}'s weights {out['checksum']} are not the "
                 f"reference's {refs['checksum']}")
    layers = _seq_cfg().num_layers
    grid = parallel.RankGrid(*SEQ_GRID)
    launches = None
    for kind, c in SEQ.items():
        want = dict.fromkeys(ranks[0][kind]["launches"], 0)
        want["flash_attention"] = layers
        want["butterfly_reduce_quant"] = want["butterfly_dequant_restore"] = \
            1 + SEQ_STEPS
        worst = 0.0
        for r, out in enumerate(ranks):
            got = out[kind]
            if got["launches"] != want:
                fail(f"seq decode {kind} rank {r}: launched {got['launches']}, "
                     f"expected {want}")
            rows = got["prefill"].shape[0]
            lo = grid.coords(r)["data"] * rows if c["B"] > 1 else 0
            ref = refs[kind]
            for j in range(rows):
                d, limit = _hold_logits(f"seq decode {kind} prefill rank {r} row "
                                        f"{j}", got["prefill"][j],
                                        ref["prefill"][lo + j], witness=0.0,
                                        greedy=True)
                worst = max(worst, d)
                for i in range(SEQ_STEPS):
                    d, _ = _hold_logits(f"seq decode {kind} step {i} rank {r} "
                                        f"row {j}", got["steps"][i][j],
                                        ref["steps"][i][lo + j], witness=0.0,
                                        greedy=True)
                    worst = max(worst, d)
            launches = {k: (launches or {}).get(k, 0) + v
                        for k, v in got["launches"].items()}
        ms = ranks[0][kind]["ms"]
        print(f"seq decode {kind}: {c['B']} x {c['S']} tokens, capacity "
              f"{c['cap']} sharded on {c['axis']}: prefill and {SEQ_STEPS} steps "
              f"within {worst:.4g} of degree 1 (limit {limit:.4g}), greedy "
              f"tokens held; launches a rank {want}")
        print(f"seq decode {kind} on {smi}: kernel prefill "
              f"{ranks[0][kind]['prefill_ms']:.1f} ms (4 ranks) vs "
              f"{refs[kind]['prefill_ms']:.1f} ms degree 1; decode "
              f"{statistics.median(ms[1:]):.1f} ms a step (median of "
              f"{len(ms) - 1}) vs {statistics.median(refs[kind]['ms'][1:]):.1f} ms")
    # 4. each rank's card counts against its meta trace in a fake world
    built = M.build(_seq_cfg())
    layout = dryrun.init_params(built)                 # meta: no data
    for kind, shape in _seq_kinds().items():
        for r, out in enumerate(ranks):
            with parallel.fake_world(grid, r):
                counter, memory = dryrun.count_step(built, shape, "meta",
                                                    params=layout, grid=grid)
            meta = (counter.flops, counter.bytes, dict(counter.collectives),
                    memory["argument_size_in_bytes"])
            if meta != out["counts"][kind]:
                fail(f"seq decode: rank {r}'s {shape.name} counts on the card "
                     f"{out['counts'][kind]}, in a fake world on meta {meta}")
        f, b, coll, arg = ranks[0]["counts"][kind]
        print(f"seq decode: {shape.name} ({shape.global_batch} rows) one plain "
              f"decode step, every rank's card counts == its fake-world meta "
              f"trace; rank 0: {f} FLOPs, {b} B, collectives "
              f"{ {k: v for k, v in coll.items() if v} } B, arguments {arg / 1e9:.3f} GB")
    for r, out in enumerate(ranks):
        print(f"seq decode: rank {r} init {out['init_s']:.1f} s, holds "
              f"{out['held_gb']:.2f} GB, peak {out['peak_gb']:.2f} GB")
    print(f"seq decode: phase {time.perf_counter() - t0:.1f} s")
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
    paths["qwen3-8b split pipeline"] = phase_split_pipeline(runner)
    phase_dryrun_counts(runner, smi)
    phase_launchers(smi)
    profile_dir = Path(args.profile) if args.profile else None
    if args.profile is not None:
        phase_profile(runner, profile_dir)
        phase_profile_pipeline(runner, profile_dir)
    axis_refs = model_axis_references(runner)
    del runner                       # the qwen3-8b weights leave the card
    _free()
    paths["qwen3-8b model axis, 2 ranks"] = phase_model_axis(axis_refs, smi)
    del axis_refs
    _free()
    paths["qwen3-moe automatic (data=2, model=2), 4 ranks"] = phase_automatic(smi)
    _free()
    paths["qwen3-8b seq-sharded decode (data=2, model=2), 4 ranks"] = \
        phase_seq_decode(smi)
    _free()
    paths["gemma3-12b kernel prefill"], _, _ = phase_kernel_prefill(
        "gemma3-12b", args.profile is not None, profile_dir)
    # each model's weights leave the card before the next one is built
    _free()
    print(f"qwen3-14b serving: card {smi}")
    paths["qwen3-14b split serving"], runner = phase_serving(
        "qwen3-14b", new_tokens=8, streamed_len=None, label="qwen3-14b serving")
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
    paths["qwen3-moe decode pipeline"] = phase_bank_pipeline(runner)
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
    _free()
    paths.update(phase_recurrent("zamba2-7b", smi, args.profile is not None,
                                 profile_dir))
    paths.update(phase_recurrent("xlstm-125m", smi, args.profile is not None,
                                 profile_dir))

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
