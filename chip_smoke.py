#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main path on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

Phases, each fatal on failure (the script exits non-zero and prints no
result line):
  1. device  - requires CUDA; prints the card's name and power limit;
  2. build   - compiles the butterfly kernels from src/repro_torch/csrc with
               nvcc for sm_90a and prints the build seconds and ptxas report;
  3. kernels - holds each kernel against its plain PyTorch version on the
               card at the main path's shapes (d=4096, d_r=64, bf16) and at
               a small f32 shape;
  4. times   - median CUDA-event time of each kernel and of its plain
               version (inputs cold in L2), beside the least time the card
               could take (bytes or operations over its data-sheet rates);
  5. serving - full-width qwen3-8b (36 layers, d_model 4096, bf16, random
               weights from seed 0) split after layer 4 with a d_r=64 int8
               butterfly: four requests prefill through edge_half -> host
               wire -> cloud_half and decode 16 tokens each in the serving
               engine (cache handoff); one more decodes 8 tokens streamed
               through edge_step/stream_step.  Both kernels' launch counts
               must grow on this path, and the cloud logits must stay within
               5% of the reference forward's largest logit.
With ``--profile [DIR]`` it then profiles one prefill and 8 decode steps
(torch.profiler: wall time, device-busy share, top kernels; the operator
tables go to DIR when one is given).  It then prints the kernels' JSON line and, last, the
result line.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parent

# data-sheet rates of the H100 SXM (NVIDIA, dense): bytes/s of device memory
# and bf16 tensor-core FLOP/s (the kernels' inputs are bf16 at the timed shapes)
H100_RATES = (3.35e12, 989e12)

D, D_R = 4096, 64
CHECK_ROWS = (1, 4, 8, 37, 64, 128, 512, 1024, 1025, 4096)
# reduce_quant runs 1-row blocks up to 1,024 rows and 16-row blocks above
TIME_ROWS = (1, 128, 1024, 1025, 4096)
JSON_ROWS = 128          # a 128-token prompt's edge/cloud call on the main path


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
    from repro_torch.kernels import build
    lib, log, secs = build.compile_library()
    build.load()
    print(f"build: {lib.name} in {secs:.1f} s (nvcc, sm_90a)")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")


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
    cases = [(T, D, D_R, torch.bfloat16) for T in CHECK_ROWS] + \
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
        worst["butterfly_reduce_quant"] = max(worst["butterfly_reduce_quant"], max_diff)
        worst["butterfly_dequant_restore"] = max(worst["butterfly_dequant_restore"], err)
        print(f"kernels: T={T:5d} d={d} d_r={d_r} {str(dtype)[6:]:8s} codes "
              f"differ {n_diff}/{diff.numel()} (max {max_diff}), restore max "
              f"|err| {err:.3g}")
    torch.cuda.synchronize()
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


def phase_times(rates):
    import torch
    from repro_torch.kernels import butterfly_kernel as bk, ref
    out = {}
    for T in TIME_ROWS:
        x, w, wr = _inputs(T, D, D_R, torch.bfloat16, seed=T)
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
        bounds = dict(zip(rows, _bounds(rates, T, D, D_R)))
        for name, (kern, plain) in rows.items():
            ms, plain_ms = _device_ms(kern), _device_ms(plain)
            bound_ms, bound_by = bounds[name]
            out[(name, T)] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                  bound_by=bound_by)
            print(f"times: {name:26s} T={T:5d} kernel {ms:.4f} ms  plain "
                  f"{plain_ms:.4f} ms  bound {bound_ms:.4f} ms ({bound_by})")
    return out


# --------------------------------------------------------------------------- 5
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
    cloud_half and joins the engine, which then decodes them together."""
    import torch
    params = runner.params
    reqs, logits_out, prefill_ms = [], [], []
    wire = raw = 0
    for toks in prompts:
        torch.cuda.synchronize()
        t = time.perf_counter()
        payload, scales, c0 = runner.edge_half(params, toks[None])
        payload_h, scales_h = payload.cpu(), scales.cpu()          # the wire
        logits, c1 = runner.cloud_half(params, payload_h.cuda(), scales_h.cuda())
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t) * 1e3)
        wire += payload_h.numel() * payload_h.element_size() + \
            scales_h.numel() * scales_h.element_size()
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


def phase_serving():
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import butterfly_kernel as bk
    from repro_torch.runtime.split_exec import SplitModelBank

    cfg = get_config("qwen3-8b")
    split, d_r = cfg.num_layers // 8, max(16, cfg.d_model // 64)
    t0 = time.perf_counter()
    bank = SplitModelBank(cfg, d_r, wire_mode="int8", seed=0, device="cuda")
    runner = bank.runner(split)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(runner.params))
    print(f"serving: {cfg.name} {cfg.num_layers} layers d_model {cfg.d_model} "
          f"{cfg.dtype}, {n_params / 1e9:.3f} B params, split {split}, d_r "
          f"{d_r}, int8 wire; init {time.perf_counter() - t0:.1f} s")
    max_len = 256
    prompts = _prompts(5, (64, 80, 100, 128, 96))
    engine = runner.make_engine(max_batch=4, max_len=max_len, seed=0)
    # warm-up at the same shapes, so the timed run pays no first-call costs
    # (cuBLAS heuristics, allocator growth)
    t0 = time.perf_counter()
    _serve_handoff(runner, engine, prompts[:4], 2)
    _serve_streamed(runner, engine, prompts[4], 2, max_len)
    print(f"serving: warm-up {time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()

    bk.reduce_quant.launches = 0
    bk.dequant_restore.launches = 0
    reqs, cloud_logits, prefill_ms, wire_bytes, raw_bytes, decode_ms, \
        decode_steps = _serve_handoff(runner, engine, prompts[:4], 16)
    sreq, stream_ms = _serve_streamed(runner, engine, prompts[4], 8, max_len)
    launches = {"butterfly_reduce_quant": bk.reduce_quant.launches,
                "butterfly_dequant_restore": bk.dequant_restore.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    print(f"serving: launches on the main path {launches}")
    if min(launches.values()) <= 0:
        fail(f"a kernel was not launched on the main path: {launches}")
    for r in reqs + [sreq]:
        if not r.done:
            fail(f"request {r.uid} did not finish")
    if [len(r.generated) for r in reqs] != [16] * 4 or len(sreq.generated) != 8:
        fail("wrong number of generated tokens")

    # the reference rounds x @ w_reduce to bf16 before quantizing, so the
    # check is a bound, not equality
    agree = 0
    for toks, lg in zip(prompts[:4], cloud_logits):
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
        print(f"serving: S={len(toks)} max|logits - reference| {delta:.4g} "
              f"(limit {limit:.4g})")
    for r, lg in zip(reqs, cloud_logits):
        if r.generated[0] != int(torch.argmax(lg)):
            fail("the first token is not the greedy token of the cloud logits")
    print(f"serving: greedy first-token agreement with the reference "
          f"{agree}/4")
    print(f"serving: wire {wire_bytes} B (codes + scales) for {raw_bytes} B of "
          f"raw bf16 boundary activations ({raw_bytes / wire_bytes:.1f}x)")
    print(f"serving: prefill (edge + wire + cloud) ms per request "
          f"{[round(v, 3) for v in prefill_ms]}, median "
          f"{statistics.median(prefill_ms):.3f}")
    print(f"serving: handoff decode {decode_ms:.3f} ms per step of 4 slots "
          f"({decode_steps} steps, {decode_ms / 4:.3f} ms per token); streamed "
          f"decode {stream_ms:.3f} ms per token")
    print(f"serving: peak device memory {peak_gb:.2f} GB")
    print(f"serving: tokens {[r.generated for r in reqs]} streamed {sreq.generated}")
    return launches, runner


def _leaves(tree):
    from repro_torch.tree import tree_leaves
    return tree_leaves(tree)


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


def phase_profile(runner, out_dir: Optional[Path]):
    """Where the time goes (``--profile``): one 128-token request's prefill
    (edge + host wire + cloud) and 8 handoff decode steps of 4 slots, after
    a warm-up."""
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
    _profiled("prefill", lambda: prefill(prompts[0]), out_dir)
    _profiled("decode", lambda: [engine.step() for _ in range(8)], out_dir)


def main():
    ap = argparse.ArgumentParser(description="Run the port's main path on "
                                 "one NVIDIA GPU (see the module docstring).")
    ap.add_argument("--profile", nargs="?", const="", metavar="DIR",
                    help="profile one prefill and 8 decode steps; write the "
                         "operator tables to DIR if given")
    args = ap.parse_args()
    name, smi, rates = phase_device()
    phase_build()
    worst = phase_kernels()
    times = phase_times(rates)
    launches, runner = phase_serving()
    if args.profile is not None:
        phase_profile(runner, Path(args.profile) if args.profile else None)
    kernels = []
    for kname, line in (("butterfly_reduce_quant", 38),
                        ("butterfly_dequant_restore", 188)):
        t = times[(kname, JSON_ROWS)]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "src/repro_torch/csrc/butterfly.cu",
            "replaces": f"src/repro/kernels/butterfly_kernel.py:{line}",
            "launches": launches[kname], "max_abs_err": worst[kname],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
        })
    print(json.dumps({"kernels": kernels}))
    import torch
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
