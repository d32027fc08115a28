"""Dry run on one card (the port's counterpart of ``repro.launch.dryrun``):
for each (architecture x input shape) pair, trace the real step and record
its FLOPs, bytes and memory against the H100's rates (``roofline.py``).

The JAX package lowers each pair through XLA ahead of time on a
512-device production mesh against TPU v5e constants.  Here the step runs
eagerly on ``meta`` tensors, which carry shapes and dtypes and no data, so
nothing is allocated at full scale and no device is touched:

  train_4k          ``make_train_step``: forward, backward and the AdamW
                    update, at the shape's global batch;
  prefill_32k       ``forward_prefill``;
  decode_32k,       ``forward_decode`` of one token a sequence over
  long_500k         caches of the shape's length (``init_stage_cache``).

A :class:`roofline.CostCounter` sees every aten op.  The eager trace runs
every layer, so XLA's two-point scan correction has no counterpart, and a
card has no collectives to parse.  ``--multi-pod`` and ``--both-meshes``
trace over a production grid (``launch/mesh.py``): the automatic regime
runs there as one process a rank (``models/parallel.make_context``), and
counting one rank's step on meta tensors, its collectives counted rather
than run, is the dry run's next slice; until then both flags raise.
``device="cpu"`` or ``"cuda"``
runs the same trace on real tensors (random weights), which the tests and
the card use to check the meta counts.

Example:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b --shape decode_32k
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional

import torch

from repro_torch import device as dev_lib
from repro_torch.configs import INPUT_SHAPES, get_config, supports_shape
from repro_torch.configs.all import ASSIGNED
from repro_torch.core import costs
from repro_torch.launch import roofline
from repro_torch.models import model as M
from repro_torch.models import transformer as tfm
from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                            cosine_schedule)
from repro_torch.training.train_loop import make_train_step
from repro_torch.tree import tree_leaves

OUT_DIR = "build/dryrun"


def init_params(built, device: str = "meta"):
    """The model's params from seed 0: on ``meta`` their layout only."""
    if device == "meta":
        with dev_lib.OnMeta():
            return M.init_model(torch.Generator().manual_seed(0), built,
                                device="cpu")
    device = dev_lib.resolve(device)
    return M.init_model(torch.Generator(device=device).manual_seed(0), built,
                        device=device)


def _tokens(shape, vocab: int, device) -> torch.Tensor:
    if device.type == "meta":
        return torch.empty(shape, dtype=torch.int64, device=device)
    return torch.randint(0, vocab, shape, device=device,
                         generator=torch.Generator(device=device).manual_seed(1))


def make_batch(built, shape, device):
    """The step's inputs at ``shape``: tokens (after a VLM's patches), a
    whisper's frames, and training targets."""
    cfg = built.cfg
    B, S = shape.global_batch, shape.seq_len
    dt = dev_lib.torch_dtype(cfg.dtype)
    if shape.kind == "decode":
        return {"tokens": _tokens((B, 1), cfg.vocab_size, device)}
    n_text = S - cfg.num_patches if cfg.num_patches else S
    batch = {"tokens": _tokens((B, n_text), cfg.vocab_size, device)}
    if cfg.num_patches:
        batch["patches"] = torch.zeros((B, cfg.num_patches, cfg.d_model),
                                       dtype=dt, device=device)
    if cfg.is_encdec:
        batch["frames"] = torch.zeros((B, cfg.encoder_frames, cfg.d_model),
                                      dtype=dt, device=device)
    if shape.kind == "train":
        batch["targets"] = _tokens((B, S), cfg.vocab_size, device)
    return batch


def model_flops(cfg, shape) -> float:
    """The useful FLOPs of the step (``core.costs``), as the JAX dry run
    counts them."""
    if shape.kind == "train":
        return costs.model_flops_train(cfg, shape.global_batch * shape.seq_len)
    if shape.kind == "prefill":
        return 2.0 * costs.param_count(cfg, active_only=True) * \
            shape.global_batch * shape.seq_len
    return costs.model_flops_decode(cfg, shape.global_batch)


def count_step(built, shape, device: str = "meta", params=None):
    """Run ``shape``'s step once on ``device`` inside a
    :class:`roofline.CostCounter`; returns (counter, memory): the argument,
    output and peak live bytes.  ``params`` (on ``device``) replaces the
    seed-0 init."""
    cfg = built.cfg
    dev = torch.device("meta") if device == "meta" else dev_lib.resolve(device)
    if params is None:
        params = init_params(built, device)
    batch = make_batch(built, shape, dev)
    counter = roofline.CostCounter()
    if shape.kind == "train":
        opt = adamw_init(params)
        step = make_train_step(
            built, AdamWConfig(lr=cosine_schedule(3e-4, 100, 10000)))
        args = (params, opt, batch)
    elif shape.kind == "prefill":
        step = lambda p, b: M.forward_prefill(p, built, b)
        args = (params, batch)
    else:
        dt = dev_lib.torch_dtype(cfg.dtype)
        caches = [tfm.init_stage_cache(list(segs), cfg, shape.global_batch,
                                       shape.seq_len, dt, dev)
                  for segs in built.stages]
        step = lambda p, t, c: M.forward_decode(p, built, t, c,
                                                shape.seq_len - 1)
        args = (params, batch["tokens"], caches)
    arg_bytes = counter.hold(args)
    with counter:
        out = step(*args)
    out_bytes = sum({t.untyped_storage()._cdata: t.untyped_storage().nbytes()
                     for t in tree_leaves(out) if isinstance(t, torch.Tensor)
                     }.values())
    return counter, {"argument_size_in_bytes": float(arg_bytes),
                     "output_size_in_bytes": float(out_bytes),
                     "peak_memory_in_bytes": float(counter.peak),
                     "fits_device": counter.peak <= roofline.DEVICE_BYTES}


def run_pair(arch: str, shape_name: str, out_dir: str = OUT_DIR,
             butterfly_layer: Optional[int] = None, d_r: int = 0,
             tag: str = "") -> dict:
    """Trace one (arch x shape) pair on meta tensors, print its line and
    write its record to ``out_dir/<arch>_<shape>_1.json``; a pair
    ``supports_shape`` refuses is written as skipped."""
    shape = INPUT_SHAPES[shape_name]
    cfg = get_config(arch)
    if butterfly_layer is not None:
        cfg = cfg.with_butterfly(butterfly_layer,
                                 d_r or max(64, cfg.d_model // 16))
    ok, why = supports_shape(cfg, shape)
    if not ok:
        rec = {"arch": arch, "shape": shape_name, "mesh": "1", "skipped": why}
        print(f"SKIP  {arch:28s} {shape_name:12s} {'1':8s} {why}")
    else:
        built = M.build(cfg, long_mode=shape_name == "long_500k")
        t0 = time.time()
        counter, memory = count_step(built, shape)
        trace_s = time.time() - t0
        rep = roofline.analyze(arch, shape_name, counter,
                               model_flops(cfg, shape), memory)
        rec = {"arch": arch, "shape": shape_name, "mesh": "1", "chips": 1,
               "device": "meta", "trace_s": round(trace_s, 1),
               "aten_ops": counter.ops, "model_flops": rep.model_flops,
               "butterfly": None if cfg.butterfly is None else
               {"layer": cfg.butterfly.layer, "d_r": cfg.butterfly.d_r},
               **roofline.to_dict(rep)}
        print(f"OK    {arch:28s} {shape_name:12s} {'1':8s} "
              f"compute={rep.compute_s*1e3:8.2f}ms memory={rep.memory_s*1e3:8.2f}ms "
              f"coll={rep.collective_s*1e3:8.2f}ms bottleneck={rep.bottleneck:10s} "
              f"useful={rep.useful_ratio:5.2f} "
              f"peakmem={memory['peak_memory_in_bytes']/1e9:6.2f}GB "
              f"trace={trace_s:.1f}s")
    os.makedirs(out_dir, exist_ok=True)
    suffix = f"_{tag}" if tag else ""
    with open(os.path.join(out_dir, f"{arch}_{shape_name}_1{suffix}.json"),
              "w") as f:
        json.dump(rec, f, indent=1, default=float)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description="one-card dry run on meta tensors")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=[*INPUT_SHAPES, None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true", help="all arch x shape")
    ap.add_argument("--butterfly-layer", type=int, default=None)
    ap.add_argument("--d-r", type=int, default=0)
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)
    if args.multi_pod or args.both_meshes:
        raise NotImplementedError(
            "--multi-pod and --both-meshes need a meta trace of one rank's "
            "step over the production grid with its collectives counted, "
            "not run: the dry run's next slice (ROADMAP section 1)")

    archs = ASSIGNED if (args.all or args.arch is None) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or args.shape is None) else [args.shape]
    results = []
    for arch in archs:
        for shape in shapes:
            try:
                results.append(run_pair(arch, shape, args.out,
                                        args.butterfly_layer, args.d_r,
                                        tag=args.tag))
            except Exception as e:  # noqa: BLE001 — report and continue
                print(f"FAIL  {arch:28s} {shape:12s} {'1':8s} "
                      f"{type(e).__name__}: {e}")
                results.append({"arch": arch, "shape": shape, "mesh": "1",
                                "error": f"{type(e).__name__}: {e}"})
    n_ok = sum(1 for r in results if "compute_s" in r)
    n_skip = sum(1 for r in results if "skipped" in r)
    n_fail = len(results) - n_ok - n_skip
    print(f"\ndone: {n_ok} ok, {n_skip} skipped (documented), {n_fail} failed")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
