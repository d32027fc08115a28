"""Dry run on meta tensors (the port's counterpart of
``repro.launch.dryrun``): for each (architecture x input shape) pair, trace
the real step and record its FLOPs, bytes, collectives and memory against
the H100's rates (``roofline.py``).

The JAX package lowers each pair through XLA ahead of time on a production
mesh against TPU v5e constants.  Here the step runs eagerly on ``meta``
tensors, which carry shapes and dtypes and no data, so nothing is
allocated at full scale and no device is touched:

  train_4k          ``make_train_step``: forward, backward and the AdamW
                    update, at the shape's global batch;
  prefill_32k       ``forward_prefill``;
  decode_32k,       ``forward_decode`` of one token a sequence over
  long_500k         caches of the shape's length.

By default one card runs the whole step (``mesh "1"``).  ``--multi-pod``
traces the (2, 16, 16) grid over ``("pod", "data", "model")`` and
``--both-meshes`` the (16, 16) grid over ``("data", "model")`` too
(``launch/mesh.py``), as the JAX dry run does: inside
``parallel.fake_world`` this process is rank 0 of a 512- or 256-rank world
whose collectives return at once, and it runs rank 0's step in the
automatic regime (``parallel.make_context``) on its shards
(``model.param_specs``), its block of the batch (``input_specs``) and, in
decode, its block of the caches (``decode_state_specs``, the length over
``model``, or over ``("data", "model")`` at a batch of one, as JAX's
``seq_axis``), with AdamW's state of its shards in train.  Every
collective is counted by kind (``roofline.CostCounter``).  Rank 0 is
traced: in decode only the rank that holds the new token's slot writes
it, rank 0 only while the position lies in its block, so other ranks'
counts differ by those writes.  A :class:`roofline.CostCounter` sees every
aten op.  The eager trace runs every layer, so XLA's two-point scan
correction has no counterpart.  ``device="cpu"`` or ``"cuda"`` runs the
same trace on real tensors (random weights; ranks of a real world on a
grid), which the tests and the card use to check the meta counts.

Example:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b --shape decode_32k --both-meshes
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
from repro_torch.launch.mesh import make_production_mesh, mesh_chips
from repro_torch.models import model as M
from repro_torch.models import parallel
from repro_torch.models import transformer as tfm
from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                            cosine_schedule)
from repro_torch.training.train_loop import make_train_step
from repro_torch.tree import tree_leaves, tree_map

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


def _owned(tree):
    """Each leaf as a tensor of its own storage (shards are views of the
    whole tree, whose storage the counter would charge)."""
    return tree_map(lambda a: a.clone(memory_format=torch.contiguous_format),
                    tree)


def seq_axis_of(shape):
    """The decode caches' sequence axes, as the JAX dry run picks them:
    ``("data", "model")`` at a batch of one, else ``"model"``."""
    return ("data", "model") if shape.global_batch == 1 else "model"


def count_step(built, shape, device: str = "meta", params=None, grid=None,
               shards=None):
    """Run ``shape``'s step once on ``device`` inside a
    :class:`roofline.CostCounter`; returns (counter, memory): the argument,
    output and peak live bytes.  ``params`` (on ``device``) replaces the
    seed-0 init.  With ``grid`` (a ``parallel.RankGrid``, in a world of
    its size: ``parallel.fake_world`` on meta, real ranks otherwise) the
    step is this rank's in the automatic regime, on its shards and blocks
    (module docstring): ``shards``, this rank's own (each leaf its own
    storage), or those cut from ``params``."""
    cfg = built.cfg
    dev = torch.device("meta") if device == "meta" else dev_lib.resolve(device)
    if params is None and shards is None:
        params = init_params(built, device)
    batch = make_batch(built, shape, dev)
    pctx = parallel.LOCAL
    if grid is not None:
        pctx = parallel.make_context(grid).for_batch(shape.global_batch)
        params = shards if shards is not None else _owned(parallel.shard_grid(
            params, M.param_specs(built, grid), grid))
        _, bspec = M.input_specs(built, shape, pctx)
        batch = _owned(parallel.shard_grid(
            batch, {a: bspec for a in pctx.data_axes}, grid))
    counter = roofline.CostCounter()
    if shape.kind == "train":
        opt = adamw_init(params)
        step = make_train_step(
            built, AdamWConfig(lr=cosine_schedule(3e-4, 100, 10000)), pctx)
        args = (params, opt, batch)
    elif shape.kind == "prefill":
        step = lambda p, b: M.forward_prefill(p, built, b, pctx)
        args = (params, batch)
    else:
        if grid is None:
            dt = dev_lib.torch_dtype(cfg.dtype)
            caches = [tfm.init_stage_cache(list(segs), cfg, shape.global_batch,
                                           shape.seq_len, dt, dev)
                      for segs in built.stages]
        else:
            pctx = pctx.for_cache(seq_axis_of(shape))
            whole, specs = M.decode_state_specs(built, shape, pctx,
                                                seq_axis=seq_axis_of(shape))
            caches = tree_map(lambda a: torch.zeros(a.shape, dtype=a.dtype,
                                                    device=dev),
                              parallel.shard_grid(whole, specs, grid))
        step = lambda p, t, c: M.forward_decode(p, built, t, c,
                                                shape.seq_len - 1, pctx)
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


def _mesh_name(multi_pod: Optional[bool]) -> str:
    if multi_pod is None:
        return "1"
    return "2x16x16" if multi_pod else "16x16"


def run_pair(arch: str, shape_name: str, multi_pod: Optional[bool] = None,
             out_dir: str = OUT_DIR, butterfly_layer: Optional[int] = None,
             d_r: int = 0, tag: str = "") -> dict:
    """Trace one (arch x shape) pair on meta tensors, print its line and
    write its record to ``out_dir/<arch>_<shape>_<mesh>.json``: on one
    card (``multi_pod=None``, mesh ``1``), or rank 0 of the ``16x16``
    (False) or ``2x16x16`` (True) grid in a fake world; a pair
    ``supports_shape`` refuses is written as skipped."""
    shape = INPUT_SHAPES[shape_name]
    mesh = _mesh_name(multi_pod)
    cfg = get_config(arch)
    if butterfly_layer is not None:
        cfg = cfg.with_butterfly(butterfly_layer,
                                 d_r or max(64, cfg.d_model // 16))
    ok, why = supports_shape(cfg, shape)
    if not ok:
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh, "skipped": why}
        print(f"SKIP  {arch:28s} {shape_name:12s} {mesh:8s} {why}")
    else:
        built = M.build(cfg, long_mode=shape_name == "long_500k")
        t0 = time.time()
        if multi_pod is None:
            grid, chips, rank = None, 1, None
            counter, memory = count_step(built, shape)
        else:
            grid, rank = make_production_mesh(multi_pod=multi_pod), 0
            chips = mesh_chips(grid)
            with parallel.fake_world(grid, rank):
                counter, memory = count_step(built, shape, grid=grid)
        trace_s = time.time() - t0
        rep = roofline.analyze(arch, shape_name, counter,
                               model_flops(cfg, shape), memory, mesh, chips)
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh, "chips": chips,
               "device": "meta", "trace_s": round(trace_s, 1),
               "aten_ops": counter.ops, "model_flops": rep.model_flops,
               "butterfly": None if cfg.butterfly is None else
               {"layer": cfg.butterfly.layer, "d_r": cfg.butterfly.d_r},
               **roofline.to_dict(rep)}
        if rank is not None:
            rec["rank"] = rank
        print(f"OK    {arch:28s} {shape_name:12s} {mesh:8s} "
              f"compute={rep.compute_s*1e3:8.2f}ms memory={rep.memory_s*1e3:8.2f}ms "
              f"coll={rep.collective_s*1e3:8.2f}ms bottleneck={rep.bottleneck:10s} "
              f"useful={rep.useful_ratio:5.2f} "
              f"peakmem={memory['peak_memory_in_bytes']/1e9:6.2f}GB "
              f"trace={trace_s:.1f}s")
    os.makedirs(out_dir, exist_ok=True)
    suffix = f"_{tag}" if tag else ""
    fname = f"{arch}_{shape_name}_{mesh.replace('x', '-')}{suffix}.json"
    with open(os.path.join(out_dir, fname), "w") as f:
        json.dump(rec, f, indent=1, default=float)
    return rec


def table(results, meshes) -> str:
    """A markdown table of traced records, one row a pair, each mesh's
    terms in ms (compute / memory / collective), bottleneck, peak live GB
    a rank and whether it fits the card; a pair not traced on a mesh shows
    its reason (skipped or failed)."""
    head = "| arch | shape | " + " | ".join(
        f"{m}: compute / memory / coll ms | bottleneck | peak GB | fits"
        for m in meshes) + " |"
    rows = [head, "|" + "---|" * (2 + 4 * len(meshes))]
    by = {(r["arch"], r["shape"], r["mesh"]): r for r in results}
    for arch, shape in dict.fromkeys((r["arch"], r["shape"]) for r in results):
        cells = []
        for m in meshes:
            r = by.get((arch, shape, m), {})
            if "compute_s" not in r:
                why = "skipped" if "skipped" in r else "FAIL"
                cells.append(f"{why} | | |")
                continue
            cells.append(roofline.RooflineReport(**{
                k: r[k] for k in roofline.RooflineReport.__dataclass_fields__
            }).cells())
        if any(not c.startswith("skipped") for c in cells):
            rows.append(f"| {arch} | {shape} | " + " | ".join(cells) + " |")
    return "\n".join(rows)


def main(argv=None):
    ap = argparse.ArgumentParser(description="dry run on meta tensors")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=[*INPUT_SHAPES, None])
    ap.add_argument("--multi-pod", action="store_true",
                    help="rank 0 of the 2x16x16 grid (default: one card)")
    ap.add_argument("--both-meshes", action="store_true",
                    help="rank 0 of the 16x16 and the 2x16x16 grids")
    ap.add_argument("--all", action="store_true", help="all arch x shape")
    ap.add_argument("--butterfly-layer", type=int, default=None)
    ap.add_argument("--d-r", type=int, default=0)
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)

    archs = ASSIGNED if (args.all or args.arch is None) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = [False, True] if args.both_meshes else \
        [True] if args.multi_pod else [None]
    results = []
    t0 = time.time()
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                try:
                    results.append(run_pair(arch, shape, mp, args.out,
                                            args.butterfly_layer, args.d_r,
                                            tag=args.tag))
                except Exception as e:  # noqa: BLE001 — report and continue
                    print(f"FAIL  {arch:28s} {shape:12s} {_mesh_name(mp):8s} "
                          f"{type(e).__name__}: {e}")
                    results.append({"arch": arch, "shape": shape,
                                    "mesh": _mesh_name(mp),
                                    "error": f"{type(e).__name__}: {e}"})
    n_ok = sum(1 for r in results if "compute_s" in r)
    n_skip = sum(1 for r in results if "skipped" in r)
    n_fail = len(results) - n_ok - n_skip
    if n_ok:
        print("\n" + table(results, [_mesh_name(mp) for mp in meshes]))
    print(f"\ndone: {n_ok} ok, {n_skip} skipped (documented), {n_fail} failed "
          f"in {time.time() - t0:.1f}s")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
