"""Training launcher (port of ``repro.launch.train``'s local mode: the same
flags and the same log lines, plus ``--device``).

Trains a (reduced or custom) config on the synthetic LM stream on one
device: ``cuda`` by default, ``cpu`` on request; it raises, never falls
back, when the device is missing.  ``--checkpoint`` saves in the JAX
package's ``.npz`` format (``training.checkpoint``).  ``--lower-only`` traces the
full config's train step at ``train_4k`` on meta tensors
(``launch/dryrun.py``) and writes its record to ``build/dryrun/``: on one
card, or with ``--multi-pod`` as rank 0 of the 2x16x16 grid, its
collectives counted.  Training across
ranks is the train step under an automatic context
(``training.make_train_step(built, opt, pctx)``); the launcher, as the JAX
package's, trains on one device.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b --reduced \\
      --steps 200 --batch 16 --seq 128 --butterfly-layer 1 --d-r 32
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 20 \\
      --batch 4 --seq 32 --vocab 64 --butterfly-layer 1 --d-r 16
"""
from __future__ import annotations

import argparse
import dataclasses
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--vocab", type=int, default=0, help="override vocab (synthetic data)")
    ap.add_argument("--butterfly-layer", type=int, default=None)
    ap.add_argument("--d-r", type=int, default=32)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--lower-only", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; raises if it is missing")
    args = ap.parse_args(argv)

    if args.lower_only:
        from repro_torch.launch.dryrun import OUT_DIR, run_pair
        run_pair(args.arch, "train_4k", True if args.multi_pod else None,
                 OUT_DIR)
        return

    import torch

    from repro_torch import device as dev_lib
    from repro_torch.configs import get_config
    from repro_torch.data import lm_batches
    from repro_torch.models import model as M
    from repro_torch.training import (AdamWConfig, adamw_init, cosine_schedule,
                                      make_train_step)
    from repro_torch.training.checkpoint import save_checkpoint
    from repro_torch.tree import tree_leaves

    device = dev_lib.resolve(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.vocab:
        cfg = dataclasses.replace(cfg, vocab_size=args.vocab)
    if args.butterfly_layer is not None:
        cfg = cfg.with_butterfly(args.butterfly_layer, args.d_r)
    built = M.build(cfg)
    params = M.init_model(torch.Generator(device=device).manual_seed(0), built,
                          device=device)
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M butterfly={cfg.butterfly}")

    opt_state = adamw_init(params)
    opt_cfg = AdamWConfig(lr=cosine_schedule(args.lr, 20, args.steps))
    step_fn = make_train_step(built, opt_cfg)
    stream = lm_batches(cfg.vocab_size, args.seq, args.batch)

    t0 = time.time()
    for i, raw in zip(range(args.steps), stream):
        batch = {k: dev_lib.as_tensor(v, device) for k, v in raw.items()}
        dt = dev_lib.torch_dtype(cfg.dtype)
        if cfg.num_patches:
            # the stub vision frontend's zero patches, placed before the
            # tokens; no target is scored over them
            batch["patches"] = torch.zeros(
                (args.batch, cfg.num_patches, cfg.d_model), dtype=dt, device=device)
            batch["targets"] = torch.cat(
                [torch.full((args.batch, cfg.num_patches), -1,
                            dtype=batch["targets"].dtype, device=device),
                 batch["targets"]], dim=1)
        if cfg.is_encdec:
            batch["frames"] = torch.zeros(
                (args.batch, cfg.encoder_frames, cfg.d_model), dtype=dt,
                device=device)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if i % args.log_every == 0 or i == args.steps - 1:
            tput = (i + 1) * args.batch * args.seq / (time.time() - t0)
            print(f"step {i:5d} loss {float(metrics['loss']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.2f} "
                  f"tok/s {tput:,.0f}")
    if args.checkpoint:
        path = save_checkpoint(args.checkpoint, params, opt_state,
                               step=args.steps, metadata={"arch": cfg.name})
        print("saved", path)


if __name__ == "__main__":
    main()
