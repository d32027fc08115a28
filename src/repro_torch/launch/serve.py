"""Serving launcher (port of ``repro.launch.serve``: the same flags and the
same lines, plus ``--device``): batched requests through the ServingEngine
(single-device baseline) or the two-pod split pipeline (``--split``, the
paper's deployment) with both pods on ``--device``, each with its own
stream on a card.  The model is the arch's reduced config with the byte
tokenizer's vocabulary; ``--checkpoint`` restores a ``.npz`` saved by
either package's ``training.checkpoint``.  ``cuda`` by default; it raises,
never falls back, when the device is missing.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b --prompts "hello" "world"
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-12b --split
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --split
"""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--prompts", nargs="*", default=["the quick brown fox",
                                                     "once upon a time"])
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--split", action="store_true",
                    help="2-pod split pipeline demo (both pods on --device)")
    ap.add_argument("--butterfly-layer", type=int, default=1)
    ap.add_argument("--d-r", type=int, default=32)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; raises if it is missing")
    args = ap.parse_args(argv)

    import dataclasses

    import numpy as np
    import torch

    from repro_torch import device as dev_lib
    from repro_torch.configs import get_config
    from repro_torch.data import tokenizer as tok
    from repro_torch.models import model as M

    device = dev_lib.resolve(args.device)
    cfg = get_config(args.arch).reduced()
    cfg = dataclasses.replace(cfg, vocab_size=max(cfg.vocab_size, tok.VOCAB_SIZE))
    if args.split:
        cfg = cfg.with_butterfly(args.butterfly_layer, args.d_r)
    built = M.build(cfg)
    params = M.init_model(torch.Generator(device=device).manual_seed(0), built,
                          device=device)
    if args.checkpoint:
        from repro_torch.training.checkpoint import restore_checkpoint
        params, _, meta = restore_checkpoint(args.checkpoint, params)
        print("restored", meta)

    if args.split:
        from repro_torch.serving.pipeline import make_split_pipeline, wire_stats
        S = 32
        toks = np.stack([np.resize(tok.encode(p), S) for p in args.prompts])
        Mmb = len(args.prompts)
        pipe = make_split_pipeline(built, (device, device), Mmb, S, 1)
        logits = pipe(params, toks)
        stats = wire_stats(cfg, 1, S)
        print(f"split pipeline over pod axis: wire={stats['wire_bytes']}B/mb "
              f"raw={stats['raw_boundary_bytes']}B compression={stats['compression']:.1f}x")
        for p, l in zip(args.prompts, logits):
            print(f"  {p!r} -> next-token id {int(torch.argmax(l))}")
        return

    from repro_torch.serving.engine import ServingEngine
    eng = ServingEngine(params, built, max_batch=max(4, len(args.prompts)),
                        max_len=256, device=device)
    reqs = [eng.submit(tok.encode(p), max_new_tokens=args.max_new_tokens,
                       temperature=args.temperature)
            for p in args.prompts]
    eng.run()
    for p, r in zip(args.prompts, reqs):
        print(f"  {p!r} -> {tok.decode(r.generated)!r} (ids {r.generated})")


if __name__ == "__main__":
    main()
