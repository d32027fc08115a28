"""The paper's deployment on two pods (the port's counterpart of
``examples/split_serving.py``): the edge pod computes the prefix and the
reduction unit, only the int8 codes and their scales cross the pod
boundary, the cloud pod restores and finishes, and the logits return.

Both pods are on ``--device``, each with its own stream on a card.  The
JAX script counts the int8 collective-permutes in the compiled HLO; here
the pipeline's ``crossings`` list records every crossing, and the count is
of those that carry int8.

Run:  PYTHONPATH=src python -m repro_torch.examples.split_serving [--device cpu]
"""
import argparse

import torch

from repro_torch import device as dev_lib
from repro_torch.configs import get_config
from repro_torch.models import model as M
from repro_torch.serving.pipeline import make_split_pipeline, wire_stats


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; raises if it is missing")
    device = dev_lib.resolve(ap.parse_args(argv).device)

    cfg = get_config("gemma3-12b").reduced().with_butterfly(layer=1, d_r=16)
    built = M.build(cfg)
    params = M.init_model(torch.Generator(device=device).manual_seed(0), built,
                          device=device)

    Mmb, mb, S = 4, 2, 32
    toks = torch.randint(0, cfg.vocab_size, (Mmb * mb, S), device=device,
                         generator=torch.Generator(device=device).manual_seed(1))

    pipe = make_split_pipeline(built, (device, device), Mmb, S, mb)
    crossings = []
    logits = pipe(params, toks, crossings)

    stats = wire_stats(cfg, mb, S)
    print(f"arch {cfg.name}: butterfly after layer {cfg.butterfly.layer}, "
          f"d_model {cfg.d_model} -> d_r {cfg.butterfly.d_r}")
    print(f"pod-boundary bytes/microbatch: wire {stats['wire_bytes']:,} vs "
          f"raw {stats['raw_boundary_bytes']:,}  "
          f"({stats['compression']:.1f}x compression)")

    ref, _ = M.forward_train(params, built, {"tokens": toks})
    err = float((logits - ref[:, -1]).abs().max())
    print(f"pipeline vs in-graph max |err|: {err:.2e}")

    n_int8 = sum(1 for c in crossings if c[1] == torch.int8)
    print(f"int8 crossings between the pods: {n_int8}")


if __name__ == "__main__":
    main()
