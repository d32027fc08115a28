"""The paper's experiment at reproducible scale (the port's counterpart of
``examples/train_resnet_butterfly.py``): train ResNet+butterfly end to end
for every (split x D_r) on the synthetic image task, reproduce the Fig. 7
accuracy-vs-D_r trend, then run Algorithm 1 (profile + select) across
3G/4G/Wi-Fi — the miniature of Tables IV/V.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_resnet_butterfly \\
          [--steps 150] [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch import device as dev_lib
from repro_torch.configs.resnet50 import PAPER_MIN_DR, resnet50
from repro_torch.core import costs
from repro_torch.core.planner import (TrainingPhaseResult, profiling_phase,
                                      selection_phase)
from repro_torch.core.profiler import GTX_1080TI, JETSON_TX2
from repro_torch.core.wireless import NETWORKS
from repro_torch.data import ImageTaskConfig, SyntheticImages
from repro_torch.models.resnet import forward_resnet, init_resnet
from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                            adamw_update, constant_schedule)
from repro_torch.training.train_loop import value_and_grad


def resnet_loss(params, images, labels, cfg):
    """Mean cross entropy of the logits; returns (loss, {})."""
    logits = forward_resnet(params, images, cfg, train=True)
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels[:, None].long()).mean(), {}


def make_resnet_step(cfg, ocfg: AdamWConfig):
    """``step(params, opt, images, labels) -> (params, opt, loss, grad
    norm)``: one AdamW update (in place) on the cross entropy."""
    grads_of = value_and_grad(resnet_loss)

    def step(params, opt, images, labels):
        (loss, _), grads = grads_of(params, images, labels, cfg)
        params, opt, gnorm = adamw_update(ocfg, params, grads, opt)
        return params, opt, loss, gnorm
    return step


def train_and_eval(cfg, steps: int, seed: int = 0, device="cuda") -> float:
    device = dev_lib.resolve(device)
    params = init_resnet(torch.Generator(device=device).manual_seed(seed), cfg,
                         device=device)
    task = SyntheticImages(ImageTaskConfig(num_classes=cfg.num_classes,
                                           image_size=cfg.image_size))
    rng = np.random.default_rng(seed)
    opt = adamw_init(params)
    step = make_resnet_step(cfg, AdamWConfig(lr=constant_schedule(1e-3),
                                             weight_decay=1e-4))
    for _ in range(steps):
        x, y = task.batch(32, rng)
        params, opt, _, _ = step(params, opt, dev_lib.as_tensor(x, device),
                                 dev_lib.as_tensor(y, device))
    xs, ys = task.batch(256, np.random.default_rng(999))
    with torch.no_grad():
        logits = forward_resnet(params, dev_lib.as_tensor(xs, device), cfg,
                                train=False)
    return float((logits.argmax(-1).cpu() == torch.from_numpy(ys)).float().mean())


def algorithm1_selection() -> dict:
    """Profiling and selection on the FULL ResNet-50's costs (the paper's
    model) with the paper's least D_r per split: ``{(network, objective):
    Selection}``."""
    full = resnet50()

    def split_costs(split, d_r):
        ef, cf, wire = costs.resnet_split_flops(full, split, d_r)
        return ef, ef / 10, cf, cf / 10, wire

    trained_full = [TrainingPhaseResult(s, PAPER_MIN_DR[s], 0.74)
                    for s in range(1, 17)]
    profiles = profiling_phase(trained_full, split_costs, JETSON_TX2, GTX_1080TI)
    return {(net_name, objective): selection_phase(profiles, net, objective)
            for net_name, net in NETWORKS.items()
            for objective in ("latency", "energy")}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; raises if it is missing")
    args = ap.parse_args(argv)

    base = resnet50().reduced()          # 2 residual blocks at 32x32
    target = train_and_eval(base, args.steps, device=args.device)
    print(f"baseline (no butterfly) accuracy: {target:.3f}")

    # Fig. 7 trend: accuracy vs D_r for each split
    print("\naccuracy vs D_r (paper Fig. 7, miniature):")
    results = {}
    for split in range(1, base.num_blocks + 1):
        row = {}
        for d_r in (1, 2, 4, 8):
            row[d_r] = train_and_eval(base.with_butterfly(split, d_r),
                                      args.steps, device=args.device)
        results[split] = row
        print(f"  after RB{split}: " +
              "  ".join(f"D_r={d}: {a:.3f}" for d, a in row.items()))

    # Algorithm 1 training phase result: minimal D_r within 2% of target
    for split, row in results.items():
        ok = [d for d, a in row.items() if a >= target - 0.02]
        d_r = min(ok) if ok else max(row)
        print(f"  minimal D_r for RB{split}: {d_r} (acc {row[d_r]:.3f})")

    print("\nAlgorithm 1 selection on full ResNet-50 (paper min-D_r):")
    for (net_name, objective), sel in algorithm1_selection().items():
        print(f"  {net_name:5s} {objective:8s}: split after RB{sel.split} "
              f"(D_r={sel.d_r})  latency {sel.latency_s*1e3:.2f} ms  "
              f"energy {sel.energy_mj:.2f} mJ")


if __name__ == "__main__":
    main()
