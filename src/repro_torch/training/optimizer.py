"""AdamW and learning-rate schedules (port of
``repro/training/optimizer.py``).

The optimizer state is a tree parallel to the params, ``{"mu", "nu",
"step"}``: f32 moments of the params' layout and an int32 0-d step.
``adamw_update`` follows the JAX package's arithmetic step for step: the
learning rate at the new 1-based step, the global grad norm taken before
the clip, the bias correction in f32, weight decay on every leaf with
``ndim >= 2`` (a layer's norm weight, stacked over repeats to ``(reps, d)``,
is decayed as in the JAX package; ``final_norm`` ``(d,)`` is not), and the
new param computed in f32 and cast to the param's dtype.

Unlike the JAX function, the update is made IN PLACE: the params' and the
moments' storage is overwritten (no second copy of either is allocated),
and the same trees are returned.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.models import parallel
from repro_torch.models.parallel import LOCAL, ParallelContext
from repro_torch.tree import tree_leaves, tree_map

# ---------------------------------------------------------------------------
# schedules: step (a tensor or int) -> f32 0-d tensor on the step's device
# ---------------------------------------------------------------------------


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1) -> Callable:
    def fn(step):
        step = torch.as_tensor(step).float()
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
        cos = base_lr * (min_frac + (1 - min_frac) * 0.5 *
                         (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)
    return fn


def constant_schedule(lr: float) -> Callable:
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=torch.as_tensor(step).device)


# ---------------------------------------------------------------------------
# adamw
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AdamWConfig:
    lr: Callable
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: Optional[float] = 1.0


def adamw_init(params) -> dict:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    device = tree_leaves(params)[0].device
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree, specs: Optional[dict] = None,
                pctx: ParallelContext = LOCAL) -> torch.Tensor:
    """The L2 norm of the whole tree.  Under an automatic ``pctx`` with the
    tree's ``specs`` (``model.param_specs``) each leaf is a rank's shard:
    the squares of the leaves sharded over the same axes are summed and
    all-reduced over those axes, replicated leaves counted once, so every
    rank gets the norm of the whole gradient."""
    if pctx.grid is None or specs is None:
        return torch.sqrt(torch.stack([x.float().square().sum()
                                       for x in tree_leaves(tree)]).sum())
    sums: dict = {}
    for x, axes in zip(tree_leaves(tree),
                       parallel.leaf_axes(specs, tree, pctx.grid)):
        sq = x.float().square().sum()
        sums[axes] = sq if axes not in sums else sums[axes] + sq
    total = None
    for axes, sq in sums.items():
        group = pctx.grid.group(axes)
        if group is not None:
            dist.all_reduce(sq, group=group)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state, *,
                 pctx: ParallelContext = LOCAL, specs: Optional[dict] = None):
    """One AdamW step on ``params`` (updated in place) from ``grads`` (a
    tree of the params' layout, any float dtype).  Returns (params, state,
    grad norm before the clip); nothing here waits for the device.  Across
    ranks, each rank's shards with the whole gradient's norm
    (:func:`global_norm` with ``specs`` and ``pctx``)."""
    step = state["step"] + 1
    lr = cfg.lr(step)
    gnorm = global_norm(grads, specs, pctx)
    scale = None
    if cfg.grad_clip is not None:
        scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
    t = step.float()
    bc1 = 1 - torch.pow(cfg.b1, t)
    bc2 = 1 - torch.pow(cfg.b2, t)

    def upd(p, g, mu, nu):
        g = g.float() if scale is None else g.float() * scale
        mu.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        nu.mul_(cfg.b2).add_((1 - cfg.b2) * g.square())
        delta = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
        if p.ndim >= 2:                        # no decay on norms/biases
            delta = delta + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)

    tree_map(upd, params, grads, state["mu"], state["nu"])
    state["step"] = step
    return params, state, gnorm
