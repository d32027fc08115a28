"""Training loop: loss, train step (autograd + AdamW), eval (port of
``repro/training/train_loop.py``).

The butterfly unit, when configured, trains end to end through the
straight-through wire quantizer (the paper's key property), and its rate
term joins the loss with ``rate_weight``.  Training runs plain PyTorch
autograd: the JAX package trains with ``use_kernel=False`` only, because
its Pallas kernels have no backward, so ``make_train_step`` refuses
``use_kernel=True`` rather than invent one.

Unlike the JAX step, which returns new arrays, ``train_step`` updates the
params and the optimizer state in place (``optimizer.adamw_update``) and
returns them.  Its metrics are 0-d tensors on the params' device: reading
one is the only host sync.

Across ranks (an automatic ``ParallelContext``, ``models/parallel``) each
rank steps on its block of the batch and its shards of the params
(``model.param_specs``): the loss and the rate are the global batch's
means, every rank backpropagates its own term, the gradients of leaves
replicated over a data axis are summed over it, the grad norm is the whole
gradient's, and AdamW updates each rank's shards with no further
collective.  ``accum_steps`` splits each rank's block into microbatches.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.utils.checkpoint

from repro_torch import device as dev_lib
from repro_torch.models import model as M
from repro_torch.models import parallel
from repro_torch.models.parallel import LOCAL, ParallelContext
from repro_torch.training.optimizer import AdamWConfig, adamw_init, adamw_update
from repro_torch.tree import tree_leaves, tree_map

_METRICS = ("loss", "load_balance", "router_z", "wire_rate_bits")


def value_and_grad(fn):
    """``jax.value_and_grad(fn, has_aux=True)`` for a tree of tensors:
    ``fn(params, *args) -> (scalar, aux dict)`` becomes ``g(params, *args)
    -> ((scalar, aux), grads)``, everything detached and the grads in the
    params' layout.  The caller's tensors stay ``requires_grad=False``: the
    graph is built on grad-requiring aliases of their storage."""
    def g(params, *args):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        it = iter(leaves)
        with torch.enable_grad():
            value, aux = fn(tree_map(lambda _: next(it), params), *args)
            grads = iter(torch.autograd.grad(value, leaves))
        return ((value.detach(), {k: v.detach() for k, v in aux.items()}),
                tree_map(lambda _: next(grads), params))
    return g


def make_loss_fn(built: M.BuiltModel, pctx: ParallelContext = LOCAL,
                 use_kernel: bool = False):
    bf = built.cfg.butterfly
    rate_weight = bf.rate_weight if bf is not None else 0.0

    def loss_fn(params, batch):
        # next-token objective: batch["targets"] is already shifted by the
        # data pipeline (targets[t] = tokens[t+1], -1 where masked); a
        # vocab-sharded head's logits stay blocks, and the loss is taken on them
        loss, aux = M.forward_loss(params, built, batch, pctx, use_kernel)
        rate = aux["wire_rate_bits"]
        total = loss + aux["load_balance"] + aux["router_z"] + rate_weight * rate
        metrics = {"loss": loss, "load_balance": aux["load_balance"],
                   "router_z": aux["router_z"], "wire_rate_bits": rate}
        return total, metrics
    return loss_fn


def make_train_step(built: M.BuiltModel, opt_cfg: AdamWConfig,
                    pctx: ParallelContext = LOCAL, use_kernel: bool = False,
                    remat: bool = False, accum_steps: int = 1):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``.  ``remat`` recomputes the forward in the backward
    (``torch.utils.checkpoint``); ``accum_steps > 1`` splits the batch's
    leading dim into that many microbatches, run one after another, and
    averages their f32-summed grads before the one optimizer update.
    Under an automatic ``pctx`` the params, optimizer state and batch are
    this rank's (module docstring)."""
    if use_kernel:
        raise NotImplementedError(
            "training through the kernels needs their backward, and none "
            "exists: the JAX package cannot differentiate its Pallas kernels "
            "either (_pallas_call_jvp_rule); train with use_kernel=False")
    loss_fn = make_loss_fn(built, pctx)
    specs = M.param_specs(built, pctx.grid) if pctx.automatic else None
    if remat:
        plain = loss_fn
        loss_fn = lambda params, batch: torch.utils.checkpoint.checkpoint(
            plain, params, batch, use_reentrant=False)

    grads_of = value_and_grad(loss_fn)

    def train_step(params, opt_state, batch):
        if accum_steps == 1:
            (total, metrics), grads = grads_of(params, batch)
        else:
            B = next(iter(batch.values())).shape[0]
            if B % accum_steps:
                raise ValueError(f"batch {B} does not split into "
                                 f"{accum_steps} microbatches")
            micro = zip(*(torch.split(v, B // accum_steps) for v in batch.values()))
            grads, total, metrics = None, 0.0, dict.fromkeys(_METRICS, 0.0)
            for mb in micro:
                (t, m), g = grads_of(params, dict(zip(batch, mb)))
                g = tree_map(lambda a: a.float(), g)
                grads = g if grads is None else tree_map(torch.add, grads, g)
                total = total + t
                metrics = {k: metrics[k] + m[k] for k in _METRICS}
            grads = tree_map(lambda g: g / accum_steps, grads)
            total = total / accum_steps
            metrics = {k: v / accum_steps for k, v in metrics.items()}
        if specs is not None:
            grads = sum_replicated_grads(grads, specs, pctx)
        params, opt_state, gnorm = adamw_update(opt_cfg, params, grads,
                                                opt_state, pctx=pctx,
                                                specs=specs)
        return params, opt_state, dict(metrics, total=total, grad_norm=gnorm)

    return train_step


def sum_replicated_grads(grads, specs: dict, pctx: ParallelContext):
    """Each rank's gradient terms summed over the data axes that do not
    shard the leaf (in place): a leaf replicated over ``data`` gets every
    data rank's term; an FSDP shard already got them from its gather's
    backward.  The leaves summed over the same axes go in one all-reduce
    (a bucket a group and dtype), in the same order on every rank."""
    grid = pctx.grid
    buckets: dict = {}
    for g, axes in zip(tree_leaves(grads),
                       parallel.leaf_axes(specs, grads, grid)):
        over = tuple(a for a in pctx.data_axes if a not in axes)
        if grid.group(over) is not None:
            buckets.setdefault((over, g.dtype), []).append(g)
    for (over, _), leaves in buckets.items():
        flat = torch.cat([g.reshape(-1) for g in leaves])
        dist.all_reduce(flat, group=grid.group(over))
        for g, part in zip(leaves, flat.split([g.numel() for g in leaves])):
            g.copy_(part.view_as(g))
    return grads


def make_eval_step(built: M.BuiltModel, pctx: ParallelContext = LOCAL):
    loss_fn = make_loss_fn(built, pctx)

    @torch.no_grad()
    def eval_step(params, batch):
        _, metrics = loss_fn(params, batch)
        return metrics

    return eval_step


def init_train_state(gen: torch.Generator, built: M.BuiltModel, *,
                     device="cuda", grid=None):
    """(params, optimizer state, specs) from ``gen`` (a generator on
    ``device``): the whole tree, and the automatic regime's layout of it
    over ``grid`` (``model.param_specs``: a spec tree a grid axis), which
    ``parallel.shard_grid`` cuts a rank's shards by."""
    params = M.init_model(gen, built, device=dev_lib.resolve(device))
    return params, adamw_init(params), M.param_specs(built, grid)


def opt_state_specs(param_specs: dict) -> dict:
    """The optimizer state's layout mirrors the params': each axis's spec
    tree for both moments, the step replicated."""
    return {axis: None if t is None else {"mu": t, "nu": t, "step": None}
            for axis, t in param_specs.items()}
