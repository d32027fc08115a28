"""Mixture-of-Experts layer with sort-based dropped dispatch (port of
``repro/models/moe.py``, its local path).

Tokens are ranked into per-expert capacity slots with a stable argsort over
expert ids, never through an O(T*E*C) one-hot dispatch tensor, and
scattered k times into an ``(E*C, d)`` buffer; the experts' GLU runs as one
batched matmul over that buffer, and k gathers weighted by the renormalised
gates combine the result.  A (token, choice) past its expert's capacity is
dropped: it writes to one spare row that is sliced off, and reads a zero
row.  Router math runs in f32, and the router weight stays f32 in a bf16
model.  The load-balance and router-z aux losses come back scaled by their
coefficients.

All three of the JAX package's paths are ported.  Under tensor
parallelism in the manual regime every model rank routes all tokens
identically into the same capacity slots (the f32 router is replicated),
computes only its ``E/mp`` experts, those from ``e_offset = rank * E/mp``,
and the partial combines are summed over the ranks.

The automatic regime (an automatic ``ParallelContext``, JAX's own
``shard_map`` over the mesh) runs one process a rank: tokens are this
rank's block of the batch over the data axes, experts shard over
``model`` (over ``pod`` and ``model`` with :data:`EXPERTS_OVER_POD`), and
the experts' ``d_ff`` over ``data`` (FSDP) where ``F % 16 == 0``,
all-gathered just in time.  Capacity is reckoned from a rank's own tokens,
so a data shard competes for capacity alone; the partial combines are
summed over ``model``, the aux losses averaged over the data axes.  At one
token a sequence, :data:`DECODE_BROADCAST` all-gathers the tokens instead
of the weights, ranks all ``B*S`` of them for capacity, sums the d_ff
partial outputs over ``model`` and ``data`` and takes back this rank's
rows.  Under experts over the pod axis the decode broadcast also sums over
``pod``: the JAX branch sums over ``model`` and ``data`` only and so drops
the other pod's experts (``moe.py:168``, ``:236-241`` there); the port
computes the layer, which is the local path's answer.  A batch smaller
than the data axes is held whole on every rank and gives the local path's
answer too (capacity from all its tokens, none gathered twice over
``pod``); JAX's branch does not trace that case under jax 0.9.
"""
from __future__ import annotations

import math
import os

import torch

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models.common import apply_mlp, dense_init, glu_act, init_mlp
from repro_torch.models import parallel
from repro_torch.models.parallel import LOCAL, ParallelContext, model_psum

# Experts over the pod axis too (the JAX package's multi-pod FSDP option,
# off by default); read at each call, as there
EXPERTS_OVER_POD = os.environ.get("REPRO_MOE_EXPERTS_OVER_POD", "0") == "1"
# The decode path broadcasts tokens rather than gathering weights (on by
# default, as in the JAX package); REPRO_MOE_DECODE_BROADCAST=0 gathers the
# weights at S == 1 as at any other length
DECODE_BROADCAST = os.environ.get("REPRO_MOE_DECODE_BROADCAST", "1") == "1"

# the f32 draw of one chunk of experts holds at most this many elements, so
# initialising a (128, 5120, 8192) bf16 expert weight never makes its whole
# f32 temporary (21.5 GB)
_INIT_CHUNK = 1 << 28


def _expert_weights(gen, E: int, d_in: int, d_out: int, dtype, device):
    """(E, d_in, d_out): a normal truncated to (-2, 2), times sqrt(1/d_in),
    drawn in f32 a chunk of experts at a time and cast to ``dtype``."""
    out = torch.empty((E, d_in, d_out), dtype=dtype, device=device)
    step = max(1, _INIT_CHUNK // (d_in * d_out))
    for e in range(0, E, step):
        t = torch.empty((min(step, E - e), d_in, d_out), dtype=torch.float32,
                        device=device)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
        out[e:e + step] = t.mul_(math.sqrt(1.0 / d_in))
        del t
    return out


def init_moe(gen, cfg: ModelConfig, dtype, device) -> dict:
    """The JAX package's layout: ``router`` (d, E) in f32, ``wg``/``wu``
    (E, d, F) and ``wd`` (E, F, d) in ``dtype``, and the shared expert's
    GLU under ``shared`` when the config has one."""
    m = cfg.moe
    d, E, F = cfg.d_model, m.num_experts, m.d_ff_expert
    params = {
        "router": dense_init(gen, d, E, torch.float32, device),
        "wg": _expert_weights(gen, E, d, F, dtype, device),
        "wu": _expert_weights(gen, E, d, F, dtype, device),
        "wd": _expert_weights(gen, E, F, d, dtype, device),
    }
    if m.shared_expert_ff:
        params["shared"] = init_mlp(gen, d, m.shared_expert_ff, dtype, device)
    return params


def _capacity(tokens: int, mcfg: MoEConfig) -> int:
    cap = int(math.ceil(tokens * mcfg.top_k / mcfg.num_experts
                        * mcfg.capacity_factor))
    return max(cap, 1)


def route(x_flat, router, mcfg: MoEConfig, capacity: int, forced=None):
    """f32 routing of (T, d) tokens: returns ``(logits, probs, gate, eids,
    pos, dst)``.  ``eids`` (T, k) are the top-k experts, highest
    probability first and the lower expert id first on a tie (as
    ``lax.top_k``: a stable descending sort); ``gate`` their renormalised
    probabilities; ``pos`` each choice's slot within its expert, in token
    order, then choice order; ``dst`` its row of the (E*C, d) buffer, or
    E*C (the spare row) where ``pos >= capacity``.

    ``forced``, an ``(eids, pos)`` pair of another run's routes, replaces
    the computed ones (the gates are then these experts' renormalised
    probabilities), so that a reference run can take the routes another
    path took; routes equal to the computed ones give the same result, bit
    for bit.  None computes them."""
    T = x_flat.shape[0]
    E, k = mcfg.num_experts, mcfg.top_k
    logits = x_flat.float() @ router                              # (T, E)
    probs = torch.softmax(logits, dim=-1)
    if forced is not None:
        eids, pos = forced
        gate = torch.gather(probs, 1, eids)
        gate = gate / gate.sum(dim=-1, keepdim=True)
    else:
        sorted_p, order_p = torch.sort(probs, dim=-1, descending=True,
                                       stable=True)
        gate, eids = sorted_p[:, :k], order_p[:, :k]
        gate = gate / gate.sum(dim=-1, keepdim=True)

        flat_e = eids.reshape(-1)                                 # (T*k,)
        order = torch.argsort(flat_e, stable=True)
        se = flat_e[order]
        group_start = torch.searchsorted(se, torch.arange(E, device=x_flat.device))
        ar = torch.arange(T * k, device=x_flat.device)
        pos_sorted = ar - group_start[se]
        inv = torch.empty_like(order)
        inv[order] = ar
        pos = pos_sorted[inv].reshape(T, k)
    dst = torch.where(pos < capacity, eids * capacity + pos, E * capacity)
    return logits, probs, gate, eids, pos, dst


def moe_dispatch(x_flat, router, wg, wu, wd, *, mcfg: MoEConfig, act: str,
                 capacity: int, e_offset: int = 0, copy=None):
    """``_moe_shard`` of the JAX package: (T, d) tokens -> ((T, d) output,
    load-balance loss, router-z loss), the losses unscaled.  ``wg``/``wu``/
    ``wd`` hold the experts ``[e_offset, e_offset + E_local)``; a choice of
    another expert, or past its expert's capacity, adds nothing here.
    ``copy`` (Megatron's f, ``parallel.model_copy``) wraps what only this
    rank's experts read, the dispatched tokens and the gates, so that
    their gradients sum over the model axis; the router's own math is
    replicated and stays outside it."""
    T, d = x_flat.shape
    E, k = mcfg.num_experts, mcfg.top_k
    E_local = wg.shape[0]
    logits, probs, gate, eids, pos, dst = route(x_flat, router, mcfg, capacity)
    x_in = x_flat
    if copy is not None:
        x_in, gate = copy(x_flat), copy(gate)
    if E_local != E:
        local_e = eids - e_offset
        keep = (pos < capacity) & (local_e >= 0) & (local_e < E_local)
        dst = torch.where(keep, local_e * capacity + pos, E_local * capacity)

    # dispatch: k scatters of (T, d) into E_local*C rows and one spare
    buf = x_flat.new_zeros((E_local * capacity + 1, d))
    for j in range(k):
        buf[dst[:, j]] = x_in
    buf = buf[:-1].reshape(E_local, capacity, d)

    # the experts' GLU, batched over experts
    h = glu_act(torch.bmm(buf, wg), act) * torch.bmm(buf, wu)
    out_buf = torch.bmm(h, wd).reshape(E_local * capacity, d)
    out_buf = torch.cat([out_buf, out_buf.new_zeros((1, d))])     # dropped: 0

    # combine: k gathers weighted by the gates
    out = x_flat.new_zeros((T, d))
    for j in range(k):
        out = out + gate[:, j, None].to(x_flat.dtype) * out_buf[dst[:, j]]

    me = probs.mean(dim=0)                                        # (E,)
    # the choices an expert got (a scatter, not bincount, whose output size
    # depends on the data, so that the dry run can trace it on meta)
    flat = eids.reshape(-1)
    counts = torch.zeros(E, dtype=flat.dtype, device=flat.device).scatter_add_(
        0, flat, torch.ones_like(flat))
    frac = counts.float() / (T * k)
    lb_loss = E * torch.sum(me * frac)
    z_loss = torch.logsumexp(logits, dim=-1).square().mean()
    return out, lb_loss, z_loss


def apply_moe(params, x, *, cfg: ModelConfig, act: str,
              pctx: ParallelContext = LOCAL):
    """x (B, S, d) -> (out, aux): every one of the B*S tokens competes for
    the same capacity, ``ceil(B*S*k/E * capacity_factor)`` slots an
    expert; aux holds ``load_balance`` and ``router_z`` (0-d f32, times
    their coefficients, the same on every model rank).  Under tensor
    parallelism the params hold this rank's ``E/mp`` experts and the
    routed output is summed over the ranks.  Under an automatic context x
    is this rank's block and the branch above applies
    (:func:`_apply_automatic`).  The shared expert, when there is one, is
    replicated and adds its GLU of every token."""
    mcfg = cfg.moe
    B, S, d = x.shape
    if pctx.automatic:
        out, lb, zl = _apply_automatic(params, x, mcfg, act, pctx)
    else:
        mp = pctx.mp_size if pctx.manual else 1
        if mcfg.num_experts % mp:
            raise ValueError(f"model axis {mp} must divide num_experts "
                             f"({mcfg.num_experts})")
        out, lb, zl = moe_dispatch(
            x.reshape(B * S, d), params["router"], params["wg"], params["wu"],
            params["wd"], mcfg=mcfg, act=act, capacity=_capacity(B * S, mcfg),
            e_offset=pctx.rank * (mcfg.num_experts // mp) if mp > 1 else 0)
        out = model_psum(out, pctx).reshape(B, S, d)
    aux = {"load_balance": lb * mcfg.load_balance_coef,
           "router_z": zl * mcfg.router_z_coef}
    if mcfg.shared_expert_ff:
        out = out + apply_mlp(params["shared"], x, act)
    return out, aux


def ff_sharded(mcfg: MoEConfig, data: int) -> bool:
    """Whether the experts' d_ff shards over a data axis of ``data`` ranks
    (FSDP): the JAX package's rule, ``d_ff_expert % 16 == 0``, whatever
    the axis; a data axis that does not divide such a d_ff raises."""
    F = mcfg.d_ff_expert
    if F % 16:
        return False
    if F % data:
        raise ValueError(f"data axis {data} must divide d_ff_expert ({F})")
    return True


def _apply_automatic(params, x, mcfg: MoEConfig, act: str,
                     pctx: ParallelContext):
    """The JAX package's automatic branch on this rank: x (B, S, d) is this
    rank's block of the batch (the whole batch when it is replicated),
    ``wg``/``wu``/``wd`` this rank's expert shard, their d_ff its data
    block where :func:`ff_sharded`.  Returns the rank's (B, S, d) output
    and the aux losses, unscaled and averaged over the data axes."""
    B, S, d = x.shape
    grid, mp, dp = pctx.grid, pctx.mp_size, pctx.dp_size
    over_pod = EXPERTS_OVER_POD and "pod" in grid.axes
    n_pods = grid.axis_size("pod") if over_pod else 1
    ep = n_pods * mp
    E = mcfg.num_experts
    if E % ep:
        raise ValueError(f"the expert axes ({ep} ranks) must divide "
                         f"num_experts ({E})")
    sharded = dp > 1 and not pctx.replicated_batch
    decode = DECODE_BROADCAST and S == 1
    ff = ff_sharded(mcfg, grid.axis_size("data"))
    e_off = (grid.index("pod") * mp + pctx.rank if over_pod else pctx.rank) \
        * (E // ep)
    copy = lambda t: parallel.model_copy(t, pctx)
    router, wg, wu, wd = (params[k] for k in ("router", "wg", "wu", "wd"))
    xf = x.reshape(B * S, d)
    if decode:
        # gather the (tiny) token blocks instead of the weights, pod-major
        if sharded:
            xf = parallel.all_gather(xf, 0, pctx.data_group)
        out, lb, zl = moe_dispatch(xf, router, wg, wu, wd, mcfg=mcfg, act=act,
                                   capacity=_capacity(xf.shape[0], mcfg),
                                   e_offset=e_off, copy=copy)
        out = model_psum(out, pctx)
        # the d_ff partials (data) and, with experts over the pod axis, the
        # other pod's experts; then this rank's rows
        axes = (("pod",) if over_pod else ()) + (("data",) if ff else ())
        out = parallel.psum_scatter(out, 0, pctx.data_rank if sharded else 0,
                                    dp if sharded else 1, grid.group(axes))
    else:
        if ff:
            group = grid.group("data")
            wg = parallel.all_gather(wg, 2, group)
            wu = parallel.all_gather(wu, 2, group)
            wd = parallel.all_gather(wd, 1, group)
        gather = over_pod and sharded
        if gather:
            # every expert rank sees the candidate tokens of both pods
            xf = parallel.all_gather(xf, 0, grid.group("pod"))
        out, lb, zl = moe_dispatch(xf, router, wg, wu, wd, mcfg=mcfg, act=act,
                                   capacity=_capacity(xf.shape[0], mcfg),
                                   e_offset=e_off, copy=copy)
        out = model_psum(out, pctx)
        if over_pod:
            # the other pod's experts; then this pod's rows
            out = parallel.psum_scatter(
                out, 0, grid.index("pod") if gather else 0,
                n_pods if gather else 1, grid.group("pod"))
    # the aux losses averaged over the data shards
    lb = parallel.reduce_sum(lb, pctx.data_group) / dp
    zl = parallel.reduce_sum(zl, pctx.data_group) / dp
    return out.reshape(B, S, d), lb, zl
