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

The JAX package's local path and its manual path are ported.  Under
tensor parallelism (a ``ParallelContext`` in the manual regime) every model
rank routes all tokens identically into the same capacity slots (the f32
router is replicated), computes only its ``E/mp`` experts, those from
``e_offset = rank * E/mp``, and the partial combines are summed over the
ranks.  The automatic regime (MoE's own ``shard_map`` with data axes, the
decode broadcast, experts over the pod axis) is not ported.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models.common import apply_mlp, dense_init, glu_act, init_mlp
from repro_torch.models.parallel import LOCAL, ParallelContext, model_psum

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
                 capacity: int, e_offset: int = 0):
    """``_moe_shard`` of the JAX package: (T, d) tokens -> ((T, d) output,
    load-balance loss, router-z loss), the losses unscaled.  ``wg``/``wu``/
    ``wd`` hold the experts ``[e_offset, e_offset + E_local)``; a choice of
    another expert, or past its expert's capacity, adds nothing here."""
    T, d = x_flat.shape
    E, k = mcfg.num_experts, mcfg.top_k
    E_local = wg.shape[0]
    logits, probs, gate, eids, pos, dst = route(x_flat, router, mcfg, capacity)
    if E_local != E:
        local_e = eids - e_offset
        keep = (pos < capacity) & (local_e >= 0) & (local_e < E_local)
        dst = torch.where(keep, local_e * capacity + pos, E_local * capacity)

    # dispatch: k scatters of (T, d) into E_local*C rows and one spare
    buf = x_flat.new_zeros((E_local * capacity + 1, d))
    for j in range(k):
        buf[dst[:, j]] = x_flat
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
    routed output is summed over the ranks.  The shared expert, when there
    is one, is replicated and adds its GLU of every token."""
    mcfg = cfg.moe
    B, S, d = x.shape
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
