"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory, chunkwise
parallel) and sLSTM (scalar memory, a sequential loop with exponential
gating); port of ``repro/models/xlstm.py``.

As in the JAX package, the mLSTM max-stabilizer is replaced by the bounded
log-sigmoid forget-gate cumulative form (every decay <= 1) and the
denominator uses ``max(|q . n|, 1)``; sLSTM keeps the i/f/z/o exponential
gating with its stabilizer and block-diagonal (per-head) recurrent weights,
one step per position.

Decode state:
  mLSTM: {"C": (B,H,P,P) f32, "n": (B,H,P) f32, "conv": (B,W-1,d_inner)}
  sLSTM: {"c","n","h","m": (B,H,P) f32}
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import parallel
from repro_torch.models.common import dense_init, fixed_axis_spec, rms_norm
from repro_torch.models.parallel import LOCAL, ParallelContext
from repro_torch.models.ssm import _causal_mask, causal_conv, check_chunks, \
    conv_step


def _mlstm_dims(cfg: ModelConfig):
    d_inner = 2 * cfg.d_model
    H = cfg.num_heads
    return cfg.xlstm, d_inner, H, d_inner // H


def _slstm_dims(cfg: ModelConfig):
    H = cfg.num_heads
    return H, cfg.d_model // H


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def init_mlstm(gen, cfg: ModelConfig, dtype, device) -> dict:
    xcfg, d_inner, H, _ = _mlstm_dims(cfg)
    d = cfg.d_model
    f32 = torch.float32
    return {
        "up_z": dense_init(gen, d, d_inner, dtype, device),
        "up_x": dense_init(gen, d, d_inner, dtype, device),
        "conv_w": (torch.randn((xcfg.conv_width, d_inner), generator=gen,
                               dtype=f32, device=device)
                   / math.sqrt(xcfg.conv_width)).to(dtype),
        "conv_b": torch.zeros((d_inner,), dtype=dtype, device=device),
        "wq": dense_init(gen, d_inner, d_inner, dtype, device),
        "wk": dense_init(gen, d_inner, d_inner, dtype, device),
        "wv": dense_init(gen, d_inner, d_inner, dtype, device),
        "w_if": dense_init(gen, d_inner, 2 * H, f32, device),
        "b_if": torch.cat([torch.zeros((H,), device=device),
                           3.0 * torch.ones((H,), device=device)]),
        "norm_w": torch.zeros((d_inner,), dtype=dtype, device=device),
        "down": dense_init(gen, d_inner, d, dtype, device, scale=1.0 / d_inner),
    }


def init_mlstm_state(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    xcfg, d_inner, H, Pd = _mlstm_dims(cfg)
    f32 = torch.float32
    return {
        "C": torch.zeros((batch, H, Pd, Pd), dtype=f32, device=device),
        "n": torch.zeros((batch, H, Pd), dtype=f32, device=device),
        "conv": torch.zeros((batch, xcfg.conv_width - 1, d_inner), dtype=dtype,
                            device=device),
    }


def mlstm_specs(cfg: ModelConfig, mp) -> dict:
    """The automatic layout's model-axis specs of an mLSTM mixer, as the
    JAX package's ``init_mlstm`` places them: ``up_z``/``up_x`` columns
    and ``down`` rows where 16 divides d_inner (``common.fixed_axis_spec``);
    the rest replicated.  A rank gathers both up projections whole before
    the mixer and multiplies its block of the output by its rows of
    ``down``."""
    _, d_inner, _, _ = _mlstm_dims(cfg)
    d = cfg.d_model
    return {"up_z": fixed_axis_spec((d, d_inner), 1, mp),
            "up_x": fixed_axis_spec((d, d_inner), 1, mp),
            "down": fixed_axis_spec((d_inner, d), 0, mp)}


def mlstm_state_spec(batch_axis=None, axis: str = "model") -> dict:
    """The mLSTM state's spec over grid axis ``axis``: the batch only, as
    the JAX package's ``layer_cache_spec``."""
    dim = parallel.axis_dim((batch_axis,), axis)
    return {"C": dim, "n": dim, "conv": dim}


def _mlstm_gates(params, xi):
    """xi: (B,S,d_inner) -> log_i, log_f (B,S,H) in f32, both <= 0."""
    g = xi.float() @ params["w_if"] + params["b_if"]
    H = g.shape[-1] // 2
    return -F.softplus(-g[..., :H]), -F.softplus(-g[..., H:])


def mlstm_fullseq(params, x, *, cfg: ModelConfig, return_state: bool = False,
                  pctx: ParallelContext = LOCAL):
    xcfg, d_inner, H, Pd = _mlstm_dims(cfg)
    Bsz, S, _ = x.shape
    L = check_chunks(S, xcfg.chunk_size)
    C = S // L

    z, xi_in = parallel.column_parallel(x, [params["up_z"], params["up_x"]],
                                        d_inner, pctx)
    z = F.silu(z)
    xi = causal_conv(xi_in, params["conv_w"], params["conv_b"], xcfg.conv_width)
    q = (xi @ params["wq"]).reshape(Bsz, S, H, Pd) / math.sqrt(Pd)
    k = (xi @ params["wk"]).reshape(Bsz, S, H, Pd)
    v = (xi @ params["wv"]).reshape(Bsz, S, H, Pd)
    log_i, log_f = _mlstm_gates(params, xi)

    qc = q.reshape(Bsz, C, L, H, Pd).float()
    kc = k.reshape(Bsz, C, L, H, Pd).float()
    vc = v.reshape(Bsz, C, L, H, Pd).float()
    lic = log_i.reshape(Bsz, C, L, H)
    cumf = torch.cumsum(log_f.reshape(Bsz, C, L, H), dim=2)      # <= 0

    # intra-chunk: D[i,j] = exp(cumf_i - cumf_j + log_i_j), i >= j; the
    # mask goes before the exp (see ssm.py)
    seg = cumf[:, :, :, None, :] - cumf[:, :, None, :, :] + lic[:, :, None, :, :]
    D = torch.exp(torch.where(_causal_mask(L, x.device), seg, -1e9))
    scores = torch.einsum("bcihp,bcjhp->bcijh", qc, kc)
    num_intra = torch.einsum("bcijh,bcjhp->bcihp", scores * D, vc)
    den_intra = torch.einsum("bcijh->bcih", scores * D)

    # chunk state contributions
    last = cumf[:, :, -1:, :]
    w = torch.exp(last - cumf + lic)                             # (B,C,L,H)
    C_chunk = torch.einsum("bclh,bclhp,bclhq->bchpq", w, vc, kc)  # v k^T
    n_chunk = torch.einsum("bclh,bclhp->bchp", w, kc)
    chunk_decay = torch.exp(last[:, :, 0, :])

    Cs = torch.zeros((Bsz, H, Pd, Pd), dtype=torch.float32, device=x.device)
    ns = torch.zeros((Bsz, H, Pd), dtype=torch.float32, device=x.device)
    num_inter, den_inter = [], []
    for c in range(C):
        e = torch.exp(cumf[:, c])
        num_inter.append(torch.einsum("blhp,bhqp->blhq", qc[:, c], Cs) * e[..., None])
        den_inter.append(torch.einsum("blhp,bhp->blh", qc[:, c], ns) * e)
        Cs = Cs * chunk_decay[:, c, :, None, None] + C_chunk[:, c]
        ns = ns * chunk_decay[:, c, :, None] + n_chunk[:, c]
    num = num_intra + torch.stack(num_inter, dim=1)
    den = den_intra + torch.stack(den_inter, dim=1)
    y = num / torch.clamp(den.abs(), min=1.0)[..., None]
    y = y.reshape(Bsz, S, d_inner).to(x.dtype)
    y = rms_norm(y, params["norm_w"], cfg.rms_eps) * z
    out = parallel.row_parallel(y, params["down"], pctx)
    if return_state:
        return out, {"C": Cs, "n": ns,
                     "conv": xi_in[:, -(xcfg.conv_width - 1):, :]}
    return out, None


def mlstm_decode(params, x, state, *, cfg: ModelConfig,
                 pctx: ParallelContext = LOCAL):
    """x: (B, 1, d) -> (out, new state); ``state`` is not written."""
    _, d_inner, H, Pd = _mlstm_dims(cfg)
    Bsz = x.shape[0]
    z, xi_new = parallel.column_parallel(x, [params["up_z"], params["up_x"]],
                                         d_inner, pctx)
    z = F.silu(z)[:, 0]                                          # (B,di)
    window = torch.cat([state["conv"], xi_new], dim=1)
    xi = conv_step(window, params["conv_w"], params["conv_b"]).to(x.dtype)

    q = (xi @ params["wq"]).reshape(Bsz, H, Pd).float() / math.sqrt(Pd)
    k = (xi @ params["wk"]).reshape(Bsz, H, Pd).float()
    v = (xi @ params["wv"]).reshape(Bsz, H, Pd).float()
    log_i, log_f = _mlstm_gates(params, xi[:, None, :])
    i_t = torch.exp(log_i[:, 0])                                 # (B,H)
    f_t = torch.exp(log_f[:, 0])

    C = state["C"] * f_t[:, :, None, None] + \
        i_t[:, :, None, None] * torch.einsum("bhp,bhq->bhpq", v, k)
    n = state["n"] * f_t[:, :, None] + i_t[:, :, None] * k
    num = torch.einsum("bhpq,bhq->bhp", C, q)
    den = torch.clamp(torch.einsum("bhp,bhp->bh", n, q).abs(), min=1.0)
    y = (num / den[..., None]).reshape(Bsz, d_inner).to(x.dtype)
    y = rms_norm(y, params["norm_w"], cfg.rms_eps) * z
    out = parallel.row_parallel(y, params["down"], pctx)[:, None, :]
    return out, {"C": C, "n": n,
                 "conv": window[:, 1:, :].to(state["conv"].dtype)}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def _slstm_ff(d: int) -> int:
    return max(int(d * 8 / 3) // 64 * 64, 64)


def init_slstm(gen, cfg: ModelConfig, dtype, device) -> dict:
    H, Pd = _slstm_dims(cfg)
    d = cfg.d_model
    d_ff = _slstm_ff(d)
    f32 = torch.float32
    return {
        "w_in": dense_init(gen, d, 4 * d, f32, device),          # i,f,z,o pre-acts
        "r": torch.randn((4, H, Pd, Pd), generator=gen, dtype=f32,
                         device=device) / math.sqrt(Pd),
        "b": torch.cat([torch.zeros((d,), device=device),
                        3.0 * torch.ones((d,), device=device),
                        torch.zeros((2 * d,), device=device)]),
        "norm_w": torch.zeros((d,), dtype=dtype, device=device),
        "w_ff1": dense_init(gen, d, d_ff, dtype, device),
        "w_ff2": dense_init(gen, d_ff, d, dtype, device, scale=1.0 / d_ff),
    }


def init_slstm_state(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    H, Pd = _slstm_dims(cfg)
    zeros = lambda: torch.zeros((batch, H, Pd), dtype=torch.float32,
                                device=device)
    return {"c": zeros(), "n": zeros(), "h": zeros(), "m": zeros() - 10.0}


def slstm_specs(cfg: ModelConfig, mp) -> dict:
    """The automatic layout's model-axis specs of an sLSTM mixer, as the
    JAX package's ``init_slstm`` places them: its MLP's ``w_ff1`` columns
    and ``w_ff2`` rows where 16 divides d_ff (``common.fixed_axis_spec``),
    a Megatron MLP; the recurrence's weights replicated."""
    d = cfg.d_model
    ff = _slstm_ff(d)
    return {"w_ff1": fixed_axis_spec((d, ff), 1, mp),
            "w_ff2": fixed_axis_spec((ff, d), 0, mp)}


def slstm_state_spec(batch_axis=None, axis: str = "model") -> dict:
    """The sLSTM state's spec over grid axis ``axis``: the batch only."""
    dim = parallel.axis_dim((batch_axis,), axis)
    return {k: dim for k in ("c", "n", "h", "m")}


def _slstm_step(params, carry, pre, H: int, Pd: int):
    """One sLSTM time step; pre: (B, 4d) input pre-activations (f32)."""
    c, n, h, m = carry
    g = pre.reshape(pre.shape[0], 4, H, Pd) + \
        torch.einsum("ghpq,bhq->bghp", params["r"], h)           # (B,4,H,P)
    gi, gf, gz, go = g.unbind(1)
    log_f = -F.softplus(-gf)                                     # log sigmoid
    m_new = torch.maximum(log_f + m, gi)
    i = torch.exp(gi - m_new)
    f = torch.exp(log_f + m - m_new)
    c = f * c + i * torch.tanh(gz)
    n = f * n + i
    h = torch.sigmoid(go) * c / torch.clamp(n, min=1.0)
    return (c, n, h, m_new), h


def _slstm_out(params, h, x, cfg: ModelConfig, pctx: ParallelContext):
    """The norm of the cell output and its MLP; a sharded MLP (the
    automatic layout) runs its d_ff block and sums over the model axis."""
    y = rms_norm(h.reshape(x.shape).to(x.dtype), params["norm_w"], cfg.rms_eps)
    w1, w2 = params["w_ff1"], params["w_ff2"]
    if not pctx.tensor_parallel or w1.shape[1] == _slstm_ff(cfg.d_model):
        return y + F.gelu(y @ w1, approximate="tanh") @ w2
    part = F.gelu(parallel.model_copy(y, pctx) @ w1, approximate="tanh") @ w2
    return y + parallel.model_psum(part, pctx)


def slstm_fullseq(params, x, *, cfg: ModelConfig, return_state: bool = False,
                  pctx: ParallelContext = LOCAL):
    H, Pd = _slstm_dims(cfg)
    Bsz, S, _ = x.shape
    pre = x.float() @ params["w_in"] + params["b"]               # (B,S,4d)
    state = init_slstm_state(cfg, Bsz, x.dtype, x.device)
    carry = tuple(state[k] for k in ("c", "n", "h", "m"))
    hs = []
    for t in range(S):
        carry, h = _slstm_step(params, carry, pre[:, t], H, Pd)
        hs.append(h)
    y = _slstm_out(params, torch.stack(hs, dim=1), x, cfg, pctx)
    if return_state:
        return y, dict(zip(("c", "n", "h", "m"), carry))
    return y, None


def slstm_decode(params, x, state, *, cfg: ModelConfig,
                 pctx: ParallelContext = LOCAL):
    """x: (B, 1, d) -> (out, new state); ``state`` is not written."""
    H, Pd = _slstm_dims(cfg)
    pre = x[:, 0].float() @ params["w_in"] + params["b"]
    carry = tuple(state[k] for k in ("c", "n", "h", "m"))
    carry, h = _slstm_step(params, carry, pre, H, Pd)
    return _slstm_out(params, h, x, cfg, pctx), dict(zip(("c", "n", "h", "m"), carry))
