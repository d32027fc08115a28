"""Mamba2 (SSD) block: the chunked state-space dual form for train and
prefill, a recurrent step for decode (port of ``repro/models/ssm.py``).

Within a chunk the output is a masked-decay attention-like product; across
chunks one (B, H, P, N) f32 state is carried by a Python loop over the
chunks (``lax.scan`` in the JAX package).  Every decay exponent is a
difference of a decreasing cumulative sum (A < 0, dt > 0), so each exp()
is <= 1.  The casts are the JAX package's: the intra-chunk weights ``G``
and ``x * dt`` in the model dtype, the states and the inter-chunk terms in
f32, the decode conv in f32 with its state stored back in the model dtype.

Decode state: {"ssm": (B, H, P, N) f32, "conv": (B, W-1, conv channels)}.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import parallel
from repro_torch.models.common import dense_init, rms_norm


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.num_heads * s.head_dim
    conv_ch = d_inner + 2 * s.state_dim
    return s, d_inner, conv_ch


# ---------------------------------------------------------------------------
# params and state
# ---------------------------------------------------------------------------


def init_mamba(gen, cfg: ModelConfig, dtype, device) -> dict:
    s, d_inner, conv_ch = _dims(cfg)
    d = cfg.d_model
    proj_out = 2 * d_inner + 2 * s.state_dim + s.num_heads   # z, x, B, C, dt
    f32 = torch.float32
    return {
        "in_proj": dense_init(gen, d, proj_out, dtype, device),
        "conv_w": (torch.randn((s.conv_width, conv_ch), generator=gen, dtype=f32,
                               device=device)
                   * (1.0 / math.sqrt(s.conv_width))).to(dtype),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=device),
        "dt_bias": torch.zeros((s.num_heads,), dtype=f32, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, s.num_heads, dtype=f32,
                                          device=device)),
        "D": torch.ones((s.num_heads,), dtype=f32, device=device),
        "norm_w": torch.zeros((d_inner,), dtype=dtype, device=device),
        "out_proj": dense_init(gen, d_inner, d, dtype, device,
                               scale=1.0 / d_inner),
    }


def init_ssm_state(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    s, _, conv_ch = _dims(cfg)
    return {
        "ssm": torch.zeros((batch, s.num_heads, s.head_dim, s.state_dim),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, s.conv_width - 1, conv_ch), dtype=dtype,
                            device=device),
    }


def ssm_state_spec(batch_axis=None, axis: str = "model") -> dict:
    """The state's spec over grid axis ``axis`` (its sharded dim, or None):
    the batch only, as the JAX package's ``ssm_state_spec``."""
    dim = parallel.axis_dim((batch_axis,), axis)
    return {"ssm": dim, "conv": dim}


# ---------------------------------------------------------------------------
# pieces
# ---------------------------------------------------------------------------


def _split_proj(params, x, cfg: ModelConfig):
    _, d_inner, conv_ch = _dims(cfg)
    zxbcdt = x @ params["in_proj"]
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner:d_inner + conv_ch]
    dt = zxbcdt[..., d_inner + conv_ch:].float()                 # (..., H)
    return z, xbc, dt


def causal_conv(xbc, conv_w, conv_b, width: int):
    """Depthwise causal conv over (B, S, C) by width-shifted adds, then
    SiLU (the JAX package's ``_causal_conv`` and xLSTM's ``_conv_silu``)."""
    S = xbc.shape[1]
    out = xbc * conv_w[-1]
    for i in range(1, width):
        out = out + F.pad(xbc, (0, 0, i, 0))[:, :S] * conv_w[-1 - i]
    return F.silu(out + conv_b)


def conv_step(window, conv_w, conv_b):
    """The decode conv over a (B, W, C) window, in f32: SiLU of
    ``sum_w window[:, w] * conv_w[w] + conv_b`` -> (B, C) f32."""
    conv = torch.einsum("bwc,wc->bc", window.float(), conv_w.float())
    return F.silu(conv + conv_b.float())


def check_chunks(S: int, chunk: int) -> int:
    """The chunk length of an S-long sequence, ``min(chunk, S)``; S must be
    a multiple of it, as the JAX package asserts (no padding, no other
    chunk)."""
    L = min(chunk, S)
    if S % L:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"chunk length {L}")
    return L


def _gated_out(params, y, z, cfg: ModelConfig):
    y = rms_norm(y * F.silu(z), params["norm_w"], cfg.rms_eps)
    return y @ params["out_proj"]


def _causal_mask(L: int, device) -> torch.Tensor:
    """(1, 1, L, L, 1) bool, True where query i sees key j (i >= j)."""
    return torch.ones((L, L), dtype=torch.bool, device=device).tril()[
        None, None, :, :, None]


# ---------------------------------------------------------------------------
# full-sequence SSD (train / prefill)
# ---------------------------------------------------------------------------


def mamba_fullseq(params, x, *, cfg: ModelConfig, return_state: bool = False):
    s, d_inner, _ = _dims(cfg)
    Bsz, S, _ = x.shape
    H, Pd, N = s.num_heads, s.head_dim, s.state_dim
    L = check_chunks(S, s.chunk_size)
    C = S // L

    z, xbc_in, dt = _split_proj(params, x, cfg)
    xbc = causal_conv(xbc_in, params["conv_w"], params["conv_b"], s.conv_width)
    xs = xbc[..., :d_inner].reshape(Bsz, S, H, Pd)
    Bm = xbc[..., d_inner:d_inner + N]
    Cm = xbc[..., d_inner + N:]

    dt = F.softplus(dt + params["dt_bias"])                      # (B,S,H) f32
    A = -torch.exp(params["A_log"])                              # (H,) < 0
    a = dt * A                                                   # (B,S,H) < 0

    # chunked views
    xc = xs.reshape(Bsz, C, L, H, Pd)
    dtc = dt.reshape(Bsz, C, L, H)
    Bc = Bm.reshape(Bsz, C, L, N).float()
    Cc = Cm.reshape(Bsz, C, L, N).float()
    cum = torch.cumsum(a.reshape(Bsz, C, L, H), dim=2)           # (B,C,L,H)

    # ---- intra-chunk (decay-masked attention)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]          # (B,C,L,L,H) i-j
    # mask BEFORE exp: masked (i < j) entries are positive and can overflow,
    # and where(mask, exp(seg), 0) would make the backward 0 * inf = NaN
    decay = torch.exp(torch.where(_causal_mask(L, x.device), seg, -1e9))
    scores = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    G = (scores[..., None] * decay).to(x.dtype)                  # (B,C,L,L,H)
    xdt = xc * dtc[..., None].to(x.dtype)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", G, xdt)

    # ---- chunk summary states
    last = cum[:, :, -1:, :]                                     # (B,C,1,H)
    w = torch.exp(last - cum) * dtc                              # (B,C,L,H)
    S_chunk = torch.einsum("bcln,bclh,bclhp->bchpn", Bc, w, xc.float())
    chunk_decay = torch.exp(last[:, :, 0, :])                    # (B,C,H)

    # ---- inter-chunk scan: y from the state entering each chunk, decayed
    # to each of its positions
    state = torch.zeros((Bsz, H, Pd, N), dtype=torch.float32, device=x.device)
    y_inter = []
    for c in range(C):
        y_inter.append(torch.einsum("bln,bhpn->blhp", Cc[:, c], state)
                       * torch.exp(cum[:, c])[..., None])
        state = state * chunk_decay[:, c, :, None, None] + S_chunk[:, c]
    y_inter = torch.stack(y_inter, dim=1)                        # (B,C,L,H,P)

    y = (y_intra.float() + y_inter).reshape(Bsz, S, H, Pd)
    y = y + params["D"][None, None, :, None] * xs.float()
    y = y.reshape(Bsz, S, d_inner).to(x.dtype)
    out = _gated_out(params, y, z, cfg)
    if return_state:
        # the conv state is the tail of the pre-activation conv input
        return out, {"ssm": state, "conv": xbc_in[:, -(s.conv_width - 1):, :]}
    return out, None


# ---------------------------------------------------------------------------
# decode step
# ---------------------------------------------------------------------------


def mamba_decode(params, x, state, *, cfg: ModelConfig):
    """x: (B, 1, d); state: {"ssm": (B,H,P,N) f32, "conv": (B,W-1,Cc)}.
    Returns (out, new state); ``state`` is not written."""
    s, d_inner, _ = _dims(cfg)
    Bsz = x.shape[0]
    H, Pd, N = s.num_heads, s.head_dim, s.state_dim

    z, xbc_new, dt = _split_proj(params, x, cfg)                 # (B,1,*)
    window = torch.cat([state["conv"], xbc_new], dim=1)          # (B,W,Cc)
    xbc = conv_step(window, params["conv_w"], params["conv_b"])  # (B,Cc) f32

    xs = xbc[:, :d_inner].reshape(Bsz, H, Pd)
    Bm = xbc[:, d_inner:d_inner + N]
    Cm = xbc[:, d_inner + N:]

    dt = F.softplus(dt[:, 0] + params["dt_bias"])                # (B,H)
    decay = torch.exp(dt * -torch.exp(params["A_log"]))          # (B,H)

    upd = torch.einsum("bh,bhp,bn->bhpn", dt, xs, Bm)
    ssm = state["ssm"] * decay[:, :, None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", ssm, Cm)
    y = y + params["D"][None, :, None] * xs
    y = y.reshape(Bsz, 1, d_inner).to(x.dtype)
    out = _gated_out(params, y, z, cfg)
    return out, {"ssm": ssm, "conv": window[:, 1:, :].to(state["conv"].dtype)}
