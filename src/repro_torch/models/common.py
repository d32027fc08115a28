"""Shared model primitives: norms, RoPE, GLU MLPs, initializers (port of
``repro/models/common.py``).  Params are plain nested dicts of tensors."""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# sharding helpers
# ---------------------------------------------------------------------------

MODEL_AXIS = "model"


def maybe_axis(dim_size: int, size: Optional[int], axis: str = MODEL_AXIS):
    """``axis`` where its ``size`` ranks divide a dim of ``dim_size``, else
    None (replicated).  Unlike the JAX package's, which assumes the
    production mesh's 16, ``size`` is the axis's real length; None stands
    for an axis that divides everything (the manual regime's stages, whose
    divisibility is checked up front)."""
    return axis if size is None or dim_size % size == 0 else None


def dense_spec(shape: tuple, shard_dim: Optional[int],
               size: Optional[int]) -> Optional[int]:
    """A leaf's spec over the model axis of ``size`` ranks: ``shard_dim``
    where the axis divides that dim, else None (see :func:`maybe_axis`)."""
    if shard_dim is None or maybe_axis(shape[shard_dim], size) is None:
        return None
    return shard_dim


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def trunc_normal(gen: torch.Generator, shape, scale: float, dtype,
                 device) -> torch.Tensor:
    """Normal truncated to (-2, 2), times sqrt(scale), drawn in f32 then
    cast (as ``repro/models/common.py:trunc_normal``)."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * math.sqrt(scale)).to(dtype)


def dense_init(gen, d_in: int, d_out: int, dtype, device,
               scale: Optional[float] = None) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / d_in
    return trunc_normal(gen, (d_in, d_out), scale, dtype, device)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + weight.float())).to(dtype)


def init_rms_norm(d: int, dtype, device) -> torch.Tensor:
    # zero-centered weight (gemma-style "1 + w") so init is identity
    return torch.zeros((d,), dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions broadcastable to (..., seq)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)          # (hd/2,)
    angles = positions[..., :, None].float() * freqs                # (..., seq, hd/2)
    angles = angles[..., :, None, :]                                # (..., seq, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoid_angles(pos: torch.Tensor, d_model: int) -> torch.Tensor:
    """Whisper-style fixed sinusoidal embeddings at f32 positions ``pos``
    (any shape): (..., d_model), sines then cosines."""
    dim = torch.arange(d_model // 2, dtype=torch.float32, device=pos.device)
    inv = torch.exp(-math.log(10000.0) * dim / max(d_model // 2 - 1, 1))
    ang = pos.float()[..., None] * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def sinusoid_positions(seq: int, d_model: int, device=None) -> torch.Tensor:
    """(seq, d_model) f32 embeddings of positions 0..seq-1."""
    return sinusoid_angles(torch.arange(seq, dtype=torch.float32,
                                        device=device), d_model)


# ---------------------------------------------------------------------------
# gated mlp (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------


def init_mlp(gen, d_model: int, d_ff: int, dtype, device) -> dict:
    return {
        "w_gate": dense_init(gen, d_model, d_ff, dtype, device),
        "w_up": dense_init(gen, d_model, d_ff, dtype, device),
        "w_down": dense_init(gen, d_ff, d_model, dtype, device, scale=1.0 / d_ff),
    }


def glu_act(gate: torch.Tensor, act: str) -> torch.Tensor:
    if act == "silu":
        return F.silu(gate)
    if act == "gelu":
        return F.gelu(gate, approximate="tanh")
    raise ValueError(f"unknown act {act}")


def apply_mlp(params, x: torch.Tensor, act: str) -> torch.Tensor:
    gate = glu_act(x @ params["w_gate"], act)
    up = x @ params["w_up"]
    return (gate * up) @ params["w_down"]


# ---------------------------------------------------------------------------
# embedding / unembedding
# ---------------------------------------------------------------------------


def init_embedding(gen, vocab: int, d_model: int, dtype, device) -> torch.Tensor:
    return trunc_normal(gen, (vocab, d_model), 1.0 / d_model, dtype, device)


def embed(table: torch.Tensor, tokens: torch.Tensor, scale: bool = False) -> torch.Tensor:
    out = table[tokens]
    if scale:
        out = out * torch.tensor(math.sqrt(table.shape[-1]), dtype=out.dtype,
                                 device=out.device)
    return out


def unembed(table: torch.Tensor, x: torch.Tensor,
            softcap: Optional[float] = None) -> torch.Tensor:
    # the product is taken in x's dtype and only then cast to f32: at bf16
    # the logits round to bf16 first, as in the JAX package
    logits = (x @ table.t()).float()
    if softcap is not None:
        logits = torch.tanh(logits / softcap) * softcap
    return logits
