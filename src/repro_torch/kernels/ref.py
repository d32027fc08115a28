"""Plain PyTorch versions of the port's kernels: what the wrappers in
``kernels/ops.py`` run on a CPU tensor, and what the kernels are held
against on the card.  They follow ``repro/kernels/ref.py``: for the
butterfly, f32 product, per-row absmax, scale, round half to even, clip;
for RMSNorm, f32 mean of squares and ``1 + w``; for attention, f32 scores
over an end-aligned causal/window mask."""
from __future__ import annotations

import math
from typing import Optional

import torch


def butterfly_reduce_quant_ref(x: torch.Tensor, w_reduce: torch.Tensor,
                               bits: int = 8):
    """x: (T, d), w_reduce: (d, d_r) -> (codes int8 (T, d_r), scales f32 (T, 1))."""
    qmax = 2 ** (bits - 1) - 1
    r = x.float() @ w_reduce.float()
    absmax = r.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(absmax, min=1e-8) / qmax
    codes = torch.clamp(torch.round(r / scale), -qmax - 1, qmax).to(torch.int8)
    return codes, scale


def symbol_counts(codes: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """(T, d_r) int8 codes -> (d_r, 2**bits) int32 per-channel histogram of
    the symbols ``code + 2**(bits-1)``."""
    nsym = 1 << bits
    d_r = codes.shape[1]
    sym = codes.long() + nsym // 2
    flat = (torch.arange(d_r, device=codes.device) * nsym + sym).reshape(-1)
    counts = torch.bincount(flat, minlength=d_r * nsym)
    return counts.reshape(d_r, nsym).to(torch.int32)


def butterfly_reduce_quant_bincount_ref(x: torch.Tensor,
                                        w_reduce: torch.Tensor, bits: int = 8):
    """:func:`butterfly_reduce_quant_ref` plus :func:`symbol_counts` of its
    codes."""
    codes, scale = butterfly_reduce_quant_ref(x, w_reduce, bits)
    return codes, scale, symbol_counts(codes, bits)


def butterfly_dequant_restore_ref(codes: torch.Tensor, scales: torch.Tensor,
                                  w_restore: torch.Tensor,
                                  out_dtype=torch.float32) -> torch.Tensor:
    """codes: (T, d_r) int8, scales (T, 1) f32, w_restore (d_r, d) -> (T, d)."""
    r = codes.float() * scales
    return (r @ w_restore.float()).to(out_dtype)


def rms_norm_ref(x: torch.Tensor, weight: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    """The model's RMSNorm (gemma-style ``1 + w`` weight) in f32, cast back
    to x's dtype; restated here so the kernels' plain versions import no
    model code."""
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + weight.float())).to(dtype)


def butterfly_restore_norm_ref(codes: torch.Tensor, scales: torch.Tensor,
                               w_restore: torch.Tensor, norm_w: torch.Tensor,
                               eps: float = 1e-6, out_dtype=torch.float32):
    """Dequant+restore, then the RMSNorm of the restored x after its cast
    to ``out_dtype``.  Returns (x, h)."""
    x = butterfly_dequant_restore_ref(codes, scales, w_restore, out_dtype)
    return x, rms_norm_ref(x, norm_w, eps)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True,
                        window: Optional[int] = None) -> torch.Tensor:
    """q: (B,S,N,hd), k/v: (B,T,K,hd) with N % K == 0 -> (B,S,N,hd) in
    q's dtype, f32 math.  Query i sits at position i + T - S (the ends
    align); a masked score is -1e30, so a row that sees no key averages v."""
    B, S, N, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    qg = q.reshape(B, S, K, N // K, hd).float()
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k.float()) / math.sqrt(hd)
    qpos = torch.arange(S, device=q.device)[:, None] + (T - S)
    kpos = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    scores = scores.masked_fill(~mask, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v.float())
    return out.reshape(B, S, N, hd).to(q.dtype)
