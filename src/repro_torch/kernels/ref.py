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
    """x: (T, d), w_reduce: (d, d_r) -> (codes (T, d_r), scales f32 (T, 1));
    the codes are int8 at bits <= 8 and int16 at 16 bits."""
    qmax = 2 ** (bits - 1) - 1
    r = x.float() @ w_reduce.float()
    absmax = r.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(absmax, min=1e-8) / qmax
    codes = torch.clamp(torch.round(r / scale), -qmax - 1, qmax)
    return codes.to(torch.int8 if bits <= 8 else torch.int16), scale


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
    """codes: (T, d_r) int8 or int16, scales (T, 1) f32, w_restore (d_r, d)
    -> (T, d).  int16 codes (the 16-bit wire) dequantize in the reference's
    unfused order: ``code * scale`` rounded to w_restore's dtype, then the
    f32 product; int8 codes as its Pallas kernel, the f32 ``code * scale``
    straight into the product."""
    r = codes.float() * scales
    if codes.dtype == torch.int16:
        r = r.to(w_restore.dtype).float()
    return (r @ w_restore.float()).to(out_dtype)


def butterfly_dequant_restore_tc_ref(codes: torch.Tensor, scales: torch.Tensor,
                                     w_restore: torch.Tensor,
                                     out_dtype=torch.bfloat16) -> torch.Tensor:
    """The bf16 kernel's order of operations, for tests: the codes as bf16
    (exact), their f32 product with w_restore, then the row's scale once,
    then the cast; :func:`butterfly_dequant_restore_ref` scales first."""
    acc = codes.to(torch.bfloat16).float() @ w_restore.float()
    return (acc * scales).to(out_dtype)


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


def _attention_weights(q: torch.Tensor, k: torch.Tensor, causal: bool,
                       window: Optional[int]) -> torch.Tensor:
    """The softmax weights of :func:`flash_attention_ref`, (B, K, N/K, S, T)
    f32."""
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
    return torch.softmax(scores.masked_fill(~mask, -1e30), dim=-1)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True,
                        window: Optional[int] = None) -> torch.Tensor:
    """q: (B,S,N,hd), k/v: (B,T,K,hd) with N % K == 0 -> (B,S,N,hd) in
    q's dtype, f32 math.  Query i sits at position i + T - S (the ends
    align); a masked score is -1e30, so a row that sees no key averages v."""
    B, S, N, hd = q.shape
    probs = _attention_weights(q, k, causal, window)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v.float())
    return out.reshape(B, S, N, hd).to(q.dtype)


def flash_attention_bf16_bound(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, causal: bool = True,
                               window: Optional[int] = None):
    """The f32 result o of :func:`flash_attention_ref` and the bound that
    the bf16 tensor-core kernel's result is held to, elementwise, both
    (B,S,N,hd) f32: ``|out - o| <= 2**-7 |o| + 2**-7 sum_t w_t |v_t - o|``,
    with w the reference's softmax weights of that row.

    Derivation (u = 2**-8, bf16's unit roundoff): the kernel rounds each
    weight p_t to bf16, p_t (1 + d_t) with |d_t| <= u, and divides by the
    sum of the rounded weights, so each normalised weight moves by at most
    w_t 2u / (1 - u).  The moves sum to 0, so the output moves by
    sum_t (w'_t - w_t)(v_t - o), at most 2u sum_t w_t |v_t - o| = 2**-7
    sum_t w_t |v_t - o| up to a factor 1 + O(u).  Rounding the output to
    bf16 adds at most u |o|, half the first term; the other half covers the
    O(u) factors and the f32 terms (scores summed in another order, exp2
    for exp, the tensor cores' f32 sums), which are near 2**-20 of the
    output.  A row that sees one key (weight 1) gets a bound of u |v|."""
    B, S, N, hd = q.shape
    K = k.shape[2]
    probs = _attention_weights(q, k, causal, window)          # (B,K,G,S,T)
    vf = v.float().permute(0, 2, 1, 3)[:, :, None]             # (B,K,1,T,hd)
    o = probs @ vf                                             # (B,K,G,S,hd)
    spread = torch.empty_like(o)
    rows = max(1, (1 << 25) // max(1, probs[..., :1, :].numel() * hd))
    for r in range(0, S, rows):
        dev = (vf[:, :, :, None] - o[:, :, :, r:r + rows, None]).abs_()
        spread[:, :, :, r:r + rows] = (probs[:, :, :, r:r + rows, None]
                                       @ dev).squeeze(-2)
    bound = 2 ** -7 * (o.abs() + spread)

    def to_bsnh(t):
        return t.permute(0, 3, 1, 2, 4).reshape(B, S, N, hd)
    return to_bsnh(o), to_bsnh(bound)
