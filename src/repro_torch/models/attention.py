"""GQA attention with qk-norm, RoPE, sliding windows and ring-buffer KV
caches, full-sequence and one-token decode, and whisper's cross attention
(port of ``repro/models/attention.py``).  Scores, masks and softmax run in f32 with
``MASK_VALUE`` for masked slots.  ``use_kernel=True`` sends full-sequence
attention through ``kernels/ops.flash_attention`` (the Hopper kernel on a
CUDA tensor).

When a window is set the decode cache holds ``min(capacity, window)`` rows
and is a ring buffer: position ``p`` lives in slot ``p % T``.
"""
from __future__ import annotations

import math
import os
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.common import apply_rope, dense_init, rms_norm

MASK_VALUE = -1e30


def _padded_heads(cfg: ModelConfig) -> int:
    """The q-head count ``init_attention`` lays out.  With
    ``REPRO_ATTN_PAD_HEADS=1`` (as in the JAX package) a count that 16
    does not divide is padded to the next multiple of 16 that the kv-head
    count divides, so that a 16-way model axis takes whole heads; the
    padded heads are dead (their ``wo`` rows are zero).  Otherwise the
    config's count."""
    if os.environ.get("REPRO_ATTN_PAD_HEADS", "0") != "1":
        return cfg.num_heads
    n = cfg.num_heads
    if n % 16 == 0:
        return n
    p = ((n + 15) // 16) * 16
    while p % cfg.num_kv_heads:
        p += 16
    return p


def init_attention(gen, cfg: ModelConfig, dtype, device) -> dict:
    """``wq`` (d, H*hd), ``wk``/``wv`` (d, K*hd), ``wo`` (H*hd, d), and the
    qk-norm weights.  Under padded heads (:func:`_padded_heads`) ``wq``
    has the padded count's columns and ``wo`` gains zero rows, inserted
    per kv group so that each q head stays with its kv head."""
    hd = cfg.resolved_head_dim
    n_pad = _padded_heads(cfg)
    params = {
        "wq": dense_init(gen, cfg.d_model, n_pad * hd, dtype, device),
        "wk": dense_init(gen, cfg.d_model, cfg.num_kv_heads * hd, dtype, device),
        "wv": dense_init(gen, cfg.d_model, cfg.num_kv_heads * hd, dtype, device),
        "wo": pad_wo(dense_init(gen, cfg.num_heads * hd, cfg.d_model, dtype,
                                device, scale=1.0 / (cfg.num_heads * hd)),
                     cfg, n_pad),
    }
    if cfg.qk_norm:
        params["q_norm"] = torch.zeros((hd,), dtype=dtype, device=device)
        params["k_norm"] = torch.zeros((hd,), dtype=dtype, device=device)
    return params


def pad_wo(wo, cfg: ModelConfig, n_pad: int):
    """``wo`` (H*hd, d) with the dead heads' zero rows of ``n_pad`` q heads
    placed at the end of each kv group's heads (``wo`` itself when
    ``n_pad`` is the config's head count)."""
    if n_pad == cfg.num_heads:
        return wo
    hd, K = cfg.resolved_head_dim, cfg.num_kv_heads
    G, G_pad = cfg.num_heads // K, n_pad // K
    wo = wo.reshape(K, G, hd, cfg.d_model)
    pad = wo.new_zeros((K, G_pad - G, hd, cfg.d_model))
    return torch.cat([wo, pad], dim=1).reshape(n_pad * hd, cfg.d_model)


def tp_attention_specs(cfg: ModelConfig) -> dict:
    """Megatron-style specs of one attention param set over a model axis
    (each leaf's sharded dim, or None): q/k/v column-parallel (whole heads
    a rank), ``wo`` row-parallel, its partial outputs summed by
    ``transformer.apply_layer``; the qk-norm weights replicated."""
    specs = {"wq": 1, "wk": 1, "wv": 1, "wo": 0}
    if cfg.qk_norm:
        specs["q_norm"] = None
        specs["k_norm"] = None
    return specs


def init_kv_cache(cfg: ModelConfig, batch: int, length: int, dtype,
                  device) -> dict:
    shape = (batch, length, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _project_qkv(params, x, cfg: ModelConfig, positions, rope: bool = True):
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    n_q = params["wq"].shape[1] // hd
    n_kv = params["wk"].shape[1] // hd
    q = (x @ params["wq"]).reshape(B, S, n_q, hd)
    k = (x @ params["wk"]).reshape(B, S, n_kv, hd)
    v = (x @ params["wv"]).reshape(B, S, n_kv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.rms_eps)
        k = rms_norm(k, params["k_norm"], cfg.rms_eps)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _gqa_scores(q, k):
    """q: (B,S,N,hd) -> grouped (B,S,K,G,hd); scores (B,K,G,S,T) in f32."""
    B, S, N, hd = q.shape
    K = k.shape[2]
    qg = q.reshape(B, S, K, N // K, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg.float(), k.float())
    return scores * (1.0 / math.sqrt(hd))


def _attend(scores, v, mask, dtype):
    # a Python scalar fill: a fresh device tensor here would be a blocking
    # host-to-device copy in every layer
    scores = scores.masked_fill(~mask, MASK_VALUE)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v.float())
    B, S, K, G, hd = out.shape
    return out.reshape(B, S, K * G, hd).to(dtype)


def causal_mask(S: int, T: int, offset: int = 0, window: Optional[int] = None,
                device=None) -> torch.Tensor:
    """(S, T) boolean mask; query i at absolute position offset+i."""
    qpos = torch.arange(S, device=device)[:, None] + offset
    kpos = torch.arange(T, device=device)[None, :]
    mask = kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def attention_fullseq(params, x, *, cfg: ModelConfig, window: Optional[int],
                      positions=None, use_kernel: bool = False,
                      causal: bool = True, rope: bool = True):
    """Train/prefill attention over the whole sequence; returns (out, kv).
    As in the JAX package, the plain path applies ``window`` only with the
    causal mask; the kernel applies it either way."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _project_qkv(params, x, cfg, positions, rope=rope)
    if use_kernel:
        out = kops.flash_attention(q, k, v, causal=causal, window=window)
    else:
        scores = _gqa_scores(q, k)
        if causal:
            mask = causal_mask(S, S, window=window, device=x.device)[None, None, None]
        else:
            mask = torch.ones((1, 1, 1, S, S), dtype=torch.bool, device=x.device)
        out = _attend(scores, v, mask, x.dtype)
    out = out.reshape(B, S, -1) @ params["wo"]
    return out, {"k": k, "v": v}


def attention_decode(params, x, cache, cache_pos, *, cfg: ModelConfig,
                     window: Optional[int], rope: bool = True):
    """x: (B,1,d).  ``cache_pos`` is the absolute position of the new token:
    an int or 0-d tensor (all rows aligned) or a (B,) tensor (the ragged
    serving engine).  The new k/v row is written at ``min(pos, T-1)``, or,
    when ``window`` is set, at ring slot ``pos % T`` (the cache then holds
    ``min(capacity, window)`` rows).

    Unlike the JAX function, the cache is updated IN PLACE (and returned):
    its leaves are views into the caller's stacked stage cache, so a decode
    step writes one row per layer instead of copying the cache."""
    B = x.shape[0]
    T = cache["k"].shape[1]
    pos = torch.as_tensor(cache_pos, dtype=torch.int64, device=x.device)
    positions = pos.expand(B)[:, None] if pos.dim() == 0 else pos[:, None]
    q, k_new, v_new = _project_qkv(params, x, cfg, positions, rope=rope)
    if window is not None:
        slots = positions[:, 0] % T
    else:
        slots = torch.clamp(positions[:, 0], max=T - 1)
    b_idx = torch.arange(B, device=x.device)
    k, v = cache["k"], cache["v"]
    k[b_idx, slots] = k_new[:, 0].to(k.dtype)
    v[b_idx, slots] = v_new[:, 0].to(v.dtype)
    scores = _gqa_scores(q, k)                                 # (B,K,G,1,T)
    idx = torch.arange(T, device=x.device)[None, :]
    if window is not None:
        # ring buffer: slot s holds absolute position p iff p % T == s and
        # p <= pos and p > pos - window
        age = (slots[:, None] - idx) % T                       # 0 = newest
        valid = age < torch.clamp(positions + 1, max=window)
    else:
        valid = idx <= positions
    out = _attend(scores, v, valid[:, None, None, None, :], x.dtype)
    out = out.reshape(B, 1, -1) @ params["wo"]
    return out, {"k": k, "v": v}


# ---------------------------------------------------------------------------
# cross attention (whisper decoder -> encoder states)
# ---------------------------------------------------------------------------


def cross_attention(params, x, enc_kv, *, cfg: ModelConfig):
    """x (B,S,d) against ``enc_kv`` = {k, v} of shape (B,F,K,hd), from
    :func:`encoder_kv`; every frame is visible, and no RoPE (plain, as in
    the JAX package)."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = (x @ params["wq"]).reshape(B, S, cfg.num_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.rms_eps)
    scores = _gqa_scores(q, enc_kv["k"])
    F = enc_kv["k"].shape[1]
    mask = torch.ones((1, 1, 1, S, F), dtype=torch.bool, device=x.device)
    out = _attend(scores, enc_kv["v"], mask, x.dtype)
    return out.reshape(B, S, -1) @ params["wo"]


def encoder_kv(params, enc_out, *, cfg: ModelConfig) -> dict:
    """The cross attention's keys and values of the encoder output
    (B,F,d): what prefill caches as ``cross_kv`` for decode."""
    B, F, _ = enc_out.shape
    hd = cfg.resolved_head_dim
    k = (enc_out @ params["wk"]).reshape(B, F, cfg.num_kv_heads, hd)
    v = (enc_out @ params["wv"]).reshape(B, F, cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        k = rms_norm(k, params["k_norm"], cfg.rms_eps)
    return {"k": k, "v": v}
