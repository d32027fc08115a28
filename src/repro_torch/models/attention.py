"""GQA attention with qk-norm and RoPE, full-sequence and one-token decode
(port of ``repro/models/attention.py``, the plain path: the flash-attention
kernel arrives with its own slice).  Scores, masks and softmax run in f32
with ``MASK_VALUE`` for masked slots.

Windowed ring-buffer caches arrive with the windowed families; a layer with
a window raises here.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import apply_rope, dense_init, rms_norm

MASK_VALUE = -1e30


def _no_window(window: Optional[int]):
    if window is not None:
        raise NotImplementedError("windowed attention is not ported yet")


def init_attention(gen, cfg: ModelConfig, dtype, device) -> dict:
    hd = cfg.resolved_head_dim
    params = {
        "wq": dense_init(gen, cfg.d_model, cfg.num_heads * hd, dtype, device),
        "wk": dense_init(gen, cfg.d_model, cfg.num_kv_heads * hd, dtype, device),
        "wv": dense_init(gen, cfg.d_model, cfg.num_kv_heads * hd, dtype, device),
        "wo": dense_init(gen, cfg.num_heads * hd, cfg.d_model, dtype, device,
                         scale=1.0 / (cfg.num_heads * hd)),
    }
    if cfg.qk_norm:
        params["q_norm"] = torch.zeros((hd,), dtype=dtype, device=device)
        params["k_norm"] = torch.zeros((hd,), dtype=dtype, device=device)
    return params


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
                      positions=None, causal: bool = True, rope: bool = True):
    """Train/prefill attention over the whole sequence; returns (out, kv)."""
    _no_window(window)
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _project_qkv(params, x, cfg, positions, rope=rope)
    scores = _gqa_scores(q, k)
    if causal:
        mask = causal_mask(S, S, device=x.device)[None, None, None]
    else:
        mask = torch.ones((1, 1, 1, S, S), dtype=torch.bool, device=x.device)
    out = _attend(scores, v, mask, x.dtype)
    out = out.reshape(B, S, -1) @ params["wo"]
    return out, {"k": k, "v": v}


def attention_decode(params, x, cache, cache_pos, *, cfg: ModelConfig,
                     window: Optional[int], rope: bool = True):
    """x: (B,1,d).  ``cache_pos`` is the absolute position of the new token:
    an int or 0-d tensor (all rows aligned) or a (B,) tensor (the ragged
    serving engine).  The new k/v row is written at ``min(pos, T-1)``.

    Unlike the JAX function, the cache is updated IN PLACE (and returned):
    its leaves are views into the caller's stacked stage cache, so a decode
    step writes one row per layer instead of copying the cache."""
    _no_window(window)
    B = x.shape[0]
    T = cache["k"].shape[1]
    pos = torch.as_tensor(cache_pos, dtype=torch.int64, device=x.device)
    positions = pos.expand(B)[:, None] if pos.dim() == 0 else pos[:, None]
    q, k_new, v_new = _project_qkv(params, x, cfg, positions, rope=rope)
    slots = torch.clamp(positions[:, 0], max=T - 1)
    b_idx = torch.arange(B, device=x.device)
    k, v = cache["k"], cache["v"]
    k[b_idx, slots] = k_new[:, 0].to(k.dtype)
    v[b_idx, slots] = v_new[:, 0].to(v.dtype)
    scores = _gqa_scores(q, k)                                 # (B,K,G,1,T)
    valid = torch.arange(T, device=x.device)[None, :] <= positions
    out = _attend(scores, v, valid[:, None, None, None, :], x.dtype)
    out = out.reshape(B, 1, -1) @ params["wo"]
    return out, {"k": k, "v": v}
