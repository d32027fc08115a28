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
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import parallel
from repro_torch.models.common import apply_rope, dense_init, dense_spec, \
    rms_norm
from repro_torch.models.parallel import LOCAL, ParallelContext
from repro_torch.runtime import metrics

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


def head_layout(cfg: ModelConfig, mp: Optional[int]) -> Tuple[bool, bool]:
    """(q sharded, kv sharded) over a model axis of ``mp`` ranks, in whole
    heads: the port's form of the JAX package's head-aware rule
    (``REPRO_ATTN_HEAD_AWARE``, ``attention.py:73-88`` there), which
    shards a fused heads*hd dim only where the head count divides the
    axis, since a cut through a head costs an all-reduce of f32
    score-sized tensors a layer.  q shards where ``mp`` divides the
    (padded, :func:`_padded_heads`) q heads and each rank's heads fall in
    whole kv groups or inside one group; kv shards where, besides, ``mp``
    divides the kv heads, and is replicated otherwise, each rank reading
    the kv head(s) of its q heads; where q cannot shard the whole
    attention is replicated.  ``mp=None`` shards both (the manual
    regime's stages, checked by ``transformer.check_tp_divisibility``)."""
    if mp is None:
        return True, True
    n_pad, K = _padded_heads(cfg), cfg.num_kv_heads
    if mp <= 1 or n_pad % mp:
        return False, False
    n_q, G = n_pad // mp, n_pad // K
    if n_q % G and G % n_q:
        return False, False
    return True, K % mp == 0


def attention_specs(cfg: ModelConfig, mp: Optional[int] = None) -> dict:
    """Specs of one attention param set over a model axis of ``mp`` ranks
    (each leaf's sharded dim, or None) by :func:`head_layout`: q/k/v
    column-parallel in whole heads where they shard, ``wo`` row-parallel
    with q (its partial outputs summed by ``transformer.apply_layer``),
    the qk-norm weights replicated."""
    q_ok, kv_ok = head_layout(cfg, mp)
    hd, d, n_pad = cfg.resolved_head_dim, cfg.d_model, _padded_heads(cfg)
    kv_cols = cfg.num_kv_heads * hd
    specs = {"wq": dense_spec((d, n_pad * hd), 1 if q_ok else None, mp),
             "wk": dense_spec((d, kv_cols), 1 if kv_ok else None, mp),
             "wv": dense_spec((d, kv_cols), 1 if kv_ok else None, mp),
             "wo": dense_spec((n_pad * hd, d), 0 if q_ok else None, mp)}
    if cfg.qk_norm:
        specs["q_norm"] = None
        specs["k_norm"] = None
    return specs


def init_kv_cache(cfg: ModelConfig, batch: int, length: int, dtype,
                  device) -> dict:
    shape = (batch, length, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def kv_cache_spec(batch_axis, length_axis=None, head_axis=None,
                  axis: str = "model") -> dict:
    """The kv cache's (B, T, K, hd) spec over grid axis ``axis``: the dim
    whose named axes (each a name, a tuple of names, or None) include it,
    or None; as the JAX package's ``kv_cache_spec`` lays the cache out."""
    dim = parallel.axis_dim((batch_axis, length_axis, head_axis, None), axis)
    return {"k": dim, "v": dim}


def _kv_heads(cfg: ModelConfig, n_q: int, n_kv: int, rank: int):
    """(lo, n): the kv heads, of the ``n_kv`` at hand, that this rank's
    ``n_q`` q heads read: all of them, unless the q heads are a shard and
    the kv heads every kv head (kv replicated, :func:`head_layout`); then
    q head ``j`` reads kv head ``j // G`` (G the padded group size)."""
    n_pad = _padded_heads(cfg)
    if n_q == n_pad or n_kv != cfg.num_kv_heads:
        return 0, n_kv
    G = n_pad // n_kv
    j0 = rank * n_q
    lo = j0 // G
    return lo, (j0 + n_q - 1) // G + 1 - lo


def _cols(w, lo: int, n: int, hd: int):
    """Columns of heads [lo, lo + n) of a fused (d, heads*hd) weight."""
    return w if lo == 0 and n * hd == w.shape[1] else w[:, lo * hd:(lo + n) * hd]


def _project_qkv(params, x, cfg: ModelConfig, positions, rope: bool = True,
                 kv=None):
    """q over the params' q heads; k and v over kv heads ``kv`` = (lo, n)
    of the params' (all of them when None)."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    n_q = params["wq"].shape[1] // hd
    lo, n_kv = kv if kv is not None else (0, params["wk"].shape[1] // hd)
    q = (x @ params["wq"]).reshape(B, S, n_q, hd)
    k = (x @ _cols(params["wk"], lo, n_kv, hd)).reshape(B, S, n_kv, hd)
    v = (x @ _cols(params["wv"], lo, n_kv, hd)).reshape(B, S, n_kv, hd)
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


def _rank(pctx: ParallelContext) -> int:
    return pctx.rank if pctx.tensor_parallel else 0


def attention_fullseq(params, x, *, cfg: ModelConfig, window: Optional[int],
                      positions=None, use_kernel: bool = False,
                      causal: bool = True, rope: bool = True,
                      pctx: ParallelContext = LOCAL):
    """Train/prefill attention over the whole sequence; returns (out, kv).
    As in the JAX package, the plain path applies ``window`` only with the
    causal mask; the kernel applies it either way.  A rank whose q heads
    are a shard over replicated kv params projects only the kv head(s)
    they read (:func:`_kv_heads`), and returns those as its kv; under
    sequence-sharded caches (``pctx.for_cache``) it projects every kv head
    of its params, which the caches keep.  Under ``torch.profiler`` the
    core (the S×S scores, mask, softmax and values, or the flash kernel) is
    the span ``mixer.attn.core`` (``runtime.metrics.span``), counting
    ``flash`` 1 where it took the kernel and 0 where it took the plain
    path."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    hd = cfg.resolved_head_dim
    n_kv = params["wk"].shape[1] // hd
    lo, n = _kv_heads(cfg, params["wq"].shape[1] // hd, n_kv, _rank(pctx))
    keep_all = pctx.seq_size > 1
    q, k, v = _project_qkv(params, x, cfg, positions, rope=rope,
                           kv=(0, n_kv) if keep_all else (lo, n))
    ka, va = (k[:, :, lo:lo + n], v[:, :, lo:lo + n]) if keep_all else (k, v)
    with metrics.span("mixer.attn.core", x, flash=int(use_kernel)):
        if use_kernel:
            out = kops.flash_attention(q, ka, va, causal=causal, window=window)
        else:
            scores = _gqa_scores(q, ka)
            if causal:
                mask = causal_mask(S, S, window=window,
                                   device=x.device)[None, None, None]
            else:
                mask = torch.ones((1, 1, 1, S, S), dtype=torch.bool,
                                  device=x.device)
            out = _attend(scores, va, mask, x.dtype)
    out = out.reshape(B, S, -1) @ params["wo"]
    return out, {"k": k, "v": v}


def attention_decode(params, x, cache, cache_pos, *, cfg: ModelConfig,
                     window: Optional[int], rope: bool = True,
                     pctx: ParallelContext = LOCAL):
    """x: (B,1,d).  ``cache_pos`` is the absolute position of the new token:
    an int or 0-d tensor (all rows aligned) or a (B,) tensor (the ragged
    serving engine).  The new k/v row is written at ``min(pos, T-1)``, or,
    when ``window`` is set, at ring slot ``pos % T`` (the cache then holds
    ``min(capacity, window)`` rows).  Under sequence-sharded caches
    (``pctx.for_cache``) see :func:`_decode_seq_sharded`.

    Unlike the JAX function, the cache is updated IN PLACE (and returned):
    its leaves are views into the caller's stacked stage cache, so a decode
    step writes one row per layer instead of copying the cache."""
    if pctx.seq_size > 1:
        return _decode_seq_sharded(params, x, cache, cache_pos, cfg=cfg,
                                   window=window, rope=rope, pctx=pctx)
    B = x.shape[0]
    T = cache["k"].shape[1]
    hd = cfg.resolved_head_dim
    pos = torch.as_tensor(cache_pos, dtype=torch.int64, device=x.device)
    positions = pos.expand(B)[:, None] if pos.dim() == 0 else pos[:, None]
    kv = _kv_heads(cfg, params["wq"].shape[1] // hd,
                   params["wk"].shape[1] // hd, _rank(pctx))
    q, k_new, v_new = _project_qkv(params, x, cfg, positions, rope=rope, kv=kv)
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


def _decode_seq_sharded(params, x, cache, cache_pos, *, cfg: ModelConfig,
                        window: Optional[int], rope: bool,
                        pctx: ParallelContext):
    """Decode over a cache whose length dim shards over ``pctx.seq_axes``:
    this rank holds positions ``[i*Tl, (i+1)*Tl)`` (ring slots, for a
    windowed layer) of every kv head, ``i = pctx.seq_rank``.  The new
    token's q heads (and its k/v heads, where kv shards) are gathered over
    the model axis; each row's slot is ``pos % T`` on a ring, else
    ``min(pos, T-1)``, and only the rank whose block holds a row's slot
    writes that row's k/v; every rank attends all heads over its block
    under each row's own mask, and the blocks' partial softmaxes merge over
    the sequence group by log-sum-exp (an all-reduce MAX of the row max,
    then one SUM of the rescaled outputs and sums).  The rank then keeps
    its own q heads for the row-parallel ``wo``.  ``cache_pos`` is an int,
    a 0-d tensor or a (B,) tensor (ragged rows), as in
    :func:`attention_decode`."""
    B = x.shape[0]
    hd, n_pad = cfg.resolved_head_dim, _padded_heads(cfg)
    Tl = cache["k"].shape[1]
    T = Tl * pctx.seq_size
    pos = torch.as_tensor(cache_pos, dtype=torch.int64, device=x.device)
    positions = pos.expand(B)[:, None] if pos.dim() == 0 else pos[:, None]
    q, k_new, v_new = _project_qkv(params, x, cfg, positions, rope=rope)
    n_q = q.shape[2]
    if n_q < n_pad:
        q = parallel.all_gather(q, 2, pctx.group)
    if k_new.shape[2] < cfg.num_kv_heads:
        k_new = parallel.all_gather(k_new, 2, pctx.group)
        v_new = parallel.all_gather(v_new, 2, pctx.group)
    lo = pctx.seq_rank * Tl
    k, v = cache["k"], cache["v"]
    slots = positions[:, 0] % T if window is not None else \
        torch.clamp(positions[:, 0], max=T - 1)
    mine = ((slots >= lo) & (slots < lo + Tl))[:, None, None]
    # every row writes a slot of this block: its new k/v where the slot is
    # this rank's, else what the slot held (no host sync, and the same
    # shapes on meta tensors in the dry run)
    b_idx = torch.arange(B, device=x.device)
    local = torch.clamp(slots - lo, 0, Tl - 1)
    k[b_idx, local] = torch.where(mine, k_new[:, 0].to(k.dtype), k[b_idx, local])
    v[b_idx, local] = torch.where(mine, v_new[:, 0].to(v.dtype), v[b_idx, local])
    scores = _gqa_scores(q, k)                                 # (B,K,G,1,Tl)
    idx = torch.arange(lo, lo + Tl, device=x.device)[None, :]
    if window is not None:
        # ring ages, per row
        valid = (slots[:, None] - idx) % T < torch.clamp(positions + 1, max=window)
    else:
        valid = idx <= positions
    valid = valid[:, None, None, None, :]
    scores = scores.masked_fill(~valid, MASK_VALUE)
    m = scores.amax(dim=-1, keepdim=True)
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=pctx.seq_group)
    p = torch.exp(scores - m)
    o = torch.einsum("bkgst,btkh->bskgh", p, v.float())        # (B,1,K,G,hd)
    s = p.sum(dim=-1)                                          # (B,K,G,1)
    both = torch.cat([o.reshape(-1), s.reshape(-1)])
    dist.all_reduce(both, group=pctx.seq_group)
    o, s = both.split([o.numel(), s.numel()])
    K, G = k.shape[2], n_pad // k.shape[2]
    out = o.view(B, 1, K, G, hd) / s.view(B, K, G, 1).permute(0, 3, 1, 2)[..., None]
    out = out.reshape(B, 1, n_pad, hd).to(x.dtype)
    if n_q < n_pad:
        out = out[:, :, pctx.rank * n_q:(pctx.rank + 1) * n_q]
    out = out.reshape(B, 1, -1) @ params["wo"]
    return out, {"k": k, "v": v}


# ---------------------------------------------------------------------------
# cross attention (whisper decoder -> encoder states)
# ---------------------------------------------------------------------------


def cross_attention(params, x, enc_kv, *, cfg: ModelConfig,
                    pctx: ParallelContext = LOCAL):
    """x (B,S,d) against ``enc_kv`` = {k, v} of shape (B,F,K,hd), from
    :func:`encoder_kv`; every frame is visible, and no RoPE (plain, as in
    the JAX package).  A rank with a shard of the q heads reads the kv
    heads they need from an ``enc_kv`` of every kv head."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = (x @ params["wq"]).reshape(B, S, -1, hd)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.rms_eps)
    lo, n = _kv_heads(cfg, q.shape[2], enc_kv["k"].shape[2], _rank(pctx))
    k, v = enc_kv["k"][:, :, lo:lo + n], enc_kv["v"][:, :, lo:lo + n]
    scores = _gqa_scores(q, k)
    F = k.shape[1]
    mask = torch.ones((1, 1, 1, S, F), dtype=torch.bool, device=x.device)
    out = _attend(scores, v, mask, x.dtype)
    return out.reshape(B, S, -1) @ params["wo"]


def encoder_kv(params, enc_out, *, cfg: ModelConfig) -> dict:
    """The cross attention's keys and values of the encoder output
    (B,F,d): what prefill caches as ``cross_kv`` for decode (the params'
    kv heads: a rank's shard where kv shards)."""
    B, F, _ = enc_out.shape
    hd = cfg.resolved_head_dim
    k = (enc_out @ params["wk"]).reshape(B, F, -1, hd)
    v = (enc_out @ params["wv"]).reshape(B, F, -1, hd)
    if cfg.qk_norm:
        k = rms_norm(k, params["k_norm"], cfg.rms_eps)
    return {"k": k, "v": v}
