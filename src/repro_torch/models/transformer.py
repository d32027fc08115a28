"""Segmented layer stack (port of ``repro/models/transformer.py``: the
attention layers, with an MLP or a mixture of experts after them and, in
whisper's decoder, cross attention between).

A model is a flat list of ``LayerDef``s compressed into ``Segment``s: a
repeating unit with its params stacked over repeats, as in the JAX package,
so the weight bridge is a tree map and a layer-range slice is a view.  A
Python loop over the repeats replaces ``lax.scan``.  Each apply function
returns, as JAX's does, the MoE layers' aux losses ``[load_balance,
router_z]`` summed over the layers it ran (zeros where there are none).
The recurrent mixers (mamba, mLSTM, sLSTM) and zamba2's shared block are
not ported: their configs raise ``NotImplementedError``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models.common import apply_mlp, init_mlp, init_rms_norm, rms_norm
from repro_torch.tree import tree_map

# ---------------------------------------------------------------------------
# layer defs and segmentation
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LayerDef:
    mixer: str                      # attn (mamba | mlstm | slstm not ported)
    ffn: Optional[str] = "mlp"      # mlp | moe | None
    window: Optional[int] = None
    shared: bool = False            # zamba2 shared-attention params
    cross: bool = False             # whisper decoder cross-attention


@dataclass(frozen=True)
class Segment:
    unit: Tuple[LayerDef, ...]
    repeats: int

    @property
    def num_layers(self) -> int:
        return len(self.unit) * self.repeats


def build_layer_defs(cfg: ModelConfig, long_mode: bool = False) -> List[LayerDef]:
    """The flat per-layer spec of an attention architecture: an MoE layer
    where ``i % every == every - 1``, cross attention in every layer of an
    encoder-decoder's decoder.  The recurrent families raise until their
    slice is ported."""
    if (cfg.xlstm is not None or cfg.hybrid_attn_every is not None
            or cfg.ssm is not None):
        raise NotImplementedError(
            f"{cfg.name}: only attention architectures are ported")
    defs: List[LayerDef] = []
    for i in range(cfg.num_layers):
        window = None
        if cfg.sliding_window is not None:
            if cfg.global_every is None or (i % cfg.global_every != cfg.global_every - 1):
                window = cfg.sliding_window
            elif long_mode:
                window = cfg.long_context_window
        elif long_mode and cfg.long_context_window is not None:
            window = cfg.long_context_window
        ffn = "mlp"
        if cfg.moe is not None and (i % cfg.moe.every == cfg.moe.every - 1):
            ffn = "moe"
        defs.append(LayerDef(mixer="attn", ffn=ffn, window=window,
                             cross=cfg.is_encdec))
    return defs


def segmentize(defs: Sequence[LayerDef]) -> List[Segment]:
    """Compress a flat def list into repeated-unit segments (greedy)."""
    defs = list(defs)
    if not defs:
        return []
    best = None
    for u in range(1, min(len(defs), 8) + 1):
        unit = tuple(defs[:u])
        reps = 1
        while (reps + 1) * u <= len(defs) and tuple(defs[reps * u:(reps + 1) * u]) == unit:
            reps += 1
        score = (reps * u, -u)
        if best is None or score > best[0]:
            best = (score, unit, reps)
    _, unit, reps = best
    return [Segment(unit=unit, repeats=reps)] + segmentize(defs[len(unit) * reps:])


def split_defs(defs: Sequence[LayerDef], boundary: Optional[int]) -> List[List[Segment]]:
    """Stage list for a butterfly at ``boundary`` (layers [0,b) | [b,N))."""
    if boundary is None:
        return [segmentize(defs)]
    assert 0 < boundary < len(defs), boundary
    return [segmentize(defs[:boundary]), segmentize(defs[boundary:])]


# ---------------------------------------------------------------------------
# layer-range views over a full stacked stage
# ---------------------------------------------------------------------------


def _range_spans(segments: Sequence[Segment], lo: int, hi: int):
    """For flat layers [lo, hi) yield aligned repeat-slices or per-layer peels:

      ("slice", seg_index, rep_lo, rep_hi)    — whole repeats [rep_lo, rep_hi)
      ("peel",  seg_index, rep, pos_in_unit)  — one layer of one repeat
    """
    base = 0
    for si, seg in enumerate(segments):
        u = len(seg.unit)
        span = u * seg.repeats
        s, e = max(lo, base) - base, min(hi, base + span) - base
        if s < e:
            head = min(e, (s + u - 1) // u * u)
            tail = max(head, e // u * u)
            for li in range(s, head):
                yield ("peel", si, li // u, li % u)
            if head < tail:
                yield ("slice", si, head // u, tail // u)
            for li in range(tail, e):
                yield ("peel", si, li // u, li % u)
        base += span


def range_segments(segments: Sequence[Segment], lo: int, hi: int) -> List[Segment]:
    """Segmentation of flat layers [lo, hi) of a full stage, matching what
    :func:`slice_stage_params` produces."""
    out: List[Segment] = []
    for span in _range_spans(segments, lo, hi):
        if span[0] == "slice":
            _, si, r0, r1 = span
            out.append(Segment(unit=segments[si].unit, repeats=r1 - r0))
        else:
            _, si, _, pos = span
            out.append(Segment(unit=(segments[si].unit[pos],), repeats=1))
    return out


def slice_stage_params(segments: Sequence[Segment], stage_params, lo: int, hi: int):
    """Restrict a stage's stacked params to flat layers [lo, hi).  Every leaf
    of the result is a view of the full stacked leaf: no copies."""
    out_segs: List[Segment] = []
    out_params = []
    for span in _range_spans(segments, lo, hi):
        if span[0] == "slice":
            _, si, r0, r1 = span
            out_segs.append(Segment(unit=segments[si].unit, repeats=r1 - r0))
            out_params.append([tree_map(lambda a: a[r0:r1], up)
                               for up in stage_params[si]])
        else:
            _, si, rep, pos = span
            out_segs.append(Segment(unit=(segments[si].unit[pos],), repeats=1))
            out_params.append([tree_map(lambda a: a[rep:rep + 1],
                                        stage_params[si][pos])])
    return out_segs, out_params


def apply_layer_range(segments: Sequence[Segment], stage_params, x, lo: int,
                      hi: int, *, cfg, mode, range_cache, pos,
                      use_kernel: bool = False, first_h=None):
    """Run flat layers [lo, hi) of a full stacked stage; ``range_cache`` is
    structured per :func:`range_segments`.  Returns (x, caches, aux)."""
    segs, params = slice_stage_params(segments, stage_params, lo, hi)
    return apply_stage(segs, params, x, cfg=cfg, mode=mode,
                       stage_cache=range_cache, pos=pos,
                       use_kernel=use_kernel, first_h=first_h)


def first_layer_norm1(segments: Sequence[Segment], stage_params, lo: int = 0):
    """The norm1 weight of flat layer ``lo`` of a stacked stage: what the
    fused dequant+restore+norm kernel needs to compute that layer's input
    norm at the butterfly boundary."""
    for span in _range_spans(segments, lo, lo + 1):
        if span[0] == "peel":
            _, si, rep, pos = span
            return stage_params[si][pos]["norm1"][rep]
        _, si, r0, _ = span
        return stage_params[si][0]["norm1"][r0]
    raise ValueError(f"layer {lo} out of range")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_layer(gen, ldef: LayerDef, cfg: ModelConfig, dtype, device) -> dict:
    if ldef.mixer != "attn" or ldef.shared or ldef.ffn is None:
        raise NotImplementedError(f"layer {ldef} is not ported")
    params = {"norm1": init_rms_norm(cfg.d_model, dtype, device),
              "mixer": attn.init_attention(gen, cfg, dtype, device)}
    if ldef.cross:
        params["norm_cross"] = init_rms_norm(cfg.d_model, dtype, device)
        params["cross"] = attn.init_attention(gen, cfg, dtype, device)
    params["norm2"] = init_rms_norm(cfg.d_model, dtype, device)
    if ldef.ffn == "moe":
        params["ffn"] = moe_lib.init_moe(gen, cfg, dtype, device)
    else:
        params["ffn"] = init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, device)
    return params


def init_segment(gen, seg: Segment, cfg: ModelConfig, dtype, device) -> list:
    """[params per unit position, each leaf stacked over repeats].  Each
    repeat is drawn and copied into its slot, so init holds one layer's
    temporaries beside the stacked tree; a single repeat is a view of its
    one layer, never a copy (llama4's MoE layer alone is 32 GB)."""
    unit_params = []
    for ldef in seg.unit:
        first = init_layer(gen, ldef, cfg, dtype, device)
        if seg.repeats == 1:
            unit_params.append(tree_map(lambda a: a[None], first))
            continue
        stacked = tree_map(lambda a: torch.empty((seg.repeats,) + tuple(a.shape),
                                                 dtype=a.dtype, device=a.device), first)
        tree_map(lambda s, a: s[0].copy_(a), stacked, first)
        del first
        for r in range(1, seg.repeats):
            tree_map(lambda s, a: s[r].copy_(a), stacked,
                     init_layer(gen, ldef, cfg, dtype, device))
        unit_params.append(stacked)
    return unit_params


def init_layer_cache(ldef: LayerDef, cfg: ModelConfig, batch: int, length: int,
                     dtype, device) -> dict:
    """Cache template (zeros) for one layer in decode mode: ``length`` rows,
    or a ring of ``min(length, window)`` rows for a windowed layer; a
    cross-attention layer adds ``cross_kv``, the encoder's keys and values
    (``encoder_frames`` rows)."""
    if ldef.mixer != "attn":
        raise NotImplementedError(f"cache of layer {ldef} is not ported")
    cache_len = min(length, ldef.window) if ldef.window else length
    c = {"kv": attn.init_kv_cache(cfg, batch, cache_len, dtype, device)}
    if ldef.cross:
        c["cross_kv"] = attn.init_kv_cache(cfg, batch, cfg.encoder_frames,
                                           dtype, device)
    return c


def init_stage_cache(segments: List[Segment], cfg, batch, length, dtype,
                     device) -> list:
    """Stacked zero caches per segment; ``device="meta"`` gives the shapes
    without allocating."""
    out = []
    for seg in segments:
        unit = []
        for ldef in seg.unit:
            c = init_layer_cache(ldef, cfg, batch, length, dtype, device)
            unit.append(tree_map(
                lambda a: torch.zeros((seg.repeats,) + tuple(a.shape),
                                      dtype=a.dtype, device=a.device), c))
        out.append(unit)
    return out


def pad_to_template(cache, template):
    """Zero-pad each leaf of a prefill-shaped cache to its decode template's
    shape (a tree of the same structure, e.g. on the meta device).  A ring
    cache comes out exactly ``min(capacity, window)`` rows long, as its slot
    is ``pos % T``."""
    def pad(leaf, t):
        if leaf.shape == t.shape:
            return leaf
        if any(ls > ts for ls, ts in zip(leaf.shape, t.shape)):
            raise ValueError(f"cache leaf {tuple(leaf.shape)} is longer than "
                             f"its decode template {tuple(t.shape)}")
        out = torch.zeros(t.shape, dtype=leaf.dtype, device=leaf.device)
        out[tuple(slice(0, s) for s in leaf.shape)] = leaf
        return out

    return tree_map(pad, cache, template)


def to_ring(kv: dict, window: int) -> dict:
    """Arrange the last ``window`` positions of a full-seq KV into ring
    order: position ``p`` in slot ``p % window``."""
    S = kv["k"].shape[1]
    if S <= window:
        return kv
    # tail row i holds position S - window + i, whose slot is (i + S) % window
    return {name: torch.roll(a[:, -window:], shifts=S % window, dims=1)
            for name, a in kv.items()}


# ---------------------------------------------------------------------------
# apply
# ---------------------------------------------------------------------------


def apply_layer(ldef: LayerDef, p, x, *, cfg: ModelConfig, mode: str, cache,
                pos, enc_out=None, use_kernel: bool = False,
                causal: bool = True, h_pre=None):
    """Returns (x, new_cache, aux): aux is the layer's MoE losses
    ``[load_balance, router_z]``, or None for an MLP layer.  ``h_pre``
    short-circuits the input RMSNorm for a caller that already holds
    ``rms_norm(x, norm1)``.  Prefill caches of windowed layers come back in
    ring order (:func:`to_ring`).  A cross-attention layer reads the
    encoder output ``enc_out`` in train and prefill, and its ``cross_kv``
    cache in decode."""
    aux = None
    h = h_pre if h_pre is not None else rms_norm(x, p["norm1"], cfg.rms_eps)
    rope = not cfg.is_encdec          # whisper uses sinusoid embeds, no RoPE
    new_cache = None
    if mode == "decode":
        out, kv = attn.attention_decode(p["mixer"], h, cache["kv"], pos,
                                        cfg=cfg, window=ldef.window, rope=rope)
        new_cache = {"kv": kv}
    else:
        out, kv = attn.attention_fullseq(p["mixer"], h, cfg=cfg,
                                         window=ldef.window,
                                         use_kernel=use_kernel, causal=causal,
                                         rope=rope)
        if mode == "prefill":
            new_cache = {"kv": to_ring(kv, ldef.window) if ldef.window else kv}
    x = x + out
    if ldef.cross:
        hc = rms_norm(x, p["norm_cross"], cfg.rms_eps)
        if mode == "decode":
            ckv = cache["cross_kv"]
        else:
            ckv = attn.encoder_kv(p["cross"], enc_out, cfg=cfg)
        x = x + attn.cross_attention(p["cross"], hc, ckv, cfg=cfg)
        if new_cache is not None:
            new_cache["cross_kv"] = ckv
    h2 = rms_norm(x, p["norm2"], cfg.rms_eps)
    if ldef.ffn == "moe":
        out, moe_aux = moe_lib.apply_moe(p["ffn"], h2, cfg=cfg, act=cfg.act)
        x = x + out
        aux = torch.stack([moe_aux["load_balance"], moe_aux["router_z"]])
    else:
        x = x + apply_mlp(p["ffn"], h2, cfg.act)
    return x, new_cache, aux


def apply_segment(seg: Segment, seg_params, x, *, cfg, mode, seg_cache, pos,
                  enc_out=None, use_kernel: bool = False, causal: bool = True,
                  first_h=None):
    """seg_params: per unit position, leaves stacked over repeats.  Decode
    writes the stacked ``seg_cache`` in place and returns it; prefill
    returns the new caches stacked over repeats; train returns None.
    Returns (x, caches, aux summed over the segment's MoE layers, or
    None)."""
    aux_sum = None
    per_rep = []
    for rep in range(seg.repeats):
        caches = []
        for i, ldef in enumerate(seg.unit):
            p = tree_map(lambda a: a[rep], seg_params[i])
            c = None if seg_cache is None else \
                tree_map(lambda a: a[rep], seg_cache[i])
            x, nc, aux = apply_layer(
                ldef, p, x, cfg=cfg, mode=mode, cache=c, pos=pos,
                enc_out=enc_out, use_kernel=use_kernel, causal=causal,
                h_pre=first_h if rep == 0 and i == 0 else None)
            aux_sum = _add_aux(aux_sum, aux)
            caches.append(nc)
        per_rep.append(caches)
    if mode == "decode":
        return x, seg_cache, aux_sum
    if mode == "prefill":
        return x, [tree_map(lambda *reps: torch.stack(reps), *[c[i] for c in per_rep])
                   for i in range(len(seg.unit))], aux_sum
    return x, None, aux_sum


def apply_stage(segments: List[Segment], stage_params, x, *, cfg, mode,
                stage_cache, pos, enc_out=None, use_kernel: bool = False,
                causal: bool = True, first_h=None):
    """Returns (x, new stage caches, aux): the f32 ``[load_balance,
    router_z]`` summed over the stage's MoE layers (zeros without one)."""
    aux_total = None
    new_caches = []
    for si, seg in enumerate(segments):
        cache = None if stage_cache is None else stage_cache[si]
        x, nc, aux = apply_segment(
            seg, stage_params[si], x, cfg=cfg, mode=mode, seg_cache=cache,
            pos=pos, enc_out=enc_out, use_kernel=use_kernel, causal=causal,
            first_h=first_h if si == 0 else None)
        new_caches.append(nc)
        aux_total = _add_aux(aux_total, aux)
    if aux_total is None:
        aux_total = torch.zeros((2,), dtype=torch.float32, device=x.device)
    return x, new_caches, aux_total


def _add_aux(total, aux):
    """Sum of aux vectors where None stands for zeros (layers without an
    MoE add no device work)."""
    if aux is None:
        return total
    return aux if total is None else total + aux
