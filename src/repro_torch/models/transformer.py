"""Segmented layer stack (port of ``repro/models/transformer.py``).

Layer kinds: mixer in {attn, mamba, mlstm, slstm} x ffn in {mlp, moe,
None}; ``shared=True`` marks zamba2's shared attention block, whose mixer
and MLP are stored once at the top of the param tree (``shared_attn``) and
read by every shared layer; ``cross`` adds whisper-style cross attention.

A model is a flat list of ``LayerDef``s compressed into ``Segment``s: a
repeating unit with its params stacked over repeats, as in the JAX package,
so the weight bridge is a tree map and a layer-range slice is a view.  A
Python loop over the repeats replaces ``lax.scan``.  Each apply function
returns, as JAX's does, the MoE layers' aux losses ``[load_balance,
router_z]`` summed over the layers it ran (zeros where there are none).
A recurrent layer's cache is its state (``models/ssm.py``,
``models/xlstm.py``): leaves with no sequence axis.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch import device as dev_lib
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import xlstm as xlstm_lib
from repro_torch.models import parallel
from repro_torch.models.common import apply_mlp, dense_spec, init_mlp, \
    init_rms_norm, rms_norm
from repro_torch.models.parallel import (LOCAL, ParallelContext, model_copy,
                                         model_psum)
from repro_torch.tree import tree_map

# ---------------------------------------------------------------------------
# layer defs and segmentation
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LayerDef:
    mixer: str                      # attn | mamba | mlstm | slstm
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
    """The flat per-layer spec for an architecture: xLSTM's sLSTM where
    ``i % slstm_every == slstm_every - 1`` (mLSTM elsewhere), zamba2's
    shared attention where ``i % hybrid_attn_every == hybrid_attn_every - 1``
    (mamba elsewhere), an MoE layer where ``i % every == every - 1``, cross
    attention in every layer of an encoder-decoder's decoder.

    ``long_mode`` — the long_500k sub-quadratic variant: every attention layer
    runs with a bounded window (cfg.long_context_window)."""
    defs: List[LayerDef] = []
    for i in range(cfg.num_layers):
        if cfg.xlstm is not None:
            every = cfg.xlstm.slstm_every
            mixer = "slstm" if (i % every == every - 1) else "mlstm"
            defs.append(LayerDef(mixer=mixer, ffn=None))
            continue
        if cfg.hybrid_attn_every is not None:
            if i % cfg.hybrid_attn_every == cfg.hybrid_attn_every - 1:
                window = cfg.long_context_window if long_mode else None
                defs.append(LayerDef(mixer="attn", ffn="mlp", shared=True,
                                     window=window))
            else:
                defs.append(LayerDef(mixer="mamba", ffn=None))
            continue
        if cfg.arch_type == "ssm" and cfg.ssm is not None:
            defs.append(LayerDef(mixer="mamba", ffn=None))
            continue
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
                      pctx: ParallelContext = LOCAL, shared_params=None,
                      use_kernel: bool = False, first_h=None):
    """Run flat layers [lo, hi) of a full stacked stage; ``range_cache`` is
    structured per :func:`range_segments`.  ``shared_params`` is the whole
    shared block (never sliced by layer range).  Returns (x, caches,
    aux)."""
    segs, params = slice_stage_params(segments, stage_params, lo, hi)
    return apply_stage(segs, params, x, cfg=cfg, mode=mode,
                       stage_cache=range_cache, pos=pos, pctx=pctx,
                       shared_params=shared_params, use_kernel=use_kernel,
                       first_h=first_h)


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
# tensor-parallel (model-axis) sharding specs
# ---------------------------------------------------------------------------


def check_tp_divisibility(defs: Sequence[LayerDef], cfg: ModelConfig,
                          mp: int) -> None:
    """Model-parallel stages shard whole attention heads, whole d_ff columns
    and whole experts: raise ValueError when ``mp`` cannot divide them.
    Mixers with no tensor-parallel decomposition (mamba, mLSTM, sLSTM)
    replicate and run on every rank, so they impose no constraint."""
    if mp <= 1:
        return
    for ldef in defs:
        if ldef.mixer != "attn":
            continue
        if ldef.cross:
            raise ValueError("tensor-parallel stages do not support "
                             "cross-attention layers")
        if attn._padded_heads(cfg) % mp or cfg.num_kv_heads % mp:
            raise ValueError(
                f"model axis {mp} must divide heads "
                f"({attn._padded_heads(cfg)}) and kv heads "
                f"({cfg.num_kv_heads})")
        if (ldef.ffn == "mlp" or ldef.shared) and cfg.d_ff % mp:
            raise ValueError(f"model axis {mp} must divide d_ff ({cfg.d_ff})")
        if ldef.ffn == "moe" and cfg.moe.num_experts % mp:
            raise ValueError(f"model axis {mp} must divide num_experts "
                             f"({cfg.moe.num_experts})")


def mlp_specs(cfg: Optional[ModelConfig], mp: Optional[int]) -> dict:
    """A GLU MLP's specs over a model axis of ``mp`` ranks: column-parallel
    in, row-parallel out, where ``mp`` divides d_ff (``common.dense_spec``;
    ``mp=None`` always shards); replicated otherwise."""
    if mp is None:
        return {"w_gate": 1, "w_up": 1, "w_down": 0}
    d, ff = cfg.d_model, cfg.d_ff
    return {"w_gate": dense_spec((d, ff), 1, mp),
            "w_up": dense_spec((d, ff), 1, mp),
            "w_down": dense_spec((ff, d), 0, mp)}


def tp_layer_specs(ldef: LayerDef, cfg: ModelConfig, dtype,
                   mp: Optional[int] = None) -> dict:
    """Spec tree (each leaf's sharded dim, or None) of one layer's params
    over a model axis of ``mp`` ranks, everything else replicated; the
    structure is :func:`init_layer`'s.  Attention (self and cross) follows
    ``attention.head_layout``'s whole-head rule, the MLP shards its d_ff
    where ``mp`` divides it, MoE its experts.  ``mp=None`` shards them
    all: the manual regime's stages, whose divisibility
    :func:`check_tp_divisibility` checks.  MoE's router and shared expert
    stay replicated: their outputs are whole, so only the routed experts'
    partials are summed."""
    with dev_lib.OnMeta():              # the layer's layout, no data
        layout = init_layer(torch.Generator(), ldef, cfg, dtype, "cpu")
    specs = tree_map(lambda _: None, layout)
    if ldef.mixer == "attn" and not ldef.shared:
        specs["mixer"] = attn.attention_specs(cfg, mp)
    if ldef.cross:
        specs["cross"] = attn.attention_specs(cfg, mp)
    if ldef.mixer == "attn" and ldef.ffn == "mlp" and not ldef.shared:
        specs["ffn"] = mlp_specs(cfg, mp)
    elif ldef.mixer == "attn" and ldef.ffn == "moe":
        specs["ffn"].update(wg=0, wu=0, wd=0)      # the expert dim
    return specs


def _prepend_none(spec_tree):
    """The specs of a leaf stacked over repeats: every sharded dim moves
    up by one."""
    return tree_map(lambda d: d + 1, spec_tree)


def tp_stage_specs(segments: Sequence[Segment], cfg: ModelConfig, dtype,
                   mp: Optional[int] = None):
    """Spec tree of a whole stage's stacked params (the leading repeats dim
    unsharded) over a model axis of ``mp`` ranks (:func:`tp_layer_specs`)."""
    return [[_prepend_none(tp_layer_specs(ldef, cfg, dtype, mp))
             for ldef in seg.unit] for seg in segments]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_layer(gen, ldef: LayerDef, cfg: ModelConfig, dtype, device) -> dict:
    """One layer's params: ``norm1`` always; a shared layer keeps only its
    norms, its mixer and MLP being the model's ``shared_attn``."""
    params = {"norm1": init_rms_norm(cfg.d_model, dtype, device)}
    if ldef.mixer == "attn":
        if not ldef.shared:
            params["mixer"] = attn.init_attention(gen, cfg, dtype, device)
        if ldef.cross:
            params["norm_cross"] = init_rms_norm(cfg.d_model, dtype, device)
            params["cross"] = attn.init_attention(gen, cfg, dtype, device)
    elif ldef.mixer == "mamba":
        params["mixer"] = ssm_lib.init_mamba(gen, cfg, dtype, device)
    elif ldef.mixer == "mlstm":
        params["mixer"] = xlstm_lib.init_mlstm(gen, cfg, dtype, device)
    elif ldef.mixer == "slstm":
        params["mixer"] = xlstm_lib.init_slstm(gen, cfg, dtype, device)
    else:
        raise ValueError(ldef.mixer)
    if ldef.ffn is not None and ldef.mixer == "attn":
        params["norm2"] = init_rms_norm(cfg.d_model, dtype, device)
        if ldef.ffn == "moe":
            params["ffn"] = moe_lib.init_moe(gen, cfg, dtype, device)
        elif not ldef.shared:
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
    (``encoder_frames`` rows).  A recurrent layer's cache is its zero
    state, whatever ``length``."""
    if ldef.mixer == "mamba":
        return ssm_lib.init_ssm_state(cfg, batch, dtype, device)
    if ldef.mixer == "mlstm":
        return xlstm_lib.init_mlstm_state(cfg, batch, dtype, device)
    if ldef.mixer == "slstm":
        return xlstm_lib.init_slstm_state(cfg, batch, dtype, device)
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


def layer_cache_spec(ldef: LayerDef, batch_axis=None, seq_axis=None,
                     head_axis=None, axis: str = "model") -> dict:
    """One layer's cache spec over grid axis ``axis`` (each leaf's sharded
    dim, or None), laid out as the JAX package's ``layer_cache_spec``:
    ``batch_axis``, ``seq_axis`` and ``head_axis`` (each a grid axis, a
    tuple of them, or None) name what shards the batch, the kv length and
    the kv heads.  A cross-attention cache shards its batch only, and
    recurrent state (no sequence axis) too."""
    if ldef.mixer == "attn":
        c = {"kv": attn.kv_cache_spec(batch_axis, seq_axis, head_axis, axis)}
        if ldef.cross:
            c["cross_kv"] = attn.kv_cache_spec(batch_axis, None, None, axis)
        return c
    if ldef.mixer == "mamba":
        return ssm_lib.ssm_state_spec(batch_axis, axis)
    if ldef.mixer == "mlstm":
        return xlstm_lib.mlstm_state_spec(batch_axis, axis)
    if ldef.mixer == "slstm":
        return xlstm_lib.slstm_state_spec(batch_axis, axis)
    raise ValueError(ldef.mixer)


def stage_cache_spec(segments: List[Segment], cfg, batch_axis=None,
                     seq_axis=None, head_axis=None, *,
                     axis: str = "model") -> list:
    """Spec tree of a stage's stacked caches over grid axis ``axis`` (each
    leaf's sharded dim, or None; :func:`layer_cache_spec`).  ``head_axis``
    (e.g. ``"model"``) shards the attention kv-head dim, which
    tensor-parallel stages keep with their head shard; the dry run's
    decode shards the batch over the data axes and the length over
    ``seq_axis`` (``model.decode_state_specs``)."""
    return [[_prepend_none(layer_cache_spec(ldef, batch_axis, seq_axis,
                                            head_axis, axis))
             for ldef in seg.unit] for seg in segments]


def pad_to_template(cache, template):
    """Zero-pad each leaf of a prefill-shaped cache to its decode template's
    shape (a tree of the same structure, e.g. on the meta device).  A ring
    cache comes out exactly ``min(capacity, window)`` rows long, as its slot
    is ``pos % T``; recurrent state, which has no sequence axis, already
    has its template's shape and passes through."""
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
                pos, pctx: ParallelContext = LOCAL, enc_out=None,
                shared_params=None, use_kernel: bool = False,
                causal: bool = True, h_pre=None, pending=None,
                defer_psum: bool = False):
    """Returns (x, new_cache, aux, pending_out): aux is the layer's MoE
    losses ``[load_balance, router_z]``, or None for an MLP layer.  ``h_pre``
    short-circuits the input RMSNorm for a caller that already holds
    ``rms_norm(x, norm1)``.  Prefill caches of windowed layers come back in
    ring order (:func:`to_ring`).  A cross-attention layer reads the
    encoder output ``enc_out`` in train and prefill, and its ``cross_kv``
    cache in decode.  A shared layer runs ``shared_params``' mixer and
    MLP.  A recurrent layer's prefill cache is its final state; in decode
    its new state is written into ``cache`` in place, as attention writes
    its key and value rows.

    Under tensor parallelism (``pctx``) a sharded attention's ``wo`` and
    a sharded MLP's ``w_down`` are row-sharded, so their outputs are this
    rank's partial sums, reduced with :func:`model_psum` (an MoE layer
    reduces its own); a part the automatic rule replicates
    (``attention.head_layout``, ``mlp_specs``) runs whole and is not
    summed.  The kv cache holds the kv heads this rank's attention reads,
    or, under sequence-sharded caches (``pctx.for_cache``), every kv head
    over this rank's block of the length.  Recurrent mixers replicate.
    Where autograd records (a train step across ranks) the sums take
    Megatron's g rule and the sharded blocks' inputs its f
    (``parallel.model_copy``).  ``pending``/``defer_psum`` implement psum
    overlap: with ``defer_psum`` an attention+MLP layer returns its MLP output
    unreduced as ``pending_out`` (None where nothing is pending), and the
    next layer adds ``model_psum(pending)`` to x at its top, before norm1:
    the same value, one layer later, in the same order of additions."""
    aux, pending_out = None, None
    if pending is not None:
        x = x + model_psum(pending, pctx)
    if ldef.shared:
        p = dict(p, mixer=shared_params["mixer"], ffn=shared_params["ffn"])
    h = h_pre if h_pre is not None else rms_norm(x, p["norm1"], cfg.rms_eps)
    if ldef.mixer != "attn":
        fullseq, decode = {
            "mamba": (ssm_lib.mamba_fullseq, ssm_lib.mamba_decode),
            "mlstm": (xlstm_lib.mlstm_fullseq, xlstm_lib.mlstm_decode),
            "slstm": (xlstm_lib.slstm_fullseq, xlstm_lib.slstm_decode),
        }[ldef.mixer]
        if mode == "decode":
            out, st = decode(p["mixer"], h, cache, cfg=cfg)
            for name, leaf in st.items():
                cache[name].copy_(leaf)
            return x + out, cache, None, None
        out, st = fullseq(p["mixer"], h, cfg=cfg,
                          return_state=mode == "prefill")
        return x + out, st, None, None
    rope = not cfg.is_encdec          # whisper uses sinusoid embeds, no RoPE
    new_cache = None
    mixer, attn_tp = _rank_attention(p["mixer"], cfg, pctx)
    if attn_tp:
        h = model_copy(h, pctx)
    if mode == "decode":
        out, kv = attn.attention_decode(mixer, h, cache["kv"], pos, cfg=cfg,
                                        window=ldef.window, rope=rope,
                                        pctx=pctx)
        new_cache = {"kv": kv}
    else:
        out, kv = attn.attention_fullseq(mixer, h, cfg=cfg,
                                         window=ldef.window,
                                         use_kernel=use_kernel, causal=causal,
                                         rope=rope, pctx=pctx)
        if mode == "prefill":
            kv = to_ring(kv, ldef.window) if ldef.window else kv
            new_cache = {"kv": _seq_block(kv, cfg, pctx)}
    x = x + (model_psum(out, pctx) if attn_tp else out)
    if ldef.cross:
        cross, cross_tp = _rank_attention(p["cross"], cfg, pctx)
        hc = rms_norm(x, p["norm_cross"], cfg.rms_eps)
        if cross_tp:
            hc = model_copy(hc, pctx)
        if mode == "decode":
            ckv = cache["cross_kv"]
        else:
            enc = model_copy(enc_out, pctx) if cross_tp else enc_out
            ckv = attn.encoder_kv(cross, enc, cfg=cfg)
        out = attn.cross_attention(cross, hc, ckv, cfg=cfg, pctx=pctx)
        x = x + (model_psum(out, pctx) if cross_tp else out)
        if new_cache is not None:
            new_cache["cross_kv"] = ckv if mode == "decode" else \
                _seq_block(ckv, cfg, pctx, cut=False)
    h2 = rms_norm(x, p["norm2"], cfg.rms_eps)
    if ldef.ffn == "moe":
        out, moe_aux = moe_lib.apply_moe(p["ffn"], h2, cfg=cfg, act=cfg.act,
                                         pctx=pctx)
        x = x + out
        aux = torch.stack([moe_aux["load_balance"], moe_aux["router_z"]])
    else:
        mlp_tp = pctx.tensor_parallel and p["ffn"]["w_down"].shape[0] < cfg.d_ff
        part = apply_mlp(p["ffn"], model_copy(h2, pctx) if mlp_tp else h2,
                         cfg.act)
        if defer_psum and mlp_tp:
            pending_out = part
        else:
            x = x + (model_psum(part, pctx) if mlp_tp else part)
    return x, new_cache, aux, pending_out


def _rank_attention(params, cfg: ModelConfig, pctx: ParallelContext):
    """(params, sharded): an attention param set as this rank reads it,
    and whether its q heads are a model-axis shard (its output then a
    partial sum).  Where they are, Megatron's f goes on the replicated
    weights that only the rank's heads read, as on the block's input: the
    qk-norm weights, and the kv projections where kv is replicated
    (``attention.head_layout``); their gradients sum over the model
    axis."""
    hd = cfg.resolved_head_dim
    sharded = pctx.tensor_parallel and \
        params["wq"].shape[1] < attn._padded_heads(cfg) * hd
    if not sharded:
        return params, False
    kv_whole = params["wk"].shape[1] == cfg.num_kv_heads * hd
    copied = {"q_norm", "k_norm"} | ({"wk", "wv"} if kv_whole else set())
    return {k: model_copy(v, pctx) if k in copied else v
            for k, v in params.items()}, True


def _seq_block(kv: dict, cfg: ModelConfig, pctx: ParallelContext,
               cut: bool = True) -> dict:
    """A prefill's (B, S, K', hd) keys and values as sequence-sharded
    caches keep them (``pctx.for_cache``): every kv head (a model-axis
    shard of them gathered over the model group) and, with ``cut``, this
    rank's block of the S rows over the sequence group.  ``kv`` itself
    without sequence axes."""
    if pctx.seq_size <= 1:
        return kv
    n, i = pctx.seq_size, pctx.seq_rank

    def one(a):
        if a.shape[2] < cfg.num_kv_heads:
            a = parallel.all_gather(a, 2, pctx.group)
        if not cut:
            return a
        S = a.shape[1]
        if S % n:
            raise ValueError(f"a cache of {S} rows does not split over "
                             f"{n} sequence ranks")
        return a[:, i * (S // n):(i + 1) * (S // n)]

    return {k: one(a) for k, a in kv.items()}


def apply_segment(seg: Segment, seg_params, x, *, cfg, mode, seg_cache, pos,
                  pctx: ParallelContext = LOCAL, enc_out=None,
                  shared_params=None, use_kernel: bool = False,
                  causal: bool = True, first_h=None,
                  overlap_psum: bool = False, pending=None):
    """seg_params: per unit position, leaves stacked over repeats.  Decode
    writes the stacked ``seg_cache`` in place and returns it; prefill
    returns the new caches stacked over repeats; train returns None.
    ``overlap_psum`` threads a deferred MLP partial (``pending``) through
    the layers (see :func:`apply_layer`); the caller flushes the one
    returned.  Returns (x, caches, aux summed over the segment's MoE
    layers or None, pending)."""
    aux_sum = None
    per_rep = []
    for rep in range(seg.repeats):
        caches = []
        for i, ldef in enumerate(seg.unit):
            p = tree_map(lambda a: a[rep], seg_params[i])
            c = None if seg_cache is None else \
                tree_map(lambda a: a[rep], seg_cache[i])
            x, nc, aux, pending = apply_layer(
                ldef, p, x, cfg=cfg, mode=mode, cache=c, pos=pos, pctx=pctx,
                enc_out=enc_out, shared_params=shared_params,
                use_kernel=use_kernel, causal=causal,
                h_pre=first_h if rep == 0 and i == 0 else None,
                pending=pending, defer_psum=overlap_psum)
            aux_sum = _add_aux(aux_sum, aux)
            caches.append(nc)
        per_rep.append(caches)
    if mode == "decode":
        return x, seg_cache, aux_sum, pending
    if mode == "prefill":
        return x, [tree_map(lambda *reps: torch.stack(reps), *[c[i] for c in per_rep])
                   for i in range(len(seg.unit))], aux_sum, pending
    return x, None, aux_sum, pending


def apply_stage(segments: List[Segment], stage_params, x, *, cfg, mode,
                stage_cache, pos, pctx: ParallelContext = LOCAL, enc_out=None,
                shared_params=None, use_kernel: bool = False,
                causal: bool = True, first_h=None,
                overlap_psum: bool = False):
    """Returns (x, new stage caches, aux): the f32 ``[load_balance,
    router_z]`` summed over the stage's MoE layers (zeros without one).
    A partial still pending at the stage's end (``overlap_psum``) is
    reduced and added there."""
    aux_total = None
    new_caches = []
    pending = None
    for si, seg in enumerate(segments):
        cache = None if stage_cache is None else stage_cache[si]
        x, nc, aux, pending = apply_segment(
            seg, stage_params[si], x, cfg=cfg, mode=mode, seg_cache=cache,
            pos=pos, pctx=pctx, enc_out=enc_out, shared_params=shared_params,
            use_kernel=use_kernel, causal=causal,
            first_h=first_h if si == 0 else None,
            overlap_psum=overlap_psum, pending=pending)
        new_caches.append(nc)
        aux_total = _add_aux(aux_total, aux)
    if pending is not None:
        x = x + model_psum(pending, pctx)          # stage-end flush
    if aux_total is None:
        aux_total = torch.zeros((2,), dtype=torch.float32, device=x.device)
    return x, new_caches, aux_total


def _add_aux(total, aux):
    """Sum of aux vectors where None stands for zeros (layers without an
    MoE add no device work)."""
    if aux is None:
        return total
    return aux if total is None else total + aux
