"""Top-level model build/init/apply for every family (port of
``repro/models/model.py``): dense, MoE, the VLM's patch inputs, whisper's
encoder-decoder, and the recurrent families (xLSTM, and zamba2's Mamba2
backbone with its one shared attention block, ``params["shared_attn"]``).

  build(cfg)                                  -> BuiltModel
  init_model(gen, built, device=...)          -> params
  forward_train(params, built, batch, pctx)   -> (logits, aux)
  forward_prefill(params, built, batch, pctx) -> (last-position logits, caches)
  pad_decode_caches(built, caches, length, pctx) -> caches at decode capacity
  forward_decode(params, built, tokens, caches, pos, pctx) -> (logits, caches)
  lm_loss(logits, targets, pctx=pctx)         -> masked next-token NLL
  input_specs(built, shape, pctx)             -> (meta batch, batch specs)
  decode_state_specs(built, shape, pctx, seq_axis) -> (meta caches, {axis: specs})
  param_specs(built, grid)                    -> {axis: spec tree}

Under an automatic ``ParallelContext`` (``models/parallel.make_context``)
every function takes and returns this rank's block of the batch
(``data.pipeline.shard_batch``) and this rank's shards of the params
(``parallel.shard_grid(params, param_specs(built, grid), grid)``):
attention, GLU, the shared block and whisper's encoder and cross attention
run Megatron's shards over the model axis in whole heads where the axis
divides them and whole otherwise, replicated over the data axes, and MoE
its own expert parallelism; the loss and the wire's rate are means over the
global batch.  Decode caches may shard their length over grid axes too
(:func:`decode_state_specs`, ``ParallelContext.for_cache``).

``use_kernel=True`` runs full-sequence attention through the flash kernel
and the in-graph butterfly wire through the fused butterfly kernels (the
Hopper kernels on CUDA tensors, their plain versions on CPU tensors).
``forward_train`` runs the butterfly's training wire (straight-through
``fake_quant``) and returns the JAX package's three aux terms: the MoE
layers' load-balance and router-z losses summed over the stack (zeros
without an MoE) and the wire's rate.

Modality frontends are stubs, as in the JAX package: pixtral takes
precomputed patch embeddings (``batch["patches"]``, placed before the
tokens), whisper precomputed frame embeddings (``batch["frames"]``), both
already at d_model.  Whisper's encoder runs its frames without a causal
mask (through the flash kernel under ``use_kernel``); its decoder adds
sinusoid position embeddings where the others rotate q and k.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import torch

from repro_torch import device as dev_lib
from repro_torch.configs.base import ModelConfig
from repro_torch.core import butterfly as bf_lib
from repro_torch.core.wire_codec import rate_bits
from repro_torch.models import transformer as tfm
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import parallel
from repro_torch.models.parallel import LOCAL, ParallelContext
from repro_torch.models.common import embed, init_embedding, init_mlp, \
    init_rms_norm, rms_norm, sinusoid_angles, sinusoid_positions, unembed


@dataclass(frozen=True)
class BuiltModel:
    cfg: ModelConfig
    stages: tuple                     # tuple of tuple[Segment]
    enc_segments: tuple = ()          # whisper encoder segments (or ())

    @property
    def has_butterfly(self) -> bool:
        return self.cfg.butterfly is not None


def build(cfg: ModelConfig, long_mode: bool = False) -> BuiltModel:
    defs = tfm.build_layer_defs(cfg, long_mode=long_mode)
    boundary = cfg.butterfly.layer if cfg.butterfly is not None else None
    enc_segments = ()
    if cfg.is_encdec:
        enc_defs = [tfm.LayerDef(mixer="attn", ffn="mlp")] * cfg.encoder_layers
        enc_segments = tuple(tfm.segmentize(enc_defs))
    return BuiltModel(cfg=cfg,
                      stages=tuple(tuple(s) for s in tfm.split_defs(defs, boundary)),
                      enc_segments=enc_segments)


def init_model(gen: torch.Generator, built: BuiltModel, *,
               device="cuda") -> dict:
    """Random init from ``gen`` (a generator on ``device``) in the JAX
    package's layout; the numbers differ from ``jax.random``'s, so parity
    runs load JAX weights through ``repro_torch.bridge`` instead."""
    device = dev_lib.resolve(device)
    cfg = built.cfg
    dtype = dev_lib.torch_dtype(cfg.dtype)
    params: dict = {
        "embed": init_embedding(gen, cfg.vocab_size, cfg.d_model, dtype, device),
        "final_norm": init_rms_norm(cfg.d_model, dtype, device),
    }
    if not cfg.tie_embeddings:
        params["head"] = init_embedding(gen, cfg.vocab_size, cfg.d_model,
                                        dtype, device)
    params["stages"] = [[tfm.init_segment(gen, seg, cfg, dtype, device)
                         for seg in segs] for segs in built.stages]
    if cfg.butterfly is not None:
        params["butterfly"] = bf_lib.init_butterfly(gen, cfg.d_model,
                                                    cfg.butterfly, dtype, device)
    if cfg.hybrid_attn_every is not None:
        # zamba2: one attention + MLP param set, read by every shared layer
        params["shared_attn"] = {
            "mixer": attn_lib.init_attention(gen, cfg, dtype, device),
            "ffn": init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, device)}
    if cfg.is_encdec:
        params["encoder"] = {
            "segments": [tfm.init_segment(gen, seg, cfg, dtype, device)
                         for seg in built.enc_segments],
            "final_norm": init_rms_norm(cfg.d_model, dtype, device)}
    return params


def tp_param_specs(built: BuiltModel, *, with_butterfly=None) -> dict:
    """Spec tree (each leaf's sharded dim, or None) matching
    :func:`init_model`'s params, with every stage layer tensor-parallel over
    the model axis (attention heads, d_ff columns, experts; see
    ``transformer.tp_layer_specs``) and zamba2's shared block sharded the
    same way; embeddings, norms, LM head and butterfly replicated.  What a
    tensor-parallel stage's params are cut by (``parallel.shard_params``).
    An encoder-decoder has no tensor-parallel stages and raises."""
    if built.cfg.is_encdec:
        raise NotImplementedError(f"{built.cfg.name}: enc-dec archs have no "
                                  f"tensor-parallel stages")
    return _model_specs(built, None, with_butterfly)


def _model_specs(built: BuiltModel, mp, with_butterfly=None) -> dict:
    """The model axis's spec tree at ``mp`` ranks (``transformer.
    tp_layer_specs``' rule; None shards every head, d_ff and expert)."""
    cfg = built.cfg
    dt = dev_lib.torch_dtype(cfg.dtype)
    if with_butterfly is None:
        with_butterfly = built.has_butterfly
    specs: dict = {"embed": None, "final_norm": None,
                   "stages": [tfm.tp_stage_specs(list(segs), cfg, dt, mp)
                              for segs in built.stages]}
    if not cfg.tie_embeddings:
        specs["head"] = None
    if with_butterfly:
        specs["butterfly"] = {"w_reduce": None, "w_restore": None}
    if cfg.hybrid_attn_every is not None:
        specs["shared_attn"] = {"mixer": attn_lib.attention_specs(cfg, mp),
                                "ffn": tfm.mlp_specs(cfg, mp)}
    if cfg.is_encdec:
        specs["encoder"] = {
            "segments": tfm.tp_stage_specs(list(built.enc_segments), cfg, dt,
                                           mp),
            "final_norm": None}
    return specs


def fsdp_param_specs(built: BuiltModel) -> dict:
    """Spec tree over the ``data`` axis (each leaf's sharded dim, or None):
    the routed experts' d_ff where ``d_ff_expert % 16 == 0`` (the JAX
    package's FSDP rule), everything else replicated."""
    cfg = built.cfg
    return _expert_specs(built, lambda: (
        {"wg": 3, "wu": 3, "wd": 2}
        if cfg.moe.d_ff_expert % 16 == 0 else None))


def _expert_specs(built: BuiltModel, of_moe) -> dict:
    """A spec tree of :func:`init_model`'s layout with ``of_moe()`` at each
    MoE layer's routed experts (leaves stacked over repeats) and None
    elsewhere."""
    def layer(ldef):
        return {"ffn": of_moe()} if ldef.ffn == "moe" else None

    def stage_specs(segs):
        return [[layer(ldef) for ldef in seg.unit] for seg in segs]

    specs: dict = {"stages": [stage_specs(segs) for segs in built.stages]}
    if built.cfg.is_encdec:
        specs["encoder"] = None
    return specs


def param_specs(built: BuiltModel, grid=None) -> dict:
    """The automatic regime's layout of :func:`init_model`'s params over
    ``grid`` (a ``parallel.RankGrid``), a spec tree for each grid axis
    (what ``parallel.shard_grid`` cuts by; the counterpart of JAX's
    ``PartitionSpec`` trees): ``model`` the whole-head tensor-parallel rule
    at the grid's model axis (``transformer.tp_layer_specs``: attention
    where its heads allow, the MLP where the axis divides d_ff, the
    experts; the encoder and cross attention likewise; embeddings, the LM
    head, the butterfly and recurrent mixers replicated), ``data`` the
    experts' FSDP d_ff (:func:`fsdp_param_specs`), ``pod`` the experts' dim
    under ``moe.EXPERTS_OVER_POD`` (else None).  Without a grid the model
    axis is taken to divide every head, d_ff and expert count."""
    cfg = built.cfg
    pod = None
    if cfg.moe is not None and moe_lib.EXPERTS_OVER_POD:
        pod = _expert_specs(built, lambda: {"wg": 1, "wu": 1, "wd": 1})
    mp = None if grid is None else grid.axis_size("model")
    return {"pod": pod, "data": fsdp_param_specs(built),
            "model": _model_specs(built, mp)}


def _check_automatic(built: BuiltModel, pctx: ParallelContext) -> None:
    """An automatic context with a model axis lays the model out by
    :func:`param_specs`' rule, which replicates what does not divide; only
    MoE's expert parallelism has no replicated form, so raise where the
    model axis does not divide the experts."""
    moe = built.cfg.moe
    if pctx.automatic and pctx.mp_size > 1 and moe is not None and \
            moe.num_experts % pctx.mp_size:
        raise ValueError(f"{built.cfg.name}: the model axis ({pctx.mp_size}) "
                         f"must divide num_experts ({moe.num_experts})")


def _embed_inputs(params, built: BuiltModel, batch: dict, pos=None):
    """Token (+ stub modality) embeddings -> (B, S, d).  An encoder-decoder
    adds the sinusoid at positions 0..S-1, or in decode at ``pos`` (an int
    or a (B,) tensor); a VLM places its patch embeddings before the
    tokens."""
    cfg = built.cfg
    scale = cfg.arch_type == "dense" and cfg.act == "gelu"   # gemma family
    x = embed(params["embed"], batch["tokens"], scale=scale)
    if cfg.is_encdec:
        if pos is None:
            sin = sinusoid_positions(x.shape[1], cfg.d_model, x.device)[None]
        else:
            p = torch.as_tensor(pos, dtype=torch.float32, device=x.device)
            sin = sinusoid_angles(p, cfg.d_model)[..., None, :]
        x = x + sin.to(x.dtype)
    if cfg.num_patches and "patches" in batch:
        x = torch.cat([batch["patches"].to(x.dtype), x], dim=1)
    return x


def _encode(params, built: BuiltModel, batch: dict, use_kernel: bool,
            pctx: ParallelContext = LOCAL):
    """Whisper's encoder over the (B, F, d) frame embeddings
    ``batch["frames"]``: the sinusoid, non-causal attention + MLP layers,
    the final norm.  None for a model without an encoder."""
    cfg = built.cfg
    if not cfg.is_encdec:
        return None
    frames = batch["frames"]
    dtype = dev_lib.torch_dtype(cfg.dtype)
    sin = sinusoid_positions(frames.shape[1], cfg.d_model, frames.device)
    x = frames.to(dtype) + sin[None].to(dtype)
    for si, seg in enumerate(built.enc_segments):
        x, _, _, _ = tfm.apply_segment(
            seg, params["encoder"]["segments"][si], x, cfg=cfg, mode="train",
            seg_cache=None, pos=None, pctx=pctx, causal=False,
            use_kernel=use_kernel)
    return rms_norm(x, params["encoder"]["final_norm"], cfg.rms_eps)


def _logits(params, built: BuiltModel, x):
    cfg = built.cfg
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    table = params["embed"] if cfg.tie_embeddings else params["head"]
    return unembed(table, x, cfg.logit_softcap)


def _run_stages(params, built: BuiltModel, x, *, mode, caches, pos,
                use_kernel: bool, enc_out=None, pctx: ParallelContext = LOCAL):
    """Returns (x, new caches, aux, wire rate): aux the f32 ``[load_balance,
    router_z]`` summed over the stages; in train mode the rate is a 0-d f32
    tensor, non-zero with ``rate_weight > 0`` (the mean over the global
    batch), otherwise None."""
    cfg = built.cfg
    _check_automatic(built, pctx)
    train = mode == "train"
    rate = torch.zeros((), dtype=torch.float32, device=x.device) if train else None
    aux_total = None
    new_caches = []
    for stage_idx, segs in enumerate(built.stages):
        if stage_idx == 1:
            if train and cfg.butterfly.rate_weight > 0:
                # recomputes the (cheap, d_r-wide) reduce matmul, as the
                # JAX package does, so apply_butterfly's signature stays
                rate = rate_bits(x @ params["butterfly"]["w_reduce"],
                                 bits=cfg.butterfly.wire_bits)
                # the data blocks are equal in size: the global mean is the
                # mean of the blocks' means
                rate = parallel.reduce_sum(rate, pctx.data_group) / pctx.dp_size
            x = bf_lib.apply_butterfly(params["butterfly"], x,
                                       wire_bits=cfg.butterfly.wire_bits,
                                       train=train, use_kernel=use_kernel)
        stage_cache = None if caches is None else caches[stage_idx]
        x, nc, aux = tfm.apply_stage(
            list(segs), params["stages"][stage_idx], x, cfg=cfg, mode=mode,
            stage_cache=stage_cache, pos=pos, pctx=pctx, enc_out=enc_out,
            shared_params=params.get("shared_attn"), use_kernel=use_kernel)
        new_caches.append(nc)
        aux_total = aux if aux_total is None else aux_total + aux
    return x, new_caches, aux_total, rate


def forward_train(params, built: BuiltModel, batch: dict,
                  pctx: ParallelContext = LOCAL, use_kernel: bool = False):
    """(logits, aux): aux holds ``load_balance``, ``router_z`` and
    ``wire_rate_bits``, 0-d f32 tensors.  ``use_kernel`` sends attention
    through the flash kernel, which has no backward: differentiate only the
    plain path (``training.make_train_step`` refuses the kernels).  Under
    an automatic ``pctx``: this rank's block and shards (module docstring);
    the aux terms are the global batch's."""
    enc_out = _encode(params, built, batch, use_kernel, pctx)
    x = _embed_inputs(params, built, batch)
    x, _, aux, rate = _run_stages(params, built, x, mode="train", caches=None,
                                  pos=None, use_kernel=use_kernel,
                                  enc_out=enc_out, pctx=pctx)
    return _logits(params, built, x), {"load_balance": aux[0],
                                       "router_z": aux[1],
                                       "wire_rate_bits": rate}


def forward_prefill(params, built: BuiltModel, batch: dict,
                    pctx: ParallelContext = LOCAL, use_kernel: bool = False):
    """Last-position logits and the caches: full length for global layers,
    ring order (``min(S, window)`` rows) for windowed ones, and the
    encoder's keys and values (``cross_kv``) for cross-attention layers.
    A VLM's S counts its patches.  Under an automatic ``pctx`` the caches
    are this rank's: its block of the batch and the kv heads its attention
    reads.  With ``REPRO_PREFILL_CACHE_SHARDED=1`` (the JAX dry run's
    option, ``dryrun.py:97-107`` there) an automatic prefill returns them
    laid out batch -> data, seq -> model, every kv head: each layer's kv
    head shards are all-gathered over ``model`` and each rank keeps its
    block of the rows (``pctx.for_cache("model")``, unless ``pctx`` names
    its own sequence axes), so those gathers are in what the dry run
    counts.  Decode from them through :func:`pad_decode_caches` under the
    same context."""
    if os.environ.get("REPRO_PREFILL_CACHE_SHARDED", "0") == "1" and \
            pctx.automatic and not pctx.seq_axes:
        pctx = pctx.for_cache("model")
    enc_out = _encode(params, built, batch, use_kernel, pctx)
    x = _embed_inputs(params, built, batch)
    x, caches, _, _ = _run_stages(params, built, x, mode="prefill",
                                  caches=None, pos=None, use_kernel=use_kernel,
                                  enc_out=enc_out, pctx=pctx)
    return _logits(params, built, x[:, -1:]), caches


def pad_decode_caches(built: BuiltModel, caches, length: int,
                      pctx: ParallelContext = LOCAL):
    """Zero-pad prefill caches to decode capacity ``length``: global caches
    to ``length`` rows, ring caches to exactly ``min(length, window)``, even
    when the prompt was shorter than the window; recurrent state and
    cross-attention caches pass through.  Each rank's caches keep their
    own kv heads.  Under sequence-sharded caches (``pctx.for_cache``) the
    prompt's blocks are all-gathered over the sequence group first, and
    each rank keeps its block of the padded rows (``ValueError`` where the
    group does not divide them)."""
    n, i = pctx.seq_size, pctx.seq_rank

    def pad(a, rows):
        if n > 1:
            a = parallel.all_gather(a, 2, pctx.seq_group)
            if rows % n:
                raise ValueError(f"a cache of {rows} rows does not split "
                                 f"over {n} sequence ranks")
        if a.shape[2] > rows:
            raise ValueError(f"cache leaf {tuple(a.shape)} is longer than "
                             f"its decode capacity {rows}")
        if a.shape[2] < rows:
            out = a.new_zeros(a.shape[:2] + (rows,) + a.shape[3:])
            out[:, :, :a.shape[2]] = a
            a = out
        # the block in storage of its own, not a view of the whole
        return a[:, :, i * (rows // n):(i + 1) * (rows // n)].clone() if n > 1 else a

    def layer(ldef, c):
        if ldef.mixer != "attn":
            return c
        rows = min(length, ldef.window) if ldef.window else length
        return dict(c, kv={k: pad(a, rows) for k, a in c["kv"].items()})

    return [[[layer(ldef, c) for ldef, c in zip(seg.unit, seg_cache)]
             for seg, seg_cache in zip(segs, stage_cache)]
            for segs, stage_cache in zip(built.stages, caches)]


def forward_decode(params, built: BuiltModel, tokens, caches, pos,
                   pctx: ParallelContext = LOCAL, use_kernel: bool = False):
    """tokens: (B, 1); pos: int or (B,) tensor of absolute positions.  The
    caches (at decode capacity, see :func:`pad_decode_caches`) are updated
    in place and returned.  Under a context with sequence axes
    (``pctx.for_cache``, the layout of :func:`decode_state_specs`) each
    rank's caches are its block of the length, and ``pos`` must be one
    position for every row.  ``use_kernel`` reaches only the butterfly
    wire: decode attention is the plain path, as in the JAX package."""
    x = _embed_inputs(params, built, {"tokens": tokens}, pos)
    x, new_caches, _, _ = _run_stages(params, built, x, mode="decode",
                                      caches=caches, pos=pos,
                                      use_kernel=use_kernel, pctx=pctx)
    return _logits(params, built, x), new_caches


def lm_loss(logits, targets, ignore: int = -1,
            pctx: ParallelContext = LOCAL):
    """Cross entropy in f32; targets equal to ``ignore`` are masked.  Under
    data axes the mean is the global batch's: the masked sum and the count
    are summed over the data ranks before the division (the ranks' means
    differ wherever their masks count differently)."""
    mask = targets != ignore
    tgt = torch.where(mask, targets, 0).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, tgt[..., None])[..., 0]
    num, den = (nll * mask).sum(), mask.sum()
    group = pctx.data_group
    if group is not None:
        num = parallel.reduce_sum(num, group)
        den = parallel.reduce_sum(den, group)
    return num / torch.clamp(den, min=1)


def input_specs(built: BuiltModel, shape, pctx: ParallelContext = LOCAL):
    """The batch of a step at ``shape`` (a ``configs.InputShape``): meta
    tensors of the global batch's shapes and dtypes, and a spec tree of
    the same keys whose leaf is the dim sharded over the data axes (0,
    the batch) or None (local, or a batch smaller than the data axes), as
    the JAX package's ``input_specs``."""
    cfg = built.cfg
    B, S = shape.global_batch, shape.seq_len
    bx = 0 if pctx.grid is not None and pctx.batch_sharded(B) else None
    meta = lambda *shp, dtype=torch.int32: torch.empty(shp, dtype=dtype,
                                                       device="meta")
    dt = dev_lib.torch_dtype(cfg.dtype)
    sds, spec = {}, {}
    if shape.kind in ("train", "prefill"):
        n_text = S - cfg.num_patches if cfg.num_patches else S
        sds["tokens"] = meta(B, n_text)
        if cfg.num_patches:
            sds["patches"] = meta(B, cfg.num_patches, cfg.d_model, dtype=dt)
        if cfg.is_encdec:
            sds["frames"] = meta(B, cfg.encoder_frames, cfg.d_model, dtype=dt)
        if shape.kind == "train":
            sds["targets"] = meta(B, S)
    else:                                                     # decode
        sds["tokens"] = meta(B, 1)
    spec = {k: bx for k in sds}
    return sds, spec


def decode_state_specs(built: BuiltModel, shape, pctx: ParallelContext = LOCAL,
                       seq_axis=None):
    """The caches of a decode step at ``shape`` and their layout, as the
    JAX package's ``decode_state_specs``: meta tensors of the global
    shapes (``shape.seq_len`` rows, every kv head) and a spec tree for
    each of the grid's axes (each leaf's sharded dim, or None), what
    ``parallel.shard_grid`` cuts a rank's block by.  The batch shards over
    the data axes where it splits (as :func:`input_specs`), the length
    over ``seq_axis`` (a grid axis, a tuple of them, or None); recurrent
    state and cross-attention caches shard their batch only.  Decode over
    such blocks runs under ``pctx.for_batch(B).for_cache(seq_axis)``."""
    cfg = built.cfg
    B, S = shape.global_batch, shape.seq_len
    bx = pctx.batch_spec_axes() if pctx.grid is not None and \
        pctx.batch_sharded(B) else None
    dt = dev_lib.torch_dtype(cfg.dtype)
    caches = [tfm.init_stage_cache(list(segs), cfg, B, S, dt, "meta")
              for segs in built.stages]
    axes = pctx.grid.axes if pctx.grid is not None else ()
    specs = {a: [tfm.stage_cache_spec(list(segs), cfg, bx, seq_axis, axis=a)
                 for segs in built.stages] for a in axes}
    return caches, specs
