"""Top-level model build/init/apply for the attention families (port of
``repro/models/model.py``): dense, MoE, the VLM's patch inputs and
whisper's encoder-decoder.

  build(cfg)                                  -> BuiltModel
  init_model(gen, built, device=...)          -> params
  forward_train(params, built, batch)         -> (logits, aux)
  forward_prefill(params, built, batch)       -> (last-position logits, caches)
  pad_decode_caches(built, caches, length)    -> caches at decode capacity
  forward_decode(params, built, tokens, caches, pos) -> (logits, caches)
  lm_loss(logits, targets)                    -> masked next-token NLL

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

from dataclasses import dataclass

import torch

from repro_torch import device as dev_lib
from repro_torch.configs.base import ModelConfig
from repro_torch.core import butterfly as bf_lib
from repro_torch.core.wire_codec import rate_bits
from repro_torch.models import transformer as tfm
from repro_torch.models.common import embed, init_embedding, init_rms_norm, \
    rms_norm, sinusoid_angles, sinusoid_positions, unembed
from repro_torch.tree import tree_leaves


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
    if cfg.is_encdec:
        params["encoder"] = {
            "segments": [tfm.init_segment(gen, seg, cfg, dtype, device)
                         for seg in built.enc_segments],
            "final_norm": init_rms_norm(cfg.d_model, dtype, device)}
    return params


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


def _encode(params, built: BuiltModel, batch: dict, use_kernel: bool):
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
        x, _, _ = tfm.apply_segment(
            seg, params["encoder"]["segments"][si], x, cfg=cfg, mode="train",
            seg_cache=None, pos=None, causal=False, use_kernel=use_kernel)
    return rms_norm(x, params["encoder"]["final_norm"], cfg.rms_eps)


def _logits(params, built: BuiltModel, x):
    cfg = built.cfg
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    table = params["embed"] if cfg.tie_embeddings else params["head"]
    return unembed(table, x, cfg.logit_softcap)


def _run_stages(params, built: BuiltModel, x, *, mode, caches, pos,
                use_kernel: bool, enc_out=None):
    """Returns (x, new caches, aux, wire rate): aux the f32 ``[load_balance,
    router_z]`` summed over the stages; in train mode the rate is a 0-d f32
    tensor, non-zero with ``rate_weight > 0``, otherwise None."""
    cfg = built.cfg
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
            x = bf_lib.apply_butterfly(params["butterfly"], x,
                                       wire_bits=cfg.butterfly.wire_bits,
                                       train=train, use_kernel=use_kernel)
        stage_cache = None if caches is None else caches[stage_idx]
        x, nc, aux = tfm.apply_stage(
            list(segs), params["stages"][stage_idx], x, cfg=cfg, mode=mode,
            stage_cache=stage_cache, pos=pos, enc_out=enc_out,
            use_kernel=use_kernel)
        new_caches.append(nc)
        aux_total = aux if aux_total is None else aux_total + aux
    return x, new_caches, aux_total, rate


def forward_train(params, built: BuiltModel, batch: dict,
                  use_kernel: bool = False):
    """(logits, aux): aux holds ``load_balance``, ``router_z`` and
    ``wire_rate_bits``, 0-d f32 tensors.  ``use_kernel`` sends attention
    through the flash kernel, which has no backward: differentiate only the
    plain path (``training.make_train_step`` refuses the kernels)."""
    enc_out = _encode(params, built, batch, use_kernel)
    x = _embed_inputs(params, built, batch)
    x, _, aux, rate = _run_stages(params, built, x, mode="train", caches=None,
                                  pos=None, use_kernel=use_kernel,
                                  enc_out=enc_out)
    return _logits(params, built, x), {"load_balance": aux[0],
                                       "router_z": aux[1],
                                       "wire_rate_bits": rate}


def forward_prefill(params, built: BuiltModel, batch: dict,
                    use_kernel: bool = False):
    """Last-position logits and the caches: full length for global layers,
    ring order (``min(S, window)`` rows) for windowed ones, and the
    encoder's keys and values (``cross_kv``) for cross-attention layers.
    A VLM's S counts its patches."""
    enc_out = _encode(params, built, batch, use_kernel)
    x = _embed_inputs(params, built, batch)
    x, caches, _, _ = _run_stages(params, built, x, mode="prefill",
                                  caches=None, pos=None, use_kernel=use_kernel,
                                  enc_out=enc_out)
    return _logits(params, built, x[:, -1:]), caches


def pad_decode_caches(built: BuiltModel, caches, length: int):
    """Zero-pad prefill caches to decode capacity ``length``: global caches
    to ``length`` rows, ring caches to exactly ``min(length, window)``, even
    when the prompt was shorter than the window."""
    cfg = built.cfg
    batch = tree_leaves(caches)[0].shape[1]           # leaves: (reps, B, S, ..)
    dtype = dev_lib.torch_dtype(cfg.dtype)
    return [tfm.pad_to_template(
                stage_cache,
                tfm.init_stage_cache(list(segs), cfg, batch, length, dtype, "meta"))
            for segs, stage_cache in zip(built.stages, caches)]


def forward_decode(params, built: BuiltModel, tokens, caches, pos,
                   use_kernel: bool = False):
    """tokens: (B, 1); pos: int or (B,) tensor of absolute positions.  The
    caches (at decode capacity, see :func:`pad_decode_caches`) are updated
    in place and returned.  ``use_kernel`` reaches only the butterfly wire:
    decode attention is the plain path, as in the JAX package."""
    x = _embed_inputs(params, built, {"tokens": tokens}, pos)
    x, new_caches, _, _ = _run_stages(params, built, x, mode="decode",
                                      caches=caches, pos=pos,
                                      use_kernel=use_kernel)
    return _logits(params, built, x), new_caches


def lm_loss(logits, targets, ignore: int = -1):
    """Cross entropy in f32; targets equal to ``ignore`` are masked."""
    mask = targets != ignore
    tgt = torch.where(mask, targets, 0).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, tgt[..., None])[..., 0]
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1)
