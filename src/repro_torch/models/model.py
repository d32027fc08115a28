"""Top-level model build/init/apply for the dense families (port of
``repro/models/model.py``).

  build(cfg)                                  -> BuiltModel
  init_model(gen, built, device=...)          -> params
  forward_train(params, built, batch)         -> (logits, aux)
  forward_prefill(params, built, batch)       -> (last-position logits, caches)
  forward_decode(params, built, tokens, caches, pos) -> (logits, caches)
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch import device as dev_lib
from repro_torch.configs.base import ModelConfig
from repro_torch.core import butterfly as bf_lib
from repro_torch.models import transformer as tfm
from repro_torch.models.common import embed, init_embedding, init_rms_norm, \
    rms_norm, unembed


@dataclass(frozen=True)
class BuiltModel:
    cfg: ModelConfig
    stages: tuple                     # tuple of tuple[Segment]

    @property
    def has_butterfly(self) -> bool:
        return self.cfg.butterfly is not None


def build(cfg: ModelConfig, long_mode: bool = False) -> BuiltModel:
    defs = tfm.build_layer_defs(cfg, long_mode=long_mode)
    boundary = cfg.butterfly.layer if cfg.butterfly is not None else None
    return BuiltModel(cfg=cfg,
                      stages=tuple(tuple(s) for s in tfm.split_defs(defs, boundary)))


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
    return params


def _embed_inputs(params, built: BuiltModel, tokens):
    cfg = built.cfg
    scale = cfg.arch_type == "dense" and cfg.act == "gelu"   # gemma family
    return embed(params["embed"], tokens, scale=scale)


def _logits(params, built: BuiltModel, x):
    cfg = built.cfg
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    table = params["embed"] if cfg.tie_embeddings else params["head"]
    return unembed(table, x, cfg.logit_softcap)


def _run_stages(params, built: BuiltModel, x, *, mode, caches, pos):
    cfg = built.cfg
    new_caches = []
    for stage_idx, segs in enumerate(built.stages):
        if stage_idx == 1:
            if mode == "train":
                raise NotImplementedError(
                    "the straight-through training wire arrives with the "
                    "training slice")
            x = bf_lib.apply_butterfly(params["butterfly"], x,
                                       wire_bits=cfg.butterfly.wire_bits)
        stage_cache = None if caches is None else caches[stage_idx]
        x, nc = tfm.apply_stage(list(segs), params["stages"][stage_idx], x,
                                cfg=cfg, mode=mode, stage_cache=stage_cache,
                                pos=pos)
        new_caches.append(nc)
    return x, new_caches


def forward_train(params, built: BuiltModel, batch: dict):
    x = _embed_inputs(params, built, batch["tokens"])
    x, _ = _run_stages(params, built, x, mode="train", caches=None, pos=None)
    return _logits(params, built, x), {}


def forward_prefill(params, built: BuiltModel, batch: dict):
    x = _embed_inputs(params, built, batch["tokens"])
    x, caches = _run_stages(params, built, x, mode="prefill", caches=None,
                            pos=None)
    return _logits(params, built, x[:, -1:]), caches


def forward_decode(params, built: BuiltModel, tokens, caches, pos):
    """tokens: (B, 1); pos: int or (B,) tensor of absolute positions.  The
    caches are updated in place and returned."""
    x = _embed_inputs(params, built, tokens)
    x, new_caches = _run_stages(params, built, x, mode="decode", caches=caches,
                                pos=pos)
    return _logits(params, built, x), new_caches
