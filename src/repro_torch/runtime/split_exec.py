"""Split execution over one shared backbone, and the runtime's analytic
timing (port of ``repro/runtime/split_exec.py``: ``CostModel``,
``SplitModelBank`` and ``SplitRunner``).

Numerics and time are decoupled on purpose: the bank computes the real
logits, tokens and caches, while the simulator's durations come from
:class:`CostModel` on the deterministic virtual clock.

:class:`SplitModelBank` holds ONE backbone param tree; every candidate
split's edge/cloud halves run views of its stacked layer params
(``models/transformer.slice_stage_params``), so only the per-split
butterfly projections are materialised per candidate.  The int8 wire runs
through the butterfly unit's fused wrappers (``core/butterfly.py`` ->
``kernels/ops.py``): the Hopper kernels on the card, their plain versions on
the CPU.  The unfused codec runs only in :meth:`SplitRunner.reference_prefill`.

Each half runs at a model-axis degree (``edge_mp``, ``cloud_mp``).  The JAX
bank wraps a degree-``mp`` half in a ``shard_map`` over ``mp`` devices; the
port runs it as ``mp`` processes (``models/parallel.spawn``), a group of
``mp`` consecutive ranks of the ``torch.distributed`` world, each with its
rank's views of the backbone (attention heads, d_ff columns and experts
sharded; ``model.tp_param_specs``) and its own kv heads in the caches.  A
degree must divide the world; a degree-1 half runs whole on every rank.
Every rank of a group returns the same logits, codes and tokens.  A cache
that moves from one half's degree to another's (the edge's stage-0 cache
into a cloud engine) is cut, or gathered and cut, to the receiving
degree's heads (:meth:`SplitRunner.to_degree`).

The JAX bank jits one function per ``(kind, split, mp)`` at bucket-padded
``(B, S)`` shapes.  PyTorch runs eagerly, but the port keeps the same
padding and the same compile-cache keys and hit/miss counts, so the
runtime's ``bank_jit_cache_*`` counters read the same from either package.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import device as dev_lib
from repro_torch.configs.base import ButterflyConfig
from repro_torch.core import butterfly as bf_lib
from repro_torch.core import costs
from repro_torch.core.planner import wire_mode_bytes
from repro_torch.core.profiler import HardwareProfile
from repro_torch.core.quantization import pack_int4, unpack_int4
from repro_torch.models import model as M
from repro_torch.models import parallel
from repro_torch.models import transformer as tfm
from repro_torch.models.common import embed, rms_norm, unembed
from repro_torch.serving import pipeline as spl
from repro_torch.serving.engine import ServingEngine
from repro_torch.tree import tree_map

# The JAX bank folds its decode-row kernel block into every compile-cache
# key (``kernels/ops.decode_row_block()``, 8 for a 1-row call); the port has
# no such block, but keeps the value so the keys of both packages compare
# equal.
ROW_BLOCK = 8


def act_bytes(cfg) -> int:
    return 2 if cfg.dtype == "bfloat16" else 4


def input_bytes(cfg, seq: int) -> float:
    """Cloud-only offload ships the frontend's feature output (the paper
    ships the raw 224x224x3 image) — one d_model-wide row per position."""
    return float(seq * cfg.d_model * act_bytes(cfg))


# ---------------------------------------------------------------------------
# analytic timing (virtual-clock durations)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CostModel:
    """``edge_mp``/``cloud_mp`` — model-axis degree each half's stage is
    sharded over (DESIGN.md section 11): per-stage estimates divide by the
    degree via :func:`costs.model_parallel_share` (heterogeneous fleets run
    edge_mp=1 against a wide cloud)."""
    cfg: object
    edge: HardwareProfile
    cloud: HardwareProfile
    edge_mp: int = 1
    cloud_mp: int = 1

    def _where(self, where: str):
        if where == "edge":
            return self.edge, self.edge_mp
        return self.cloud, self.cloud_mp

    def _roofline(self, hw: HardwareProfile, flops: float,
                  load: float = 0.0, mp: int = 1) -> float:
        nbytes = flops / max(self.cfg.d_model, 1)      # planner's bytes proxy
        flops, nbytes = costs.model_parallel_share((flops, nbytes), mp)
        return hw.latency_s(flops, nbytes) / max(1e-9, 1.0 - load)

    def edge_prefill_s(self, split: int, seq: int, d_r: int) -> float:
        f = costs.stack_flops(self.cfg, seq, 0, split)
        f += 2 * seq * self.cfg.d_model * d_r          # reduction unit
        return self._roofline(self.edge, f, mp=self.edge_mp)

    def cloud_prefill_s(self, split: int, seq: int, d_r: int,
                        load: float = 0.0) -> float:
        f = costs.stack_flops(self.cfg, seq, split, self.cfg.num_layers)
        f += 2 * seq * d_r * self.cfg.d_model          # restoration unit
        f += costs.embed_flops(self.cfg, seq)
        return self._roofline(self.cloud, f, load, mp=self.cloud_mp)

    def full_prefill_s(self, seq: int, *, where: str,
                       load: float = 0.0) -> float:
        f = costs.stack_flops(self.cfg, seq, 0, self.cfg.num_layers)
        f += costs.embed_flops(self.cfg, seq)
        hw, mp = self._where(where)
        return self._roofline(hw, f, load, mp=mp)

    def decode_step_s(self, batch: int, *, where: str,
                      load: float = 0.0) -> float:
        # decode is weight-bound: every step streams the full parameter set
        hw, mp = self._where(where)
        f, nbytes = costs.model_parallel_share(
            costs.full_decode_step_cost(self.cfg, batch), mp)
        return hw.latency_s(f, nbytes) / max(1e-9, 1.0 - load)

    def edge_energy_mj(self, seconds: float) -> float:
        return seconds * self.edge.compute_power_w * 1e3

    def edge_decode_step_s(self, split: int, d_r: int) -> float:
        """One streamed-decode edge step: embed + layers [0, split) +
        reduce/quantize for a single token."""
        f, b = costs.model_parallel_share(
            costs.edge_decode_step_cost(self.cfg, split, d_r), self.edge_mp)
        return self.edge.latency_s(f, b)

    def cloud_decode_step_s(self, split: int, d_r: int, batch: int = 1,
                            load: float = 0.0) -> float:
        """One streamed-decode cloud turn: restore + layers [split, N) +
        unembed for ``batch`` arrived rows."""
        f, b = costs.model_parallel_share(
            costs.cloud_decode_step_cost(self.cfg, split, d_r, batch),
            self.cloud_mp)
        return self.cloud.latency_s(f, b) / max(1e-9, 1.0 - load)

    def stream_row_bytes(self, wire_mode: str, d_r: int) -> float:
        """Per-token uplink bytes of the streamed transport: one boundary
        row in the wire format (int8 codes + f32 scale for the paper's
        mode; "int4" nibble-packs two codes per byte, halving the code
        bytes)."""
        return wire_mode_bytes(self.cfg, 1, d_r, wire_mode)

    def serial_decode_tick_s(self, split: int, d_r: int, *,
                             wire_mode: str = "int8",
                             link_bps: Optional[float] = None,
                             batch: int = 1, load: float = 0.0) -> float:
        """Per-token latency of serial ping-pong decode: the edge step, the
        wire row and the cloud step run strictly in sequence, so one pod
        always idles."""
        t = self.edge_decode_step_s(split, d_r) + \
            self.cloud_decode_step_s(split, d_r, batch, load)
        if link_bps:
            t += self.stream_row_bytes(wire_mode, d_r) * 8.0 / link_bps
        return t

    def pipelined_decode_tick_s(self, split: int, d_r: int, *,
                                wire_mode: str = "int8",
                                link_bps: Optional[float] = None,
                                batch: int = 1, load: float = 0.0) -> float:
        """Steady-state per-token cadence of pipelined decode (>= 2
        in-flight microbatches rotating through the 2-pod mesh): the edge
        step for microbatch k+1, the wire row and the cloud step for
        microbatch k all overlap, so the tick is the slowest part instead
        of the sum."""
        parts = [self.edge_decode_step_s(split, d_r),
                 self.cloud_decode_step_s(split, d_r, batch, load)]
        if link_bps:
            parts.append(self.stream_row_bytes(wire_mode, d_r) * 8.0
                         / link_bps)
        return max(parts)

    def payload_bytes(self, mode: str, wire_mode: str, seq: int,
                      d_r: int, split: int, new_tokens: int = 1,
                      transport: str = "cache_handoff") -> float:
        """Prefill uplink bytes per request.  Split requests generating more
        than one token additionally ship the edge stage-0 KV cache under the
        ``cache_handoff`` decode transport (counted honestly); the
        ``streamed`` transport keeps that cache on the edge and pays one
        ``stream_row_bytes`` row per later token instead."""
        if mode == "cloud":
            return input_bytes(self.cfg, seq)
        if mode == "edge":
            return 0.0
        b = wire_mode_bytes(self.cfg, seq, d_r, wire_mode)
        if new_tokens > 1 and transport == "cache_handoff":
            b += self.stage0_cache_bytes(seq, split)
        return b

    def stage0_cache_bytes(self, seq: int, split: int) -> float:
        """KV bytes of the edge stage's ``split`` layers (the cache-handoff
        uplink term) — the arch formula lives in :func:`costs.kv_cache_bytes`."""
        return costs.kv_cache_bytes(self.cfg, seq, split)


# ---------------------------------------------------------------------------
# real numerics: one shared backbone, per-split views
# ---------------------------------------------------------------------------


def _next_bucket(n: int, lo: int = 8) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


class SplitModelBank:
    """One backbone parameter tree serving every candidate split.

    ``params``/``butterfly`` take ready trees (``butterfly`` maps split ->
    {"w_reduce", "w_restore"}), which is how ``repro_torch.bridge`` feeds
    JAX weights in; otherwise the bank initialises on ``device`` from
    ``seed``.  ``edge_mp``/``cloud_mp`` are the default model-axis degrees
    of the halves (a runner may override them per half); a degree above 1
    runs on that many ranks (see the module note).  ``profiler`` (a
    ``runtime.metrics.JitProfiler``) times every keyed dispatch of the bank
    and of its engines."""

    def __init__(self, base_cfg, d_r: int, *, wire_mode: str = "int8",
                 seed: int = 0, device="cuda", params: Optional[dict] = None,
                 butterfly: Optional[Dict[int, dict]] = None,
                 edge_mp: int = 1, cloud_mp: int = 1, profiler=None):
        self.device = dev_lib.resolve(device)
        # Matmuls run at full precision: no TF32 for f32 products, and bf16
        # products reduce in f32, as XLA does in the reference.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

        if base_cfg.num_layers < 2:
            raise ValueError("need >=2 layers to split")
        if base_cfg.is_encdec:
            # the edge half would need the encoder's output for its cross
            # attention, and nothing ships it: the JAX bank cannot run an
            # encoder-decoder either
            raise NotImplementedError(
                f"{base_cfg.name}: an encoder-decoder has no split bank (its "
                f"cross-attention layers need the encoder output, which no "
                f"wire carries)")
        # "entropy" is numerically int8: only byte accounting differs
        if wire_mode not in ("raw", "reduced", "int8", "int4", "entropy"):
            raise ValueError(f"unknown wire_mode {wire_mode!r}")
        if wire_mode == "int4" and d_r % 2:
            raise ValueError("int4 wire packs two codes per byte: d_r must be even")
        if base_cfg.butterfly is not None:
            base_cfg = dataclasses.replace(base_cfg, butterfly=None)
        self.base_cfg = base_cfg
        self.d_r = d_r
        self.wire_mode = wire_mode
        self.seed = seed
        self.edge_mp = int(edge_mp)
        self.cloud_mp = int(cloud_mp)
        self.built = M.build(base_cfg)
        self._dt = dev_lib.torch_dtype(base_cfg.dtype)
        self._defs = tfm.build_layer_defs(base_cfg)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = M.init_model(gen, self.built, device=self.device)
        self.params = params
        self._butterfly: Dict[int, dict] = dict(butterfly or {})

        # seq bucketing preserves numerics only under pure causal global
        # attention (MoE layers still see the padded rows compete for their
        # capacity, as in the JAX bank); batch rows are independent except
        # under MoE
        self._seq_bucket_ok = all(d.mixer == "attn" and d.window is None
                                  and not d.cross for d in self._defs)
        self._batch_bucket_ok = all(d.ffn != "moe" for d in self._defs)
        # the fused codec emits int8 codes: the int8 wire, and the int4 wire
        # as codes in [-8, 7] packed two to a byte after the kernel
        self.wire_eff_bits = 4 if wire_mode == "int4" else 8
        self.row_block = ROW_BLOCK
        self._wire_sig = (wire_mode, self.wire_eff_bits, self.row_block)

        # runner key (split, edge_mp, cloud_mp); fn key (kind, split, mp)
        self._runners: Dict[Tuple[int, int, int], "SplitRunner"] = {}
        self._fns: Dict[Tuple, object] = {}
        self._cache_templates: Dict[Tuple, object] = {}
        self.jit_cache_keys: set = set()
        self.profiler = profiler
        self.cache_hits = 0
        self.cache_misses = 0

    # ------------------------------------------------------------------ api
    @property
    def candidates(self) -> Tuple[int, ...]:
        return tuple(range(1, self.base_cfg.num_layers))

    @property
    def jit_cache_entries(self) -> int:
        return len(self.jit_cache_keys)

    @property
    def batch_numerics_ok(self) -> bool:
        """Whether independent requests may be stacked into one batch
        without changing any request's numerics (False for MoE, whose
        expert-capacity pool couples the batch)."""
        return self._batch_bucket_ok

    def cache_key(self, kind: str, split: int, mp: int, B: int, S: int) -> Tuple:
        """The JAX bank's compile-cache key: padded shape bucket plus the
        wire signature (mode, effective bits, decode-row block)."""
        return (kind, split, mp, B, S) + self._wire_sig

    def timed_call(self, key: Tuple, fn, *args):
        """Count ``key`` as the JAX bank's jit cache would, then call —
        through the profiler when one is attached."""
        self.note_key(key)
        if self.profiler is None:
            return fn(*args)
        return self.profiler.timed(key, fn, *args)

    def note_key(self, key: Tuple) -> None:
        if key in self.jit_cache_keys:
            self.cache_hits += 1
        else:
            self.cache_misses += 1
            self.jit_cache_keys.add(key)

    def runner(self, split: int, *, edge_mp: Optional[int] = None,
               cloud_mp: Optional[int] = None) -> "SplitRunner":
        """Facade for one candidate split; ``edge_mp``/``cloud_mp`` override
        the bank's degrees, so heterogeneous halves (edge 1, cloud N) share
        the one backbone.  A degree must divide the heads, kv heads, d_ff
        and experts (ValueError)."""
        edge_mp = self.edge_mp if edge_mp is None else int(edge_mp)
        cloud_mp = self.cloud_mp if cloud_mp is None else int(cloud_mp)
        key = (split, edge_mp, cloud_mp)
        if key not in self._runners:
            if not 0 < split < self.base_cfg.num_layers:
                raise ValueError(f"split {split} outside (0, "
                                 f"{self.base_cfg.num_layers})")
            for mp in {edge_mp, cloud_mp}:
                tfm.check_tp_divisibility(self._defs, self.base_cfg, mp)
            self._runners[key] = SplitRunner(self, split, edge_mp=edge_mp,
                                             cloud_mp=cloud_mp)
        return self._runners[key]

    def _pctx(self, mp: int) -> parallel.ParallelContext:
        """The model axis a degree-``mp`` half runs on: this rank's group
        of ``mp`` ranks (ValueError when they are not there), or LOCAL."""
        return parallel.manual_context(parallel.model_group(mp, "bank"))

    def cache_cfg(self, mp: int):
        """The config a degree-``mp`` cache is laid out by: each rank holds
        ``num_kv_heads / mp`` kv heads (recurrent state replicates)."""
        cfg = self.base_cfg
        return dataclasses.replace(cfg, num_kv_heads=cfg.num_kv_heads // mp)

    def butterfly_params(self, split: int) -> dict:
        if split not in self._butterfly:
            # its own generator per split, so a split's butterfly does not
            # depend on which splits were materialised before it
            gen = torch.Generator(device=self.device).manual_seed(
                self.seed * 1_000_003 + split)
            bf = ButterflyConfig(layer=split, d_r=self.d_r,
                                 wire_bits=self.wire_eff_bits)
            self._butterfly[split] = bf_lib.init_butterfly(
                gen, self.base_cfg.d_model, bf, self._dt, self.device)
        return self._butterfly[split]

    # ----------------------------------------------------- bucketing helpers
    def _buckets(self, B: int, S: int) -> Tuple[int, int]:
        Bb = _next_bucket(B, 1) if self._batch_bucket_ok else B
        Sb = _next_bucket(S, 16) if self._seq_bucket_ok else S
        return Bb, Sb

    def _pad_toks(self, toks: torch.Tensor, Bb: int, Sb: int) -> torch.Tensor:
        B, S = toks.shape
        if (B, S) != (Bb, Sb):
            toks = F.pad(toks, (0, Sb - S, 0, Bb - B))
        return toks

    def _cache_template(self, stage: int, split: int, B: int, S: int,
                        mp: int = 1):
        """Meta-tensor tree of stage ``stage``'s range cache at true (B, S)
        and degree ``mp``: shapes only, nothing allocated."""
        key = (stage, split, B, S, mp)
        if key not in self._cache_templates:
            self._cache_templates[key] = tfm.init_stage_cache(
                self.engine_stages(split)[stage], self.cache_cfg(mp), B, S,
                self._dt, "meta")
        return self._cache_templates[key]

    def _slice_cache(self, cache, stage: int, split: int, B: int, S: int,
                     mp: int = 1):
        """Views of a bucket-padded cache at the request's true shape."""
        def cut(leaf, t):
            if leaf.shape == t.shape:
                return leaf
            return leaf[tuple(slice(0, s) for s in t.shape)]
        return tree_map(cut, cache,
                        self._cache_template(stage, split, B, S, mp))

    def engine_stages(self, split: int):
        """Per-stage segmentations matching the range-sliced param views."""
        segs = list(self.built.stages[0])
        return [tfm.range_segments(segs, 0, split),
                tfm.range_segments(segs, split, self.base_cfg.num_layers)]

    # --------------------------------------------------------- wire transforms
    def _pack_wire(self, codes):
        return pack_int4(codes) if self.wire_mode == "int4" else codes

    def _unpack_wire(self, codes):
        return unpack_int4(codes) if self.wire_mode == "int4" else codes

    def _reduce(self, bf, x):
        """Edge end of the wire: (payload, scales) per wire mode."""
        if self.wire_mode == "raw":
            return x, torch.zeros((*x.shape[:2], 1), dtype=torch.float32,
                                  device=x.device)
        if self.wire_mode == "reduced":
            r = x @ bf["w_reduce"]
            return r, torch.zeros((*r.shape[:2], 1), dtype=torch.float32,
                                  device=x.device)
        codes, scales = bf_lib.reduce_unit(bf, x, use_kernel=True,
                                           wire_bits=self.wire_eff_bits)
        return self._pack_wire(codes), scales

    def _restore(self, bf, payload, scales):
        """Cloud end of the wire: the boundary activation per wire mode."""
        if self.wire_mode == "raw":
            return payload
        if self.wire_mode == "reduced":
            return payload @ bf["w_restore"]
        return bf_lib.restore_unit(bf, self._unpack_wire(payload), scales,
                                   self._dt, use_kernel=True)

    def _wire_ingraph(self, bf, x, *, use_kernel: bool):
        """The wire as the hosted model sees it: raw passes x, reduced
        projects down/up, int8/int4 round-trip the quantized codec (int4 also
        round-trips the nibble packing).  ``use_kernel=False`` is the JAX
        reference codec, unfused in the activation dtype (the packing is an
        exact round trip, so it is left out there)."""
        if use_kernel or self.wire_mode in ("raw", "reduced"):
            payload, scales = self._reduce(bf, x)
            return self._restore(bf, payload, scales)
        return bf_lib.apply_butterfly(bf, x, wire_bits=self.wire_eff_bits)

    # ------------------------------------------------------ the split halves
    def _fn(self, kind: str, split: int, mp: int = 1):
        """The bank's shared function for ``(kind, split, mp)``: every
        runner and engine of a split at one degree gets the same closure,
        which takes a runner's full params and runs this rank's views of
        them."""
        key = (kind, split, mp) + self._wire_sig
        if key not in self._fns:
            pctx = self._pctx(mp)
            fn = getattr(self, f"_make_{kind}")(split, pctx)
            if mp > 1:
                specs = M.tp_param_specs(self.built, with_butterfly=True)
                fn = (lambda f: lambda params, *a: f(parallel.shard_params(
                    params, specs, pctx.rank, mp), *a))(fn)
            self._fns[key] = fn
        return self._fns[key]

    def _head(self, params, x):
        cfg = self.base_cfg
        x = rms_norm(x, params["final_norm"], cfg.rms_eps)
        table = params["embed"] if cfg.tie_embeddings else params["head"]
        return unembed(table, x, cfg.logit_softcap)

    def _embed(self, params, toks):
        cfg = self.base_cfg
        return embed(params["embed"], toks,
                     scale=cfg.arch_type == "dense" and cfg.act == "gelu")

    def _layers(self, params, x, lo, hi, mode, cache, pos,
                pctx=parallel.LOCAL):
        """(x, caches) of flat layers [lo, hi); the MoE aux losses are
        dropped, as the JAX bank drops them.  Both halves read the whole
        shared block (zamba2's), never a layer-range slice of it."""
        x, caches, _ = tfm.apply_layer_range(
            list(self.built.stages[0]), params["stages"][0], x, lo, hi,
            cfg=self.base_cfg, mode=mode, range_cache=cache, pos=pos,
            pctx=pctx, shared_params=params.get("shared_attn"))
        return x, caches

    def _make_edge(self, split: int, pctx):
        def edge(params, toks):
            x, cache0 = self._layers(params, self._embed(params, toks), 0,
                                     split, "prefill", None, None, pctx)
            payload, scales = self._reduce(params["butterfly"], x)
            return payload, scales, cache0
        return edge

    def _make_cloud(self, split: int, pctx):
        def cloud(params, payload, scales, length: int):
            x = self._restore(params["butterfly"], payload, scales)
            x, cache1 = self._layers(params, x, split,
                                     self.base_cfg.num_layers, "prefill",
                                     None, None, pctx)
            return self._head(params, x[:, length - 1:length])[:, 0], cache1
        return cloud

    def _make_prefill(self, split: int, pctx):
        """Whole hosted-model prefill (both halves and the wire)."""
        def prefill(params, toks, length: int):
            x, cache0 = self._layers(params, self._embed(params, toks), 0,
                                     split, "prefill", None, None, pctx)
            x = self._wire_ingraph(params["butterfly"], x, use_kernel=True)
            x, cache1 = self._layers(params, x, split,
                                     self.base_cfg.num_layers, "prefill",
                                     None, None, pctx)
            return self._head(params, x[:, length - 1:length]), [cache0, cache1]
        return prefill

    def _make_decode(self, split: int, pctx):
        """Batched hosted-model decode step for the ServingEngine: ragged
        per-slot positions, the wire through the fused kernels."""
        def decode(params, tokens, caches, pos):
            x, nc0 = self._layers(params, self._embed(params, tokens), 0,
                                  split, "decode", caches[0], pos, pctx)
            x = self._wire_ingraph(params["butterfly"], x, use_kernel=True)
            x, nc1 = self._layers(params, x, split, self.base_cfg.num_layers,
                                  "decode", caches[1], pos, pctx)
            return self._head(params, x), [nc0, nc1]
        return decode

    def _make_edge_step(self, split: int, pctx):
        """Streamed-decode edge half: one token through layers [0, split)
        against the edge-resident stage-0 cache, then one wire row."""
        def edge_step(params, tok, cache0, pos):
            x, nc0 = self._layers(params, self._embed(params, tok), 0, split,
                                  "decode", cache0, pos, pctx)
            payload, scales = self._reduce(params["butterfly"], x)
            return payload, scales, nc0
        return edge_step

    def _make_cloud_step(self, split: int, pctx):
        """Streamed-decode cloud half: restore one arrived row and run layers
        [split, N) against the cloud-resident stage-1 cache."""
        def cloud_step(params, payload, scales, cache1, pos):
            x = self._restore(params["butterfly"], payload, scales)
            x, nc1 = self._layers(params, x, split, self.base_cfg.num_layers,
                                  "decode", cache1, pos, pctx)
            return self._head(params, x), nc1
        return cloud_step


class SplitRunner:
    """Facade for one candidate split.  ``runner.params`` shares every
    backbone leaf with ``bank.params``; only the butterfly is per split.
    ``edge_mp``/``cloud_mp`` are each half's model-axis degree: the edge
    half (edge_half, edge_step) and the cloud half (cloud_half, and the
    whole-model prefill and decode of the cloud's engines) run at their
    own, and the caches each returns hold that degree's kv heads."""

    def __init__(self, bank: SplitModelBank, split: int, *, edge_mp: int = 1,
                 cloud_mp: int = 1):
        self.bank = bank
        self.split = split
        self.edge_mp = int(edge_mp)
        self.cloud_mp = int(cloud_mp)
        self.cfg = bank.base_cfg.with_butterfly(split, bank.d_r,
                                                bank.wire_eff_bits)
        self.wire_mode = bank.wire_mode
        self.built = bank.built
        self.params = dict(bank.params)
        self.params["butterfly"] = bank.butterfly_params(split)

    def _tensor(self, a, dtype=None):
        return dev_lib.as_tensor(a, self.bank.device, dtype)

    # ------------------------------------------------------------ split halves
    def edge_half(self, params, toks):
        """Edge stage: layers [0, split) + reduce + quantize on (B, S) tokens.
        Returns true-shape (payload, scales, cache0); the work runs at the
        bucket-padded (B, S)."""
        bank = self.bank
        toks = self._tensor(toks)
        B, S = toks.shape
        Bb, Sb = bank._buckets(B, S)
        payload, scales, cache0 = bank.timed_call(
            bank.cache_key("edge", self.split, self.edge_mp, Bb, Sb),
            bank._fn("edge", self.split, self.edge_mp), params,
            bank._pad_toks(toks, Bb, Sb))
        return (payload[:B, :S], scales[:B, :S],
                bank._slice_cache(cache0, 0, self.split, B, S, self.edge_mp))

    def cloud_half(self, params, payload, scales):
        """Cloud stage: restore + layers [split, N) + LM head.  Returns
        (last-position logits (B, V), cache1)."""
        bank = self.bank
        payload, scales = self._tensor(payload), self._tensor(scales)
        B, S = payload.shape[:2]
        Bb, Sb = bank._buckets(B, S)
        if (Bb, Sb) != (B, S):
            pad = (0, 0, 0, Sb - S, 0, Bb - B)
            payload, scales = F.pad(payload, pad), F.pad(scales, pad)
        logits, cache1 = bank.timed_call(
            bank.cache_key("cloud", self.split, self.cloud_mp, Bb, Sb),
            bank._fn("cloud", self.split, self.cloud_mp), params, payload,
            scales, S)
        return logits[:B], bank._slice_cache(cache1, 1, self.split, B, S,
                                             self.cloud_mp)

    # --------------------------------------------------------- streamed decode
    def edge_step(self, params, tok, cache0, pos):
        """One streamed-decode edge step: ``tok`` (B, 1), ``cache0`` the
        edge-resident stage-0 cache (padded with :meth:`pad_decode_cache`;
        updated in place), ``pos`` (B,) write positions.  Returns
        ``(payload, scales, cache0)``."""
        bank = self.bank
        tok = self._tensor(tok, torch.int64)
        return bank.timed_call(
            bank.cache_key("edge_step", self.split, self.edge_mp,
                           tok.shape[0], 1),
            bank._fn("edge_step", self.split, self.edge_mp), params, tok,
            cache0, self._tensor(pos, torch.int64))

    def stream_step(self, engine, req, cache, payload, scales, pos: int):
        """One streamed-decode cloud turn through ``engine``.  Returns
        ``(token, cache)``."""
        out = engine.stream_step(req, cache, payload, scales, pos)
        self.bank.note_key(self.bank.cache_key("cloud_step", self.split,
                                               self.cloud_mp, 1, 1))
        return out

    def pad_decode_cache(self, cache, stage: int, length: int):
        """Pad a prefill-shaped (B=1, seq=S) stage cache to decode capacity
        ``length`` (zeros past the prompt), at the degree of the half that
        made it (stage 0 the edge's, stage 1 the cloud's).  A leaf that
        already has its decode shape (recurrent state, a full ring) is
        returned as it is, so the decode steps that update the result in
        place update it."""
        mp = self.edge_mp if stage == 0 else self.cloud_mp
        return tfm.pad_to_template(
            cache, self.bank._cache_template(stage, self.split, 1, length, mp))

    def to_degree(self, cache, stage: int, mp: int):
        """Stage ``stage``'s cache with the kv heads of degree ``mp`` on this
        rank: a cache that already has them as it is; a whole one (degree
        1) cut to this rank's block; one of another degree gathered over
        its group first.  Recurrent state is replicated and passes
        through.  Every rank must call it together (it may gather)."""
        bank = self.bank
        K = bank.base_cfg.num_kv_heads
        want = K // mp
        spec = tfm.stage_cache_spec(bank.engine_stages(self.split)[stage],
                                    bank.base_cfg, head_axis="model")

        def one(leaf, dim):
            have = leaf.shape[dim]
            if have == want:
                return leaf
            if have != K:
                group = parallel.model_group(K // have, "bank")
                parts = [torch.empty_like(leaf) for _ in
                         range(torch.distributed.get_world_size(group))]
                torch.distributed.all_gather(parts, leaf.contiguous(),
                                             group=group)
                leaf = torch.cat(parts, dim=dim)
            rank = bank._pctx(mp).rank
            return leaf.narrow(dim, rank * want, want)

        return parallel._map_spec(one, spec, cache)

    # ------------------------------------------------------ pipelined decode
    def stage_view(self):
        """(built, params): the model cut at this split into two stages, as
        ``M.build(cfg.with_butterfly(split, d_r))`` lays it out, its params
        views of the bank's shared backbone plus this split's butterfly."""
        segs = list(self.built.stages[0])
        N = self.bank.base_cfg.num_layers
        s0, p0 = tfm.slice_stage_params(segs, self.params["stages"][0],
                                        0, self.split)
        s1, p1 = tfm.slice_stage_params(segs, self.params["stages"][0],
                                        self.split, N)
        params = dict(self.params)
        params["stages"] = [p0, p1]
        return M.BuiltModel(cfg=self.cfg, stages=(tuple(s0), tuple(s1))), params

    def decode_pipeline(self, pods, num_microbatches: int, prompt_len: int,
                        microbatch: int, new_tokens: int, *,
                        pipelined: bool = True, use_kernel: bool = False,
                        overlap_psum: bool = False):
        """Multi-token greedy decode over two pods through this split:
        ``serving.pipeline.make_decode_pipeline``'s microbatch rotation (or
        its serial reference with ``pipelined=False``) running views of the
        bank's shared backbone.  ``pods`` is a pair of devices, edge then
        cloud, or a pair of device lists for a model axis inside each pod
        (the JAX version's mesh; see ``serving.pipeline.make_pods``); None
        puts both on the bank's device (two streams of one card).  Returns ``run(tokens, timings=None, states=None) ->
        (num_microbatches * microbatch, new_tokens)`` greedy ids.  The built
        function and its split-view params are kept in the bank's function
        cache under the wire signature, and each run counts its key as the
        JAX bank's jit cache would."""
        bank = self.bank
        if bank.wire_mode not in ("int8", "int4", "entropy"):
            raise ValueError("the decode pipeline wires quantized codes "
                             "(int8/int4/entropy)")
        pods = (bank.device, bank.device) if pods is None else tuple(pods)
        key = ("decode_pipeline", self.split, str(pods),
               num_microbatches, prompt_len, microbatch, new_tokens,
               bool(pipelined), bool(use_kernel), bool(overlap_psum)) \
            + bank._wire_sig
        if key not in bank._fns:
            built, params = self.stage_view()
            fn = spl.make_decode_pipeline(
                built, pods, num_microbatches, prompt_len, microbatch,
                new_tokens, wire_mode=bank.wire_mode, pipelined=pipelined,
                use_kernel=use_kernel, overlap_psum=overlap_psum)
            bank._fns[key] = (fn, params)
        fn, params = bank._fns[key]

        def run(tokens, timings: Optional[dict] = None,
                states: Optional[dict] = None):
            bank.note_key(key)
            return fn(params, tokens, timings, states)

        return run

    # ------------------------------------------------------------- engine glue
    def _engine_prefill(self, params, toks, mp: int = 1):
        bank = self.bank
        toks = self._tensor(toks)
        B, S = toks.shape
        Bb, Sb = bank._buckets(B, S)
        logits, caches = bank.timed_call(
            bank.cache_key("prefill", self.split, mp, Bb, Sb),
            bank._fn("prefill", self.split, mp), params,
            bank._pad_toks(toks, Bb, Sb), S)
        return logits[:B], [
            bank._slice_cache(caches[0], 0, self.split, B, S, mp),
            bank._slice_cache(caches[1], 1, self.split, B, S, mp)]

    def make_engine(self, *, max_batch: int, max_len: int, seed: int = 0,
                    mp: Optional[int] = None) -> ServingEngine:
        """``mp`` — model-axis degree of the engine's whole-model prefill
        and decode steps; the runner's cloud degree by default (the engines
        live on the cloud server), the edge degree for a device's local
        engine.  Its slot pool holds that degree's kv heads, and caches
        admitted from halves of other degrees are brought to it
        (:meth:`to_degree`)."""
        mp = self.cloud_mp if mp is None else int(mp)
        bank = self.bank

        def cache_in(caches):
            return [self.to_degree(c, stage, mp)
                    for stage, c in enumerate(caches)]

        return ServingEngine(self.params, self.built, max_batch=max_batch,
                             max_len=max_len, seed=seed,
                             stages=bank.engine_stages(self.split),
                             prefill_fn=lambda p, t: self._engine_prefill(p, t, mp),
                             decode_fn=bank._fn("decode", self.split, mp),
                             stream_fn=bank._fn("cloud_step", self.split, mp),
                             device=bank.device, profiler=bank.profiler,
                             profile_key=(self.split, mp),
                             cache_cfg=bank.cache_cfg(mp),
                             cache_in=cache_in if max(mp, self.edge_mp,
                                                      self.cloud_mp) > 1
                             else None)

    # --------------------------------------------------------------- reference
    def reference_prefill(self, toks):
        """Single-model forward (what the split path must reproduce), with
        the reference (unfused, activation-dtype) wire codec."""
        bank = self.bank
        params = self.params
        x, cache0 = bank._layers(params, bank._embed(params, self._tensor(toks)),
                                 0, self.split, "prefill", None, None)
        x = bank._wire_ingraph(params["butterfly"], x, use_kernel=False)
        x, cache1 = bank._layers(params, x, self.split,
                                 bank.base_cfg.num_layers, "prefill", None, None)
        return bank._head(params, x[:, -1:]), [cache0, cache1]
