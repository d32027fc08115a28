"""The paper's deployment as a two-stage pipeline over two pods (port of
``repro/serving/pipeline.py``: ``wire_stats``, ``pipeline_param_specs``,
``make_split_pipeline``, ``_grow_cache`` and ``make_decode_pipeline``).

Pod 0 ("edge") runs the embedding, layers [0, j) and the reduction unit with
the wire quantization; only the codes and their f32 scales cross to pod 1
("cloud"), which restores them, runs layers [j, N) and the LM head; the
last-token logits (the prefill pipeline) or the greedy token (decode)
cross back.  The JAX package runs its pods on the ``pod`` axis of a mesh
and crosses with ``lax.ppermute``.  Here a pod is a
``torch.device`` with its own CUDA stream (both pods may name the same
card), and each crossing is a handoff: the consumer's stream waits on an
event the producer's stream records, the tensor moves with
``.to(device, non_blocking=True)`` (nothing moves when both pods share a
card), and ``record_stream`` keeps the caching allocator from handing its
memory to the producer's stream while the consumer still reads it.  One
Python thread launches both pods' work; on the CPU the pods run one after
the other.

Within a pod, stages may be tensor-parallel over a model axis, as in the
JAX package's (pod, model) mesh: attention heads, d_ff columns and MoE
experts shard over the pod's model ranks Megatron-style, and each layer's
partial outputs are summed over them (``models/parallel.model_psum``).  The
port runs one process per model rank (``parallel.spawn``); ``pods`` then
names each pod's devices, one a rank, and each process holds both pods'
shards of its rank.  The wire still crosses inside the process, because
the codes are replicated over the model axis: JAX's ppermute sends from
model rank r of pod 0 to model rank r of pod 1.  Each pod sums over a
process group of its own, issued on its stream.  MoE layers run the manual
expert-parallel path; recurrent mixers replicate.  An encoder-decoder
raises ``NotImplementedError``, as the JAX package asserts it out of the
pipeline's scope.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from repro_torch import device as dev_lib
from repro_torch.core import butterfly as bf_lib
from repro_torch.core.quantization import (dequantize, pack_int4, quantize,
                                           unpack_int4, wire_bytes)
from repro_torch.kernels import ops
from repro_torch.models import model as M
from repro_torch.models import parallel
from repro_torch.models import transformer as tfm
from repro_torch.models.common import embed, rms_norm, unembed
from repro_torch.tree import tree_map


def wire_stats(cfg, microbatch: int, seq: int,
               wire_bits: Optional[int] = None) -> dict:
    """Bytes crossing the pod boundary per microbatch tick: ceil-packed
    codes (two int4 codes per byte) plus one f32 scale per row."""
    d_r = cfg.butterfly.d_r
    bits = cfg.butterfly.wire_bits if wire_bits is None else wire_bits
    act_bytes = 2 if cfg.dtype == "bfloat16" else 4
    wire = wire_bytes((microbatch, seq, d_r), bits)
    raw = microbatch * seq * cfg.d_model * act_bytes
    return {"wire_bytes": wire, "raw_boundary_bytes": raw,
            "compression": raw / wire}


def _grow_cache(small, template):
    """Zero-pad a prefill-time stage cache into its decode-capacity template
    (meta tensors from ``tfm.init_stage_cache``): the seq axis grows from
    prompt_len to prompt_len + new_tokens; ring caches already match.
    Padding is safe because decode masks cache slots past the position."""
    grown = tfm.pad_to_template(small, template)
    return tree_map(lambda a, t: a.to(t.dtype), grown, template)


def pipeline_param_specs(built, mp: int):
    """Spec tree (a prefix of the params tree; leaves the sharded dim or
    None) of a pipeline's params at model-axis degree ``mp``: stage layers
    shard over the model axis by the tensor-parallel rules, everything else
    replicates.  ``mp == 1`` gives a bare None, the fully replicated
    prefix."""
    if mp <= 1:
        return None
    return M.tp_param_specs(built)


@dataclasses.dataclass(frozen=True)
class Pod:
    device: torch.device
    stream: Optional["torch.cuda.Stream"]      # None on the CPU
    pctx: parallel.ParallelContext = parallel.LOCAL

    def active(self):
        """Context in which work goes to this pod's stream (a no-op on the
        CPU, where the stream is None)."""
        return torch.cuda.stream(self.stream)


def make_pods(pods) -> tuple:
    """Two :class:`Pod` from a pair of devices (names or ``torch.device``),
    pod 0 the edge and pod 1 the cloud; on CUDA each gets its own stream,
    also when both name the same card.  A pair of equal-length device lists
    gives each pod a model axis of that degree: this process is the model
    rank ``rank % mp`` of the ``torch.distributed`` world, takes that
    entry of each list, and each pod sums over a group of its own."""
    pods = tuple(pods)
    if len(pods) != 2:
        raise NotImplementedError(f"pods must be two, got {pods!r}: the "
                                  f"pipeline has two stages")
    nested = [isinstance(p, (list, tuple)) for p in pods]
    ctxs = (parallel.LOCAL, parallel.LOCAL)
    if any(nested):
        if not all(nested) or len(pods[0]) != len(pods[1]) or not pods[0]:
            raise ValueError(f"both pods need one device per model rank, "
                             f"got {pods!r}")
        mp = len(pods[0])
        ctxs = tuple(parallel.manual_context(parallel.model_group(mp, tag))
                     for tag in ("edge", "cloud"))
        r = ctxs[0].rank if mp > 1 else 0
        pods = (pods[0][r], pods[1][r])
    devs = [dev_lib.resolve(p) for p in pods]
    if devs[0].type != devs[1].type:
        raise ValueError(f"both pods must be CUDA devices or both the CPU, "
                         f"got {devs}")
    if devs[0].type == "cpu":
        return tuple(Pod(d, None, c) for d, c in zip(devs, ctxs))
    devs = [d if d.index is not None else
            torch.device("cuda", torch.cuda.current_device()) for d in devs]
    return tuple(Pod(d, torch.cuda.Stream(device=d), c)
                 for d, c in zip(devs, ctxs))


def _handoff(t: torch.Tensor, src: Pod, dst: Pod) -> torch.Tensor:
    """``t``, made on pod ``src``, for use on pod ``dst`` (the port of one
    ``lax.ppermute``; see the module note)."""
    if src.stream is None:
        return t.to(dst.device)
    with src.active(), dst.active():
        dst.stream.wait_stream(src.stream)       # an event on src, waited on
        out = t.to(dst.device, non_blocking=True)
        out.record_stream(dst.stream)
    return out


def pod_params(built, params, pods) -> tuple:
    """(edge params, cloud params): what each stage reads, in the layout of
    the full tree, on its pod's device; zamba2's shared block goes to both,
    as layers on either side of the split read it.  A leaf already on its
    pod's device is shared, not copied, so on one card both pods use the
    caller's one copy of the weights.  At a model axis each pod takes views
    of this rank's shards of the full tree (:func:`pipeline_param_specs`)."""
    cfg = built.cfg
    mp = pods[0].pctx.mp_size
    params = parallel.shard_params(params, pipeline_param_specs(built, mp),
                                   pods[0].pctx.rank, mp)
    head = "embed" if cfg.tie_embeddings else "head"
    edge = {"embed": params["embed"], "stages": [params["stages"][0], None],
            "butterfly": {"w_reduce": params["butterfly"]["w_reduce"]}}
    cloud = {"final_norm": params["final_norm"], head: params[head],
             "stages": [None, params["stages"][1]],
             "butterfly": {"w_restore": params["butterfly"]["w_restore"]}}
    if "shared_attn" in params:
        edge["shared_attn"] = cloud["shared_attn"] = params["shared_attn"]
    return tuple(tree_map(lambda a, d=pod.device: a.to(d), p)
                 for p, pod in zip((edge, cloud), pods))


WIRE_MODES = ("raw", "reduced", "int8", "int4", "entropy")


def make_split_pipeline(built, pods, num_microbatches: int, seq_len: int,
                        microbatch: int, wire_mode: str = "int8",
                        pipelined: bool = True):
    """Returns ``pipeline_fn(params, tokens, crossings=None) -> logits``.

    ``pods``: two devices, pod 0 the edge and pod 1 the cloud (the JAX
    version's ``mesh`` with a ``pod`` axis of 2).  tokens:
    (num_microbatches * microbatch, seq_len); the result is the
    (num_microbatches * microbatch, V) f32 last-token logits on the edge
    pod's device.  A ``crossings`` list, when given, receives
    ``(direction, dtype, shape, nbytes)`` for every crossing between the
    pods, in order: ``"edge->cloud"`` for a microbatch's wire (the dtype
    and shape of what it carries; its bytes with the scales included) and
    ``"cloud->edge"`` for its logits.  They are what the JAX version's
    collective-permutes carry, less its zero scales beside the raw and
    reduced wires.

    Per microbatch the edge embeds (gemma's scale), runs stage 0 in
    ``mode="train"`` and puts on the wire, by ``wire_mode``:
      "raw"     the (mb, S, d_model) activation in the model's dtype;
      "reduced" ``x @ w_reduce``, (mb, S, d_r) in the model's dtype;
      "int8"    ``quantize(x @ w_reduce)``'s codes and f32 row scales;
      "int4"    the same at 4 bits, nibble-packed two codes a byte;
      "entropy" int8's numerics (rANS is lossless over the codes; only
                the byte count outside the pipeline changes).
    The cloud unpacks, dequantizes and restores (``@ w_restore``; raw goes
    straight in), runs stage 1, the final norm on the last position and
    the LM head through the tied table or the head, without a softcap, as
    the JAX version does.  MoE layers take their local path, or under a
    model axis the manual expert-parallel one: each microbatch's tokens
    compete for its experts' capacity.

    ``pods`` as two device lists of ``mp`` entries runs each stage
    tensor-parallel over the pod's ``mp`` model ranks (one process each,
    see :func:`make_pods`); each takes its shards of the full ``params``
    (:func:`pod_params`), and every rank returns the same logits.
    ``mp`` must divide the heads, kv heads, d_ff and experts
    (``transformer.check_tp_divisibility``).

    Schedule (``pipelined=True``): at tick t of Mmb + 1 the edge runs
    microbatch t while the cloud runs microbatch t - 1, on the pods'
    streams; only the wire and the logits cross, by handoff.  The traced
    JAX program also runs the cloud's tick 0 on zero codes and the edge's
    last tick on the last microbatch again, both discarded; this eager port
    skips them, which changes no result.  ``pipelined=False`` is the serial
    reference: each microbatch runs edge -> wire -> cloud -> back before
    the next, on one stream when both pods name one device.
    """
    cfg = built.cfg
    if cfg.is_encdec:
        raise NotImplementedError(f"{cfg.name}: enc-dec archs are out of the "
                                  f"split pipeline's scope")
    if not built.has_butterfly or len(built.stages) != 2:
        raise ValueError("the split pipeline needs a butterfly split "
                         "(cfg.with_butterfly(...))")
    if wire_mode not in WIRE_MODES:
        raise ValueError(f"unknown wire mode {wire_mode!r}; one of {WIRE_MODES}")
    if wire_mode == "int4" and cfg.butterfly.d_r % 2:
        raise ValueError("int4 wire packs two codes per byte: d_r must be even")
    edge, cloud = make_pods(pods)
    tfm.check_tp_divisibility(tfm.build_layer_defs(cfg), cfg,
                              edge.pctx.mp_size)
    if not pipelined and edge.device == cloud.device:
        cloud = dataclasses.replace(cloud, stream=edge.stream)
    S, Mmb, mb = int(seq_len), int(num_microbatches), int(microbatch)
    bits = 4 if wire_mode == "int4" else cfg.butterfly.wire_bits
    dt = dev_lib.torch_dtype(cfg.dtype)
    stages0, stages1 = list(built.stages[0]), list(built.stages[1])
    embed_scale = cfg.arch_type == "dense" and cfg.act == "gelu"

    def stage_edge(p, toks):
        x = embed(p["embed"], toks, scale=embed_scale)
        x, _, _ = tfm.apply_stage(stages0, p["stages"][0], x, cfg=cfg,
                                  mode="train", stage_cache=None, pos=None,
                                  pctx=edge.pctx,
                                  shared_params=p.get("shared_attn"))
        if wire_mode == "raw":
            return (x,)
        r = x @ p["butterfly"]["w_reduce"]
        if wire_mode == "reduced":
            return (r,)
        codes, scales = quantize(r, bits)
        return (pack_int4(codes) if wire_mode == "int4" else codes), scales

    def stage_cloud(p, wire):
        if wire_mode == "raw":
            x = wire[0]
        elif wire_mode == "reduced":
            x = wire[0] @ p["butterfly"]["w_restore"]
        else:
            codes = unpack_int4(wire[0]) if wire_mode == "int4" else wire[0]
            x = dequantize(codes, wire[1], dt) @ p["butterfly"]["w_restore"]
        x, _, _ = tfm.apply_stage(stages1, p["stages"][1], x, cfg=cfg,
                                  mode="train", stage_cache=None, pos=None,
                                  pctx=cloud.pctx,
                                  shared_params=p.get("shared_attn"))
        x = rms_norm(x[:, -1:], p["final_norm"], cfg.rms_eps)
        table = p["embed"] if cfg.tie_embeddings else p["head"]
        return unembed(table, x)[:, 0]                      # (mb, V) f32

    placed: dict = {}

    def pipeline_fn(params, tokens, crossings: Optional[list] = None):
        if placed.get("params") is not params:
            placed.update(params=params, pods=pod_params(built, params,
                                                         (edge, cloud)))
        p_edge, p_cloud = placed["pods"]
        toks = dev_lib.as_tensor(tokens, edge.device, torch.int64)
        if tuple(toks.shape) != (Mmb * mb, S):
            raise ValueError(f"tokens {tuple(toks.shape)}, expected "
                             f"{(Mmb * mb, S)}")
        used = (edge,) if cloud.stream is edge.stream else (edge, cloud)
        caller = [torch.cuda.current_stream(pod.device)
                  for pod in used if pod.stream is not None]
        for pod, s in zip(used, caller):
            pod.stream.wait_stream(s)            # params and tokens are ready

        def cross(t, src, dst, direction):
            out = tuple(_handoff(a, src, dst) for a in t)
            if crossings is not None:
                crossings.append((direction, t[0].dtype, tuple(t[0].shape),
                                  sum(a.numel() * a.element_size() for a in t)))
            return out

        def run_edge(k):
            with edge.active():
                wire = stage_edge(p_edge, toks[k * mb:(k + 1) * mb])
            return cross(wire, edge, cloud, "edge->cloud")

        logits = []

        def run_cloud(wire):
            with cloud.active():
                out = stage_cloud(p_cloud, wire)
            logits.append(cross((out,), cloud, edge, "cloud->edge")[0])

        if pipelined:
            wire = None
            for t in range(Mmb + 1):
                sent = run_edge(t) if t < Mmb else None
                if t >= 1:
                    run_cloud(wire)
                wire = sent
        else:
            for k in range(Mmb):
                run_cloud(run_edge(k))

        with edge.active():
            out = torch.cat(logits)
        for pod, s in zip(used, caller):
            s.wait_stream(pod.stream)
        if caller:
            out.record_stream(caller[0])
        return out

    return pipeline_fn


def make_decode_pipeline(built, pods, num_microbatches: int, prompt_len: int,
                         microbatch: int, new_tokens: int,
                         wire_mode: str = "int8", pipelined: bool = True,
                         use_kernel: bool = False, overlap_psum: bool = False):
    """Returns ``decode_fn(params, tokens, timings=None) -> greedy ids``.

    ``pods``: two devices, pod 0 the edge and pod 1 the cloud (the JAX
    version's ``mesh`` with a ``pod`` axis of 2).  tokens:
    (num_microbatches * microbatch, prompt_len) prompts; the result is
    (num_microbatches * microbatch, new_tokens) int32 on the edge pod's
    device: column 0 is the token greedily decoded from the prefill logits,
    the rest come from per-token decode steps through the split.  A
    ``timings`` dict, when given, receives the prefill and decode wall
    times in ms (the pods are synchronised for it); a ``states`` dict
    receives each microbatch's final stage caches, ``states["edge"]`` and
    ``states["cloud"]`` (lists of M stage caches, on their pods).

    Schedule (``pipelined=True``, needs >= 2 microbatches): at tick t the
    edge runs the embed + stage-0 decode step for microbatch ``t % M``,
    round ``t // M``, while the cloud runs stage 1 + LM head on the row the
    edge sent at tick t-1 (microbatch ``(t-1) % M``); its token crosses back
    and is committed at the end of the tick.  The M-1 tick gap between a
    token's decode and its reuse by the edge is why >= 2 microbatches must
    be in flight.  ``pipelined=False`` is the serial reference: each tick
    runs edge -> cloud -> back for one microbatch.  Both modes visit the
    same (microbatch, position) pairs in the same order with the same
    per-step functions, so their greedy ids are equal, bit for bit.

    The traced JAX program also computes work whose result it discards:
    the cloud's tick 0 on zero codes and the edge's drain tick, both with
    their cache writes gated off, so that neither advances a recurrent
    (mamba, mLSTM, sLSTM) state.  This eager port skips both ticks, which
    changes no result and no state.

    ``wire_mode``: "int8", nibble-packed "int4", or "entropy" (numerically
    int8).  ``use_kernel``: the fused reduce+quant on the edge and the
    fused dequant+restore+norm1 (``ops.butterfly_restore_norm``, fed the
    first cloud layer's norm1 weight) on the cloud.  ``overlap_psum``:
    the cloud defers each dense layer's MLP psum into the next layer (see
    ``transformer.apply_layer``), which changes no value.

    ``pods`` as two device lists of ``mp`` entries runs each stage
    tensor-parallel over the pod's model ranks (see
    :func:`make_split_pipeline`); each rank caches only its own kv heads,
    so the decode caches are sized with ``num_kv_heads / mp`` (recurrent
    state replicates at its full shape), and every rank returns the same
    ids.
    """
    cfg = built.cfg
    if cfg.is_encdec:
        raise NotImplementedError(f"{cfg.name}: enc-dec archs are out of the "
                                  f"decode pipeline's scope")
    if not built.has_butterfly or len(built.stages) != 2:
        raise ValueError("the decode pipeline needs a butterfly split "
                         "(cfg.with_butterfly(...))")
    if wire_mode not in ("int8", "int4", "entropy"):
        raise ValueError(f"the decode pipeline wires quantized codes, not "
                         f"{wire_mode!r}")
    d_r = cfg.butterfly.d_r
    if wire_mode == "int4" and d_r % 2:
        raise ValueError("int4 wire packs two codes per byte: d_r must be even")
    S, T, Mmb, mb = int(prompt_len), int(new_tokens), int(num_microbatches), \
        int(microbatch)
    if T < 2:
        raise ValueError("need at least one decode tick (new_tokens >= 2)")
    if pipelined and Mmb < 2:
        raise ValueError("pipelined decode needs >= 2 in-flight microbatches")
    edge, cloud = make_pods(pods)
    mp = edge.pctx.mp_size
    tfm.check_tp_divisibility(tfm.build_layer_defs(cfg), cfg, mp)
    bits = 4 if wire_mode == "int4" else 8
    dt = dev_lib.torch_dtype(cfg.dtype)
    stages0, stages1 = list(built.stages[0]), list(built.stages[1])
    embed_scale = cfg.arch_type == "dense" and cfg.act == "gelu"
    cfg_rank = dataclasses.replace(cfg, num_kv_heads=cfg.num_kv_heads // mp)
    tmpl0 = tfm.init_stage_cache(stages0, cfg_rank, mb, S + T, dt, "meta")
    tmpl1 = tfm.init_stage_cache(stages1, cfg_rank, mb, S + T, dt, "meta")
    n_ticks = Mmb * (T - 1)

    def edge_wire(p, x):
        codes, scales = bf_lib.reduce_unit(p["butterfly"], x,
                                           use_kernel=use_kernel,
                                           wire_bits=bits)
        return (pack_int4(codes) if wire_mode == "int4" else codes), scales

    def cloud_restore(p, codes, scales):
        if wire_mode == "int4":
            codes = unpack_int4(codes)
        if use_kernel:
            nw = tfm.first_layer_norm1(stages1, p["stages"][1])
            return ops.butterfly_restore_norm(
                codes, scales, p["butterfly"]["w_restore"], nw,
                eps=cfg.rms_eps, out_dtype=dt)
        return bf_lib.restore_unit(p["butterfly"], codes, scales, dt), None

    def greedy(p, x):
        x = rms_norm(x[:, -1:], p["final_norm"], cfg.rms_eps)
        table = p["embed"] if cfg.tie_embeddings else p["head"]
        return unembed(table, x, cfg.logit_softcap)[:, 0].argmax(dim=-1)

    def edge_prefill(p, toks):
        x = embed(p["embed"], toks, scale=embed_scale)
        x, caches, _ = tfm.apply_stage(stages0, p["stages"][0], x, cfg=cfg,
                                       mode="prefill", stage_cache=None,
                                       pos=None, pctx=edge.pctx,
                                       shared_params=p.get("shared_attn"))
        return (*edge_wire(p, x), caches)

    def cloud_prefill(p, codes, scales):
        x, h = cloud_restore(p, codes, scales)
        x, caches, _ = tfm.apply_stage(stages1, p["stages"][1], x, cfg=cfg,
                                       mode="prefill", stage_cache=None,
                                       pos=None, pctx=cloud.pctx, first_h=h,
                                       shared_params=p.get("shared_attn"),
                                       overlap_psum=overlap_psum)
        return greedy(p, x), caches

    def edge_step(p, tok, cache, pos):
        x = embed(p["embed"], tok[:, None], scale=embed_scale)
        x, _, _ = tfm.apply_stage(stages0, p["stages"][0], x, cfg=cfg,
                                  mode="decode", stage_cache=cache, pos=pos,
                                  pctx=edge.pctx,
                                  shared_params=p.get("shared_attn"))
        return edge_wire(p, x)

    def cloud_step(p, codes, scales, cache, pos):
        x, h = cloud_restore(p, codes, scales)
        x, _, _ = tfm.apply_stage(stages1, p["stages"][1], x, cfg=cfg,
                                  mode="decode", stage_cache=cache, pos=pos,
                                  pctx=cloud.pctx, first_h=h,
                                  shared_params=p.get("shared_attn"),
                                  overlap_psum=overlap_psum)
        return greedy(p, x)

    def sync():
        for pod in (edge, cloud):
            if pod.stream is not None:
                pod.stream.synchronize()

    placed: dict = {}

    def decode_fn(params, tokens, timings: Optional[dict] = None,
                  states: Optional[dict] = None):
        if placed.get("params") is not params:
            placed.update(params=params, pods=pod_params(built, params,
                                                         (edge, cloud)))
        p_edge, p_cloud = placed["pods"]
        toks = dev_lib.as_tensor(tokens, edge.device, torch.int64)
        if tuple(toks.shape) != (Mmb * mb, S):
            raise ValueError(f"tokens {tuple(toks.shape)}, expected "
                             f"{(Mmb * mb, S)}")
        caller = [torch.cuda.current_stream(pod.device)
                  for pod in (edge, cloud) if pod.stream is not None]
        for pod, s in zip((edge, cloud), caller):
            pod.stream.wait_stream(s)            # params and tokens are ready
        t0 = time.perf_counter()

        # ---- prefill: both pods' decode caches and token 0 per microbatch
        c0, c1, tok = [], [], []
        for k in range(Mmb):
            with edge.active():
                codes, scales, caches = edge_prefill(
                    p_edge, toks[k * mb:(k + 1) * mb])
                c0.append(_grow_cache(caches, tmpl0))
            codes, scales = _handoff(codes, edge, cloud), \
                _handoff(scales, edge, cloud)
            with cloud.active():
                tok0, caches = cloud_prefill(p_cloud, codes, scales)
                c1.append(_grow_cache(caches, tmpl1))
            tok.append(_handoff(tok0, cloud, edge))
        if timings is not None:
            sync()
            timings["prefill_ms"] = (time.perf_counter() - t0) * 1e3
        t1 = time.perf_counter()

        # ---- decode ticks: pos = S + t // Mmb for microbatch t % Mmb
        with edge.active():
            pos_e = torch.arange(S, S + T - 1, device=edge.device)
        with cloud.active():
            pos_c = torch.arange(S, S + T - 1, device=cloud.device)
        out = [[t] for t in tok]

        def run_edge(t):
            k, j = t % Mmb, t // Mmb
            with edge.active():
                codes, scales = edge_step(p_edge, tok[k], c0[k], pos_e[j])
            return _handoff(codes, edge, cloud), _handoff(scales, edge, cloud)

        def run_cloud(t, codes, scales):
            # the cloud's token for (microbatch t % Mmb, round t // Mmb),
            # committed where the edge reads it
            k, j = t % Mmb, t // Mmb
            with cloud.active():
                tok_next = cloud_step(p_cloud, codes, scales, c1[k], pos_c[j])
            tok[k] = _handoff(tok_next, cloud, edge)
            out[k].append(tok[k])

        if pipelined:
            wire = None
            for t in range(n_ticks + 1):
                sent = run_edge(t) if t < n_ticks else None
                if t >= 1:
                    run_cloud(t - 1, *wire)
                wire = sent
        else:
            for t in range(n_ticks):
                run_cloud(t, *run_edge(t))

        with edge.active():
            ids = torch.stack([torch.stack(o, dim=1) for o in out])
            ids = ids.reshape(Mmb * mb, T).to(torch.int32)
        for pod, s in zip((edge, cloud), caller):
            s.wait_stream(pod.stream)
        if caller:
            ids.record_stream(caller[0])
        if timings is not None:
            sync()
            timings["decode_ms"] = (time.perf_counter() - t1) * 1e3
            timings["ticks"] = n_ticks
        if states is not None:
            states.update(edge=c0, cloud=c1)
        return ids

    return decode_fn
