"""The paper's deployment as a two-stage pipeline over two pods (port of
``repro/serving/pipeline.py``: ``wire_stats``, ``_grow_cache`` and
``make_decode_pipeline`` at model-axis degree 1).

Pod 0 ("edge") runs the embedding, layers [0, j) and the reduction unit with
the wire quantization; only the codes and their f32 scales cross to pod 1
("cloud"), which restores them, runs layers [j, N) and the LM head; the
greedy token crosses back.  The JAX package runs its pods on the ``pod``
axis of a mesh and crosses with ``lax.ppermute``.  Here a pod is a
``torch.device`` with its own CUDA stream (both pods may name the same
card), and each crossing is a handoff: the consumer's stream waits on an
event the producer's stream records, the tensor moves with
``.to(device, non_blocking=True)`` (nothing moves when both pods share a
card), and ``record_stream`` keeps the caching allocator from handing its
memory to the producer's stream while the consumer still reads it.  One
Python thread launches both pods' work; on the CPU the pods run one after
the other.

MoE layers run their local path, as the JAX package's manual path does at
model-axis degree 1: each microbatch's tokens compete for its experts'
capacity.  A model axis inside a pod (tensor-parallel stages,
``overlap_psum``) and the SSM, xLSTM and hybrid families are not ported:
they raise ``NotImplementedError``; an encoder-decoder raises it too, as
the JAX package asserts it out of the pipeline's scope.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from repro_torch import device as dev_lib
from repro_torch.core import butterfly as bf_lib
from repro_torch.core.quantization import pack_int4, unpack_int4, wire_bytes
from repro_torch.kernels import ops
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


@dataclasses.dataclass(frozen=True)
class Pod:
    device: torch.device
    stream: Optional["torch.cuda.Stream"]      # None on the CPU

    def active(self):
        """Context in which work goes to this pod's stream (a no-op on the
        CPU, where the stream is None)."""
        return torch.cuda.stream(self.stream)


def make_pods(pods) -> tuple:
    """Two :class:`Pod` from a pair of devices (names or ``torch.device``),
    pod 0 the edge and pod 1 the cloud; on CUDA each gets its own stream,
    also when both name the same card."""
    pods = tuple(pods)
    if len(pods) != 2 or any(isinstance(p, (list, tuple)) for p in pods):
        raise NotImplementedError(
            f"pods must be two devices, got {pods!r}: a model axis inside a "
            f"pod is not ported")
    devs = [dev_lib.resolve(p) for p in pods]
    if devs[0].type != devs[1].type:
        raise ValueError(f"both pods must be CUDA devices or both the CPU, "
                         f"got {devs}")
    if devs[0].type == "cpu":
        return tuple(Pod(d, None) for d in devs)
    devs = [d if d.index is not None else
            torch.device("cuda", torch.cuda.current_device()) for d in devs]
    return tuple(Pod(d, torch.cuda.Stream(device=d)) for d in devs)


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
    the full tree, on its pod's device.  A leaf already on its pod's device
    is shared, not copied, so on one card both pods use the caller's one
    copy of the weights."""
    cfg = built.cfg
    head = "embed" if cfg.tie_embeddings else "head"
    edge = {"embed": params["embed"], "stages": [params["stages"][0], None],
            "butterfly": {"w_reduce": params["butterfly"]["w_reduce"]}}
    cloud = {"final_norm": params["final_norm"], head: params[head],
             "stages": [None, params["stages"][1]],
             "butterfly": {"w_restore": params["butterfly"]["w_restore"]}}
    return tuple(tree_map(lambda a, d=pod.device: a.to(d), p)
                 for p, pod in zip((edge, cloud), pods))


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
    times in ms (the pods are synchronised for it).

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
    the cloud's tick 0 on zero codes and the edge's drain tick.  This eager
    port skips both, which changes no result.

    ``wire_mode``: "int8", nibble-packed "int4", or "entropy" (numerically
    int8).  ``use_kernel``: the fused reduce+quant on the edge and the
    fused dequant+restore+norm1 (``ops.butterfly_restore_norm``, fed the
    first cloud layer's norm1 weight) on the cloud.
    """
    cfg = built.cfg
    if overlap_psum:
        raise NotImplementedError("overlap_psum defers psums over a model "
                                  "axis, which is not ported")
    if cfg.is_encdec:
        raise NotImplementedError(f"{cfg.name}: enc-dec archs are out of the "
                                  f"decode pipeline's scope")
    if (cfg.ssm is not None or cfg.xlstm is not None
            or cfg.hybrid_attn_every is not None):
        raise NotImplementedError(f"{cfg.name}: the decode pipeline is ported "
                                  f"for attention layers only")
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
    bits = 4 if wire_mode == "int4" else 8
    dt = dev_lib.torch_dtype(cfg.dtype)
    stages0, stages1 = list(built.stages[0]), list(built.stages[1])
    embed_scale = cfg.arch_type == "dense" and cfg.act == "gelu"
    tmpl0 = tfm.init_stage_cache(stages0, cfg, mb, S + T, dt, "meta")
    tmpl1 = tfm.init_stage_cache(stages1, cfg, mb, S + T, dt, "meta")
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
                                       pos=None)
        return (*edge_wire(p, x), caches)

    def cloud_prefill(p, codes, scales):
        x, h = cloud_restore(p, codes, scales)
        x, caches, _ = tfm.apply_stage(stages1, p["stages"][1], x, cfg=cfg,
                                       mode="prefill", stage_cache=None,
                                       pos=None, first_h=h)
        return greedy(p, x), caches

    def edge_step(p, tok, cache, pos):
        x = embed(p["embed"], tok[:, None], scale=embed_scale)
        x, _, _ = tfm.apply_stage(stages0, p["stages"][0], x, cfg=cfg,
                                  mode="decode", stage_cache=cache, pos=pos)
        return edge_wire(p, x)

    def cloud_step(p, codes, scales, cache, pos):
        x, h = cloud_restore(p, codes, scales)
        x, _, _ = tfm.apply_stage(stages1, p["stages"][1], x, cfg=cfg,
                                  mode="decode", stage_cache=cache, pos=pos,
                                  first_h=h)
        return greedy(p, x)

    def sync():
        for pod in (edge, cloud):
            if pod.stream is not None:
                pod.stream.synchronize()

    placed: dict = {}

    def decode_fn(params, tokens, timings: Optional[dict] = None):
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
        return ids

    return decode_fn
