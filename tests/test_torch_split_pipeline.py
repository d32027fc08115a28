"""The port's two-pod prefill pipeline (``repro_torch/serving/pipeline.py``:
``make_split_pipeline``) against the JAX package's on the CPU.

  * (a) in one subprocess a family, with two host devices: JAX's unedited
    ``make_split_pipeline`` on a ``jax.sharding.Mesh``-built (pod=2,
    data=1) mesh against the port's on two CPU pods, with the same weights
    bridged in and the same tokens from a numpy seed, in f32, for every
    wire mode on reduced qwen3-8b, gemma3-12b (4 layers, one global in two,
    window 4), qwen3-moe (3 layers, every one MoE), zamba2-7b and
    xlstm-125m (4 layers, the split after layer 1 inside the first unit):
    logits within atol 1e-5 * max(1, max|ref|) and the same argmax.  JAX's
    pipeline returns only logits, so a route that differs shows as a logit
    gap and fails the bound.  A quantized wire rounds each code from f32
    sums that the two packages add in another order; where the port's
    ``r / scale`` lies within 1e-3 of a rounding tie the two may round it
    apart.  A microbatch whose gap is over the bound is held instead to the
    JAX package's own cloud stage (its ``dequantize``, ``apply_stage``,
    ``rms_norm`` and ``unembed``, jitted) on the port's codes, within the
    bound, and JAX's pipeline logits to that stage on the port's codes with
    some of the tie codes rounded the other way, within the bound;
  * (b) without JAX: the refusals (a model axis without its ranks among
    them); the ``crossings`` each run records (Mmb wires and Mmb logits,
    the wire's dtype and bytes those of ``wire_stats``); pipelined equal to
    serial, and entropy equal to int8, bit for bit; and a model axis of 2
    over two spawned CPU ranks against degree 1 (JAX's (pod=2, model=4)
    parity is in ``test_torch_model_parallel_jax.py``).
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import model as TM
from repro_torch.models import parallel
from repro_torch.serving import make_split_pipeline, wire_stats

ARCHS = ["qwen3-8b", "gemma3-12b", "qwen3-moe-235b-a22b", "zamba2-7b",
         "xlstm-125m"]
WIRE_MODES = ["raw", "reduced", "int8", "int4", "entropy"]
MMB, MB, S, SPLIT, D_R = 3, 2, 32, 1, 32

# ----------------------------------------------------------------------- (a)
SPLIT_CODE = r"""
import dataclasses, functools, itertools, json, os, sys
# one thread a process: the suite runs many of these at once
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=2 "
                           "--xla_cpu_multi_thread_eigen=false "
                           "intra_op_parallelism_threads=1")
import jax, jax.numpy as jnp
import numpy as np
import torch
torch.set_num_threads(1)
from jax.sharding import Mesh
from repro.configs import get_config as jget
from repro.core.quantization import dequantize as jdequantize
from repro.models import model as JM
from repro.models import transformer as jtfm
from repro.models.common import rms_norm as jrms_norm, unembed as junembed
from repro.models.parallel import LOCAL
from repro.serving.pipeline import make_split_pipeline as jmake
from repro_torch import bridge
from repro_torch.configs import get_config as tget
from repro_torch.core.quantization import quantize
from repro_torch.models import model as TM
from repro_torch.models import transformer as ttfm
from repro_torch.models.common import embed
from repro_torch.serving.pipeline import make_split_pipeline as tmake

ARCH = sys.argv[1]
Mmb, mb, S, SPLIT, D_R = (int(a) for a in sys.argv[2:7])
mesh = Mesh(np.array(jax.devices()).reshape(2, 1), ("pod", "data"))
LAYERS = {"gemma3-12b": dict(num_layers=4, global_every=2, sliding_window=4),
          "qwen3-moe-235b-a22b": dict(num_layers=3),
          "zamba2-7b": dict(num_layers=4), "xlstm-125m": dict(num_layers=4)}
jbase, tbase = (dataclasses.replace(c.reduced(), **LAYERS.get(ARCH, {}))
                for c in (jget(ARCH), tget(ARCH)))
built = JM.build(jbase.with_butterfly(layer=SPLIT, d_r=D_R))
tbuilt = TM.build(tbase.with_butterfly(layer=SPLIT, d_r=D_R))
cfg = built.cfg
params, _ = JM.init_model(jax.random.key(0), built)
tparams = bridge.to_torch(jax.tree.map(np.asarray, params), device="cpu")
toks = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                         (Mmb * mb, S)).astype(np.int32)

@functools.partial(jax.jit, static_argnums=0)
def jcloud(dt, codes, scales):
    # the JAX package's cloud stage (pipeline.stage_cloud) on unpacked codes
    x = jdequantize(codes, scales, jnp.dtype(dt)) @ params["butterfly"]["w_restore"]
    x, _, _ = jtfm.apply_stage(list(built.stages[1]), params["stages"][1], x,
                               cfg=cfg, pctx=LOCAL, mode="train",
                               stage_cache=None, pos=None,
                               shared_params=params.get("shared_attn"))
    x = jrms_norm(x[:, -1:], params["final_norm"], cfg.rms_eps)
    table = params["embed"] if cfg.tie_embeddings else params["head"]
    return junembed(table, x)[:, 0]

def port_wire(rows, bits):
    # the port's edge stage: codes, scales and r / scale of one microbatch
    x = embed(tparams["embed"], torch.from_numpy(toks[rows]).long(),
              scale=cfg.arch_type == "dense" and cfg.act == "gelu")
    x, _, _ = ttfm.apply_stage(list(tbuilt.stages[0]), tparams["stages"][0], x,
                               cfg=tbuilt.cfg, mode="train", stage_cache=None,
                               pos=None, shared_params=tparams.get("shared_attn"))
    r = x @ tparams["butterfly"]["w_reduce"]
    codes, scales = quantize(r, bits)
    return codes.numpy(), scales.numpy(), (r.float() / scales).numpy()

def settle_ties(wm, k, want, got, bound):
    # a microbatch over the bound: the port's logits against JAX's cloud
    # stage on the port's codes, and JAX's against that stage on the port's
    # codes with some of their rounding ties taken the other way
    rows = slice(k * mb, (k + 1) * mb)
    codes, scales, q = port_wire(rows, 4 if wm == "int4" else 8)
    ties = np.argwhere(np.abs(np.abs(q) - np.floor(np.abs(q)) - 0.5) < 1e-3)
    if not 0 < len(ties) <= 8:
        return f"microbatch {k}: {len(ties)} rounding ties"
    gap = np.abs(np.asarray(jcloud(cfg.dtype, codes, scales)) - got).max()
    if gap > bound:
        return f"microbatch {k}: JAX's cloud stage on the port's codes {gap}"
    other = np.floor(q) + np.ceil(q) - codes
    for flip in itertools.product((False, True), repeat=len(ties)):
        alt = codes.copy()
        for (i, j, c), f in zip(ties, flip):
            if f:
                alt[i, j, c] = other[i, j, c]
        if np.abs(np.asarray(jcloud(cfg.dtype, alt, scales)) - want).max() <= bound:
            return sum(flip)
    return f"microbatch {k}: no rounding of its {len(ties)} ties gives JAX's logits"

report = {}
for wm in ("raw", "reduced", "int8", "int4", "entropy"):
    want = np.asarray(jax.jit(jmake(built, mesh, Mmb, S, mb, wm))(
        params, jnp.asarray(toks)))
    got = tmake(tbuilt, ("cpu", "cpu"), Mmb, S, mb, wm)(tparams, toks).numpy()
    bound = 1e-5 * max(1.0, float(np.abs(want).max()))
    rep = dict(shape=list(got.shape), want_shape=list(want.shape),
               max_err=float(np.abs(want - got).max()), bound=bound,
               argmax=bool((want.argmax(-1) == got.argmax(-1)).all()), ties={})
    for k in range(Mmb):
        rows = slice(k * mb, (k + 1) * mb)
        if np.abs(want[rows] - got[rows]).max() > bound:
            rep["ties"][k] = (settle_ties(wm, k, want[rows], got[rows], bound)
                              if wm in ("int8", "int4", "entropy") else "no wire codes")
    report[wm] = rep
print("SPLIT_REPORT " + json.dumps(report))
"""


@functools.lru_cache(maxsize=None)
def _report(arch: str) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    env.pop("XLA_FLAGS", None)
    res = subprocess.run(
        [sys.executable, "-c", SPLIT_CODE, arch,
         *map(str, (MMB, MB, S, SPLIT, D_R))],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    line = [l for l in res.stdout.splitlines() if l.startswith("SPLIT_REPORT ")]
    assert len(line) == 1, res.stdout[-3000:]
    return json.loads(line[0].split(" ", 1)[1])


@pytest.mark.subprocess
@pytest.mark.parametrize("wire_mode", WIRE_MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_split_pipeline_matches_jax_two_pods(arch, wire_mode):
    """Reduced ``arch`` in f32, butterfly after layer 1 at d_r=32, Mmb=3,
    mb=2, S=32: the port's last-token logits equal JAX's within atol 1e-5 *
    max(1, max|ref|), with the same argmax; a microbatch over the bound
    differs only by codes rounded apart at a tie (see the module note)."""
    rep = _report(arch)[wire_mode]
    assert rep["shape"] == rep["want_shape"] == [MMB * MB, rep["shape"][1]]
    assert rep["argmax"], rep
    for k, verdict in rep["ties"].items():
        assert isinstance(verdict, int) and verdict >= 1, (k, verdict)
    if not rep["ties"]:
        assert rep["max_err"] <= rep["bound"], rep


# ----------------------------------------------------------------------- (b)
def _built(arch="qwen3-8b", d_r=D_R, **over):
    cfg = dataclasses.replace(get_config(arch).reduced(), num_layers=2, **over)
    built = TM.build(cfg.with_butterfly(layer=SPLIT, d_r=d_r))
    params = TM.init_model(torch.Generator().manual_seed(0), built, device="cpu")
    return built, params


def _tokens(cfg):
    return np.random.default_rng(0).integers(0, cfg.vocab_size, (MMB * MB, S))


REFUSALS = {
    "enc-dec": (NotImplementedError, lambda: make_split_pipeline(
        TM.build(get_config("whisper-base").reduced().with_butterfly(1, 16)),
        ("cpu", "cpu"), MMB, S, MB)),
    # two model ranks a pod, and no torch.distributed world to hold them
    "model axis": (ValueError, lambda: make_split_pipeline(
        _built()[0], (("cpu", "cpu"), ("cpu", "cpu")), MMB, S, MB)),
    "no butterfly": (ValueError, lambda: make_split_pipeline(
        TM.build(get_config("qwen3-8b").reduced()), ("cpu", "cpu"), MMB, S, MB)),
    "unknown wire": (ValueError, lambda: make_split_pipeline(
        _built()[0], ("cpu", "cpu"), MMB, S, MB, wire_mode="int2")),
    "int4 odd d_r": (ValueError, lambda: make_split_pipeline(
        _built(d_r=15)[0], ("cpu", "cpu"), MMB, S, MB, wire_mode="int4")),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_split_pipeline_refuses(case):
    err, make = REFUSALS[case]
    with pytest.raises(err):
        make()


@pytest.mark.parametrize("wire_mode", WIRE_MODES)
def test_crossings_match_wire_stats(wire_mode):
    """Mmb wire crossings edge -> cloud and Mmb logit crossings back, in the
    pipelined order; the quantized wire's dtype int8 and its bytes (codes
    and scales) those of ``wire_stats``; the raw wire the boundary's bytes."""
    built, params = _built()
    cfg = built.cfg
    crossings = []
    out = make_split_pipeline(built, ("cpu", "cpu"), MMB, S, MB, wire_mode)(
        params, _tokens(cfg), crossings)
    assert out.shape == (MMB * MB, cfg.vocab_size) and out.dtype == torch.float32
    order = [c[0] for c in crossings]
    assert order == ["edge->cloud"] + ["edge->cloud", "cloud->edge"] * (MMB - 1) \
        + ["cloud->edge"]
    stats = wire_stats(cfg, MB, S, 4 if wire_mode == "int4" else None)
    want = {"raw": (torch.float32, (MB, S, cfg.d_model), stats["raw_boundary_bytes"]),
            "reduced": (torch.float32, (MB, S, D_R), MB * S * D_R * 4),
            "int8": (torch.int8, (MB, S, D_R), stats["wire_bytes"]),
            "int4": (torch.int8, (MB, S, D_R // 2), stats["wire_bytes"]),
            "entropy": (torch.int8, (MB, S, D_R), stats["wire_bytes"])}[wire_mode]
    for direction, dtype, shape, nbytes in crossings:
        if direction == "edge->cloud":
            assert (dtype, shape, nbytes) == want
        else:
            assert (dtype, shape, nbytes) == (torch.float32, (MB, cfg.vocab_size),
                                              MB * cfg.vocab_size * 4)


@pytest.mark.parametrize("wire_mode", WIRE_MODES)
def test_pipelined_equals_serial(wire_mode):
    built, params = _built("gemma3-12b", global_every=2, sliding_window=4)
    toks = _tokens(built.cfg)
    runs = [make_split_pipeline(built, ("cpu", "cpu"), MMB, S, MB, wire_mode,
                                pipelined=p)(params, toks) for p in (True, False)]
    assert torch.equal(*runs)


def test_entropy_equals_int8():
    built, params = _built()
    toks = _tokens(built.cfg)
    int8, entropy = (make_split_pipeline(built, ("cpu", "cpu"), MMB, S, MB, wm)(
        params, toks) for wm in ("int8", "entropy"))
    assert torch.equal(int8, entropy)


def test_tokens_of_the_wrong_shape_raise():
    built, params = _built()
    run = make_split_pipeline(built, ("cpu", "cpu"), MMB, S, MB)
    with pytest.raises(ValueError):
        run(params, _tokens(built.cfg)[:, :S - 1])


def _two_rank_logits(rank, device, pods):
    built, params = _built(num_heads=4, num_kv_heads=2)
    toks = _tokens(built.cfg)
    return {wm: make_split_pipeline(built, pods, MMB, S, MB, wm)(params, toks)
            for wm in WIRE_MODES}


def test_model_axis_split_pipeline_on_two_ranks():
    """(pod=2, model=2) over two spawned CPU ranks (gloo), f32, every wire:
    each rank's logits within atol 1e-5 * max(1, max|ref|) of degree 1's,
    with the same argmax, and equal on both ranks."""
    want = _two_rank_logits(0, "cpu", ("cpu", "cpu"))
    got = parallel.spawn(_two_rank_logits, 2,
                         ((("cpu", "cpu"), ("cpu", "cpu")),))
    for wm, ref in want.items():
        bound = 1e-5 * max(1.0, float(ref.abs().max()))
        assert torch.equal(got[0][wm], got[1][wm]), wm
        assert float((got[0][wm] - ref).abs().max()) <= bound, wm
        assert torch.equal(got[0][wm].argmax(-1), ref.argmax(-1)), wm
