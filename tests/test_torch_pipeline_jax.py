"""The port's two-pod decode pipeline against JAX's on a two-host-device
mesh: qwen3 and windowed gemma3 (moved from ``test_torch_pipeline.py`` so
that its subprocesses spread over workers; the MoE and recurrent cases are
in ``test_torch_pipeline_jax_families.py``).

In a subprocess with two host devices, JAX's ``make_decode_pipeline`` and
``SplitRunner.decode_pipeline`` on a (pod=2, model=1, data=1) mesh against
the port's on two CPU pods, with the same weights bridged in and the same
tokens: identical greedy ids for every wire, schedule and kernel setting,
and equal compile-cache counts.
"""
import os
import subprocess
import sys

import pytest

PARITY_CODE = r"""
import dataclasses, functools, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh
from repro.configs import get_config as jget
from repro.models import model as JM
from repro.runtime.split_exec import SplitModelBank as JBank
from repro.serving.pipeline import make_decode_pipeline as jmake
from repro_torch import bridge
from repro_torch.configs import get_config as tget
from repro_torch.models import model as TM
from repro_torch.runtime.split_exec import SplitModelBank as TBank
from repro_torch.serving.pipeline import make_decode_pipeline as tmake
from repro_torch.tree import tree_map

mesh = Mesh(np.array(jax.devices()).reshape(2, 1, 1), ("pod", "model", "data"))
PODS = ("cpu", "cpu")
ARCH = sys.argv[2] if len(sys.argv) > 2 else "qwen3-8b"
Mmb, mb, S, T, SPLIT, D_R = 2, 2, 8, 4, 1, 32
jbase, tbase = jget(ARCH).reduced(), tget(ARCH).reduced()
if ARCH == "qwen3-moe-235b-a22b":
    # 3 layers, every one MoE (4 experts, top-2) at the default capacity
    jbase, tbase = (dataclasses.replace(c, num_layers=3) for c in (jbase, tbase))
if ARCH == "gemma3-12b":
    # 4 layers, one global in two, window 4: S + T = 14 positions wrap the
    # rings of the windowed layers on both pods
    T = 6
    jbase, tbase = (dataclasses.replace(c, num_layers=4, global_every=2,
                                        sliding_window=4) for c in (jbase, tbase))
RECURRENT = ARCH in ("zamba2-7b", "xlstm-125m")
if RECURRENT:
    # 4 layers, two repeat units ([mamba, shared attn] or [mLSTM, sLSTM]):
    # the split after layer 1 lands inside the first
    jbase, tbase = (dataclasses.replace(c, num_layers=4) for c in (jbase, tbase))
toks = np.random.default_rng(1).integers(
    0, jbase.vocab_size, (Mmb * mb, S)).astype(np.int32)
to_np = lambda t: jax.tree.map(np.asarray, t)
SETTINGS = [(wm, p, uk) for wm in ("int8", "int4") for p in (True, False)
            for uk in (False, True)]
if ARCH == "qwen3-moe-235b-a22b":
    SETTINGS = SETTINGS[:4]          # the wires differ only before routing
if RECURRENT:
    # pipelined with the kernels at int8 (the card's path), and serial,
    # plain at int4: each of the three switches both ways once
    SETTINGS = [("int8", True, True), ("int4", False, False)]

def same(j, t, what):
    j = np.asarray(j)
    t = t.numpy()
    assert j.shape == t.shape == (Mmb * mb, T), (what, j.shape, t.shape)
    assert (j == t).all(), (what, j.tolist(), t.tolist())

from repro.core.quantization import dequantize, quantize
from repro.kernels import ops as jops
from repro.models import transformer as jtfm
from repro.models.common import embed
from repro.models.parallel import LOCAL
from repro.serving.pipeline import _grow_cache

# stage i of built in mode, one jit for every setting and microbatch
@functools.partial(jax.jit, static_argnums=(0, 1, 2))
def run_stage(built, i, mode, params, x, cache, pos, h):
    return jtfm.apply_stage(list(built.stages[i]), params["stages"][i], x,
                            cfg=built.cfg, pctx=LOCAL, mode=mode, stage_cache=cache,
                            pos=pos, shared_params=params.get("shared_attn"),
                            first_h=h)[:2]

# each microbatch's stage caches after JAX's pipeline: prefill, then its T-1
# decode steps fed the greedy ids, through the pipeline's per-step functions
# (its warm-up and drain ticks write nothing)
def jax_states(built, params, ids, wm, uk):
    cfg, dt = built.cfg, jnp.dtype(built.cfg.dtype)
    s0, s1 = list(built.stages[0]), list(built.stages[1])
    bf = params["butterfly"]
    run = lambda i, mode, x, cache, pos, h: run_stage(built, i, mode, params, x,
                                                      cache, pos, h)

    def wire(x):
        bits = 4 if wm == "int4" else 8
        if uk:
            codes, scales = jops.butterfly_reduce_quant(x, bf["w_reduce"], bits=bits)
            nw = jtfm.first_layer_norm1(s1, params["stages"][1])
            return jops.butterfly_restore_norm(codes, scales, bf["w_restore"], nw,
                                               eps=cfg.rms_eps, out_dtype=dt)
        codes, scales = quantize(x @ bf["w_reduce"], bits)
        return dequantize(codes, scales, dt) @ bf["w_restore"], None

    out = []
    for k in range(Mmb):
        rows = slice(k * mb, (k + 1) * mb)
        x, c0 = run(0, "prefill", embed(params["embed"], jnp.asarray(toks[rows])),
                    None, None, None)
        xr, h = wire(x)
        _, c1 = run(1, "prefill", xr, None, None, h)
        c0 = _grow_cache(c0, jtfm.init_stage_cache(s0, cfg, mb, S + T, dt))
        c1 = _grow_cache(c1, jtfm.init_stage_cache(s1, cfg, mb, S + T, dt))
        for j in range(T - 1):
            pos = jnp.asarray(S + j, jnp.int32)
            x = embed(params["embed"], jnp.asarray(ids[rows, j])[:, None])
            x, c0 = run(0, "decode", x, c0, pos, None)
            xr, h = wire(x)
            _, c1 = run(1, "decode", xr, c1, pos, h)
        out.append((c0, c1))
    return out

def same_states(want, got, what):
    for k, (c0, c1) in enumerate(want):
        for side, jc, tc in (("edge", c0, got["edge"][k]), ("cloud", c1, got["cloud"][k])):
            def one(t, j):
                assert tuple(t.shape) == j.shape, (what, side, t.shape, j.shape)
                np.testing.assert_allclose(t.numpy(), j, rtol=1e-5, atol=1e-5,
                                           err_msg=f"{what} {side} {k}")
            tree_map(one, tc, to_np(jc))

if sys.argv[1] == "make_decode_pipeline":
    built = JM.build(jbase.with_butterfly(layer=SPLIT, d_r=D_R))
    params, _ = JM.init_model(jax.random.key(0), built)
    tbuilt = TM.build(tbase.with_butterfly(layer=SPLIT, d_r=D_R))
    tparams = bridge.to_torch(to_np(params), device="cpu")
    for wm, p, uk in SETTINGS:
        kw = dict(wire_mode=wm, pipelined=p, use_kernel=uk)
        j = jax.jit(jmake(built, mesh, Mmb, S, mb, T, **kw))(params, jnp.asarray(toks))
        states = {}
        same(j, tmake(tbuilt, PODS, Mmb, S, mb, T, **kw)(tparams, toks, None, states), kw)
        if RECURRENT:
            same_states(jax_states(built, params, np.asarray(j), wm, uk), states, kw)
else:
    for wm in ("int8", "int4"):
        jb = JBank(jbase, D_R, wire_mode=wm, seed=0)
        tb = TBank(tbase, D_R, wire_mode=wm, seed=0, device="cpu",
                   params=bridge.to_torch(to_np(jb.params), device="cpu"),
                   butterfly={SPLIT: bridge.to_torch(
                       to_np(jb.butterfly_params(SPLIT)), device="cpu")})
        jr, tr = jb.runner(SPLIT), tb.runner(SPLIT)
        for _, p, uk in [s for s in SETTINGS if s[0] == wm]:
            kw = dict(pipelined=p, use_kernel=uk)
            j = jr.decode_pipeline(mesh, Mmb, S, mb, T, **kw)(jnp.asarray(toks))
            same(j, tr.decode_pipeline(PODS, Mmb, S, mb, T, **kw)(toks), (wm, kw))
        assert (jb.cache_hits, jb.cache_misses) == (tb.cache_hits, tb.cache_misses)
print("PIPELINE_PARITY_OK")
"""


def _parity(*args):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", PARITY_CODE, *args], env=env,
                         capture_output=True, text=True, timeout=500)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "PIPELINE_PARITY_OK" in res.stdout


@pytest.mark.subprocess
@pytest.mark.parametrize("entry", ["make_decode_pipeline", "SplitRunner"])
def test_pipeline_matches_jax_two_pods(entry):
    """Reduced qwen3-8b in f32, butterfly after layer 1, d_r=32, Mmb=2,
    mb=2, S=8, T=4: greedy ids identical to JAX's for int8 and int4,
    pipelined and serial, with and without ``use_kernel``."""
    _parity(entry)


@pytest.mark.subprocess
@pytest.mark.parametrize("entry", ["make_decode_pipeline", "SplitRunner"])
def test_windowed_pipeline_matches_jax_two_pods(entry):
    """The same on reduced gemma3 (4 layers, one global in two, window 4,
    butterfly after layer 1), S=8, T=6, so the windowed layers' ring caches
    wrap on both pods: greedy ids identical to JAX's for every setting."""
    _parity(entry, "gemma3-12b")
