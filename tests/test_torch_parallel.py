"""The model axis's pieces (``repro_torch/models/parallel.py`` and the
tensor-parallel specs beside the layers) against the JAX package's, on the
CPU.

  * the spec trees (each leaf the sharded dim, or None) equal JAX's
    ``tp_param_specs``, ``pipeline_param_specs`` and ``stage_cache_spec``
    leaf for leaf, the "model" axis's index in each ``PartitionSpec``;
  * ``check_tp_divisibility`` raises as JAX's does, with its messages;
  * ``shard_params`` gives each rank what ``jax.device_put`` on a
    ``Mesh``-built (model=4) mesh puts on that rank's device
    (``addressable_shards``), in a JAX subprocess with four host devices;
  * padded heads (``REPRO_ATTN_PAD_HEADS=1``): the port's layout is JAX's,
    its padding of ``wo`` puts JAX's zero rows where JAX does, and the
    padded attention equals JAX's;
  * ``model_psum`` is the identity under ``LOCAL``; the backend follows the
    ranks' devices;
  * two spawned ranks (gloo): an attention+MLP layer and an MoE layer,
    sharded, equal the unsharded layer in train, prefill and decode, with
    each rank's kv cache its block of the whole one.
"""
import dataclasses
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jget_config
from repro.models import attention as jattn
from repro.models import model as JM
from repro.models import transformer as jtfm
from repro.models.common import dense_init as jdense_init
from repro.serving import pipeline as jspl
from repro_torch import bridge
from repro_torch.configs import get_config as tget_config
from repro_torch.models import attention as tattn
from repro_torch.models import model as TM
from repro_torch.models import parallel
from repro_torch.models import transformer as ttfm
from repro_torch.serving import pipeline as tspl

ARCHS = ["qwen3-8b", "qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b",
         "zamba2-7b", "xlstm-125m", "gemma3-12b", "pixtral-12b"]


def _jdims(tree):
    """A JAX spec tree with each PartitionSpec as the model axis's index."""
    return jax.tree.map(
        lambda s: list(s).index("model") if "model" in tuple(s) else None,
        tree, is_leaf=lambda s: isinstance(s, P))


def _flat(tree):
    leaves, struct = jax.tree_util.tree_flatten(tree, is_leaf=lambda x: x is None)
    return leaves, struct


def _same(port, jax_tree):
    pl, ps = _flat(port)
    jl, js = _flat(_jdims(jax_tree))
    assert ps == js
    assert pl == jl


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_jax(arch):
    jcfg = jget_config(arch).reduced().with_butterfly(1, 16)
    tcfg = tget_config(arch).reduced().with_butterfly(1, 16)
    jbuilt, tbuilt = JM.build(jcfg), TM.build(tcfg)
    _same(TM.tp_param_specs(tbuilt), JM.tp_param_specs(jbuilt))
    _same(tspl.pipeline_param_specs(tbuilt, 4), jspl.pipeline_param_specs(jbuilt, 4))
    assert tspl.pipeline_param_specs(tbuilt, 1) is None
    assert jspl.pipeline_param_specs(jbuilt, 1) == P()
    for jsegs, tsegs in zip(jbuilt.stages, tbuilt.stages):
        _same(ttfm.stage_cache_spec(list(tsegs), tcfg, head_axis="model"),
              jtfm.stage_cache_spec(list(jsegs), None, None, head_axis="model"))
        _same(ttfm.stage_cache_spec(list(tsegs), tcfg),
              jtfm.stage_cache_spec(list(jsegs), None, None))


def test_encoder_decoder_has_no_tp_specs():
    with pytest.raises(AssertionError):
        JM.tp_param_specs(JM.build(jget_config("whisper-base").reduced()))
    with pytest.raises(NotImplementedError):
        TM.tp_param_specs(TM.build(tget_config("whisper-base").reduced()))


DIVISIBILITY = {
    "kv heads": ("qwen3-8b", {}, 4),
    "heads": ("qwen3-8b", dict(num_heads=6, num_kv_heads=6), 4),
    "d_ff": ("qwen3-8b", dict(num_heads=8, num_kv_heads=4, d_ff=510), 4),
    "experts": ("qwen3-moe-235b-a22b", dict(num_heads=8, num_kv_heads=4), 8),
    "cross attention": ("whisper-base", {}, 2),
    "divides": ("qwen3-8b", dict(num_heads=8, num_kv_heads=4), 4),
    "recurrent": ("xlstm-125m", {}, 8),
}


@pytest.mark.parametrize("case", list(DIVISIBILITY))
def test_check_tp_divisibility_matches_jax(case):
    arch, over, mp = DIVISIBILITY[case]
    errors = []
    for get, tfm in ((jget_config, jtfm), (tget_config, ttfm)):
        cfg = dataclasses.replace(get(arch).reduced(), **over)
        try:
            tfm.check_tp_divisibility(tfm.build_layer_defs(cfg), cfg, mp)
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    assert errors[0] == errors[1]
    assert (errors[0] is None) == (case in ("divides", "recurrent")), errors


SHARD_CODE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses, pickle
import jax, numpy as np
from jax.sharding import Mesh, NamedSharding
from repro.configs import get_config
from repro.models import model as JM
mesh = Mesh(np.array(jax.devices()), ("model",))
ranks = {d: r for r, d in enumerate(mesh.devices)}
out = {}
for arch in sys.argv[2:]:
    cfg = get_config(arch).reduced()
    cfg = dataclasses.replace(cfg, num_heads=8, num_kv_heads=4)
    built = JM.build(cfg.with_butterfly(1, 16))
    params, _ = JM.init_model(jax.random.key(0), built)
    specs = JM.tp_param_specs(built)
    placed = jax.tree.map(lambda a, s: jax.device_put(a, NamedSharding(mesh, s)),
                          params, specs)
    shards = jax.tree.map(lambda a: [np.asarray(s.data) for s in sorted(
        a.addressable_shards, key=lambda s: ranks[s.device])], placed)
    out[arch] = (jax.tree.map(np.asarray, params), shards)
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
"""

SHARD_ARCHS = ["qwen3-moe-235b-a22b", "zamba2-7b"]


@functools.lru_cache(maxsize=None)
def _jax_shards(tmp: str) -> dict:
    """Each arch's JAX params and each leaf's shards, rank by rank."""
    import pickle
    out = os.path.join(tmp, "shards.pkl")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", SHARD_CODE, out, *SHARD_ARCHS],
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    with open(out, "rb") as f:
        return pickle.load(f)


@pytest.mark.subprocess
@pytest.mark.parametrize("arch", SHARD_ARCHS)
def test_shard_params_equal_jax_addressable_shards(tmp_path_factory, arch):
    full, shards = _jax_shards(str(tmp_path_factory.getbasetemp()))[arch]
    cfg = dataclasses.replace(tget_config(arch).reduced(), num_heads=8,
                              num_kv_heads=4)
    built = TM.build(cfg.with_butterfly(1, 16))
    params = bridge.to_torch(full, device="cpu")
    specs = TM.tp_param_specs(built)
    sharded = 0
    for rank in range(4):
        mine = parallel.shard_params(params, specs, rank, 4)
        got = jax.tree_util.tree_leaves(jax.tree.map(np.asarray, mine))
        want = [s[rank] for s in jax.tree_util.tree_leaves(
            shards, is_leaf=lambda x: isinstance(x, list) and
            all(isinstance(a, np.ndarray) for a in x))]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.shape == w.shape and np.array_equal(g, w)
        sharded += sum(g.shape != f.shape for g, f in zip(
            got, jax.tree_util.tree_leaves(full)))
    assert sharded > 0
    # the shards are views of the caller's leaves, the replicated ones those
    mine = parallel.shard_params(params, specs, 1, 4)
    assert mine["embed"] is params["embed"]
    for a, b in zip(jax.tree_util.tree_leaves(mine),
                    jax.tree_util.tree_leaves(params)):
        assert a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()


def test_padded_heads_match_jax(monkeypatch):
    monkeypatch.setenv("REPRO_ATTN_PAD_HEADS", "1")
    jcfg = dataclasses.replace(jget_config("qwen3-8b").reduced(), num_heads=12,
                               num_kv_heads=4)
    tcfg = dataclasses.replace(tget_config("qwen3-8b").reduced(), num_heads=12,
                               num_kv_heads=4)
    assert tattn._padded_heads(tcfg) == jattn._padded_heads(jcfg) == 16
    key = jax.random.key(3)
    jp, _ = jattn.init_attention(key, jcfg, jnp.float32)
    tp = tattn.init_attention(torch.Generator().manual_seed(0), tcfg,
                              torch.float32, "cpu")
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    zero_rows = lambda wo: np.flatnonzero(~np.asarray(wo).any(axis=1))
    assert np.array_equal(zero_rows(tp["wo"]), zero_rows(jp["wo"]))
    # JAX's own draw of wo, padded by the port, is JAX's padded wo
    hd = jcfg.resolved_head_dim
    wo = jdense_init(jax.random.split(key, 4)[3], jcfg.num_heads * hd,
                     jcfg.d_model, jnp.float32,
                     scale=1.0 / (jcfg.num_heads * hd))
    padded = tattn.pad_wo(torch.from_numpy(np.array(wo)), tcfg, 16)
    assert np.array_equal(padded.numpy(), np.asarray(jp["wo"]))
    # the padded attention equals JAX's on JAX's padded weights
    x = np.random.default_rng(0).standard_normal((2, 8, jcfg.d_model),
                                                 dtype=np.float32)
    jout, _ = jattn.attention_fullseq(jp, jnp.asarray(x), cfg=jcfg, window=None)
    tout, _ = tattn.attention_fullseq(bridge.to_torch(jax.tree.map(np.asarray, jp),
                                                      device="cpu"),
                                      torch.from_numpy(x), cfg=tcfg, window=None)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-5)
    # kv heads must still divide: 16 heads take mp 4 where 12 did not
    defs = ttfm.build_layer_defs(tcfg)
    ttfm.check_tp_divisibility(defs, tcfg, 4)
    monkeypatch.delenv("REPRO_ATTN_PAD_HEADS")
    assert tattn._padded_heads(tcfg) == 12
    with pytest.raises(ValueError, match="must divide heads"):
        ttfm.check_tp_divisibility(defs, dataclasses.replace(tcfg, num_kv_heads=6), 4)


def test_model_psum_is_the_identity_locally():
    x = torch.arange(6.0)
    assert parallel.manual_context(None) is parallel.LOCAL
    assert not parallel.LOCAL.tensor_parallel and parallel.LOCAL.mp_size == 1
    assert parallel.model_psum(x, parallel.LOCAL) is x
    assert torch.equal(x, torch.arange(6.0))
    assert parallel.model_group(1) is None
    with pytest.raises(ValueError, match="needs 2 ranks"):
        parallel.model_group(2)


def test_backend_follows_the_devices():
    assert parallel.backend_for(["cpu"] * 4) == "gloo"
    assert parallel.backend_for(["cuda:0", "cuda:0"]) == "gloo"
    assert parallel.backend_for(["cuda:0", "cuda:1"]) == "nccl"
    for bad in (["cpu", "cuda:0"], ["cuda", "cuda"]):
        with pytest.raises(ValueError):
            parallel.backend_for(bad)


def _layer_cfg(kind):
    cfg = tget_config("qwen3-moe-235b-a22b" if kind == "moe" else "qwen3-8b")
    cfg = dataclasses.replace(cfg.reduced(), num_heads=4, num_kv_heads=2)
    if kind == "moe":
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, num_experts=4, top_k=2))
    return cfg


def _layer_runs(rank, device, mp):
    """Train, prefill and one decode step of an attention+MLP layer and an
    MoE layer at degree ``mp`` (1: unsharded, in this process)."""
    pctx = parallel.manual_context(parallel.model_group(mp))
    out = {}
    for kind in ("dense", "moe"):
        cfg = _layer_cfg(kind)
        ldef = ttfm.build_layer_defs(cfg)[0]
        p = ttfm.init_layer(torch.Generator().manual_seed(0), ldef, cfg,
                            torch.float32, "cpu")
        p = parallel.shard_params(p, ttfm.tp_layer_specs(ldef, cfg, torch.float32),
                                  pctx.rank, mp)
        x = torch.from_numpy(np.random.default_rng(1).standard_normal(
            (2, 8, cfg.d_model), dtype=np.float32))
        kw = dict(cfg=cfg, pctx=pctx, pos=None)
        train, _, aux, _ = ttfm.apply_layer(ldef, p, x, mode="train", cache=None, **kw)
        pre, cache, _, _ = ttfm.apply_layer(ldef, p, x, mode="prefill", cache=None, **kw)
        cache = {"kv": {n: torch.cat([a, torch.zeros_like(a[:, :1])], 1)
                        for n, a in cache["kv"].items()}}
        dec, cache, _, _ = ttfm.apply_layer(ldef, p, x[:, :1] * 0.5, mode="decode",
                                            cache=cache, **dict(kw, pos=8))
        out[kind] = dict(train=train, prefill=pre, decode=dec, aux=aux,
                         k=cache["kv"]["k"])
    return out


def test_sharded_layers_equal_the_unsharded_ones():
    want = _layer_runs(0, "cpu", 1)
    got = parallel.spawn(_layer_runs, 2, (2,))
    for rank, ranks_out in enumerate(got):
        for kind, runs in ranks_out.items():
            for name in ("train", "prefill", "decode"):
                torch.testing.assert_close(runs[name], want[kind][name],
                                           rtol=1e-5, atol=1e-5)
            if kind == "moe":
                torch.testing.assert_close(runs["aux"], want[kind]["aux"],
                                           rtol=0, atol=0)
            K = want[kind]["k"].shape[2] // 2
            torch.testing.assert_close(
                runs["k"], want[kind]["k"][:, :, rank * K:(rank + 1) * K],
                rtol=1e-5, atol=1e-5)
