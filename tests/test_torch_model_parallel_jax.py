"""The model axis inside a pod: the port's tensor-parallel stages against the
JAX package's at (pod=2, model=4), on the CPU.

One JAX subprocess with eight host devices runs JAX's unedited
``make_split_pipeline`` and ``make_decode_pipeline`` on a
``jax.sharding.Mesh``-built (pod=2, model=4) mesh (never
``jax.make_mesh``, whose Explicit axes JAX's pipeline cannot slice under
jax 0.9), and ``SplitModelBank.runner(1, cloud_mp=4)`` on the first four
devices, and saves the references with the weights it made.  Then four
spawned port ranks (``repro_torch.models.parallel.spawn``, gloo, a
``FileStore`` rendezvous) load the same weights through
``repro_torch.bridge`` and run the port's counterparts, each rank holding
its quarter of the heads, kv heads, d_ff columns and experts of both pods:

  * the split (prefill) pipeline, int8 wire, for dense qwen3 (8 heads, 4 kv
    heads), qwen3-moe (4 experts, top-2, capacity factor 100) and zamba2
    (its shared block sharded, Mamba2 replicated): last-token logits within
    atol 1e-5 * max(1, max|ref|) and the same argmax;
  * the decode pipeline, int8, for dense and MoE, with ``use_kernel`` and
    ``overlap_psum`` each off and on: identical greedy ids;
  * the bank with an edge of degree 1 and a cloud of degree 4: the edge's
    int8 codes exact, the cloud half's logits within the bound with the
    same argmax, and the engine's greedy ids equal, both through its own
    prefill and through the edge and cloud halves' caches handed to it
    (the edge's whole cache cut to each rank's kv heads); and an edge of
    degree 2 handing its cache to a degree-1 engine (each rank gathers its
    pair's kv heads) serves the same ids.

Every rank returns the same results.  The quantized wire rounds each code
from f32 sums the two packages add in another order; a microbatch whose
logits miss the bound is settled as in ``test_torch_split_pipeline.py``:
its codes must hold between one and eight rounding ties, and JAX's own
degree-1 cloud stage on the port's codes must meet the bound.
"""
import functools
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core.quantization import quantize
from repro_torch.models import model as TM
from repro_torch.models import parallel
from repro_torch.models import transformer as ttfm
from repro_torch.models.common import embed
from repro_torch.runtime.split_exec import SplitModelBank
from repro_torch.serving import pipeline as spl

MMB, MB, S, T, D_R = 2, 2, 32, 4, 16
MP = 4
KINDS = ("dense", "moe", "zamba2")
DECODE = {"dense": ((False, False), (True, False), (False, True), (True, True)),
          "moe": ((False, False), (True, True))}
PROMPT = (np.arange(1, 13) * 7) % 512

CFG_CODE = r"""
import dataclasses
def cfg_of(get_config, kind):
    if kind == "moe":
        c = get_config("qwen3-moe-235b-a22b").reduced()
        c = dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, num_experts=4, top_k=2, capacity_factor=100.0))
    else:
        c = get_config("zamba2-7b" if kind == "zamba2" else "qwen3-8b").reduced()
        if kind == "zamba2":
            c = dataclasses.replace(c, num_layers=4)
    return dataclasses.replace(c, num_heads=8, num_kv_heads=4)
"""
exec(CFG_CODE)

JAX_CODE = CFG_CODE + r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                           "--xla_cpu_multi_thread_eigen=false "
                           "intra_op_parallelism_threads=1")
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh
from repro.configs import get_config
from repro.models import model as JM
from repro.runtime.split_exec import SplitModelBank
from repro.serving.pipeline import make_decode_pipeline, make_split_pipeline

out, MMB, MB, S, T, D_R = sys.argv[1], *map(int, sys.argv[2:7])
DECODE = eval(sys.argv[7])
mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("pod", "model"))
host = lambda t: jax.tree.map(np.asarray, t)
refs, trees = {}, {}
for kind in ("dense", "moe", "zamba2"):
    built = JM.build(cfg_of(get_config, kind).with_butterfly(layer=1, d_r=D_R))
    params, _ = JM.init_model(jax.random.key(0), built)
    toks = np.random.default_rng(1).integers(
        0, built.cfg.vocab_size, (MMB * MB, S)).astype(np.int32)
    trees[kind] = host(params)
    refs[f"split/{kind}"] = np.asarray(jax.jit(make_split_pipeline(
        built, mesh, MMB, S, MB))(params, toks))
    for uk, ov in DECODE.get(kind, ()):
        refs[f"decode/{kind}/{uk}/{ov}"] = np.asarray(jax.jit(
            make_decode_pipeline(built, mesh, MMB, S, MB, T, use_kernel=uk,
                                 overlap_psum=ov))(params, toks))
bank = SplitModelBank(cfg_of(get_config, "dense"), d_r=D_R)
r4 = bank.runner(1, cloud_mp=4)
prompt = ((np.arange(1, 13) * 7) % 512).astype(np.int32)
payload, scales, _ = r4.edge_half(r4.params, prompt[None])
logits, _ = r4.cloud_half(r4.params, payload, scales)
engine = r4.make_engine(max_batch=2, max_len=32)
req = engine.submit(prompt, max_new_tokens=6)
engine.run()
refs.update({"bank/codes": np.asarray(payload), "bank/logits": np.asarray(logits),
             "bank/ids": np.asarray(req.generated)})
trees["bank"] = host(bank.params)
trees["bank_butterfly"] = host(bank.butterfly_params(1))
np.savez(os.path.join(out, "refs.npz"), **refs)
with open(os.path.join(out, "weights.pkl"), "wb") as f:
    pickle.dump(trees, f)
print("REFS_OK")
"""


@functools.lru_cache(maxsize=None)
def _references(tmp: str):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    env.pop("XLA_FLAGS", None)
    res = subprocess.run(
        [sys.executable, "-c", JAX_CODE, tmp,
         *map(str, (MMB, MB, S, T, D_R)), repr(DECODE)],
        env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0 and "REFS_OK" in res.stdout, res.stderr[-3000:]
    refs = dict(np.load(os.path.join(tmp, "refs.npz")))
    with open(os.path.join(tmp, "weights.pkl"), "rb") as f:
        return refs, pickle.load(f)


def _edge_codes(built, params, pods, toks):
    """The port's degree-4 edge stage of each microbatch: codes, scales and
    r / scale, for settling rounding ties."""
    p_edge, _ = spl.pod_params(built, params, pods)
    out = []
    for k in range(MMB):
        x = embed(p_edge["embed"], torch.from_numpy(toks[k * MB:(k + 1) * MB]))
        x, _, _ = ttfm.apply_stage(list(built.stages[0]), p_edge["stages"][0],
                                   x, cfg=built.cfg, mode="train",
                                   stage_cache=None, pos=None,
                                   pctx=pods[0].pctx,
                                   shared_params=p_edge.get("shared_attn"))
        r = x @ p_edge["butterfly"]["w_reduce"]
        codes, scales = quantize(r, 8)
        out.append((codes.numpy(), scales.numpy(), (r / scales).numpy()))
    return out


def _port_rank(rank, device, trees):
    pods = (("cpu",) * MP, ("cpu",) * MP)
    out = {}
    for kind in KINDS:
        built = TM.build(cfg_of(get_config, kind).with_butterfly(layer=1, d_r=D_R))
        params = bridge.to_torch(trees[kind], device="cpu")
        toks = np.random.default_rng(1).integers(
            0, built.cfg.vocab_size, (MMB * MB, S))
        out[f"split/{kind}"] = spl.make_split_pipeline(
            built, pods, MMB, S, MB)(params, toks).numpy()
        out[f"codes/{kind}"] = _edge_codes(built, params,
                                           spl.make_pods(pods), toks)
        for uk, ov in DECODE.get(kind, ()):
            out[f"decode/{kind}/{uk}/{ov}"] = spl.make_decode_pipeline(
                built, pods, MMB, S, MB, T, use_kernel=uk,
                overlap_psum=ov)(params, toks).numpy()
    bank = SplitModelBank(cfg_of(get_config, "dense"), D_R, device="cpu",
                          params=bridge.to_torch(trees["bank"], device="cpu"),
                          butterfly={1: bridge.to_torch(trees["bank_butterfly"],
                                                        device="cpu")})
    r4 = bank.runner(1, cloud_mp=MP)
    payload, scales, cache0 = r4.edge_half(r4.params, PROMPT[None])
    logits, cache1 = r4.cloud_half(r4.params, payload, scales)
    engine = r4.make_engine(max_batch=2, max_len=32)
    req = engine.submit(PROMPT, max_new_tokens=6)
    handed = engine.submit_prefilled(len(PROMPT), [cache0, cache1], logits[0],
                                     max_new_tokens=6)
    engine.run()
    # an edge of degree 2 (ranks {0, 1} and {2, 3}) handing its cache to a
    # degree-1 engine: each rank gathers the edge's kv heads of its pair
    r21 = bank.runner(1, edge_mp=2, cloud_mp=1)
    payload2, scales2, edge2 = r21.edge_half(r21.params, PROMPT[None])
    logits2, cloud1 = r21.cloud_half(r21.params, payload2, scales2)
    whole = r21.make_engine(max_batch=1, max_len=32)
    gathered = whole.submit_prefilled(len(PROMPT), [edge2, cloud1],
                                      logits2[0], max_new_tokens=6)
    whole.run()
    out.update({"bank/gathered_ids": np.asarray(gathered.generated),
                "bank/edge2_kv_heads": edge2[0][0]["kv"]["k"].shape[3]})
    out.update({"bank/codes": payload.numpy(), "bank/logits": logits.numpy(),
                "bank/ids": np.asarray(req.generated),
                "bank/handoff_ids": np.asarray(handed.generated),
                "bank/kv_heads": tuple(cache0[0][0]["kv"]["k"].shape[3:4]) +
                tuple(cache1[0][0]["kv"]["k"].shape[3:4])})
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    refs, trees = _references(str(tmp_path_factory.mktemp("mp_refs")))
    ranks = parallel.spawn(_port_rank, MP, (trees,))
    return refs, trees, ranks


def _jax_cloud(trees, kind):
    """JAX's degree-1 cloud stage of the split pipeline (jitted, one
    device): what a microbatch whose codes rounded apart is held to."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.core.quantization import dequantize
    from repro.models import model as JM
    from repro.models import transformer as jtfm
    from repro.models.common import rms_norm, unembed
    from repro.models.parallel import LOCAL
    built = JM.build(cfg_of(jget, kind).with_butterfly(layer=1, d_r=D_R))
    params = jax.tree.map(jnp.asarray, trees[kind])
    cfg = built.cfg

    @jax.jit
    def cloud(codes, scales):
        x = dequantize(codes, scales, jnp.float32) @ params["butterfly"]["w_restore"]
        x, _, _ = jtfm.apply_stage(list(built.stages[1]), params["stages"][1], x,
                                   cfg=cfg, pctx=LOCAL, mode="train",
                                   stage_cache=None, pos=None,
                                   shared_params=params.get("shared_attn"))
        x = rms_norm(x[:, -1:], params["final_norm"], cfg.rms_eps)
        table = params["embed"] if cfg.tie_embeddings else params["head"]
        return unembed(table, x)[:, 0]
    return cloud


@pytest.mark.subprocess
@pytest.mark.parametrize("kind", KINDS)
def test_split_pipeline_matches_jax_pod_model(runs, kind):
    refs, trees, ranks = runs
    want = refs[f"split/{kind}"]
    got = ranks[0][f"split/{kind}"]
    for r in ranks[1:]:
        assert np.array_equal(r[f"split/{kind}"], got)
    assert got.shape == want.shape
    bound = 1e-5 * max(1.0, float(np.abs(want).max()))
    assert (got.argmax(-1) == want.argmax(-1)).all()
    for k in range(MMB):
        rows = slice(k * MB, (k + 1) * MB)
        if np.abs(got[rows] - want[rows]).max() <= bound:
            continue
        codes, scales, q = ranks[0][f"codes/{kind}"][k]
        ties = np.abs(np.abs(q) - np.floor(np.abs(q)) - 0.5) < 1e-3
        assert 0 < ties.sum() <= 8, (kind, k, int(ties.sum()))
        jax_on_port = np.asarray(_jax_cloud(trees, kind)(codes, scales))
        assert np.abs(jax_on_port - got[rows]).max() <= bound, (kind, k)


@pytest.mark.subprocess
@pytest.mark.parametrize("setting", [(kind, uk, ov) for kind in DECODE
                                     for uk, ov in DECODE[kind]],
                         ids=lambda s: f"{s[0]}-kernel{int(s[1])}-overlap{int(s[2])}")
def test_decode_pipeline_matches_jax_pod_model(runs, setting):
    refs, _, ranks = runs
    key = "decode/{}/{}/{}".format(*setting)
    for r in ranks:
        assert np.array_equal(r[key], refs[key]), (setting, r[key], refs[key])


@pytest.mark.subprocess
def test_bank_cloud_mp_matches_jax(runs):
    refs, _, ranks = runs
    for r in ranks:
        assert r["bank/kv_heads"] == (4, 1)         # edge whole, cloud 4 / 4
        assert np.array_equal(r["bank/codes"], refs["bank/codes"])
        want = refs["bank/logits"]
        bound = 1e-5 * max(1.0, float(np.abs(want).max()))
        assert np.abs(r["bank/logits"] - want).max() <= bound
        assert (r["bank/logits"].argmax(-1) == want.argmax(-1)).all()
        assert list(r["bank/ids"]) == list(refs["bank/ids"])
        assert list(r["bank/handoff_ids"]) == list(refs["bank/ids"])
        assert r["bank/edge2_kv_heads"] == 2
        assert list(r["bank/gathered_ids"]) == list(refs["bank/ids"])
