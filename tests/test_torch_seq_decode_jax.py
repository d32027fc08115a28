"""Decode over sequence-sharded caches, and the whole-head automatic layout,
against the JAX package's, on the CPU.

One JAX subprocess with eight host devices runs JAX's unedited
``forward_decode`` under ``jit`` on a ``Mesh``-built (data=2, model=2) mesh,
with ``in_shardings`` from ``decode_state_specs(seq_axis=)`` as the JAX dry
run builds them: the caches' length sharded over ``model`` with a batch of
4 (2 a data block), and over ``("data", "model")`` with a batch of 1.  Its
caches come from a jitted ``forward_prefill`` of a 20-token prompt,
zero-padded to a capacity of 32 (a ring keeps its window's rows).  Then
four spawned port ranks (gloo) load the same weights, take their shards
(``param_specs(built, grid)``), prefill under sequence-sharded caches (the
batch of 4 through ``REPRO_PREFILL_CACHE_SHARDED=1``, the batch of 1 under
``for_cache(("data", "model"))``), pad them (``pad_decode_caches``) and
decode 3 greedy steps.  Reduced configs in f32, each with a layout the
rule picks at a model axis of 2:

  * qwen3 with 4 q heads over 1 kv head: q sharded, kv replicated, each
    rank reading kv head 0;
  * qwen3 with 3 q heads: the whole attention replicated;
  * gemma3 with a 16-position window: a ring that wraps in the prompt and
    in decode;
  * zamba2: Mamba2 state beside the shared attention block;
  * whisper: cross attention over replicated-batch encoder caches.

The kv-replicated and ring cases also decode ragged rows from the same
prefill under the ``model``-sharded caches: row b at position ``20 + step
+ OFFSETS[b]``, offsets (0, -7, 3, -9) (the serving engine's ragged
decode).  Each data block's two rows then write slots in different blocks
of the length, in the global caches (16 slots a block: positions 11-25)
and on the ring (8 slots a block: slots 4-15), and on the ring at
different ages.

Bounds: logits within atol 1e-5 * max(1, max|ref|), the greedy ids
identical, each rank's block of every cache leaf (cut from JAX's final
caches by ``decode_state_specs``' specs) within the same bound.  Then 3
train steps of the kv-replicated layout across the ranks against JAX's
jitted step, at ``test_torch_training.py``'s bounds as
``test_torch_automatic_jax.py`` holds them.
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
from repro_torch.configs import InputShape, get_config
from repro_torch.data import shard_batch
from repro_torch.models import model as TM
from repro_torch.models import parallel
from repro_torch.training import (AdamWConfig, adamw_init, cosine_schedule,
                                  make_train_step)
from repro_torch.tree import tree_leaves, tree_map

CASES = {"kv_replicated": ("qwen3-8b", {"num_kv_heads": 1}),
         "replicated": ("qwen3-8b", {"num_heads": 3, "num_kv_heads": 1}),
         "ring": ("gemma3-12b", {"sliding_window": 16}),
         "zamba2": ("zamba2-7b", {}),
         "whisper": ("whisper-base", {})}
SEQS = {"m": ("model", 4), "dm": (("data", "model"), 1)}
# the cases that also decode ragged rows over the "model"-sharded caches,
# and each row's offset from the aligned position
RAGGED = ("kv_replicated", "ring")
OFFSETS = (0, -7, 3, -9)
GRID = ((2, 2), ("data", "model"))
PROMPT, CAP, STEPS, TRAIN_STEPS, TRAIN_B, TRAIN_S = 20, 32, 3, 3, 4, 16

CFG_CODE = r"""
import dataclasses
def case_cfg(get_config, arch, over):
    return dataclasses.replace(get_config(arch).reduced(), dtype="float32", **over)
"""
exec(CFG_CODE)

JAX_CODE = CFG_CODE + r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                           "--xla_cpu_multi_thread_eigen=false "
                           "--xla_backend_optimization_level=0 "
                           "--xla_llvm_disable_expensive_passes=true "
                           "intra_op_parallelism_threads=1")
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import InputShape, get_config
from repro.data.pipeline import lm_batches
from repro.models import model as JM
from repro.models.parallel import make_context
from repro.training.optimizer import AdamWConfig, adamw_init, cosine_schedule
from repro.training.train_loop import make_loss_fn, make_train_step

out = sys.argv[1]
CASES, SEQS, RAGGED = eval(sys.argv[2]), eval(sys.argv[3]), eval(sys.argv[10])
OFFSETS = np.asarray(eval(sys.argv[11]))
PROMPT, CAP, STEPS, TRAIN_STEPS, TRAIN_B, TRAIN_S = map(int, sys.argv[4:10])
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
pctx = make_context(mesh)
host = lambda t: jax.tree.map(np.asarray, t)
sh = lambda specs: jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                                is_leaf=lambda s: isinstance(s, P))
refs, trees = {}, {}


def pad(built, caches):
    # global caches to CAP rows, ring caches to min(CAP, window)
    out = []
    for segs, stage in zip(built.stages, caches):
        st = []
        for seg, unit in zip(segs, stage):
            u = []
            for ldef, c in zip(seg.unit, unit):
                if ldef.mixer == "attn":
                    rows = min(CAP, ldef.window) if ldef.window else CAP
                    c = dict(c, kv={k: jnp.pad(a, [(0, 0), (0, 0), (0, rows - a.shape[2]),
                                                   (0, 0), (0, 0)])
                                    for k, a in c["kv"].items()})
                u.append(c)
            st.append(u)
        out.append(st)
    return out


for name, (arch, over) in CASES.items():
    cfg = case_cfg(get_config, arch, over)
    built = JM.build(cfg)
    params, pspecs = JM.init_model(jax.random.key(0), built)
    trees[name] = host(params)
    prefill = jax.jit(lambda p, b: JM.forward_prefill(p, built, b, pctx))
    for kind, (seq_axis, B) in SEQS.items():
        rng = np.random.default_rng(3)
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)}
        if cfg.is_encdec:
            batch["frames"] = rng.standard_normal(
                (B, cfg.encoder_frames, cfg.d_model)).astype(np.float32)
        key = f"{name}/{kind}"
        for k, v in batch.items():
            refs[f"{key}/batch/{k}"] = v
        logits, caches = prefill(params, batch)
        refs[f"{key}/prefill"] = np.asarray(logits)
        shape = InputShape("d", CAP, B, "decode")
        _, cspecs = JM.decode_state_specs(built, shape, pctx, seq_axis=seq_axis)
        _, bspec = JM.input_specs(built, shape, pctx)
        dec = jax.jit(lambda p, t, c, pos: JM.forward_decode(p, built, t, c, pos, pctx),
                      in_shardings=(sh(pspecs), NamedSharding(mesh, bspec["tokens"]),
                                    sh(cspecs), None),
                      out_shardings=(None, sh(cspecs)))
        caches = pad(built, caches)
        first = np.asarray(logits)[:, -1].argmax(-1)[:, None].astype(np.int32)
        runs = [("", caches, 0)]
        if kind == "m" and name in RAGGED:
            runs.append(("/ragged", caches, 1))
        for tag, caches, ragged in runs:
            tok = first
            steps, ids = [], []
            for i in range(STEPS):
                pos = PROMPT + i + OFFSETS if ragged else PROMPT + i
                lg, caches = dec(params, tok, caches, jnp.asarray(pos, jnp.int32))
                steps.append(np.asarray(lg))
                tok = np.asarray(lg)[:, -1].argmax(-1)[:, None].astype(np.int32)
                ids.append(tok[:, 0])
            refs[f"{key}{tag}/decode"] = np.stack(steps)
            refs[f"{key}{tag}/ids"] = np.stack(ids)
            trees[f"{key}{tag}/caches"] = host(caches)

# three train steps of the kv-replicated layout
built = JM.build(case_cfg(get_config, *CASES["kv_replicated"]).with_butterfly(1, 16, rate_weight=0.01))
params, pspecs = JM.init_model(jax.random.key(0), built)
trees["train"] = host(params)
ospecs = {"mu": pspecs, "nu": pspecs, "step": P()}
_, bspec = JM.input_specs(built, InputShape("t", TRAIN_S, TRAIN_B, "train"), pctx)
train_step = make_train_step(built, AdamWConfig(lr=cosine_schedule(1e-3, 3, TRAIN_STEPS)), pctx)
loss_fn = make_loss_fn(built, pctx)
step = jax.jit(lambda p, o, b: (train_step(p, o, b), jax.grad(lambda q: loss_fn(q, b)[0])(p)),
               in_shardings=(sh(pspecs), sh(ospecs), sh(bspec)),
               out_shardings=((sh(pspecs), sh(ospecs), None), sh(pspecs)))
opt = adamw_init(params)
stream = lm_batches(built.cfg.vocab_size, TRAIN_S, TRAIN_B, seed=1)
metrics, near0 = [], None
for i in range(TRAIN_STEPS):
    raw = next(stream)
    refs[f"train/{i}/tokens"], refs[f"train/{i}/targets"] = raw["tokens"], raw["targets"]
    (params, opt, m), g = step(params, opt, raw)
    g = jax.tree.map(lambda a: np.abs(np.asarray(a)) <= 1e-5 * np.abs(np.asarray(a)).max(), g)
    near0 = g if near0 is None else jax.tree.map(np.logical_or, near0, g)
    metrics.append({k: float(v) for k, v in m.items()})
trees["stepped"], trees["near0"], trees["metrics"] = host(params), near0, metrics
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
        [sys.executable, "-c", JAX_CODE, tmp, repr(CASES), repr(SEQS),
         *map(str, (PROMPT, CAP, STEPS, TRAIN_STEPS, TRAIN_B, TRAIN_S)),
         repr(RAGGED), repr(OFFSETS)],
        env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0 and "REFS_OK" in res.stdout, res.stderr[-3000:]
    refs = dict(np.load(os.path.join(tmp, "refs.npz")))
    with open(os.path.join(tmp, "weights.pkl"), "rb") as f:
        return refs, pickle.load(f)


def _rank(rank, device, refs, trees):
    """One rank of the (data=2, model=2) grid: every case's prefill and
    decode at both cache layouts, then the train steps."""
    grid = parallel.RankGrid(*GRID)
    base = parallel.make_context(grid)
    out = {}
    for name, (arch, over) in CASES.items():
        built = TM.build(case_cfg(get_config, arch, over))
        params = parallel.shard_grid(bridge.to_torch(trees[name], device="cpu"),
                                     TM.param_specs(built, grid), grid)
        for kind, (seq_axis, B) in SEQS.items():
            key = f"{name}/{kind}"
            pctx = base.for_batch(B)
            batch = shard_batch({k: refs[f"{key}/batch/{k}"] for k in
                                 ("tokens", "frames") if f"{key}/batch/{k}" in refs},
                                pctx, device="cpu")
            if kind == "m":
                # the JAX dry run's option: the prefill's caches come out
                # batch -> data, seq -> model
                os.environ["REPRO_PREFILL_CACHE_SHARDED"] = "1"
                logits, caches = TM.forward_prefill(params, built, batch, pctx)
                del os.environ["REPRO_PREFILL_CACHE_SHARDED"]
                pctx = pctx.for_cache(seq_axis)
            else:
                pctx = pctx.for_cache(seq_axis)
                logits, caches = TM.forward_prefill(params, built, batch, pctx)
            out[f"{key}/prefill"] = logits.numpy()
            caches = TM.pad_decode_caches(built, caches, CAP, pctx)
            runs = [("", caches, 0)]
            if kind == "m" and name in RAGGED:
                # decode updates the caches in place: the ragged run gets
                # its own copy of the prefill's
                runs.append(("/ragged", tree_map(torch.clone, caches), 1))
            # this rank's rows of the global batch
            b0 = grid.coords(rank)["data"] * 2 if B > 1 else 0
            for tag, caches, ragged in runs:
                tok = logits[:, -1].argmax(-1, keepdim=True)
                steps, ids = [], []
                for i in range(STEPS):
                    pos = PROMPT + i + torch.tensor(
                        OFFSETS[b0:b0 + tok.shape[0]]) if ragged else PROMPT + i
                    lg, caches = TM.forward_decode(params, built, tok, caches,
                                                   pos, pctx)
                    steps.append(lg.numpy())
                    tok = lg[:, -1].argmax(-1, keepdim=True)
                    ids.append(tok[:, 0].numpy())
                out[f"{key}{tag}/decode"] = np.stack(steps)
                out[f"{key}{tag}/ids"] = np.stack(ids)
                out[f"{key}{tag}/caches"] = _keyed(tree_map(
                    lambda a: a.numpy().copy(), caches))

    built = TM.build(case_cfg(get_config, *CASES["kv_replicated"]).with_butterfly(
        1, 16, rate_weight=0.01))
    params = tree_map(torch.clone, parallel.shard_grid(
        bridge.to_torch(trees["train"], device="cpu"), TM.param_specs(built, grid),
        grid))
    step = make_train_step(built, AdamWConfig(lr=cosine_schedule(1e-3, 3, TRAIN_STEPS)),
                           base)
    opt = adamw_init(params)
    metrics = []
    for i in range(TRAIN_STEPS):
        batch = shard_batch({k: refs[f"train/{i}/{k}"] for k in ("tokens", "targets")},
                            base, device="cpu")
        params, opt, m = step(params, opt, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    out["train/metrics"] = metrics
    out["train/stepped"] = [t.numpy() for t in tree_leaves(params)]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    refs, trees = _references(str(tmp_path_factory.mktemp("seq_refs")))
    return refs, trees, parallel.spawn(_rank, 4, (refs, trees))


def _keyed(tree, path=()) -> dict:
    """A tree's leaves by their path (dict keys and list indices)."""
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _keyed(tree[key], path + (key,)).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, t in enumerate(tree) for k, v in _keyed(t, path + (i,)).items()}
    return {} if tree is None else {path: tree}


def _bound(want) -> float:
    return 1e-5 * max(1.0, float(np.abs(want).max()))


def _check_decode(runs, name, kind, tag=""):
    refs, trees, ranks = runs
    grid = parallel.RankGrid(*GRID)
    _, B = SEQS[kind]
    key = f"{name}/{kind}"
    built = TM.build(case_cfg(get_config, *CASES[name]))
    pctx = parallel.ParallelContext(grid=grid, data_axes=("data",))
    _, specs = TM.decode_state_specs(built, InputShape("d", CAP, B, "decode"),
                                     pctx, seq_axis=SEQS[kind][0])
    want_caches = bridge.to_torch(trees[f"{key}{tag}/caches"], device="cpu")
    for r, out in enumerate(ranks):
        rows = slice(0, 1) if B == 1 else slice(grid.coords(r)["data"] * 2,
                                                grid.coords(r)["data"] * 2 + 2)
        for what in ("/prefill", tag + "/decode"):
            want = refs[f"{key}{what}"]
            want = want[rows] if what == "/prefill" else want[:, rows]
            np.testing.assert_allclose(out[f"{key}{what}"], want, rtol=0,
                                       atol=_bound(want))
        assert np.array_equal(out[f"{key}{tag}/ids"], refs[f"{key}{tag}/ids"][:, rows])
        blocks = _keyed(parallel.shard_grid(want_caches, specs, grid, rank=r))
        got = out[f"{key}{tag}/caches"]
        assert set(got) == set(blocks)
        for path, want in blocks.items():
            assert got[path].shape == tuple(want.shape), path
            np.testing.assert_allclose(got[path], want.numpy(), rtol=0,
                                       atol=_bound(want.numpy()), err_msg=str(path))


@pytest.mark.subprocess
@pytest.mark.parametrize("kind", SEQS)
@pytest.mark.parametrize("name", CASES)
def test_seq_sharded_decode_matches_jax(runs, name, kind):
    _check_decode(runs, name, kind)


@pytest.mark.subprocess
@pytest.mark.parametrize("name", RAGGED)
def test_seq_sharded_ragged_decode_matches_jax(runs, name):
    """Ragged rows (a (B,) position, row b at 20 + b + step) over caches
    sharded on ``model``, against JAX's ``forward_decode`` under the same
    ``decode_state_specs(seq_axis="model")`` shardings."""
    _check_decode(runs, name, "m", "/ragged")


@pytest.mark.subprocess
def test_kv_replicated_train_steps_match_jax(runs):
    _, trees, ranks = runs
    grid = parallel.RankGrid(*GRID)
    built = TM.build(case_cfg(get_config, *CASES["kv_replicated"]).with_butterfly(
        1, 16, rate_weight=0.01))
    specs = TM.param_specs(built, grid)
    assert specs["model"]["stages"][0][0][0]["mixer"] == {
        "wq": 2, "wk": None, "wv": None, "wo": 1, "q_norm": None, "k_norm": None}
    stepped = bridge.to_torch(trees["stepped"], device="cpu")
    near0 = bridge.to_torch(trees["near0"], device="cpu")
    for r, out in enumerate(ranks):
        for got, want in zip(out["train/metrics"], trees["metrics"]):
            for k in ("loss", "grad_norm", "wire_rate_bits", "total"):
                np.testing.assert_allclose(got[k], want[k], rtol=1e-3)
        want = tree_leaves(parallel.shard_grid(stepped, specs, grid, rank=r))
        zero = tree_leaves(parallel.shard_grid(near0, specs, grid, rank=r))
        assert len(want) == len(out["train/stepped"])
        for g, w, z in zip(out["train/stepped"], want, zero):
            miss = np.abs(g - w.numpy()) > 5e-4
            assert miss.sum() <= 8 and z.numpy()[miss].all(), r
            np.testing.assert_allclose(g, w.numpy(), rtol=0,
                                       atol=2 * 1e-3 * TRAIN_STEPS)
    losses = [m["loss"] for m in ranks[0]["train/metrics"]]
    assert losses[-1] < losses[0]
