"""The automatic regime (data axes beside the model axis, MoE's expert
parallelism, the train step across ranks) against the JAX package's, on
the CPU.

One JAX subprocess with eight host devices runs JAX's unedited functions
under ``make_context(mesh)`` on meshes built as
``jax.sharding.Mesh(np.array(jax.devices()).reshape(...), axes)`` (never
``jax.make_mesh``, whose Explicit axes JAX's code cannot slice under jax
0.9), and saves the references with the weights it made.  Then spawned
port ranks (``repro_torch.models.parallel.spawn``, gloo) load the same
weights through ``repro_torch.bridge``, take their shards
(``parallel.shard_grid``) and their blocks of the batch
(``data.pipeline.shard_batch``), and run the port's counterparts:

  * (a) ``apply_moe`` at (data=2, model=2): the train path (4, 8), the
    decode broadcast (8, 1) and a batch smaller than the data axes (1, 8),
    at capacity factors 100 (nothing drops) and 1.25 (choices drop, and a
    data shard competes for capacity alone).  The small batch is held to
    JAX's local ``apply_moe``: JAX's branch does not trace it under jax
    0.9 (``shard_map``'s replication check refuses its out_specs), and
    held whole on every rank it means the local path;
  * (b) the same at (pod=2, data=2, model=2) with ``EXPERTS_OVER_POD``
    (set in the environment the ranks inherit).  Its decode path is held
    to JAX's local ``apply_moe`` of all the tokens: JAX's branch sums that
    path over ``model`` and ``data`` only and so drops the other pod's
    experts, a limit of the reference (ROADMAP section 3);
  * (c) the model API at (data=2, model=2), JAX's jitted with
    ``in_shardings`` from ``init_model``'s specs and ``input_specs`` as the
    dry run builds them: ``forward_train``, ``forward_prefill`` of 12
    tokens and 4 greedy ``forward_decode`` steps, for reduced qwen3-moe (4
    experts, top-2, the default capacity factor) and reduced dense qwen3,
    both with 8 heads and 4 kv heads;
  * (d) 3 steps of ``make_train_step(built, opt, pctx)``, JAX's jitted with
    the dry run's param, optimizer and batch shardings, for the same two
    configs with a butterfly and its rate term, one row's targets masked
    (the loss is the global masked mean).

Bounds: f32 outputs and logits within atol 1e-5 * max(1, max|ref|); the
experts chosen for every token, and the greedy ids, identical; the aux
losses within rtol 1e-5; the train steps' losses, rates, totals and grad
norms within rtol 1e-3 and each rank's updated shards within 5e-4 of
JAX's, the bounds ``test_torch_training.py`` holds one rank to.  The
gradients agree within a few 1e-6 of each leaf's largest, and Adam steps
by about the learning rate whatever a gradient's size, so an entry whose
gradient lies within 1e-5 of its leaf's largest of zero at some step
moves by up to 2 * lr a step in either package, by the sign of the sums'
rounding: at most 8 such entries a leaf may miss 5e-4, by at most
2 * 1e-3 * 3 (the steps' lr sum, doubled).
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
from repro_torch.data import shard_batch
from repro_torch.models import model as TM
from repro_torch.models import moe as tmoe
from repro_torch.models import parallel
from repro_torch.training import (AdamWConfig, adamw_init, cosine_schedule,
                                  make_train_step)
from repro_torch.tree import tree_leaves, tree_map

CFS = (100.0, 1.25)
SHAPES = {"train": (4, 8), "decode": (8, 1), "small": (1, 8)}
LAYOUTS = {"dm": ((2, 2), ("data", "model")),
           "pdm": ((2, 2, 2), ("pod", "data", "model"))}
KINDS = ("dense", "moe")
B, S, PROMPT, T, STEPS = 4, 16, 12, 4, 3

CFG_CODE = r"""
import dataclasses
def moe_cfg(get_config, cf):
    c = get_config("qwen3-moe-235b-a22b").reduced()
    return dataclasses.replace(c, moe=dataclasses.replace(
        c.moe, num_experts=4, top_k=2, capacity_factor=cf, d_ff_expert=128))
def model_cfg(get_config, kind, train):
    c = get_config("qwen3-moe-235b-a22b" if kind == "moe" else "qwen3-8b").reduced()
    c = dataclasses.replace(c, num_heads=8, num_kv_heads=4)
    if c.moe is not None:
        c = dataclasses.replace(c, moe=dataclasses.replace(c.moe, num_experts=4, top_k=2))
    return c.with_butterfly(1, 16, rate_weight=0.01) if train else c
"""
exec(CFG_CODE)

JAX_CODE = CFG_CODE + r"""
import os, pickle, sys
# compiling dominates at these sizes: a lower backend optimisation level
# compiles faster and computes the same functions
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
from repro.models import moe as jmoe
from repro.models.parallel import LOCAL, make_context
from repro.training.optimizer import AdamWConfig, adamw_init, cosine_schedule
from repro.training.train_loop import make_loss_fn, make_train_step

out = sys.argv[1]
CFS, SHAPES = eval(sys.argv[2]), eval(sys.argv[3])
B, S, PROMPT, T, STEPS = map(int, sys.argv[4:9])
devs = np.array(jax.devices())
meshes = {"dm": Mesh(devs[:4].reshape(2, 2), ("data", "model")),
          "pdm": Mesh(devs.reshape(2, 2, 2), ("pod", "data", "model"))}
host = lambda t: jax.tree.map(np.asarray, t)
sh = lambda mesh, specs: jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                                      is_leaf=lambda s: isinstance(s, P))
shard = lambda mesh, tree, specs: jax.device_put(tree, sh(mesh, specs))
refs, trees = {}, {}

# (a), (b): the MoE layer
rng = np.random.default_rng(1)
for name, (b, s) in SHAPES.items():
    refs[f"x/{name}"] = (rng.standard_normal((b, s, 256)) * 0.5).astype(np.float32)
for cf in CFS:
    cfg = moe_cfg(get_config, cf)
    params, _ = jmoe.init_moe(jax.random.key(0), cfg, jnp.float32)
    trees[f"moe/{cf}"] = host(params)
    for lay, mesh in meshes.items():
        jmoe.EXPERTS_OVER_POD = lay == "pdm"
        pctx = make_context(mesh)
        e = ("pod", "model") if lay == "pdm" else "model"
        specs = {"router": P(None, None), "wg": P(e, None, "data"),
                 "wu": P(e, None, "data"), "wd": P(e, "data", None)}
        p = shard(mesh, params, specs)
        fn = jax.jit(lambda p, x: jmoe.apply_moe(p, x, cfg=cfg, pctx=pctx,
                                                 act="silu"))
        for name, (b, s) in SHAPES.items():
            x = refs[f"x/{name}"]
            key = f"moe/{cf}/{lay}/{name}"
            if name == "small" or (lay == "pdm" and name == "decode"):
                o, aux = jmoe.apply_moe(params, jnp.asarray(x), cfg=cfg,
                                        pctx=LOCAL, act="silu")
            else:
                bx = pctx.batch_spec_axes() if b >= pctx.dp_size else None
                o, aux = fn(p, jax.device_put(x, NamedSharding(mesh, P(bx, None, None))))
            refs[key] = np.asarray(o)
            refs[key + "/aux"] = np.array([aux["load_balance"], aux["router_z"]])
        x = jnp.asarray(refs["x/train"]).reshape(-1, 256)
        refs[f"moe/{cf}/eids"] = np.asarray(jax.lax.top_k(jax.nn.softmax(
            x @ params["router"]), 2)[1])
jmoe.EXPERTS_OVER_POD = False

# (c), (d): the model API and the train step at (data=2, model=2)
mesh = meshes["dm"]
pctx = make_context(mesh)
for kind in ("dense", "moe"):
    built = JM.build(model_cfg(get_config, kind, False))
    params, pspecs = JM.init_model(jax.random.key(0), built)
    trees[f"model/{kind}"] = host(params)
    p_sh = sh(mesh, pspecs)
    toks = np.random.default_rng(2).integers(0, built.cfg.vocab_size,
                                             (B, S)).astype(np.int32)
    refs[f"tokens/{kind}"] = toks
    _, bspec = JM.input_specs(built, InputShape("t", S, B, "train"), pctx)
    logits, _ = jax.jit(lambda p, b: JM.forward_train(p, built, b, pctx),
                        in_shardings=(p_sh, sh(mesh, {"tokens": bspec["tokens"]})))(
        params, {"tokens": toks})
    refs[f"train/{kind}"] = np.asarray(logits)
    _, bspec = JM.input_specs(built, InputShape("p", PROMPT, B, "prefill"), pctx)
    logits, caches = jax.jit(lambda p, b: JM.forward_prefill(p, built, b, pctx),
                             in_shardings=(p_sh, sh(mesh, bspec)))(
        params, {"tokens": toks[:, :PROMPT]})
    refs[f"prefill/{kind}"] = np.asarray(logits)
    caches = jax.tree.map(lambda a: jnp.pad(
        a, [(0, 0), (0, 0), (0, PROMPT + T - a.shape[2]), (0, 0), (0, 0)]), caches)
    _, dspec = JM.input_specs(built, InputShape("d", PROMPT + T, B, "decode"), pctx)
    dec = jax.jit(lambda p, t, c, pos: JM.forward_decode(p, built, t, c, pos, pctx),
                  in_shardings=(p_sh, NamedSharding(mesh, dspec["tokens"]), None, None))
    tok = np.asarray(logits)[:, -1].argmax(-1)[:, None].astype(np.int32)
    steps, ids = [], []
    for i in range(T):
        lg, caches = dec(params, tok, caches, jnp.asarray(PROMPT + i, jnp.int32))
        steps.append(np.asarray(lg))
        tok = np.asarray(lg)[:, -1].argmax(-1)[:, None].astype(np.int32)
        ids.append(tok[:, 0])
    refs[f"decode/{kind}"] = np.stack(steps)
    refs[f"ids/{kind}"] = np.stack(ids)

    # (d): three train steps with the rate term
    built = JM.build(model_cfg(get_config, kind, True))
    params, pspecs = JM.init_model(jax.random.key(0), built)
    trees[f"train/{kind}"] = host(params)
    ospecs = {"mu": pspecs, "nu": pspecs, "step": P()}
    _, bspec = JM.input_specs(built, InputShape("t", S, B, "train"), pctx)
    train_step = make_train_step(built, AdamWConfig(
        lr=cosine_schedule(1e-3, 3, STEPS)), pctx)
    loss_fn = make_loss_fn(built, pctx)

    def step_and_grads(p, o, b):
        # one program for the step and its gradients (one compile)
        return train_step(p, o, b), jax.grad(lambda q: loss_fn(q, b)[0])(p)
    step = jax.jit(step_and_grads,
                   in_shardings=(sh(mesh, pspecs), sh(mesh, ospecs), sh(mesh, bspec)),
                   out_shardings=((sh(mesh, pspecs), sh(mesh, ospecs), None),
                                  sh(mesh, pspecs)))
    opt = adamw_init(params)
    stream = lm_batches(built.cfg.vocab_size, S, B, seed=1)
    metrics, near0 = [], None
    for i in range(STEPS):
        raw = next(stream)
        raw["targets"][0, :5] = -1               # rank 0's block counts fewer
        refs[f"batch/{kind}/{i}/tokens"] = raw["tokens"]
        refs[f"batch/{kind}/{i}/targets"] = raw["targets"]
        # the entries whose gradient lies within the packages' agreement of
        # zero: there the sign of Adam's step is the sums' rounding
        (params, opt, m), g = step(params, opt, raw)
        g = jax.tree.map(lambda a: np.abs(np.asarray(a)) <= 1e-5 * np.abs(
            np.asarray(a)).max(), g)
        near0 = g if near0 is None else jax.tree.map(np.logical_or, near0, g)
        metrics.append({k: float(v) for k, v in m.items()})
    trees[f"stepped/{kind}"] = host(params)
    trees[f"near0/{kind}"] = near0
    trees[f"metrics/{kind}"] = metrics
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
        [sys.executable, "-c", JAX_CODE, tmp, repr(CFS), repr(SHAPES),
         *map(str, (B, S, PROMPT, T, STEPS))],
        env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0 and "REFS_OK" in res.stdout, res.stderr[-3000:]
    refs = dict(np.load(os.path.join(tmp, "refs.npz")))
    with open(os.path.join(tmp, "weights.pkl"), "rb") as f:
        return refs, pickle.load(f)


def _layer_specs(over_pod: bool) -> dict:
    experts = {"wg": 0, "wu": 0, "wd": 0}
    return {"pod": experts if over_pod else None, "model": experts,
            "data": {"wg": 2, "wu": 2, "wd": 1}}


class _Eids:
    """The experts ``moe.route`` chose, call by call, while in the block."""

    def __enter__(self):
        self.route, self.eids = tmoe.route, []

        def route(*a, **k):
            out = self.route(*a, **k)
            self.eids.append(out[3].clone())
            return out
        tmoe.route = route
        return self

    def __exit__(self, *exc):
        tmoe.route = self.route


def _moe_runs(pctx, refs, trees, over_pod: bool) -> dict:
    out = {}
    for cf in CFS:
        cfg = moe_cfg(get_config, cf)
        params = parallel.shard_grid(bridge.to_torch(trees[f"moe/{cf}"], device="cpu"),
                                     _layer_specs(over_pod), pctx.grid)
        for name, (b, s) in SHAPES.items():
            x = shard_batch({"x": refs[f"x/{name}"]}, pctx, device="cpu")["x"]
            with _Eids() as r:
                o, aux = tmoe.apply_moe(params, x, cfg=cfg, act="silu",
                                        pctx=pctx.for_batch(b))
            key = f"{cf}/{name}"
            out[key] = o.numpy()
            out[key + "/aux"] = np.array([float(aux["load_balance"]),
                                          float(aux["router_z"])])
            out[key + "/eids"] = r.eids[0].numpy()
    return out


def _dm_rank(rank, device, refs, trees):
    """One rank of the (data=2, model=2) grid: (a), (c) and (d)."""
    grid = parallel.RankGrid(*LAYOUTS["dm"])
    pctx = parallel.make_context(grid)
    out = {"moe": _moe_runs(pctx, refs, trees, False)}
    for kind in KINDS:
        built = TM.build(model_cfg(get_config, kind, False))
        params = parallel.shard_grid(bridge.to_torch(trees[f"model/{kind}"],
                                                     device="cpu"),
                                     TM.param_specs(built), grid)
        toks = shard_batch({"t": refs[f"tokens/{kind}"]}, pctx, device="cpu")["t"]
        logits, _ = TM.forward_train(params, built, {"tokens": toks}, pctx)
        out[f"train/{kind}"] = logits.numpy()
        logits, caches = TM.forward_prefill(params, built,
                                            {"tokens": toks[:, :PROMPT]}, pctx)
        out[f"prefill/{kind}"] = logits.numpy()
        caches = TM.pad_decode_caches(built, caches, PROMPT + T, pctx)
        tok = logits[:, -1].argmax(-1, keepdim=True)
        steps, ids = [], []
        for i in range(T):
            lg, caches = TM.forward_decode(params, built, tok, caches,
                                           PROMPT + i, pctx)
            steps.append(lg.numpy())
            tok = lg[:, -1].argmax(-1, keepdim=True)
            ids.append(tok[:, 0].numpy())
        out[f"decode/{kind}"] = np.stack(steps)
        out[f"ids/{kind}"] = np.stack(ids)

        built = TM.build(model_cfg(get_config, kind, True))
        params = parallel.shard_grid(bridge.to_torch(trees[f"train/{kind}"],
                                                     device="cpu"),
                                     TM.param_specs(built), grid)
        params = tree_map(torch.clone, params)      # the step updates in place
        step = make_train_step(built, AdamWConfig(lr=cosine_schedule(1e-3, 3, STEPS)),
                               pctx)
        opt = adamw_init(params)
        metrics = []
        for i in range(STEPS):
            batch = shard_batch({k: refs[f"batch/{kind}/{i}/{k}"]
                                 for k in ("tokens", "targets")}, pctx, device="cpu")
            params, opt, m = step(params, opt, batch)
            metrics.append({k: float(v) for k, v in m.items()})
        out[f"metrics/{kind}"] = metrics
        out[f"stepped/{kind}"] = [t.numpy() for t in tree_leaves(params)]
    return out


def _pdm_rank(rank, device, refs, trees):
    """One rank of the (pod=2, data=2, model=2) grid with experts over the
    pod axis: (b)."""
    assert tmoe.EXPERTS_OVER_POD, "the ranks inherit REPRO_MOE_EXPERTS_OVER_POD"
    pctx = parallel.make_context(parallel.RankGrid(*LAYOUTS["pdm"]))
    return {"moe": _moe_runs(pctx, refs, trees, True)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    refs, trees = _references(str(tmp_path_factory.mktemp("auto_refs")))
    dm = parallel.spawn(_dm_rank, 4, (refs, trees))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_MOE_EXPERTS_OVER_POD", "1")
        pdm = parallel.spawn(_pdm_rank, 8, (refs, trees))
    return refs, trees, {"dm": dm, "pdm": pdm}


def _bound(want) -> float:
    return 1e-5 * max(1.0, float(np.abs(want).max()))


def _block_rows(grid, rank: int, n_rows: int, sharded: bool) -> slice:
    """The rows of a (B*S)-row global array that rank ``rank`` holds."""
    if not sharded:
        return slice(0, n_rows)
    at = grid.coords(rank)
    d = at["data"] + (at["pod"] * grid.axis_size("data") if "pod" in at else 0)
    n = n_rows // (grid.axis_size("pod") * grid.axis_size("data"))
    return slice(d * n, (d + 1) * n)


@pytest.mark.subprocess
@pytest.mark.parametrize("cf", CFS)
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("shape", SHAPES)
def test_moe_layer_matches_jax(runs, cf, layout, shape):
    refs, _, ranks = runs
    grid = parallel.RankGrid(*LAYOUTS[layout])
    dp = grid.axis_size("pod") * grid.axis_size("data")
    b, s = SHAPES[shape]
    want = refs[f"moe/{cf}/{layout}/{shape}"]
    want_aux = refs[f"moe/{cf}/{layout}/{shape}/aux"]
    eids = refs[f"moe/{cf}/eids"]
    for r, out in enumerate(ranks[layout]):
        key = f"{cf}/{shape}"
        rows = _block_rows(grid, r, b, b >= dp)
        np.testing.assert_allclose(out["moe"][key], want[rows], rtol=0,
                                   atol=_bound(want))
        np.testing.assert_allclose(out["moe"][key + "/aux"], want_aux, rtol=1e-5)
        if shape == "train":
            # the routes of the rank's tokens (both pods' under experts over
            # the pod axis)
            blocks = [_block_rows(grid, q, b * s, True) for q in
                      (grid.members("pod", r) if layout == "pdm" else [r])]
            assert np.array_equal(out["moe"][key + "/eids"],
                                  np.concatenate([eids[x] for x in blocks]))


@pytest.mark.subprocess
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("what", ("train", "prefill", "decode"))
def test_model_api_matches_jax(runs, kind, what):
    refs, _, ranks = runs
    grid = parallel.RankGrid(*LAYOUTS["dm"])
    want = refs[f"{what}/{kind}"]
    for r, out in enumerate(ranks["dm"]):
        rows = _block_rows(grid, r, B, True)
        got = out[f"{what}/{kind}"]
        if what == "decode":
            np.testing.assert_allclose(got, want[:, rows], rtol=0, atol=_bound(want))
            assert np.array_equal(out[f"ids/{kind}"], refs[f"ids/{kind}"][:, rows])
        else:
            np.testing.assert_allclose(got, want[rows], rtol=0, atol=_bound(want))
            assert np.array_equal(got[:, -1].argmax(-1), want[rows][:, -1].argmax(-1))


@pytest.mark.subprocess
@pytest.mark.parametrize("kind", KINDS)
def test_train_steps_match_jax(runs, kind):
    _, trees, ranks = runs
    grid = parallel.RankGrid(*LAYOUTS["dm"])
    built = TM.build(model_cfg(get_config, kind, True))
    stepped = bridge.to_torch(trees[f"stepped/{kind}"], device="cpu")
    for r, out in enumerate(ranks["dm"]):
        for got, want in zip(out[f"metrics/{kind}"], trees[f"metrics/{kind}"]):
            for k in ("loss", "grad_norm", "wire_rate_bits", "total"):
                np.testing.assert_allclose(got[k], want[k], rtol=1e-3)
            for k in ("load_balance", "router_z"):
                np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-7)
        want = tree_leaves(parallel.shard_grid(stepped, TM.param_specs(built),
                                               grid, rank=r))
        assert len(want) == len(out[f"stepped/{kind}"])
        near0 = tree_leaves(parallel.shard_grid(
            bridge.to_torch(trees[f"near0/{kind}"], device="cpu"),
            TM.param_specs(built), grid, rank=r))
        for g, w, z in zip(out[f"stepped/{kind}"], want, near0):
            miss = np.abs(g - w.numpy()) > 5e-4
            assert miss.sum() <= 8 and z.numpy()[miss].all(), (kind, r)
            np.testing.assert_allclose(g, w.numpy(), rtol=0, atol=2 * 1e-3 * STEPS)
    losses = [m["loss"] for m in ranks["dm"][0][f"metrics/{kind}"]]
    assert losses[-1] < losses[0]
