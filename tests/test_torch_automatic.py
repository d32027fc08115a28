"""The automatic regime's pieces without JAX, on the CPU: the rank grid and
its groups, the production and local grids, ``make_context``,
``shard_batch``, ``input_specs``, the automatic param specs, the
differentiable collectives, ``global_norm`` over shards and the train step
across ranks.

Four spawned ranks (``parallel.spawn``, gloo), one spawn, over three
grids of the same world: (data=2, model=2), (pod=2, data=1, model=2)
(with experts over the pod axis for ``global_norm``) and (data=4,
model=1).  Each collective's gradient is held to one process's autograd on the
whole tensors; ``global_norm`` over each rank's shards to the norm of the
whole tree; a dense model's train step across ranks to the local step on
the whole batch (the same numbers: only MoE's per-shard capacity changes
them), with one row's targets masked, under ``remat`` and ``accum_steps``
too, and with a batch smaller than the data axes.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import INPUT_SHAPES, InputShape, get_config
from repro_torch.data import shard_batch
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.models import parallel
from repro_torch.training import (AdamWConfig, adamw_init, constant_schedule,
                                  init_train_state, make_train_step,
                                  opt_state_specs)
from repro_torch.training.optimizer import global_norm
from repro_torch.tree import tree_map


@pytest.mark.parametrize("shape,axes", [((2, 2), ("data", "model")),
                                        ((2, 2, 2), ("pod", "data", "model")),
                                        ((2, 1, 4), ("pod", "data", "model")),
                                        ((16, 16), ("data", "model"))])
def test_grid_layout_is_numpys(shape, axes):
    grid = parallel.RankGrid(shape, axes)
    ranks = np.arange(grid.size).reshape(shape)
    assert np.array_equal(grid.ranks(), ranks)
    for r in range(grid.size):
        at = grid.coords(r)
        assert ranks[tuple(at[a] for a in axes)] == r
        for a in axes:
            # the ranks along one axis agree with r on every other axis
            sel = tuple(slice(None) if b == a else at[b] for b in axes)
            assert grid.members(a, r) == sorted(ranks[sel].tolist())
            assert grid.index(a, r) == at[a]
        assert grid.members(axes, r) == list(range(grid.size))
    assert grid.axis_size("absent") == 1 and grid.index("absent", 0) == 0


def test_grid_refusals():
    with pytest.raises(ValueError, match="pair up"):
        parallel.RankGrid((2, 2), ("data",))
    with pytest.raises(ValueError, match="pair up"):
        parallel.RankGrid((2, 2), ("data", "data"))
    with pytest.raises(ValueError, match="empty"):
        parallel.RankGrid((2, 0), ("data", "model"))
    # building the groups needs a world of the grid's size
    with pytest.raises(ValueError, match="needs 4 ranks"):
        parallel.make_context(parallel.RankGrid((2, 2), ("data", "model")))


def test_production_and_local_grids():
    single = mesh_lib.make_production_mesh()
    multi = mesh_lib.make_production_mesh(multi_pod=True)
    local = mesh_lib.make_local_mesh()
    assert (single.shape, single.axes) == ((16, 16), ("data", "model"))
    assert (multi.shape, multi.axes) == ((2, 16, 16), ("pod", "data", "model"))
    assert (local.shape, local.axes) == ((1, 1), ("data", "model"))
    assert [mesh_lib.mesh_chips(g) for g in (single, multi, local)] == [256, 512, 1]


def test_make_context_of_none_is_local():
    assert parallel.make_context(None) is parallel.LOCAL
    local = parallel.LOCAL
    assert not local.enabled and not local.automatic
    assert (local.dp_size, local.mp_size, local.batch_spec_axes()) == (1, 1, None)
    assert local.data_group is None and not local.tensor_parallel


def _ctx(shape, axes, rank):
    """An automatic context's data-axis view for ``rank``, built without a
    world (``shard_batch`` and ``input_specs`` read no group)."""
    grid = parallel.RankGrid(shape, axes)
    data_axes = tuple(a for a in axes if a in ("pod", "data"))
    at = grid.coords(rank)
    d = 0
    for a in data_axes:
        d = d * grid.axis_size(a) + at[a]
    return parallel.ParallelContext(grid=grid, data_axes=data_axes, data_rank=d)


def test_shard_batch_blocks_are_pod_major():
    batch = {"tokens": np.arange(8 * 3).reshape(8, 3),
             "patches": torch.arange(8 * 2.0).reshape(8, 2)}
    whole = shard_batch(batch, device="cpu")
    assert torch.equal(whole["tokens"], torch.from_numpy(batch["tokens"]))
    shape, axes = (2, 2, 2), ("pod", "data", "model")
    grid = parallel.RankGrid(shape, axes)
    for r in range(grid.size):
        at = grid.coords(r)
        block = at["pod"] * 2 + at["data"]
        got = shard_batch(batch, _ctx(shape, axes, r), device="cpu")
        assert torch.equal(got["tokens"], whole["tokens"][2 * block:2 * block + 2])
        assert torch.equal(got["patches"], batch["patches"][2 * block:2 * block + 2])
    ctx = _ctx(shape, axes, 5)
    assert ctx.batch_spec_axes() == ("pod", "data") and ctx.dp_size == 4
    # smaller than the data axes: whole on every rank, and its context says so
    small = {"tokens": np.arange(6).reshape(3, 2)}
    assert torch.equal(shard_batch(small, ctx, device="cpu")["tokens"],
                       torch.from_numpy(small["tokens"]))
    assert ctx.for_batch(3).replicated_batch and not ctx.for_batch(8).replicated_batch
    with pytest.raises(ValueError, match="does not split over 4"):
        shard_batch({"tokens": np.zeros((6, 2))}, ctx, device="cpu")
    with pytest.raises(ValueError, match="does not split"):
        ctx.for_batch(6)


def test_input_specs():
    built = M.build(get_config("qwen3-8b").reduced())
    ctx = _ctx((2, 2), ("data", "model"), 0)
    sds, spec = M.input_specs(built, INPUT_SHAPES["train_4k"], ctx)
    assert {k: (tuple(v.shape), v.dtype, v.device.type) for k, v in sds.items()} == {
        "tokens": ((256, 4096), torch.int32, "meta"),
        "targets": ((256, 4096), torch.int32, "meta")}
    assert spec == {"tokens": 0, "targets": 0}
    sds, spec = M.input_specs(built, InputShape("d", 64, 1, "decode"), ctx)
    assert tuple(sds["tokens"].shape) == (1, 1) and spec == {"tokens": None}
    sds, spec = M.input_specs(built, INPUT_SHAPES["prefill_32k"], parallel.LOCAL)
    assert tuple(sds["tokens"].shape) == (32, 32768) and spec == {"tokens": None}
    pix = M.build(get_config("pixtral-12b").reduced())
    sds, spec = M.input_specs(pix, InputShape("t", 24, 4, "train"), ctx)
    assert tuple(sds["tokens"].shape) == (4, 16)
    assert tuple(sds["patches"].shape) == (4, 8, pix.cfg.d_model)
    assert sds["patches"].dtype == getattr(torch, pix.cfg.dtype)
    assert tuple(sds["targets"].shape) == (4, 24)
    assert spec == {"tokens": 0, "patches": 0, "targets": 0}
    wh = M.build(get_config("whisper-base").reduced())
    sds, spec = M.input_specs(wh, InputShape("p", 8, 2, "prefill"), ctx)
    assert tuple(sds["frames"].shape) == (2, 16, wh.cfg.d_model)
    assert set(spec) == {"tokens", "frames"}
    with pytest.raises(ValueError, match="does not split"):
        M.input_specs(built, InputShape("t", 8, 3, "train"), ctx)


def test_param_specs(monkeypatch):
    built = M.build(get_config("qwen3-moe-235b-a22b").reduced())
    specs = M.param_specs(built)
    assert specs["model"] == M.tp_param_specs(built) and specs["pod"] is None
    for stage in specs["data"]["stages"]:
        for unit in stage:
            assert unit == [{"ffn": {"wg": 3, "wu": 3, "wd": 2}}]
    params = M.init_model(torch.Generator().manual_seed(0), built, device="cpu")
    wg = params["stages"][0][0][0]["ffn"]["wg"]                # (R, E, d, F)
    grid = parallel.RankGrid((2, 2), ("data", "model"))
    shard = parallel.shard_grid(params, specs, grid, rank=3)
    got = shard["stages"][0][0][0]["ffn"]["wg"]
    assert torch.equal(got, wg[:, 2:4, :, 64:128])
    assert shard["embed"] is params["embed"]
    monkeypatch.setattr(moe, "EXPERTS_OVER_POD", True)
    specs = M.param_specs(built)
    assert specs["pod"]["stages"][0][0][0] == {"ffn": {"wg": 1, "wu": 1, "wd": 1}}
    grid = parallel.RankGrid((2, 1, 2), ("pod", "data", "model"))
    shard = parallel.shard_grid(params, specs, grid, rank=2)     # pod 1, model 0
    assert torch.equal(shard["stages"][0][0][0]["ffn"]["wg"], wg[:, 2:3])
    o = opt_state_specs(specs)
    assert o["model"]["mu"] is specs["model"] and o["data"]["nu"] is specs["data"]
    assert o["model"]["step"] is None
    # d_ff that 16 does not divide stays whole; one the data axis does not
    # divide raises
    cfg = built.cfg
    assert not moe.ff_sharded(dataclasses.replace(cfg.moe, d_ff_expert=40), 3)
    with pytest.raises(ValueError, match="must divide d_ff_expert"):
        moe.ff_sharded(dataclasses.replace(cfg.moe, d_ff_expert=48), 5)
    p, opt, s = init_train_state(torch.Generator().manual_seed(0), built,
                                 device="cpu")
    assert set(s) == {"pod", "data", "model"} and set(opt) == {"mu", "nu", "step"}
    # an encoder-decoder lays out its encoder and its cross attention by
    # the same whole-head rule: sharded where the model axis divides the
    # heads (8 at the reduced size), whole at the production grid's 16
    wh = M.build(get_config("whisper-base").reduced())
    heads = {"wq": 2, "wk": 2, "wv": 2, "wo": 1}
    s = M.param_specs(wh)["model"]
    assert {k: s["encoder"]["segments"][0][0]["mixer"][k] for k in heads} == heads
    assert {k: s["stages"][0][0][0]["cross"][k] for k in heads} == heads
    s = M.param_specs(wh, parallel.RankGrid((16, 16), ("data", "model")))["model"]
    assert {k: s["stages"][0][0][0]["cross"][k] for k in heads} == dict.fromkeys(heads)


# ---------------------------------------------------------------------------
# spawned ranks
# ---------------------------------------------------------------------------

def _dense():
    cfg = dataclasses.replace(get_config("qwen3-8b").reduced(), num_heads=8,
                              num_kv_heads=4, dtype="float32")
    return M.build(cfg.with_butterfly(1, 16, rate_weight=0.01))


def _moe_built():
    cfg = dataclasses.replace(get_config("qwen3-moe-235b-a22b").reduced(),
                              num_heads=8, num_kv_heads=4, dtype="float32")
    return M.build(cfg)


def _train_batch(vocab, rows=4, seq=16):
    rng = np.random.default_rng(5)
    toks = rng.integers(0, vocab, (rows, seq + 1))
    targets = toks[:, 1:].copy()
    targets[0, :7] = -1                     # the first block counts fewer
    return {"tokens": toks[:, :-1], "targets": targets}


def _collective_grads(pctx):
    """Each differentiable collective's input gradient on this rank, for
    a loss that weighs the collective's output by ``C_rank``; the whole
    tensors are the same on every rank (seeded).  The data-axis ones need
    more than one data rank."""
    rank = torch.distributed.get_rank()
    grid = pctx.grid
    gen = torch.Generator().manual_seed(0)
    X = torch.randn(8, 3, generator=gen)
    C = torch.randn(grid.size, 8, 3, generator=gen)   # a weight a rank
    P = torch.randn(grid.size, 8, 3, generator=gen)   # a partial a rank
    out = {}
    group, n = grid.group("data"), grid.axis_size("data")
    d, rows = grid.index("data"), 8 // n
    if n > 1:
        x = X[d * rows:(d + 1) * rows].clone().requires_grad_()
        y = parallel.all_gather(x, 0, group)
        assert torch.equal(y, X)
        (C[rank] * y).sum().backward()
        out["all_gather"] = x.grad
        p = P[rank].clone().requires_grad_()
        y = parallel.psum_scatter(p, 0, d, n, group)
        members = grid.members("data", rank)
        assert torch.allclose(y, P[members].sum(0)[d * rows:(d + 1) * rows])
        (C[rank][:rows] * y).sum().backward()
        out["psum_scatter"] = p.grad
    x = X.clone().requires_grad_()
    (C[rank] * parallel.model_copy(x, pctx)).sum().backward()
    out["model_copy"] = x.grad
    p = P[rank].clone().requires_grad_()
    y = parallel.model_psum(p, pctx)
    assert torch.allclose(y, P[grid.members("model", rank)].sum(0))
    (C[0] * y).sum().backward()                # the same downstream on every rank
    out["model_psum"] = p.grad
    p = P[rank].clone().requires_grad_()
    parallel.reduce_sum((C[rank] * p).sum(), pctx.data_group).backward()
    out["reduce_sum"] = p.grad
    return out


def _steps(built, params, batch, pctx, n=2, **kw):
    step = make_train_step(built, AdamWConfig(lr=constant_schedule(1e-3)), pctx, **kw)
    params = tree_map(torch.clone, params)
    opt = adamw_init(params)
    ms = []
    for _ in range(n):
        params, opt, m = step(params, opt, batch)
        ms.append({k: float(v) for k, v in m.items()})
    return ms, params


GRIDS = {"dm": ((2, 2), ("data", "model")),
         "pdm_one_data": ((2, 1, 2), ("pod", "data", "model")),
         "data4": ((4, 1), ("data", "model"))}


def _norm(grads, grid, pctx) -> float:
    """global_norm over this rank's shards of a qwen3-moe tree (FSDP
    experts, and experts over pod when the flag is on)."""
    specs = M.param_specs(_moe_built())
    return float(global_norm(parallel.shard_grid(grads, specs, grid), specs,
                             pctx))


def _rank(rank, device, dense_params, grads):
    """Four ranks: the dense train steps at (data=2, model=2), and each
    grid's contexts, collectives and global_norm over the same world."""
    out = {}
    for name, (shape, axes) in GRIDS.items():
        grid = parallel.RankGrid(shape, axes)
        pctx = parallel.make_context(grid)
        out[name] = {"ctx": (pctx.rank, pctx.mp_size, pctx.data_rank,
                             pctx.dp_size, pctx.batch_spec_axes(),
                             pctx.automatic, pctx.tensor_parallel),
                     "collectives": _collective_grads(pctx)}
    grid = parallel.RankGrid(*GRIDS["dm"])
    pctx = parallel.make_context(grid)
    out["norm"] = _norm(grads, grid, pctx)
    # experts over the pod axis at (pod=2, data=1, model=2)
    over = moe.EXPERTS_OVER_POD
    moe.EXPERTS_OVER_POD = True
    try:
        pod = parallel.RankGrid(*GRIDS["pdm_one_data"])
        out["pod_norm"] = _norm(grads, pod, parallel.make_context(pod))
    finally:
        moe.EXPERTS_OVER_POD = over
    built = _dense()
    specs = M.param_specs(built)
    mine = parallel.shard_grid(dense_params, specs, grid)
    batch = _train_batch(built.cfg.vocab_size)
    block = shard_batch(batch, pctx, device="cpu")
    for name, kw in (("plain", {}), ("remat", {"remat": True}),
                     ("accum", {"accum_steps": 2})):
        out[name] = _steps(built, mine, block, pctx, **kw)[0]
    # a batch smaller than the data axes: whole on each rank
    small = {k: v[:1] for k, v in batch.items()}
    out["small"] = _steps(built, mine, shard_batch(small, pctx, device="cpu"),
                          pctx.for_batch(1))[0]
    return out


@pytest.fixture(scope="module")
def ranks():
    dense = M.init_model(torch.Generator().manual_seed(0), _dense(), device="cpu")
    grads = M.init_model(torch.Generator().manual_seed(1), _moe_built(), device="cpu")
    return dense, grads, parallel.spawn(_rank, 4, (dense, grads))


def _want_collectives(grid):
    """One process's autograd of the same losses on the whole tensors."""
    gen = torch.Generator().manual_seed(0)
    X = torch.randn(8, 3, generator=gen)
    C = torch.randn(grid.size, 8, 3, generator=gen)
    P = torch.randn(grid.size, 8, 3, generator=gen)
    want = []
    rows = 8 // grid.axis_size("data")
    for r in range(grid.size):
        d, data = grid.index("data", r), grid.members("data", r)
        model = grid.members("model", r)
        # all_gather: every data rank's loss reads the whole X
        xg = X.clone().requires_grad_()
        sum((C[q] * xg).sum() for q in data).backward()
        # psum_scatter: rank q's loss reads block q of the sum of partials
        ps = P.clone().requires_grad_()
        total = ps[data].sum(0)
        sum((C[q][:rows] * total[grid.index("data", q) * rows:][:rows]).sum()
            for q in data).backward()
        # f: each model rank weighs the one x by its own C
        xf = X.clone().requires_grad_()
        sum((C[q] * xf).sum() for q in model).backward()
        want.append({"all_gather": xg.grad[d * rows:(d + 1) * rows],
                     "psum_scatter": ps.grad[r],
                     "model_copy": xf.grad,
                     "model_psum": C[0],
                     "reduce_sum": C[r]})
    return want


@pytest.mark.subprocess
@pytest.mark.parametrize("layout", GRIDS)
def test_collective_grads_equal_whole_autograd(ranks, layout):
    _, _, runs = ranks
    grid = parallel.RankGrid(*GRIDS[layout])
    for r, (got, want) in enumerate(zip(runs, _want_collectives(grid))):
        got = got[layout]["collectives"]
        assert set(got) == set(want) - ({"all_gather", "psum_scatter"}
                                        if grid.axis_size("data") == 1 else set())
        for name in got:
            torch.testing.assert_close(got[name], want[name], rtol=1e-6,
                                       atol=1e-6, msg=f"{layout} rank {r} {name}")


@pytest.mark.subprocess
def test_contexts_over_the_grid(ranks):
    _, _, runs = ranks
    for layout, (shape, axes) in GRIDS.items():
        grid = parallel.RankGrid(shape, axes)
        data_axes = tuple(a for a in axes if a in ("pod", "data"))
        dp = grid.axis_size("pod") * grid.axis_size("data")
        for r, o in enumerate(runs):
            at = grid.coords(r)
            d = at.get("pod", 0) * grid.axis_size("data") + at["data"]
            mp = grid.axis_size("model")
            assert o[layout]["ctx"] == (
                at["model"], mp, d, dp,
                data_axes if len(data_axes) > 1 else data_axes[0], True, mp > 1)
    assert [o["dm"]["ctx"][:3] for o in runs] == [(0, 2, 0), (1, 2, 0),
                                                  (0, 2, 1), (1, 2, 1)]


@pytest.mark.subprocess
@pytest.mark.parametrize("layout", ["dm", "pod"])
def test_global_norm_over_shards(ranks, layout):
    """At (data=2, model=2) the experts shard over model and their d_ff
    over data; at (pod=2, data=1, model=2) with experts over the pod axis,
    over pod and model."""
    _, grads, runs = ranks
    want = float(global_norm(grads))
    for o in runs:
        assert o["norm" if layout == "dm" else "pod_norm"] == \
            pytest.approx(want, rel=1e-6)


@pytest.mark.subprocess
@pytest.mark.parametrize("variant", ["plain", "remat", "accum", "small"])
def test_train_step_across_ranks_equals_local(ranks, variant):
    """A dense model's steps at (data=2, model=2) against the local step
    on the whole batch: losses, rates, totals and grad norms within rtol
    1e-5 (sums in another order), every rank the same.  ``accum`` splits
    each rank's block in two (every row the same number of targets but
    the first, so its microbatch means differ from the whole batch's:
    held to the local step with the same microbatches, rows 0 and 2, then
    1 and 3).  ``small`` steps on one row held whole by both data ranks:
    its first step within 1e-5, its second within ``test_torch_training``'s
    1e-3, because one sequence leaves many gradient entries within the
    sums' rounding of zero, where Adam's step takes the rounding's sign (the
    updated params differ by up to 3e-5 after the first step, whose grads
    agree within 1e-6 of each leaf's largest)."""
    dense, _, dm = ranks
    built = _dense()
    batch = _train_batch(built.cfg.vocab_size)
    whole = shard_batch(batch, device="cpu")
    if variant == "small":
        whole = {k: v[:1] for k, v in whole.items()}
    if variant == "accum":
        # the ranks' microbatches are each block's halves: rows (0, 2), (1, 3)
        whole = {k: v[[0, 2, 1, 3]] for k, v in whole.items()}
    kw = {"remat": {"remat": True}, "accum": {"accum_steps": 2}}.get(variant, {})
    want, _ = _steps(built, dense, whole, parallel.LOCAL, **kw)
    for o in dm:
        for i, (got, w) in enumerate(zip(o[variant], want)):
            rel = 1e-3 if variant == "small" and i else 1e-5
            for k in ("loss", "wire_rate_bits", "total", "grad_norm"):
                assert got[k] == pytest.approx(w[k], rel=rel), (variant, i, k)
        assert o[variant] == dm[0][variant]
