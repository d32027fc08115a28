"""The dry run's grid trace: one rank's step on meta tensors in a fake world
(``parallel.fake_world``), its collectives counted, against the same
rank's step on real CPU tensors in a real world.

Eight spawned gloo ranks at (pod=2, data=2, model=2) each count their step
(``dryrun.count_step(..., grid=)``) on real tensors from the seed-0 init;
rank 0's counts must equal, exactly, the counts of rank 0's step traced on
meta tensors in a fake world of eight ranks: FLOPs, bytes, the argument,
output and peak live bytes, and the collective bytes by kind.  Two reduced
configs (dense qwen3 with kv replicated over the model axis, and qwen3-moe
with its experts over it), four step kinds each: train, prefill (also with
``REPRO_PREFILL_CACHE_SHARDED=1``), and decode over caches sharded on
``model`` (a batch of 4) and on ``("data", "model")`` (a batch of 1).
The argument bytes equal those of rank 0's shards, batch block and cache
block reckoned from the specs; the production grids' records are written
with their chip counts; no process group outlives a trace.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import InputShape, get_config
from repro_torch.launch import dryrun, roofline
from repro_torch.models import model as M
from repro_torch.models import parallel
from repro_torch.tree import tree_leaves

GRID = ((2, 2, 2), ("pod", "data", "model"))
CONFIGS = ("dense", "moe")
KINDS = {"train": InputShape("t", 16, 8, "train"),
         "prefill": InputShape("p", 16, 4, "prefill"),
         "prefill_sharded": InputShape("p", 16, 4, "prefill"),
         "decode": InputShape("d", 32, 4, "decode"),
         "decode_b1": InputShape("d", 32, 1, "decode")}


def _built(name: str):
    if name == "dense":
        cfg = dataclasses.replace(get_config("qwen3-8b").reduced(), num_kv_heads=1)
    else:
        cfg = get_config("qwen3-moe-235b-a22b").reduced()
    return M.build(cfg.with_butterfly(1, 16))


def _counts(built, shape, device, kind):
    sharded = kind == "prefill_sharded"
    if sharded:
        os.environ["REPRO_PREFILL_CACHE_SHARDED"] = "1"
    try:
        counter, memory = dryrun.count_step(built, shape, device,
                                            grid=parallel.RankGrid(*GRID))
    finally:
        if sharded:
            del os.environ["REPRO_PREFILL_CACHE_SHARDED"]
    return (counter.flops, counter.bytes, dict(counter.collectives), memory)


def _rank(rank, device):
    return {(name, kind): _counts(_built(name), shape, "cpu", kind)
            for name in CONFIGS for kind, shape in KINDS.items()}


@pytest.fixture(scope="module")
def real():
    return parallel.spawn(_rank, 8)[0]


@pytest.mark.subprocess
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", CONFIGS)
def test_fake_world_meta_counts_equal_a_real_rank(real, name, kind):
    with parallel.fake_world(parallel.RankGrid(*GRID), 0):
        meta = _counts(_built(name), KINDS[kind], "meta", kind)
    assert not dist.is_initialized()
    assert meta == real[(name, kind)]
    flops, _, coll, memory = meta
    assert flops > 0 and memory["fits_device"]
    assert coll["all-reduce"] > 0
    if kind == "decode_b1" or name == "moe":
        assert coll["all-gather"] > 0


def _flat_specs(specs, tree, grid) -> dict:
    """``specs`` (a spec tree a grid axis) as lists over ``tree``'s leaves."""
    return {a: parallel.spec_leaves(specs.get(a), tree) for a in grid.axes}


def _block_bytes(tree, specs, grid) -> int:
    """The bytes of a rank's block of ``tree`` by ``specs``: each leaf's
    over the product of the lengths of the axes that shard it."""
    return sum(a.numel() * a.element_size() //
               int(np.prod([grid.axis_size(x) for x in axes]))
               for a, axes in zip(tree_leaves(tree),
                                  parallel.leaf_axes(specs, tree, grid)))


@pytest.mark.parametrize("kind", ("train", "prefill", "decode", "decode_b1"))
def test_argument_bytes_are_the_rank_blocks(kind):
    grid = parallel.RankGrid(*GRID)
    built, shape = _built("moe"), KINDS[kind]
    params = dryrun.init_params(built)
    pspecs = M.param_specs(built, grid)
    want = _block_bytes(params, pspecs, grid)
    if kind == "train":
        # AdamW's f32 moments of the shards and its int32 step
        f32 = [torch.empty(a.shape, dtype=torch.float32, device="meta")
               for a in tree_leaves(params)]
        want += 2 * _block_bytes(f32, _flat_specs(pspecs, params, grid), grid) + 4
    ctx = parallel.ParallelContext(grid=grid, data_axes=("pod", "data"))
    _, bspec = M.input_specs(built, shape, ctx)
    batch = dryrun.make_batch(built, shape, torch.device("meta"))
    want += _block_bytes(batch, {a: bspec for a in ("pod", "data")}, grid)
    if shape.kind == "decode":
        whole, cspecs = M.decode_state_specs(built, shape, ctx,
                                             seq_axis=dryrun.seq_axis_of(shape))
        want += _block_bytes(whole, cspecs, grid)
    with parallel.fake_world(grid, 0):
        _, memory = dryrun.count_step(built, shape, grid=grid)
    assert memory["argument_size_in_bytes"] == want


def test_production_grids_write_their_records(tmp_path):
    """Full-width qwen3-8b decode_32k as rank 0 of the 512- and 256-rank
    grids; a second trace in the same process works, and no world is left
    behind; a fake world refuses to start inside a live one."""
    out = str(tmp_path)
    assert dryrun.main(["--arch", "qwen3-8b", "--shape", "decode_32k",
                        "--multi-pod", "--out", out]) == 0
    assert not dist.is_initialized()
    assert dryrun.main(["--arch", "qwen3-8b", "--shape", "decode_32k",
                        "--both-meshes", "--out", out]) == 0
    assert not dist.is_initialized()
    for mesh, chips in (("2-16-16", 512), ("16-16", 256)):
        with open(os.path.join(out, f"qwen3-8b_decode_32k_{mesh}.json")) as f:
            rec = json.load(f)
        assert rec["chips"] == chips and rec["rank"] == 0
        assert rec["mesh"] == mesh.replace("-", "x")
        assert rec["collectives"]["all-gather"] > 0
        assert rec["collectives"]["all-reduce"] > 0
        assert rec["collective_s"] > 0 and rec["memory_analysis"]["fits_device"]
        rep = roofline.RooflineReport(**{
            k: rec[k] for k in roofline.RooflineReport.__dataclass_fields__})
        row = rep.table_row().split(" | ")
        assert row[:3] == ["| qwen3-8b", "decode_32k", rec["mesh"]]
        assert row[-1] == "yes |" and row[-3] == "memory"
    store = dist.HashStore()
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="fake world"):
            with parallel.fake_world(parallel.RankGrid((1, 2), ("data", "model"))):
                pass
    finally:
        dist.destroy_process_group()


# (q sharded, kv sharded) at the production grid's model axis of 16; under
# REPRO_ATTN_PAD_HEADS=1 the 40-head configs shard 3 heads a rank (48) and
# whisper 1 (16); xLSTM's heads pad too, but it has no attention layer
LAYOUT_AT_16 = {"qwen3-14b": (False, False), "llama4-maverick-400b-a17b": (False, False),
                "qwen3-moe-235b-a22b": (True, False), "pixtral-12b": (True, False),
                "whisper-base": (False, False), "gemma-7b": (True, True),
                "gemma3-12b": (True, False), "qwen3-8b": (True, False),
                "xlstm-125m": (False, False), "zamba2-7b": (True, True)}
PADDED_AT_16 = {"qwen3-14b": (True, False), "llama4-maverick-400b-a17b": (True, False),
                "whisper-base": (True, False), "xlstm-125m": (True, False)}


@pytest.mark.parametrize("arch", LAYOUT_AT_16)
def test_every_assigned_arch_takes_a_layout_at_model_16(arch, monkeypatch):
    """The whole-head rule at the 16x16 grid: each architecture's attention
    specs (self, cross, the shared block, the encoder's) follow
    ``head_layout``, and a rank of the grid's automatic context passes
    the model's checks, enc-dec included."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import attention as attn
    for padded, want in ((False, LAYOUT_AT_16[arch]),
                         (True, PADDED_AT_16.get(arch, LAYOUT_AT_16[arch]))):
        monkeypatch.setenv("REPRO_ATTN_PAD_HEADS", "1" if padded else "0")
        cfg = get_config(arch)
        assert attn.head_layout(cfg, 16) == want
        built = M.build(cfg)
        grid = make_production_mesh()
        specs = M.param_specs(built, grid)["model"]
        q, kv = want
        expect = {"wq": 1 if q else None, "wk": 1 if kv else None,
                  "wv": 1 if kv else None, "wo": 0 if q else None}
        mixers = [layer[k] for stage in specs["stages"] for seg in stage
                  for layer in seg for k in ("mixer", "cross")
                  if k in layer and "wo" in layer[k]]
        mixers += [specs["shared_attn"]["mixer"]] if "shared_attn" in specs else []
        if "encoder" in specs:
            mixers += [layer["mixer"] for seg in specs["encoder"]["segments"]
                       for layer in seg]
        assert mixers or arch == "xlstm-125m"
        for m in mixers:
            # stacked over repeats, except the shared block's
            got = {k: m[k] for k in expect}
            shift = {k: None if v is None else v + 1 for k, v in expect.items()}
            assert got in (expect, shift), (arch, got)
        with parallel.fake_world(grid, 0):
            M._check_automatic(built, parallel.make_context(grid))


def test_seq_sharded_decode_refuses_ragged_positions_and_uneven_blocks():
    """The name is from when a (B,) position raised over sequence-sharded
    caches; ragged rows decode there now (``test_torch_seq_decode_jax.py``
    holds them to JAX).  A capacity the sequence group does not divide
    still raises, and so does a context that is not automatic."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm
    built = M.build(get_config("qwen3-8b").reduced())
    cfg = built.cfg
    grid = parallel.RankGrid((1, 2), ("data", "model"))
    with pytest.raises(ValueError, match="automatic"):
        parallel.LOCAL.for_cache("model")
    with parallel.fake_world(grid, 1):
        pctx = parallel.make_context(grid).for_cache("model")
        assert (pctx.seq_axes, pctx.seq_rank, pctx.seq_size) == (("model",), 1, 2)
        caches = [tfm.init_stage_cache(list(built.stages[0]), cfg, 2, 10,
                                       torch.float32, "meta")]
        with pytest.raises(ValueError, match="does not split"):
            M.pad_decode_caches(built, caches, 33, pctx)


def test_vocab_leaves_leave_the_production_rank():
    """At the 16x16 grid full-width qwen3-8b's embedding and LM head shard
    their vocab over model (JAX's dense_spec: 16 divides 151,936), so a
    rank's parameter bytes fall by 15/16 of the two tables' 2.49 GB
    against the layout that replicated them."""
    from repro_torch.launch.mesh import make_production_mesh
    built = M.build(get_config("qwen3-8b"))
    grid = make_production_mesh()
    params = dryrun.init_params(built)
    specs = M.param_specs(built, grid)
    assert specs["model"]["embed"] == specs["model"]["head"] == 0
    replicated = dict(specs, model=dict(specs["model"], embed=None, head=None))
    V, d = built.cfg.vocab_size, built.cfg.d_model
    tables = 2 * V * d * 2                                   # bf16
    assert _block_bytes(params, replicated, grid) - \
        _block_bytes(params, specs, grid) == tables - tables // 16
