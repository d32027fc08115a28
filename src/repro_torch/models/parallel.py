"""ParallelContext: how model code sees the model axis inside a pod (port of
``repro/models/parallel.py``), and the ranks that carry it.

The JAX package runs a tensor-parallel stage inside a ``shard_map`` body:
every mesh axis is manual, params arrive as per-rank shards, and layer code
``psum``s its partial outputs over the ``model`` axis.  The port runs the
same regime as one process per model rank over ``torch.distributed``: a
:class:`ParallelContext` carries the pod's process group and this process's
rank in it, where JAX carries a mesh and an axis name, and
:func:`model_psum` is ``all_reduce(SUM)`` on that group.  Attention heads,
d_ff columns and MoE experts shard over the ranks Megatron-style
(column-parallel projections in, row-parallel projections out); the specs
live beside the layers (``attention.attention_specs``,
``transformer.tp_*_specs``, ``model.tp_param_specs``) as trees whose leaves
are the sharded dim or None, leaf for leaf JAX's ``PartitionSpec`` trees.

Under :data:`LOCAL` (or a group of one rank) ``model_psum`` is the identity,
so degree-1 callers run the unsharded code unchanged.

:func:`spawn` starts the ranks: N processes that meet through a
``FileStore`` in a temporary directory (no TCP port, so concurrent runs
cannot collide), with the backend chosen from the ranks' devices
(:func:`backend_for`).  Ranks that share a card, as two model ranks on one
H100 do, use gloo, which stages CUDA tensors through pinned host memory.

The automatic regime (JAX's GSPMD, where the context wraps a whole mesh)
runs over a :class:`RankGrid`, the counterpart of a ``jax.sharding.Mesh``:
named axes over the ranks, rank ``r`` at ``np.arange(world).reshape(shape)``'s
position of ``r``.  :func:`make_context` gives a context whose data axes
are the grid's ``pod`` and ``data``.  Eager PyTorch has no sharding
propagation, so the layout is explicit: dense layers run the manual
regime's Megatron shards over the ``model`` axis in whole heads where the
axis divides them and whole otherwise (``attention.head_layout``),
replicated over the data axes, and every rank holds one block of the batch (pod-major: block
``pod * |data| + data``); MoE runs its own expert parallelism
(``models/moe.py``).  The collectives below carry autograd rules, so a
train step differentiates through them: :func:`model_copy` and
:func:`model_psum` are Megatron's f and g over the model axis,
:func:`all_gather` reduce-scatters its gradient, :func:`psum_scatter`
all-gathers it, and :func:`reduce_sum` (a loss-level sum) passes it
through.  :func:`model_gather` and :func:`model_split` move between a
model-axis block and the whole of a value every model rank computes alike
(their gradients take the block and gather the whole), which
:func:`column_parallel` and :func:`row_parallel` use where the automatic
layout shards a projection the reference shards (JAX's ``dense_spec``
rule: the vocab, the recurrent mixers' projections) but the mixer
between them runs whole on every rank.

Decode caches may shard their length as well (:meth:`ParallelContext.
for_cache`, the JAX dry run's ``decode_state_specs(seq_axis=)``), and
:func:`fake_world` makes this process one rank of a world of any size
whose collectives do nothing: the dry run traces one rank's step of a
256- or 512-rank grid on meta tensors through this module's real code.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import itertools
import os
import tempfile
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class RankGrid:
    """Named axes over the ranks of a ``torch.distributed`` world, the
    counterpart of a ``jax.sharding.Mesh`` over ``jax.devices()``: rank
    ``r`` sits at ``np.arange(size).reshape(shape)``'s position of ``r``.
    A grid is a description; its process groups (:meth:`group`) need a
    world of exactly :attr:`size` ranks, and every rank builds all of them,
    in the same order, at its first call."""
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]

    def __post_init__(self):
        object.__setattr__(self, "shape", tuple(int(n) for n in self.shape))
        object.__setattr__(self, "axes", tuple(self.axes))
        if (len(self.shape) != len(self.axes)
                or len(set(self.axes)) != len(self.axes)):
            raise ValueError(f"grid shape {self.shape} and axes {self.axes} "
                             f"do not pair up")
        if any(n < 1 for n in self.shape):
            raise ValueError(f"grid shape {self.shape} has an empty axis")

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))

    def axis_size(self, axis: str) -> int:
        """The axis's length; 1 for an axis the grid does not have."""
        return self.shape[self.axes.index(axis)] if axis in self.axes else 1

    def ranks(self) -> np.ndarray:
        return np.arange(self.size).reshape(self.shape)

    def coords(self, rank: int) -> dict:
        """Rank ``rank``'s index on each axis."""
        return {a: int(i) for a, i in
                zip(self.axes, np.unravel_index(int(rank), self.shape))}

    def index(self, axis: str, rank: Optional[int] = None) -> int:
        """This rank's (or ``rank``'s) index on ``axis`` (JAX's
        ``lax.axis_index``); 0 on an axis the grid does not have."""
        if axis not in self.axes:
            return 0
        return self.coords(dist.get_rank() if rank is None else rank)[axis]

    def members(self, axes, rank: int) -> list:
        """The ranks that agree with ``rank`` on every axis not in
        ``axes``, ascending: ``rank``'s group along ``axes``."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        at = self.coords(rank)
        sel = tuple(slice(None) if a in axes else at[a] for a in self.axes)
        return sorted(int(r) for r in self.ranks()[sel].reshape(-1))

    def group(self, axes):
        """This rank's process group along ``axes`` (one axis name or a
        tuple of them; axes the grid lacks count as length 1); None where
        that group is this rank alone."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        axes = tuple(a for a in self.axes
                     if a in axes and self.axis_size(a) > 1)
        if not axes:
            return None
        return _grid_groups(self)[axes]


def _grid_groups(grid: RankGrid) -> dict:
    """Every group of ``grid`` (each subset of its axes longer than one
    rank, each block of ranks along it), created by every rank in the same
    order; returns this rank's group for each subset."""
    if not dist.is_initialized():
        raise ValueError(f"a {grid.shape} grid over {grid.axes} needs "
                         f"{grid.size} ranks of torch.distributed (start "
                         f"them with repro_torch.models.parallel.spawn)")
    world = dist.get_world_size()
    if world != grid.size:
        raise ValueError(f"a {grid.shape} grid over {grid.axes} needs "
                         f"{grid.size} ranks, the world has {world}")
    key = ("grid", grid.shape, grid.axes, id(dist.group.WORLD))
    if key not in _GROUPS:
        rank, mine = dist.get_rank(), {}
        live = [a for a in grid.axes if grid.axis_size(a) > 1]
        for n in range(1, len(live) + 1):
            for axes in itertools.combinations(live, n):
                blocks = sorted({tuple(grid.members(axes, r))
                                 for r in range(grid.size)})
                for block in blocks:
                    g = dist.new_group(list(block))
                    if rank in block:
                        mine[axes] = g
        _GROUPS[key] = mine
    return _GROUPS[key]


@dataclasses.dataclass(frozen=True)
class ParallelContext:
    """``group`` is the model axis's process group (None when local or of
    one rank) and ``rank`` this process's place in it (JAX's
    ``lax.axis_index``).  ``manual`` marks the tensor-parallel regime
    inside a pipeline stage: params are this rank's shards and layer code
    reduces its partial outputs itself.  An automatic context (from
    :func:`make_context`) adds the ``grid``, its ``data_axes`` and this
    rank's pod-major ``data_rank`` over them; ``replicated_batch`` marks a
    batch smaller than the data axes, held whole on every rank
    (:meth:`for_batch`)."""
    group: Optional[object] = None
    rank: int = 0
    size: int = 1
    manual: bool = False
    grid: Optional[RankGrid] = None
    data_axes: Tuple[str, ...] = ()
    data_rank: int = 0
    replicated_batch: bool = False
    seq_axes: Tuple[str, ...] = ()
    seq_rank: int = 0

    @property
    def enabled(self) -> bool:
        return self.group is not None or self.grid is not None

    @property
    def automatic(self) -> bool:
        return self.grid is not None and not self.manual

    @property
    def mp_size(self) -> int:
        return self.size if self.group is not None else 1

    @property
    def dp_size(self) -> int:
        if self.grid is None:
            return 1
        return int(np.prod([self.grid.axis_size(a) for a in self.data_axes]))

    @property
    def tensor_parallel(self) -> bool:
        """True when layer params are model-axis shards whose partial
        outputs need an explicit reduction (either regime)."""
        return self.mp_size > 1

    @property
    def data_group(self):
        """The process group over all the data axes (None for one rank)."""
        return None if self.grid is None else self.grid.group(self.data_axes)

    def batch_spec_axes(self):
        """The axes a batch dim shards over (None when local)."""
        if self.grid is None or not self.data_axes:
            return None
        return self.data_axes if len(self.data_axes) > 1 else self.data_axes[0]

    def batch_sharded(self, batch: int) -> bool:
        """Whether a global batch of ``batch`` rows shards over the data
        axes: a batch smaller than them is replicated, as in the JAX
        package; one they do not divide raises ValueError."""
        dp = self.dp_size
        if batch < dp:
            return False
        if batch % dp:
            raise ValueError(f"a batch of {batch} does not split over "
                             f"{dp} data ranks")
        return dp > 1

    def for_batch(self, batch: int) -> "ParallelContext":
        """This context for a global batch of ``batch`` rows: the model
        API sees each rank's block (``data.pipeline.shard_batch``), so a
        batch smaller than the data axes, held whole on every rank, must
        be run under the context this returns."""
        return dataclasses.replace(
            self, replicated_batch=not self.batch_sharded(batch))

    @property
    def seq_size(self) -> int:
        if self.grid is None:
            return 1
        return int(np.prod([self.grid.axis_size(a) for a in self.seq_axes]))

    @property
    def seq_group(self):
        """The process group over the caches' sequence axes (None for one
        rank)."""
        return None if self.grid is None else self.grid.group(self.seq_axes)

    def for_cache(self, seq_axis) -> "ParallelContext":
        """This context for decode caches whose length dim shards over
        ``seq_axis`` (a grid axis, a tuple of them, or None for whole
        caches), as the JAX dry run's ``decode_state_specs(seq_axis=)``
        lays them out: rank block ``i`` along the axes (major to minor in
        the grid's order) holds positions ``[i*T/n, (i+1)*T/n)`` of every
        kv head.  Attention decode then gathers the new token's heads,
        writes its key and value on the rank that holds the slot, and
        merges the blocks' partial softmaxes over :attr:`seq_group`."""
        if seq_axis is None:
            return dataclasses.replace(self, seq_axes=(), seq_rank=0)
        if not self.automatic:
            raise ValueError("sequence-sharded caches need an automatic "
                             "context (parallel.make_context)")
        axes = (seq_axis,) if isinstance(seq_axis, str) else tuple(seq_axis)
        if any(a not in self.grid.axes for a in axes):
            raise ValueError(f"cache axes {axes} are not all axes of the "
                             f"grid {self.grid.axes}")
        axes = tuple(a for a in self.grid.axes if a in axes)
        at = self.grid.coords(dist.get_rank())
        rank = 0
        for a in axes:
            rank = rank * self.grid.axis_size(a) + at[a]
        return dataclasses.replace(self, seq_axes=axes, seq_rank=rank)


LOCAL = ParallelContext()


def manual_context(group) -> ParallelContext:
    """Context for layer code running as one rank of ``group``'s model
    axis.  ``group=None`` is :data:`LOCAL`, which keeps degree-1 callers on
    the exact unsharded path."""
    if group is None:
        return LOCAL
    return ParallelContext(group=group, rank=dist.get_rank(group),
                           size=dist.get_world_size(group), manual=True)


def make_context(grid: Optional[RankGrid]) -> ParallelContext:
    """The automatic regime's context over ``grid`` (:data:`LOCAL` for
    None): its data axes are the grid's ``pod`` and ``data``, in the
    grid's order, its model axis ``model``.  Builds the grid's groups, so
    every rank of a world of the grid's size must call it."""
    if grid is None:
        return LOCAL
    _grid_groups(grid)
    data_axes = tuple(a for a in grid.axes if a in ("pod", "data"))
    data_rank = 0
    for a in data_axes:
        data_rank = data_rank * grid.axis_size(a) + grid.index(a)
    return ParallelContext(group=grid.group("model"), rank=grid.index("model"),
                           size=grid.axis_size("model"), grid=grid,
                           data_axes=data_axes, data_rank=data_rank)


def _recording(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def model_psum(x: torch.Tensor, pctx: ParallelContext) -> torch.Tensor:
    """Reduce a model-axis partial activation on the model group (in
    place, or out of place with Megatron's g rule, identity backward, when
    autograd records); the identity outside tensor parallelism.  On a
    CUDA tensor it is issued on the current stream, which the collective
    waits for and which waits for its result."""
    if pctx.tensor_parallel:
        if _recording(x):
            return _Reduce.apply(x, pctx.group)
        dist.all_reduce(x, group=pctx.group)
    return x


def model_copy(x: torch.Tensor, pctx: ParallelContext) -> torch.Tensor:
    """Megatron's f: the input of a column-parallel block (or a replicated
    weight that only a rank's shard reads) is itself forward and sums its
    gradient over the model group backward.  The identity where autograd
    does not record or there is no model axis."""
    if pctx.tensor_parallel and _recording(x):
        return _Copy.apply(x, pctx.group)
    return x


# ---------------------------------------------------------------------------
# collectives with autograd rules (each the identity for a group of None)
# ---------------------------------------------------------------------------


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        x = x.contiguous()
        n, me = dist.get_world_size(group), dist.get_rank(group)
        ctx.dim, ctx.group, ctx.block, ctx.me = dim, group, x.shape[dim], me
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        parts = [p.contiguous() for p in g.split(ctx.block, ctx.dim)]
        out = torch.empty_like(parts[ctx.me])
        dist.reduce_scatter(out, parts, group=ctx.group)
        return out, None, None


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, index, n, group):
        y = x.contiguous().clone()
        if group is not None:
            dist.all_reduce(y, group=group)
        block = x.shape[dim] // n
        ctx.dim, ctx.group, ctx.shape = dim, group, x.shape
        ctx.at = index * block
        return y.narrow(dim, index * block, block).contiguous()

    @staticmethod
    def backward(ctx, g):
        full = g.new_zeros(ctx.shape)
        full.narrow(ctx.dim, ctx.at, g.shape[ctx.dim]).copy_(g)
        if ctx.group is not None:
            dist.all_reduce(full, group=ctx.group)
        return full, None, None, None, None


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' blocks of ``group`` concatenated along ``dim`` in group
    order (JAX's tiled ``all_gather``); backward, the gradients summed
    over the group and this rank's block taken (a reduce-scatter)."""
    return x if group is None else _Gather.apply(x, dim, group)


def psum_scatter(x: torch.Tensor, dim: int, index: int, n: int,
                 group) -> torch.Tensor:
    """``x`` summed over ``group`` (None: not summed), then block ``index``
    of ``n`` along ``dim``; backward, the block's gradient placed at its
    rows and summed over the group."""
    if group is None and n == 1:
        return x
    return _PsumScatter.apply(x, dim, index, n, group)


def reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """A loss-level sum over ``group``: every rank gets the total and
    backpropagates only its own term (identity backward)."""
    return x if group is None else _Reduce.apply(x, group)


class _GatherBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        x = x.contiguous()
        n, me = dist.get_world_size(group), dist.get_rank(group)
        ctx.dim, ctx.block, ctx.me = dim, x.shape[dim], me
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.me * ctx.block, ctx.block), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        n, me = dist.get_world_size(group), dist.get_rank(group)
        ctx.dim, ctx.group, ctx.n = dim, group, n
        block = x.shape[dim] // n
        return x.narrow(dim, me * block, block).contiguous()

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        parts = [torch.empty_like(g) for _ in range(ctx.n)]
        dist.all_gather(parts, g, group=ctx.group)
        return torch.cat(parts, ctx.dim), None, None


def model_gather(x: torch.Tensor, dim: int, pctx: ParallelContext) -> torch.Tensor:
    """The model ranks' blocks of a value concatenated along ``dim`` (an
    all-gather), for a whole value that every model rank then computes
    with alike; backward, this rank's block of the gradient, which every
    rank holds whole (Megatron's gather, the inverse of
    :func:`model_split`)."""
    if not pctx.tensor_parallel:
        return x
    return _GatherBlock.apply(x, dim % x.dim(), pctx.group)


def model_split(x: torch.Tensor, dim: int, pctx: ParallelContext) -> torch.Tensor:
    """This model rank's block of ``x`` along ``dim`` (equal blocks in rank
    order), where ``x`` is whole and alike on every model rank; backward,
    the blocks' gradients gathered, so the whole value's gradient is whole
    on every rank (Megatron's scatter)."""
    if not pctx.tensor_parallel:
        return x
    return _Split.apply(x, dim % x.dim(), pctx.group)


def column_parallel(x: torch.Tensor, ws, full: int,
                    pctx: ParallelContext) -> list:
    """``[x @ w for w in ws]``, each product whole.  Where the ``ws`` are
    this rank's contiguous blocks of their ``full`` columns (the automatic
    layout's shards), each rank multiplies its blocks (their input under
    :func:`model_copy`) and one all-gather over the model axis joins the
    blocks of every product."""
    if not pctx.tensor_parallel or ws[0].shape[-1] == full:
        return [x @ w for w in ws]
    x = model_copy(x, pctx)
    parts = torch.stack([x @ w for w in ws])
    return list(model_gather(parts, -1, pctx).unbind(0))


def row_parallel(y: torch.Tensor, w: torch.Tensor,
                 pctx: ParallelContext) -> torch.Tensor:
    """``y @ w`` for a ``y`` whole on every model rank.  Where ``w`` is this
    rank's block of rows (the automatic layout's shard), the rank
    multiplies its block of ``y``'s last dim (:func:`model_split`) and the
    partial products sum over the model axis (:func:`model_psum`)."""
    if not pctx.tensor_parallel or w.shape[0] == y.shape[-1]:
        return y @ w
    return model_psum(model_split(y, -1, pctx) @ w, pctx)


# ---------------------------------------------------------------------------
# groups
# ---------------------------------------------------------------------------

_GROUPS: dict = {}


def model_group(mp: int, tag: str = "model"):
    """This rank's group of ``mp`` consecutive ranks (None for degree 1).
    Each ``tag`` gets groups of its own, so two pods' collectives never
    match each other's; every rank must ask for the same (mp, tag) in the
    same order.  The counterpart of the JAX bank's "degree needs devices"
    check is a ValueError when ``mp`` ranks are not there."""
    mp = int(mp)
    if mp <= 1:
        return None
    if not dist.is_initialized():
        raise ValueError(f"model-axis degree {mp} needs {mp} ranks of "
                         f"torch.distributed (start them with "
                         f"repro_torch.models.parallel.spawn)")
    world = dist.get_world_size()
    if world % mp:
        raise ValueError(f"model-axis degree {mp} must divide the "
                         f"{world} ranks")
    key = (mp, tag, id(dist.group.WORLD))
    if key not in _GROUPS:
        rank, mine = dist.get_rank(), None
        for lo in range(0, world, mp):
            g = dist.new_group(list(range(lo, lo + mp)))
            if lo <= rank < lo + mp:
                mine = g
        _GROUPS[key] = mine
    return _GROUPS[key]


@contextlib.contextmanager
def fake_world(grid: RankGrid, rank: int = 0):
    """A ``torch.distributed`` world of ``grid.size`` ranks in which this
    process is rank ``rank`` and no other rank exists: PyTorch's ``"fake"``
    backend, whose collectives return at once and leave their tensors as
    they are.  Inside it, one rank's step over ``grid`` runs on meta
    tensors through the real process-group code, each collective a
    dispatched ``c10d`` op that ``launch.roofline.CostCounter`` counts
    (the dry run's grid trace).  Refuses to start inside a live world;
    destroys its own on exit.  The group caches are cleared on entry and
    exit: they are keyed by the world group's ``id``, which a new world
    may reuse."""
    if dist.is_initialized():
        raise RuntimeError("a fake world cannot start while a "
                           "torch.distributed world is initialized")
    if not 0 <= rank < grid.size:
        raise ValueError(f"rank {rank} is not in a world of {grid.size}")
    # importing the module registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    _GROUPS.clear()
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=grid.size)
    try:
        yield
    finally:
        dist.destroy_process_group()
        _GROUPS.clear()


def backend_for(devices: Sequence) -> str:
    """The collective backend for ranks on ``devices`` (one entry a rank):
    gloo for CPU tensors and for ranks that share a card, nccl where every
    rank has a card of its own.  Raises where neither fits (CPU and CUDA
    ranks mixed, or a CUDA rank without an index)."""
    devs = [torch.device(d) for d in devices]
    kinds = {d.type for d in devs}
    if kinds == {"cpu"}:
        return "gloo"
    if kinds != {"cuda"}:
        raise ValueError(f"no collective backend serves ranks on {devs}")
    if any(d.index is None for d in devs):
        raise ValueError(f"name each rank's card (cuda:N), got {devs}")
    return "nccl" if len({d.index for d in devs}) == len(devs) else "gloo"


def _entry(rank: int, fn: Callable, world: int, devices: list, backend: str,
           tmp: str):
    args = torch.load(os.path.join(tmp, "args.pt"), weights_only=False)
    dev = torch.device(devices[rank])
    if dev.type == "cpu":
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, store=dist.FileStore(os.path.join(tmp, "store"), world),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=600))
    try:
        out = fn(rank, dev, *args)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
        _GROUPS.clear()


def spawn(fn: Callable, nprocs: int, args: tuple = (), *,
          devices="cpu") -> list:
    """Run ``fn(rank, device, *args)`` in ``nprocs`` new processes joined in
    one ``torch.distributed`` world; returns their return values (saved with
    ``torch.save``: tensors, numbers, dicts), rank 0 first.  ``devices`` is
    one device for every rank or one a rank.  ``fn`` must be importable by
    name (a module-level function); ``args`` reach each rank as copies
    (``torch.save``), never as memory shared with this process.  A rank
    that raises stops the others, and its traceback is raised here."""
    devs = [devices] * nprocs if isinstance(devices, (str, torch.device)) \
        else list(devices)
    if len(devs) != nprocs:
        raise ValueError(f"{len(devs)} devices for {nprocs} ranks")
    devs = [str(torch.device(d)) if torch.device(d).type == "cpu" or
            torch.device(d).index is not None else "cuda:0" for d in devs]
    backend = backend_for(devs)
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as tmp:
        torch.save(tuple(args), os.path.join(tmp, "args.pt"))
        torch.multiprocessing.start_processes(
            _entry, args=(fn, nprocs, devs, backend, tmp), nprocs=nprocs,
            join=True, start_method="spawn")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(nprocs)]


# ---------------------------------------------------------------------------
# shards
# ---------------------------------------------------------------------------


def _map_spec(fn, spec, tree):
    """``fn(leaf, dim)`` over the leaves of ``tree`` that ``spec``, a
    prefix of it, shards (an int stands for every leaf beneath it); a None
    spec, or a key a dict spec lacks, leaves its subtree as it is."""
    if spec is None:
        return tree
    if isinstance(spec, int):
        return tree_map(lambda a: fn(a, spec), tree)
    if isinstance(spec, dict):
        return {k: _map_spec(fn, spec.get(k), v) for k, v in tree.items()}
    return [_map_spec(fn, s, v) for v, s in zip(tree, spec)]


def shard_params(params, specs, rank: int, mp: int):
    """Rank ``rank``'s shards of ``params`` at model-axis degree ``mp`` (the
    counterpart of ``shard_map``'s in_specs slicing): the ``rank``-th of
    ``mp`` equal blocks along each leaf's sharded dim, so a rank gets whole
    heads, whole d_ff columns and whole experts.  The shards are views of
    the caller's leaves (``.contiguous()`` one to keep it alone), and
    replicated leaves are the caller's tensors.  ``specs`` is a prefix of
    the tree (None replicates everything)."""
    if mp <= 1:
        return params

    def one(a, dim):
        n = a.shape[dim]
        if n % mp:
            raise ValueError(f"dim {dim} of a {tuple(a.shape)} leaf does not "
                             f"split over {mp} ranks")
        return a.narrow(dim, rank * (n // mp), n // mp)

    return _map_spec(one, specs, params)


def axis_dim(parts, axis: str) -> Optional[int]:
    """The dim that ``parts`` (one entry a dim, as a ``PartitionSpec``'s:
    an axis name, a tuple of names, or None) shards over grid axis
    ``axis``; None where no dim does."""
    dims = [i for i, part in enumerate(parts) if part is not None and axis in
            ((part,) if isinstance(part, str) else tuple(part))]
    if len(dims) > 1:
        raise ValueError(f"axis {axis!r} shards more than one dim of {parts}")
    return dims[0] if dims else None


def spec_leaves(spec, tree) -> list:
    """``spec`` (a prefix of ``tree``, as :func:`shard_params` takes)
    expanded to one entry a leaf, in ``tree_leaves(tree)``'s order: the
    leaf's sharded dim, or None."""
    if spec is None or isinstance(spec, int):
        return [spec] * len(tree_leaves(tree))
    if isinstance(spec, dict):
        return [d for k, v in tree.items() for d in spec_leaves(spec.get(k), v)]
    if tree is None:
        return []
    return [d for v, s in zip(tree, spec) for d in spec_leaves(s, v)]


def shard_grid(params, specs: dict, grid: Optional[RankGrid],
               rank: Optional[int] = None):
    """Rank ``rank``'s (this rank's when None) shards of ``params`` over
    ``grid`` in the automatic regime: ``specs`` maps a grid axis to its
    spec tree (``model.param_specs``), and each axis cuts in the grid's
    order, so an expert dim sharded over ``pod`` and ``model`` gives rank
    (pod, model) block ``pod * |model| + model``.  Views of the caller's
    leaves, as :func:`shard_params`; ``grid=None`` returns ``params``."""
    if grid is None:
        return params
    at = grid.coords(dist.get_rank() if rank is None else rank)
    for axis in grid.axes:
        if specs.get(axis) is not None:
            params = shard_params(params, specs[axis], at[axis],
                                  grid.axis_size(axis))
    return params


def leaf_axes(specs: dict, tree, grid: RankGrid) -> list:
    """For each leaf of ``tree`` (``tree_leaves`` order), the grid axes
    (longer than one rank) that shard it under ``specs``."""
    per_axis = {a: spec_leaves(specs.get(a), tree) for a in grid.axes
                if grid.axis_size(a) > 1}
    n = len(tree_leaves(tree))
    return [tuple(a for a, dims in per_axis.items() if dims[i] is not None)
            for i in range(n)]
