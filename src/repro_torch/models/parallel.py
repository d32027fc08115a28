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
live beside the layers (``attention.tp_attention_specs``,
``transformer.tp_*_specs``, ``model.tp_param_specs``) as trees whose leaves
are the sharded dim or None, leaf for leaf JAX's ``PartitionSpec`` trees.

Under :data:`LOCAL` (or a group of one rank) ``model_psum`` is the identity,
so degree-1 callers run the unsharded code unchanged.

:func:`spawn` starts the ranks: N processes that meet through a
``FileStore`` in a temporary directory (no TCP port, so concurrent runs
cannot collide), with the backend chosen from the ranks' devices
(:func:`backend_for`).  Ranks that share a card, as two model ranks on one
H100 do, use gloo, which stages CUDA tensors through pinned host memory.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import tempfile
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class ParallelContext:
    """``group`` is the pod's process group over its model ranks (None
    when local) and ``rank`` this process's place in it (JAX's
    ``lax.axis_index``).  ``manual`` marks the tensor-parallel regime:
    params are this rank's shards and layer code reduces its partial
    outputs itself."""
    group: Optional[object] = None
    rank: int = 0
    size: int = 1
    manual: bool = False

    @property
    def mp_size(self) -> int:
        return self.size if self.group is not None else 1

    @property
    def tensor_parallel(self) -> bool:
        """True when layer params are model-axis shards whose partial
        outputs need an explicit reduction."""
        return self.manual and self.mp_size > 1


LOCAL = ParallelContext()


def manual_context(group) -> ParallelContext:
    """Context for layer code running as one rank of ``group``'s model
    axis.  ``group=None`` is :data:`LOCAL`, which keeps degree-1 callers on
    the exact unsharded path."""
    if group is None:
        return LOCAL
    return ParallelContext(group=group, rank=dist.get_rank(group),
                           size=dist.get_world_size(group), manual=True)


def model_psum(x: torch.Tensor, pctx: ParallelContext) -> torch.Tensor:
    """Reduce a model-axis partial activation (in place, on the pod's
    group); the identity outside the tensor-parallel regime.  On a CUDA
    tensor it is issued on the current stream, which the collective waits
    for and which waits for its result."""
    if pctx.tensor_parallel:
        dist.all_reduce(x, group=pctx.group)
    return x


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
    spec leaves its subtree as it is."""
    if spec is None:
        return tree
    if isinstance(spec, int):
        return tree_map(lambda a: fn(a, spec), tree)
    if isinstance(spec, dict):
        return {k: _map_spec(fn, spec[k], v) for k, v in tree.items()}
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
