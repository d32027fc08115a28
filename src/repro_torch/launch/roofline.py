"""Roofline terms of one rank's traced step (the port's counterpart of
``repro.launch.roofline``, which reads XLA's cost analysis of a compiled
program on a TPU mesh):

  compute term    = FLOPs / peak FLOP/s
  memory term     = bytes / memory bytes/s
  collective term = collective bytes / link bytes/s   (0 on one card)

The counts come from :class:`CostCounter`, a ``TorchDispatchMode`` that
sees every aten op the eager step runs.  FLOPs are those of
``torch.utils.flop_counter``'s registry (matmuls, convolutions, attention);
bytes are each op's input plus output bytes, views excluded: the eager
program's traffic, unfused, so an upper bound on what a fused program
moves.  It also follows the storages the step makes and reports the
high-water mark of the live bytes, the arguments' included.  A collective
is a dispatched ``c10d`` op (``torch.distributed`` on any backend, the
``"fake"`` one of ``parallel.fake_world`` included): it counts, by kind,
the bytes of its output tensors on this rank, as the JAX package's
``collective_bytes`` counts an HLO collective's output (the data that
moved to this device), and never as memory bytes.

The rates are the H100 SXM's data-sheet figures (NVIDIA, dense): 989
TFLOP/s bf16 on the tensor cores, 3.35 TB/s of device memory, and NVLink 4
at 900 GB/s a card, 450 GB/s each way (:data:`LINK_BW`).  That one figure
holds inside an eight-card node; a 256- or 512-card grid also crosses the
slower links between nodes, which this term does not model.
"""
from __future__ import annotations

import weakref
from dataclasses import asdict, dataclass, field
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

PEAK_FLOPS = 989e12          # bf16 / card
HBM_BW = 3.35e12             # bytes/s / card
LINK_BW = 450e9              # bytes/s / card, NVLink 4, each way
DEVICE_BYTES = 80e9          # the card's device memory

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")
# c10d's dispatched ops, by the JAX package's kinds
_C10D_KINDS = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
}


# ops whose schema makes a new tensor that shares its input's storage
_METADATA_OPS = (torch.ops.aten._unsafe_view, torch.ops.aten.lift_fresh)


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CostCounter(TorchDispatchMode):
    """Counts ``flops`` and ``bytes`` of the aten ops run inside it, the
    output bytes of its collectives by kind (``collectives``), and the
    live bytes of the storages they make (``live``, ``peak``), starting
    from the storages given to :meth:`hold` (the step's arguments)."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flop_registry = flop_registry
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.live = 0
        self.peak = 0
        self.collectives: Dict[str, int] = dict.fromkeys(COLLECTIVE_OPS, 0)
        self._storages: Dict[int, int] = {}

    def hold(self, tree) -> int:
        """Track the storages of ``tree``'s tensors; returns their bytes."""
        before = self.live
        for t in _tensors(tree):
            self._track(t)
        return self.live - before

    def _track(self, t: torch.Tensor):
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return
        n = st.nbytes()
        self._storages[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._release, key)

    def _release(self, key: int):
        self.live -= self._storages.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        packet = func._overloadpacket
        if func.namespace == "c10d":
            name = packet.__name__
            if name not in _C10D_KINDS:
                raise NotImplementedError(f"c10d.{name}: a collective the "
                                          f"cost counter has no kind for")
            # (output tensors, work): the outputs' bytes on this rank
            self.collectives[_C10D_KINDS[name]] += sum(
                map(_nbytes, _tensors(out[0] if isinstance(out, tuple) else out)))
            return out
        if packet in self._flop_registry:
            self.flops += int(self._flop_registry[packet](*args, **kwargs,
                                                          out_val=out))
        if not (func.is_view or packet in _METADATA_OPS):
            self.bytes += sum(map(_nbytes, _tensors((args, kwargs)))) + \
                sum(map(_nbytes, _tensors(out)))
            for t in _tensors(out):
                self._track(t)
        return out


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: int
    collectives: Dict[str, int]
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float
    useful_ratio: float
    memory_analysis: Dict[str, float] = field(default_factory=dict)
    note: str = ""

    def cells(self) -> str:
        """Markdown cells: the three terms in ms (compute / memory /
        collective), the bottleneck, the peak live GB a rank and whether
        it fits the card."""
        mem = self.memory_analysis
        return (f"{self.compute_s*1e3:.3f} / {self.memory_s*1e3:.3f} / "
                f"{self.collective_s*1e3:.3f} | {self.bottleneck} | "
                f"{mem.get('peak_memory_in_bytes', 0.0)/1e9:.2f} | "
                f"{'yes' if mem.get('fits_device') else 'no'}")

    def table_row(self) -> str:
        return f"| {self.arch} | {self.shape} | {self.mesh} | {self.cells()} |"


def analyze(arch: str, shape: str, counter: CostCounter, model_flops: float,
            memory: Dict[str, float], mesh_name: str = "1",
            chips: int = 1) -> RooflineReport:
    """The report of one rank's traced step on a grid ``mesh_name`` of
    ``chips`` cards (one card by default): ``memory`` holds the argument,
    output and peak live bytes (``memory_analysis``); the useful share is
    the step's model FLOPs over every rank's (this rank's times
    ``chips``)."""
    flops, nbytes = float(counter.flops), float(counter.bytes)
    coll = dict(counter.collectives)
    coll_total = sum(coll.values())
    compute_s = flops / PEAK_FLOPS
    memory_s = nbytes / HBM_BW
    collective_s = coll_total / LINK_BW
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    total = flops * chips
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        flops_per_device=flops, bytes_per_device=nbytes,
        collective_bytes_per_device=coll_total, collectives=coll,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        bottleneck=max(terms, key=terms.get), model_flops=model_flops,
        useful_ratio=model_flops / total if total else 0.0,
        memory_analysis=dict(memory))


def to_dict(r: RooflineReport) -> dict:
    return asdict(r)
