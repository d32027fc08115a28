"""Roofline terms of a traced step on one card (the port's counterpart of
``repro.launch.roofline``, which reads XLA's cost analysis of a compiled
program on a TPU mesh):

  compute term    = FLOPs / peak FLOP/s
  memory term     = bytes / memory bytes/s
  collective term = 0 on one card

The counts come from :class:`CostCounter`, a ``TorchDispatchMode`` that
sees every aten op the eager step runs.  FLOPs are those of
``torch.utils.flop_counter``'s registry (matmuls, convolutions, attention);
bytes are each op's input plus output bytes, views excluded: the eager
program's traffic, unfused, so an upper bound on what a fused program
moves.  It also follows the storages the step makes and reports the
high-water mark of the live bytes, the arguments' included.

The rates are the H100 SXM's data-sheet figures (NVIDIA, dense): 989
TFLOP/s bf16 on the tensor cores and 3.35 TB/s of device memory.
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
DEVICE_BYTES = 80e9          # the card's device memory


# ops whose schema makes a new tensor that shares its input's storage
_METADATA_OPS = (torch.ops.aten._unsafe_view, torch.ops.aten.lift_fresh)


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CostCounter(TorchDispatchMode):
    """Counts ``flops`` and ``bytes`` of the aten ops run inside it, and
    the live bytes of the storages they make (``live``, ``peak``), starting
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


def analyze(arch: str, shape: str, counter: CostCounter, model_flops: float,
            memory: Dict[str, float]) -> RooflineReport:
    """The report of one traced step on one card: ``memory`` holds the
    argument, output and peak live bytes (``memory_analysis``)."""
    flops, nbytes = float(counter.flops), float(counter.bytes)
    compute_s = flops / PEAK_FLOPS
    memory_s = nbytes / HBM_BW
    terms = {"compute": compute_s, "memory": memory_s, "collective": 0.0}
    return RooflineReport(
        arch=arch, shape=shape, mesh="1", chips=1,
        flops_per_device=flops, bytes_per_device=nbytes,
        collective_bytes_per_device=0, collectives={},
        compute_s=compute_s, memory_s=memory_s, collective_s=0.0,
        bottleneck=max(terms, key=terms.get), model_flops=model_flops,
        useful_ratio=model_flops / flops if flops else 0.0,
        memory_analysis=dict(memory))


def to_dict(r: RooflineReport) -> dict:
    return asdict(r)
