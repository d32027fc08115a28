"""The port's one device rule: entry points default to ``"cuda"`` and
raise, rather than fall back, when CUDA is absent."""
from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode


def resolve(device) -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and no
    CUDA device is present (pass ``device="cpu"`` to run on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the port on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; the port runs on "
                         f"'cuda' or 'cpu'")
    return dev


def torch_dtype(name: str) -> torch.dtype:
    """A config's dtype string (``"bfloat16"``, ``"float32"``)."""
    return getattr(torch, name)


def as_tensor(a, device, dtype=None) -> torch.Tensor:
    """``a`` (a tensor, numpy array or list) on ``device``; host data is
    copied, never aliased."""
    if not isinstance(a, torch.Tensor):
        a = torch.tensor(a)
    return a.to(device=device, dtype=dtype)


class OnMeta(TorchDispatchMode):
    """Makes every tensor an op creates a meta tensor, and skips the random
    fills, which need a generator of the tensor's device: ``init_model``
    on the CPU, run inside it, lays out the params without allocating."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if "device" in kwargs:
            kwargs["device"] = torch.device("meta")
        if torch.Tag.nondeterministic_seeded in func.tags:
            if func._schema.is_mutable:
                return args[0]
            if "generator" in kwargs:
                kwargs["generator"] = None
        return func(*args, **kwargs)
