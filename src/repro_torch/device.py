"""The port's one device rule: entry points default to ``"cuda"`` and
raise, rather than fall back, when CUDA is absent."""
from __future__ import annotations

import torch


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
