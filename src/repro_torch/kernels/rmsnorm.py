"""Launch wrapper for the Hopper RMSNorm kernel in ``csrc/rmsnorm.cu``.

It takes a 2-D CUDA tensor, checks device, dtype, shape and contiguity,
allocates the output, launches on the current stream and raises if the
launch was refused.  ``rmsnorm.launches`` counts the kernel launches (and
nothing else), so a run can show that its path went through the kernel.
The TPU kernel it replaces is ``repro/kernels/rmsnorm.py:rmsnorm_kernel``;
the source note in the ``.cu`` file gives the kernel's bound and design.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels._launch import DTYPE_CODE, aligned, check, raise_on, \
    stream


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6):
    """x (T, d) f32|bf16, w (d,) of the same dtype -> (T, d) in x's dtype:
    ``x * rsqrt(mean(x**2) + eps) * (1 + w)`` in f32, rounded once."""
    check(x, "x", DTYPE_CODE)
    check(w, "w", (x.dtype,), ndim=1)
    T, d = x.shape
    if tuple(w.shape) != (d,) or d == 0:
        raise ValueError(f"shapes x {tuple(x.shape)}, w {tuple(w.shape)} do "
                         f"not fit")
    out = torch.empty_like(x)
    if T == 0:
        return out
    x, w = aligned(x), aligned(w)
    err = build.load("rmsnorm").rmsnorm(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), T, d, float(eps),
        DTYPE_CODE[x.dtype], stream(x))
    raise_on(err, "rmsnorm")
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0
