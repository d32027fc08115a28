"""Wire quantization for the butterfly boundary (port of
``repro/core/quantization.py``).

Symmetric absmax quantization per token row (over the ``d_r`` channel
axis); an f32 scale rides along with every row.  The arithmetic follows
the JAX package exactly: ``scale = max(absmax, 1e-8) / qmax`` and the codes
come from a true divide ``r / scale`` rounded half to even (``torch.round``
rounds like ``jnp.round``).  ``fake_quant`` is the forward of the JAX
straight-through estimator; its backward arrives with the training slice,
so until then it refuses a tensor that requires grad.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch


def quantize(x: torch.Tensor, bits: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (..., d_r) -> (codes int8/int16, scales f32 (..., 1))."""
    assert bits in (4, 8, 16), bits
    qmax = 2 ** (bits - 1) - 1
    xf = x.float()
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(absmax, min=1e-8) / qmax
    codes = torch.clamp(torch.round(xf / scale), -qmax - 1, qmax)
    return codes.to(torch.int8 if bits <= 8 else torch.int16), scale


def dequantize(codes: torch.Tensor, scale: torch.Tensor,
               dtype=torch.float32) -> torch.Tensor:
    return (codes.float() * scale).to(dtype)


def fake_quant(x: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """Quantize-dequantize in ``x``'s dtype: the forward of the JAX
    package's straight-through ``fake_quant``."""
    if x.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError(
            "fake_quant has no straight-through backward yet (it lands with "
            "the training slice); call it under torch.no_grad()")
    return dequantize(*quantize(x, bits), x.dtype)


def pack_int4(codes: torch.Tensor) -> torch.Tensor:
    """Pack int8 codes in [-8, 7] two-per-byte along the last axis.

    Byte b holds code 2b in its low nibble and code 2b+1 in its high nibble,
    so ``(..., d)`` packs to ``(..., d // 2)`` int8 (``d`` must be even)."""
    assert codes.shape[-1] % 2 == 0, \
        f"int4 packing needs an even last axis, got {tuple(codes.shape)}"
    codes = codes.to(torch.int8)
    lo = codes[..., ::2] & 0x0F
    hi = codes[..., 1::2] & 0x0F
    return lo | (hi << 4)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Invert :func:`pack_int4`: ``(..., d // 2)`` int8 -> ``(..., d)`` int8
    codes in [-8, 7], sign-extending each nibble by an arithmetic shift."""
    packed = packed.to(torch.int8)
    lo = (packed << 4) >> 4
    hi = packed >> 4
    out = torch.stack([lo, hi], dim=-1)
    return out.reshape(*packed.shape[:-1], packed.shape[-1] * 2)


def scale_dtype_bytes(dtype=torch.float32) -> int:
    """Wire width of one per-row scale at its real dtype."""
    return dtype.itemsize


def wire_bytes(shape: tuple, bits: int, scale_bytes: int = 4) -> int:
    """Bytes on the wire for bit-packed codes plus one f32 scale per row."""
    n = math.prod(shape)
    rows = n // shape[-1]
    return (n * bits + 7) // 8 + rows * scale_bytes
