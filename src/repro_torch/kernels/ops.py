"""Public wrappers for the butterfly kernels (port of the butterfly part of
``repro/kernels/ops.py``).

A CPU tensor takes the plain PyTorch version (``kernels/ref.py``); a CUDA
tensor launches the hand-written Hopper kernel (``kernels/butterfly_kernel``)
or raises.  There is no fallback from one to the other.

The JAX wrappers route rows <= 8 to a jnp fast path and pad the row count
to the Pallas block; both exist only because of Pallas dispatch and TPU
tiling.  On the card every row count goes through the kernel, which masks
the ragged edge itself, so neither is kept here.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import butterfly_kernel, ref


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return False


def butterfly_reduce_quant(x: torch.Tensor, w_reduce: torch.Tensor, *,
                           bits: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (..., d) -> (codes (..., d_r) int8, scales (..., 1) f32)."""
    if bits > 8:
        raise ValueError(f"the fused codec emits int8 codes: bits={bits} > 8")
    shape = x.shape
    d_r = w_reduce.shape[1]
    xf = x.reshape(-1, shape[-1])
    if _on_cpu(x):
        codes, scales = ref.butterfly_reduce_quant_ref(xf, w_reduce, bits)
    else:
        codes, scales = butterfly_kernel.reduce_quant(
            xf.contiguous(), w_reduce.contiguous(), bits)
    return codes.reshape(*shape[:-1], d_r), scales.reshape(*shape[:-1], 1)


def butterfly_dequant_restore(codes: torch.Tensor, scales: torch.Tensor,
                              w_restore: torch.Tensor, *,
                              out_dtype=torch.float32) -> torch.Tensor:
    """codes: (..., d_r) int8, scales (..., 1) f32 -> (..., d) ``out_dtype``."""
    shape = codes.shape
    d = w_restore.shape[1]
    cf = codes.reshape(-1, shape[-1])
    sf = scales.reshape(-1, 1)
    if _on_cpu(codes):
        out = ref.butterfly_dequant_restore_ref(cf, sf, w_restore, out_dtype)
    else:
        out = butterfly_kernel.dequant_restore(
            cf.contiguous(), sf.contiguous(), w_restore.contiguous(), out_dtype)
    return out.reshape(*shape[:-1], d)
