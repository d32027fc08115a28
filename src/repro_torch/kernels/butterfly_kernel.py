"""Launch wrappers for the Hopper butterfly kernels in ``csrc/butterfly.cu``.

Each wrapper takes 2-D CUDA tensors, checks device, dtype, shape and
contiguity, allocates its outputs, launches on the current stream and
raises if the launch was refused.  ``launches`` on each wrapper counts the
kernel launches (and nothing else), so a run can show that its path went
through the kernel.  The TPU kernels these replace are
``repro/kernels/butterfly_kernel.py:butterfly_reduce_quant_kernel`` and
``:butterfly_dequant_restore_kernel``; the source notes in the ``.cu`` file
give each kernel's bound and design.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

MAX_D_R = 1024
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check(t: torch.Tensor, name: str, dtypes, ndim: int = 2):
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} dtype {t.dtype} not in {dtypes}")
    if t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {ndim}-D tensor, got "
                         f"shape {tuple(t.shape)}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err: int, kernel: str):
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {err} "
                           f"({torch.cuda.get_device_name()})")


def reduce_quant(x: torch.Tensor, w_reduce: torch.Tensor, bits: int = 8):
    """x (T, d) f32|bf16, w_reduce (d, d_r) of the same dtype ->
    (codes (T, d_r) int8, scales (T, 1) f32)."""
    _check(x, "x", _DTYPE_CODE)
    _check(w_reduce, "w_reduce", (x.dtype,))
    if not 1 <= bits <= 8:
        raise ValueError(f"the fused codec emits int8 codes; bits={bits}")
    T, d = x.shape
    if w_reduce.shape[0] != d or not 1 <= w_reduce.shape[1] <= MAX_D_R:
        raise ValueError(f"w_reduce shape {tuple(w_reduce.shape)} does not "
                         f"fit x {tuple(x.shape)} (d_r <= {MAX_D_R})")
    d_r = w_reduce.shape[1]
    codes = torch.empty((T, d_r), dtype=torch.int8, device=x.device)
    scales = torch.empty((T, 1), dtype=torch.float32, device=x.device)
    if T == 0:
        return codes, scales
    lib = build.load()
    # the kernel reads w_reduce in 16-byte pieces at a padded channel width;
    # the zero columns give zero sums, which it computes and drops
    width = lib.butterfly_reduce_width(d_r)
    if width != d_r:
        w_reduce = F.pad(w_reduce, (0, width - d_r))
    if w_reduce.data_ptr() % 16:
        w_reduce = w_reduce.clone()
    err = lib.butterfly_reduce_quant(
        x.data_ptr(), w_reduce.data_ptr(), codes.data_ptr(), scales.data_ptr(),
        T, d, d_r, 2 ** (bits - 1) - 1, _DTYPE_CODE[x.dtype], _stream(x))
    _raise_on(err, "butterfly_reduce_quant")
    reduce_quant.launches += 1
    return codes, scales


reduce_quant.launches = 0


def dequant_restore(codes: torch.Tensor, scales: torch.Tensor,
                    w_restore: torch.Tensor, out_dtype=torch.float32):
    """codes (T, d_r) int8, scales (T, 1) f32, w_restore (d_r, d) f32|bf16 ->
    (T, d) in ``out_dtype``, which must be the dtype of ``w_restore``."""
    _check(codes, "codes", (torch.int8,))
    _check(scales, "scales", (torch.float32,))
    _check(w_restore, "w_restore", _DTYPE_CODE)
    if out_dtype != w_restore.dtype:
        raise TypeError(f"out_dtype {out_dtype} must be the dtype of w_restore "
                        f"({w_restore.dtype})")
    T, d_r = codes.shape
    if tuple(scales.shape) != (T, 1) or w_restore.shape[0] != d_r \
            or not 1 <= d_r <= MAX_D_R:
        raise ValueError(f"shapes codes {tuple(codes.shape)}, scales "
                         f"{tuple(scales.shape)}, w_restore "
                         f"{tuple(w_restore.shape)} do not fit (d_r <= {MAX_D_R})")
    d = w_restore.shape[1]
    out = torch.empty((T, d), dtype=out_dtype, device=codes.device)
    if T == 0:
        return out
    err = build.load().butterfly_dequant_restore(
        codes.data_ptr(), scales.data_ptr(), w_restore.data_ptr(),
        out.data_ptr(), T, d_r, d, _DTYPE_CODE[out_dtype], _stream(codes))
    _raise_on(err, "butterfly_dequant_restore")
    dequant_restore.launches += 1
    return out


dequant_restore.launches = 0
