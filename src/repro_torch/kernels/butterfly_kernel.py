"""Launch wrappers for the Hopper butterfly kernels in ``csrc/butterfly.cu``.

Each wrapper takes 2-D CUDA tensors, checks device, dtype, shape and
contiguity, allocates its outputs, launches on the current stream and
raises if the launch was refused.  ``launches`` on each wrapper counts the
kernel launches (and nothing else), so a run can show that its path went
through the kernel.  The TPU kernels these replace are
``repro/kernels/butterfly_kernel.py:butterfly_reduce_quant_kernel``,
``:butterfly_reduce_quant_bincount_kernel``,
``:butterfly_dequant_restore_kernel`` and
``:butterfly_dequant_restore_norm_kernel``; the source notes in the ``.cu``
file give each kernel's bound and design.
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


def _reduce_args(x: torch.Tensor, w_reduce: torch.Tensor, bits: int):
    """Check the reduce kernels' inputs; returns (library, w_reduce as the
    kernel reads it, codes, scales)."""
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
        return None, w_reduce, codes, scales
    lib = build.load("butterfly")
    # the kernel reads w_reduce in 16-byte pieces at a padded channel width;
    # the zero columns give zero sums, which it computes and drops
    width = lib.butterfly_reduce_width(d_r)
    if width != d_r:
        w_reduce = F.pad(w_reduce, (0, width - d_r))
    if w_reduce.data_ptr() % 16:
        w_reduce = w_reduce.clone()
    return lib, w_reduce, codes, scales


def reduce_quant(x: torch.Tensor, w_reduce: torch.Tensor, bits: int = 8):
    """x (T, d) f32|bf16, w_reduce (d, d_r) of the same dtype ->
    (codes (T, d_r) int8, scales (T, 1) f32)."""
    lib, w, codes, scales = _reduce_args(x, w_reduce, bits)
    if lib is None:
        return codes, scales
    T, d = x.shape
    err = lib.butterfly_reduce_quant(
        x.data_ptr(), w.data_ptr(), codes.data_ptr(), scales.data_ptr(),
        T, d, codes.shape[1], 2 ** (bits - 1) - 1, _DTYPE_CODE[x.dtype],
        _stream(x))
    _raise_on(err, "butterfly_reduce_quant")
    reduce_quant.launches += 1
    return codes, scales


reduce_quant.launches = 0


def reduce_quant_bincount(x: torch.Tensor, w_reduce: torch.Tensor,
                          bits: int = 8):
    """:func:`reduce_quant` plus the per-channel histogram of the codes'
    symbols (``code + 2**(bits-1)``): (codes (T, d_r) int8, scales (T, 1)
    f32, counts (d_r, 2**bits) int32).  Codes and scales are bit for bit
    those of :func:`reduce_quant`."""
    lib, w, codes, scales = _reduce_args(x, w_reduce, bits)
    counts = torch.zeros((codes.shape[1], 1 << bits), dtype=torch.int32,
                         device=x.device)
    if lib is None:
        return codes, scales, counts
    T, d = x.shape
    err = lib.butterfly_reduce_quant_bincount(
        x.data_ptr(), w.data_ptr(), codes.data_ptr(), scales.data_ptr(),
        counts.data_ptr(), T, d, codes.shape[1], 2 ** (bits - 1) - 1,
        _DTYPE_CODE[x.dtype], _stream(x))
    _raise_on(err, "butterfly_reduce_quant_bincount")
    reduce_quant_bincount.launches += 1
    return codes, scales, counts


reduce_quant_bincount.launches = 0


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
    err = build.load("butterfly").butterfly_dequant_restore(
        codes.data_ptr(), scales.data_ptr(), w_restore.data_ptr(),
        out.data_ptr(), T, d_r, d, _DTYPE_CODE[out_dtype], _stream(codes))
    _raise_on(err, "butterfly_dequant_restore")
    dequant_restore.launches += 1
    return out


dequant_restore.launches = 0


def dequant_restore_norm(codes: torch.Tensor, scales: torch.Tensor,
                         w_restore: torch.Tensor, norm_w: torch.Tensor,
                         eps: float = 1e-6, out_dtype=torch.float32):
    """codes (T, d_r) int8, scales (T, 1) f32, w_restore (d_r, d) f32|bf16,
    norm_w (d,) of the same dtype -> (x, h), both (T, d) in ``out_dtype``,
    which must be the dtype of ``w_restore``: x as :func:`dequant_restore`
    gives it, bit for bit, and h the RMSNorm of the rounded x, bit for bit
    what ``kernels/rmsnorm.rmsnorm(x, norm_w, eps)`` gives."""
    _check(codes, "codes", (torch.int8,))
    _check(scales, "scales", (torch.float32,))
    _check(w_restore, "w_restore", _DTYPE_CODE)
    _check(norm_w, "norm_w", (w_restore.dtype,), ndim=1)
    if out_dtype != w_restore.dtype:
        raise TypeError(f"out_dtype {out_dtype} must be the dtype of w_restore "
                        f"({w_restore.dtype})")
    T, d_r = codes.shape
    d = w_restore.shape[1]
    if tuple(scales.shape) != (T, 1) or w_restore.shape[0] != d_r \
            or not 1 <= d_r <= MAX_D_R or tuple(norm_w.shape) != (d,):
        raise ValueError(f"shapes codes {tuple(codes.shape)}, scales "
                         f"{tuple(scales.shape)}, w_restore "
                         f"{tuple(w_restore.shape)}, norm_w "
                         f"{tuple(norm_w.shape)} do not fit (d_r <= {MAX_D_R})")
    x = torch.empty((T, d), dtype=out_dtype, device=codes.device)
    h = torch.empty_like(x)
    if T == 0:
        return x, h
    err = build.load("butterfly").butterfly_dequant_restore_norm(
        codes.data_ptr(), scales.data_ptr(), w_restore.data_ptr(),
        norm_w.data_ptr(), x.data_ptr(), h.data_ptr(), T, d_r, d, float(eps),
        _DTYPE_CODE[out_dtype], _stream(codes))
    _raise_on(err, "butterfly_dequant_restore_norm")
    dequant_restore_norm.launches += 1
    return x, h


dequant_restore_norm.launches = 0
