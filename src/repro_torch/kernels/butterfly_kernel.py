"""Launch wrappers for the Hopper butterfly kernels in ``csrc/butterfly.cu``.

Each wrapper takes 2-D CUDA tensors, checks device, dtype, shape and
contiguity, allocates its outputs, launches on the current stream and
raises if the launch was refused.  ``launches`` on each wrapper counts the
kernel launches (and nothing else), so a run can show that its path went
through the kernel.  reduce_quant and dequant_restore also take the 16-bit
wire's int16 codes (their int16 variants, which no TPU kernel has: the
reference quantizes that wire unfused); the bincount and restore+norm
kernels take int8 codes only, as the reference runs them at 8 bits or
fewer.  The TPU kernels these replace are
``repro/kernels/butterfly_kernel.py:butterfly_reduce_quant_kernel``,
``:butterfly_reduce_quant_bincount_kernel``,
``:butterfly_dequant_restore_kernel`` and
``:butterfly_dequant_restore_norm_kernel``; the source notes in the ``.cu``
file give each kernel's bound and design.  The reduce kernels may split d
over blocks; their wrappers then hand the kernel its scratch (below).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels._launch import DTYPE_CODE, aligned, check, raise_on, \
    stream

MAX_D_R = 1024

# reduce_quant's split-K tickets, one buffer per (device, stream): the kernel
# leaves them zero after every launch, so launches in one stream's order
# share a buffer, and two streams never do
_tickets: dict = {}


def _reduce_scratch(lib, x: torch.Tensor, d_r: int):
    """Split-K scratch for a reduce launch on x's stream: (the partials
    tensor, to hold until the launch is queued; its data pointer; the
    tickets' data pointer), or (None, 0, 0) where the plan does not split
    k.  The f32 partial sums come from the caching allocator (ordered on
    the current stream), the tickets from the per-stream buffer, zeroed
    once when made or grown."""
    T, d = x.shape
    sizes = (ctypes.c_longlong * 2)()
    raise_on(lib.butterfly_reduce_scratch(T, d, d_r, DTYPE_CODE[x.dtype], sizes),
             "butterfly_reduce_scratch")
    if sizes[0] == 0:
        return None, 0, 0
    partials = torch.empty(sizes[0], dtype=torch.float32, device=x.device)
    key = (x.device.index, stream(x))
    tickets = _tickets.get(key)
    if tickets is None or tickets.numel() < sizes[1]:
        tickets = _tickets[key] = torch.zeros(sizes[1], dtype=torch.int32,
                                              device=x.device)
    return partials, partials.data_ptr(), tickets.data_ptr()


def code_dtype(bits: int) -> torch.dtype:
    """The codes of a ``bits``-wide wire: int8 at 1-8 bits, int16 at 16
    (the widths the reduce kernel emits); any other width raises."""
    if 1 <= bits <= 8:
        return torch.int8
    if bits == 16:
        return torch.int16
    raise ValueError(f"the fused codec emits int8 codes at 1-8 bits or "
                     f"int16 codes at 16 bits; bits={bits}")


def _reduce_args(x: torch.Tensor, w_reduce: torch.Tensor, bits: int,
                 max_bits: int = 16):
    """Check the reduce kernels' inputs; returns (library, w_reduce as the
    kernel reads it, codes, scales)."""
    check(x, "x", DTYPE_CODE)
    check(w_reduce, "w_reduce", (x.dtype,))
    if bits > max_bits:
        raise ValueError(f"this kernel emits int8 codes; bits={bits} > {max_bits}")
    cdt = code_dtype(bits)
    T, d = x.shape
    if w_reduce.shape[0] != d or not 1 <= w_reduce.shape[1] <= MAX_D_R:
        raise ValueError(f"w_reduce shape {tuple(w_reduce.shape)} does not "
                         f"fit x {tuple(x.shape)} (d_r <= {MAX_D_R})")
    d_r = w_reduce.shape[1]
    codes = torch.empty((T, d_r), dtype=cdt, device=x.device)
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
    (codes (T, d_r) int8 at bits 1-8, int16 at 16, scales (T, 1) f32)."""
    lib, w, codes, scales = _reduce_args(x, w_reduce, bits)
    if lib is None:
        return codes, scales
    T, d = x.shape
    partials, p_ptr, t_ptr = _reduce_scratch(lib, x, codes.shape[1])
    err = lib.butterfly_reduce_quant(
        x.data_ptr(), w.data_ptr(), codes.data_ptr(), scales.data_ptr(),
        p_ptr, t_ptr, T, d, codes.shape[1], 2 ** (bits - 1) - 1,
        codes.element_size(), DTYPE_CODE[x.dtype], stream(x))
    raise_on(err, "butterfly_reduce_quant")
    reduce_quant.launches += 1
    return codes, scales


reduce_quant.launches = 0


def reduce_quant_bincount(x: torch.Tensor, w_reduce: torch.Tensor,
                          bits: int = 8):
    """:func:`reduce_quant` plus the per-channel histogram of the codes'
    symbols (``code + 2**(bits-1)``): (codes (T, d_r) int8, scales (T, 1)
    f32, counts (d_r, 2**bits) int32).  Codes and scales are bit for bit
    those of :func:`reduce_quant`."""
    lib, w, codes, scales = _reduce_args(x, w_reduce, bits, max_bits=8)
    counts = torch.zeros((codes.shape[1], 1 << bits), dtype=torch.int32,
                         device=x.device)
    if lib is None:
        return codes, scales, counts
    T, d = x.shape
    partials, p_ptr, t_ptr = _reduce_scratch(lib, x, codes.shape[1])
    err = lib.butterfly_reduce_quant_bincount(
        x.data_ptr(), w.data_ptr(), codes.data_ptr(), scales.data_ptr(),
        counts.data_ptr(), p_ptr, t_ptr, T, d, codes.shape[1],
        2 ** (bits - 1) - 1, DTYPE_CODE[x.dtype], stream(x))
    raise_on(err, "butterfly_reduce_quant_bincount")
    reduce_quant_bincount.launches += 1
    return codes, scales, counts


reduce_quant_bincount.launches = 0


def dequant_restore(codes: torch.Tensor, scales: torch.Tensor,
                    w_restore: torch.Tensor, out_dtype=torch.float32):
    """codes (T, d_r) int8 or int16, scales (T, 1) f32, w_restore (d_r, d)
    f32|bf16 -> (T, d) in ``out_dtype``, which must be the dtype of
    ``w_restore``."""
    check(codes, "codes", (torch.int8, torch.int16))
    check(scales, "scales", (torch.float32,))
    check(w_restore, "w_restore", DTYPE_CODE)
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
        out.data_ptr(), T, d_r, d, DTYPE_CODE[out_dtype], codes.element_size(),
        stream(codes))
    raise_on(err, "butterfly_dequant_restore")
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
    check(codes, "codes", (torch.int8,))
    check(scales, "scales", (torch.float32,))
    check(w_restore, "w_restore", DTYPE_CODE)
    check(norm_w, "norm_w", (w_restore.dtype,), ndim=1)
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
    norm_w = aligned(norm_w)
    err = build.load("butterfly").butterfly_dequant_restore_norm(
        codes.data_ptr(), scales.data_ptr(), w_restore.data_ptr(),
        norm_w.data_ptr(), x.data_ptr(), h.data_ptr(), T, d_r, d, float(eps),
        DTYPE_CODE[out_dtype], stream(codes))
    raise_on(err, "butterfly_dequant_restore_norm")
    dequant_restore_norm.launches += 1
    return x, h


dequant_restore_norm.launches = 0


def restore_norm_wave(d_r: int, dtype=torch.bfloat16) -> int:
    """The clusters of :func:`dequant_restore_norm` the current card holds
    at once at this ``d_r``: a cluster owns one 16-row tile up to
    ``16 * wave`` rows and more beyond (the kernel asks the same)."""
    wave = ctypes.c_int()
    raise_on(build.load("butterfly").butterfly_restore_norm_wave(
        d_r, DTYPE_CODE[dtype], ctypes.byref(wave)), "butterfly_restore_norm_wave")
    return wave.value


def restore_plan(T: int, d: int, d_r: int, dtype=torch.bfloat16) -> dict:
    """How :func:`dequant_restore` launches at this shape with int8 codes
    (the kernel asks the same): ``rows`` a block, ``blocks``, ``smem``
    (dynamic shared memory a block, bytes), and ``norm_smem``,
    :func:`dequant_restore_norm`'s."""
    plan = (ctypes.c_int * 4)()
    raise_on(build.load("butterfly").butterfly_restore_plan(
        T, d_r, d, DTYPE_CODE[dtype], plan), "butterfly_restore_plan")
    return dict(zip(("rows", "blocks", "smem", "norm_smem"), plan))
