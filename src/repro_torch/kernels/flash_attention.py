"""Launch wrapper for the Hopper flash-attention kernels in
``csrc/flash_attention.cu``: bf16 runs on the tensor cores (wgmma on tiles
that TMA brings through an mbarrier ring), f32 on the CUDA cores.

It takes 4-D CUDA tensors, checks device, dtype, shapes and contiguity,
allocates the output, launches on the current stream and raises if the
launch was refused.  ``flash_attention.launches`` counts the kernel
launches (and nothing else), so a run can show that its path went through
the kernel.  The TPU kernel it replaces is
``repro/kernels/flash_attention.py:flash_attention_kernel``; the source
note in the ``.cu`` file gives the kernel's bound and design.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels._launch import DTYPE_CODE, aligned, check, raise_on, \
    stream

HEAD_DIMS = (32, 64, 112, 128, 256)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None):
    """q (B,S,N,hd), k/v (B,T,K,hd), f32 or bf16, N % K == 0, hd in
    ``HEAD_DIMS``, window None or >= 1 -> (B,S,N,hd) in q's dtype."""
    check(q, "q", DTYPE_CODE, ndim=4)
    check(k, "k", (q.dtype,), ndim=4)
    check(v, "v", (q.dtype,), ndim=4)
    if q.numel() == 0 or k.numel() == 0:
        raise ValueError("flash attention needs at least one query and one key")
    B, S, N, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, T, K, hd) or tuple(v.shape) != tuple(k.shape) \
            or N % K or hd not in HEAD_DIMS:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} do not fit (N % K == 0, hd in "
                         f"{HEAD_DIMS})")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    q, k, v = aligned(q), aligned(k), aligned(v)
    out = torch.empty_like(q)
    err = build.load("flash_attention").flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), B, S, T, N, K, hd, int(causal), window or 0,
        DTYPE_CODE[q.dtype], stream(q))
    raise_on(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def encode_ns(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              out: torch.Tensor, reps: int = 1000) -> float:
    """Mean host nanoseconds that a bf16 call spends encoding its four TMA
    tensor maps (q, k, v, out), over ``reps`` encodings; nothing launches."""
    B, S, N, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    total = ctypes.c_longlong(0)
    err = build.load("flash_attention").flash_attention_encode_ns(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, T, N, K,
        hd, reps, ctypes.addressof(total))
    raise_on(err, "flash_attention_encode_ns")
    return total.value / reps
