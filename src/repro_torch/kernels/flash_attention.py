"""Launch wrapper for the Hopper flash-attention kernel in
``csrc/flash_attention.cu``.

It takes 4-D CUDA tensors, checks device, dtype, shapes and contiguity,
allocates the output, launches on the current stream and raises if the
launch was refused.  ``flash_attention.launches`` counts the kernel
launches (and nothing else), so a run can show that its path went through
the kernel.  The TPU kernel it replaces is
``repro/kernels/flash_attention.py:flash_attention_kernel``; the source
note in the ``.cu`` file gives the kernel's bound and design.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build

HEAD_DIMS = (32, 64, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check(t: torch.Tensor, name: str, dtype):
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype not in _DTYPE_CODE or t.dtype != dtype:
        raise TypeError(f"{name} dtype {t.dtype}: q, k and v must share one "
                        f"of {tuple(_DTYPE_CODE)}")
    if t.dim() != 4 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 4-D tensor, got shape "
                         f"{tuple(t.shape)}")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    # the kernel reads rows in 16-byte pieces
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None):
    """q (B,S,N,hd), k/v (B,T,K,hd), f32 or bf16, N % K == 0, hd in
    ``HEAD_DIMS``, window None or >= 1 -> (B,S,N,hd) in q's dtype."""
    _check(q, "q", q.dtype)
    _check(k, "k", q.dtype)
    _check(v, "v", q.dtype)
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
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty_like(q)
    err = build.load("flash_attention").flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), B, S, T, N, K, hd, int(causal), window or 0,
        _DTYPE_CODE[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: cudaError {err} "
                           f"({torch.cuda.get_device_name(q.device)})")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
