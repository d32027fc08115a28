"""What the kernel wrappers share: the dtype codes of the C entry points,
the check of a tensor a kernel reads, its alignment, the launch's stream
and the error a refused launch raises."""
from __future__ import annotations

import torch

# dtype codes of every library's C entry points
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def check(t: torch.Tensor, name: str, dtypes, ndim: int = 2):
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} dtype {t.dtype} not in {tuple(dtypes)}")
    if t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {ndim}-D tensor, got "
                         f"shape {tuple(t.shape)}")


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it if its data is not 16-byte aligned: the flash
    kernels read rows in 16-byte pieces (TMA needs aligned tensors), and the
    norm row routine (``csrc/row_norm.cuh``) picks its branch by alignment,
    so an aligned copy keeps rmsnorm and restore_norm on the same branch."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def raise_on(err: int, kernel: str):
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {err} "
                           f"({torch.cuda.get_device_name()})")
