"""Plain PyTorch versions of the port's kernels: what the wrappers in
``kernels/ops.py`` run on a CPU tensor, and what the kernels are held
against on the card.  They follow ``repro/kernels/ref.py``: f32 product,
per-row absmax, scale, round half to even, clip."""
from __future__ import annotations

import torch


def butterfly_reduce_quant_ref(x: torch.Tensor, w_reduce: torch.Tensor,
                               bits: int = 8):
    """x: (T, d), w_reduce: (d, d_r) -> (codes int8 (T, d_r), scales f32 (T, 1))."""
    qmax = 2 ** (bits - 1) - 1
    r = x.float() @ w_reduce.float()
    absmax = r.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(absmax, min=1e-8) / qmax
    codes = torch.clamp(torch.round(r / scale), -qmax - 1, qmax).to(torch.int8)
    return codes, scale


def butterfly_dequant_restore_ref(codes: torch.Tensor, scales: torch.Tensor,
                                  w_restore: torch.Tensor,
                                  out_dtype=torch.float32) -> torch.Tensor:
    """codes: (T, d_r) int8, scales (T, 1) f32, w_restore (d_r, d) -> (T, d)."""
    r = codes.float() * scales
    return (r @ w_restore.float()).to(out_dtype)
