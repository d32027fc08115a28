"""Public wrappers for the port's kernels (port of the butterfly,
RMSNorm and flash-attention parts of ``repro/kernels/ops.py``).

A CPU tensor takes the plain PyTorch version (``kernels/ref.py``); a CUDA
tensor launches the hand-written Hopper kernel (``kernels/butterfly_kernel``)
or raises.  There is no fallback from one to the other.

The JAX wrappers route rows <= 8 to a jnp fast path and pad the row count
to the Pallas block (the bincount wrapper then takes the pad rows' counts
back out); all of it exists only because of Pallas dispatch and TPU
tiling.  On the card every row count goes through the kernel, which masks
the ragged edge itself, so neither is kept here.  For the same reason the
flash kernel takes any S and T, where the Pallas kernel asserts that its
blocks divide them.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import butterfly_kernel, flash_attention as fa, ref
from repro_torch.kernels import rmsnorm as rmsnorm_kernel


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


def butterfly_reduce_quant_bincount(x: torch.Tensor, w_reduce: torch.Tensor,
                                    *, bits: int = 8):
    """Fused reduce+quant+histogram: x (..., d) -> (codes (..., d_r) int8,
    scales (..., 1) f32, counts (d_r, 2**bits) int32).  ``counts`` is the
    per-channel histogram of the codes' symbols (``code + 2**(bits-1)``),
    what ``core/wire_codec.WirePrior.from_counts`` and
    ``estimate_coded_bytes`` read; codes and scales are those of
    :func:`butterfly_reduce_quant`."""
    if bits > 8:
        raise ValueError(f"the fused codec emits int8 codes: bits={bits} > 8")
    shape = x.shape
    d_r = w_reduce.shape[1]
    xf = x.reshape(-1, shape[-1])
    if _on_cpu(x):
        codes, scales, counts = ref.butterfly_reduce_quant_bincount_ref(
            xf, w_reduce, bits)
    else:
        codes, scales, counts = butterfly_kernel.reduce_quant_bincount(
            xf.contiguous(), w_reduce.contiguous(), bits)
    return (codes.reshape(*shape[:-1], d_r), scales.reshape(*shape[:-1], 1),
            counts)


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


def butterfly_restore_norm(codes: torch.Tensor, scales: torch.Tensor,
                           w_restore: torch.Tensor, norm_w: torch.Tensor, *,
                           eps: float = 1e-6, out_dtype=torch.float32
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused dequant + restore + the first cloud layer's RMSNorm.

    codes: (..., d_r) int8, scales (..., 1) f32, norm_w (d,) or (1, d) ->
    (x (..., d), h (..., d)) in ``out_dtype``: x the restored boundary
    activation, h ``rms_norm(x, norm_w)`` of x after its cast.  On the card
    x equals :func:`butterfly_dequant_restore` and h equals :func:`rmsnorm`
    of that x, bit for bit."""
    shape = codes.shape
    d = w_restore.shape[1]
    cf = codes.reshape(-1, shape[-1])
    sf = scales.reshape(-1, 1)
    nw = norm_w.reshape(d)
    if _on_cpu(codes):
        x, h = ref.butterfly_restore_norm_ref(cf, sf, w_restore, nw, eps,
                                              out_dtype)
    else:
        x, h = butterfly_kernel.dequant_restore_norm(
            cf.contiguous(), sf.contiguous(), w_restore.contiguous(),
            nw.contiguous(), eps, out_dtype)
    return x.reshape(*shape[:-1], d), h.reshape(*shape[:-1], d)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """x: (..., d) -> RMSNorm with the gemma-style ``1 + w`` weight, in x's
    dtype."""
    shape = x.shape
    xf = x.reshape(-1, shape[-1])
    if _on_cpu(x):
        out = ref.rms_norm_ref(xf, w, eps)
    else:
        out = rmsnorm_kernel.rmsnorm(xf.contiguous(), w.contiguous(), eps)
    return out.reshape(shape)


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return ref.rms_norm_ref(x, w, eps)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q (B,S,N,hd), k/v (B,T,K,hd) -> (B,S,N,hd) in q's dtype; queries
    align to the end of the keys, ``window`` (>= 1) bounds how far back a
    query sees."""
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if _on_cpu(q):
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    return fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                              causal=causal, window=window)
