"""The butterfly unit (port of ``repro/core/butterfly.py``):

  reduction unit  : learned projection  d -> d_r   (edge side)
  wire            : int8 symmetric quantization (+ f32 scales)
  restoration unit: learned projection  d_r -> d   (cloud side)

``use_kernel=True`` runs the fused reduce+quant / dequant+restore wrappers
(``kernels/ops.py``: the Hopper kernels on a CUDA tensor, their plain
versions on a CPU tensor, with f32 products; the fused codec emits int8
codes, so it takes ``wire_bits <= 8`` and raises otherwise);
``use_kernel=False`` runs the unfused ops in the activation dtype, as the JAX
package's plain path does.
``apply_butterfly(train=True)`` is the training form: the wire is
``fake_quant``, whose straight-through gradient trains the unit end to end
(the JAX package trains with no kernel either: its Pallas kernels have no
backward).  A 1x1 conv over NHWC (the paper's ResNet form,
``models/resnet.py``) is the same per-position linear map.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ButterflyConfig
from repro_torch.core.quantization import dequantize, fake_quant, quantize, \
    wire_bytes
from repro_torch.kernels import ops as kops
from repro_torch.models.common import dense_init


def init_butterfly(gen: torch.Generator, d: int, bf: ButterflyConfig, dtype,
                   device) -> dict:
    return {
        "w_reduce": dense_init(gen, d, bf.d_r, dtype, device),
        "w_restore": dense_init(gen, bf.d_r, d, dtype, device,
                                scale=1.0 / bf.d_r),
    }


def reduce_unit(params, x: torch.Tensor, *, use_kernel: bool = False,
                wire_bits: int = 8):
    """Edge half: project + quantize.  Returns (codes, scales)."""
    if use_kernel:
        return kops.butterfly_reduce_quant(x, params["w_reduce"], bits=wire_bits)
    return quantize(x @ params["w_reduce"], wire_bits)


def restore_unit(params, codes: torch.Tensor, scales: torch.Tensor, dtype,
                 *, use_kernel: bool = False) -> torch.Tensor:
    """Cloud half: dequantize + project back to d."""
    if use_kernel:
        return kops.butterfly_dequant_restore(codes, scales,
                                              params["w_restore"],
                                              out_dtype=dtype)
    return dequantize(codes, scales, dtype) @ params["w_restore"]


def apply_butterfly(params, x: torch.Tensor, *, wire_bits: int = 8,
                    train: bool = False, use_kernel: bool = False) -> torch.Tensor:
    """In-graph wire: reduce, quantize, dequantize, restore.  ``train=True``
    quantizes through the straight-through ``fake_quant``, whatever
    ``use_kernel`` says.  ``train`` defaults to False (the JAX function's
    default is True): every caller but the training forward serves."""
    if train:
        return fake_quant(x @ params["w_reduce"], wire_bits) @ params["w_restore"]
    if use_kernel:
        codes, scales = reduce_unit(params, x, use_kernel=True,
                                    wire_bits=wire_bits)
        return restore_unit(params, codes, scales, x.dtype, use_kernel=True)
    codes, scales = quantize(x @ params["w_reduce"], wire_bits)
    return dequantize(codes, scales, x.dtype) @ params["w_restore"]


def butterfly_wire_bytes(batch: int, seq: int, d_r: int, wire_bits: int = 8) -> int:
    return wire_bytes((batch, seq, d_r), wire_bits)


def compression_ratio(d: int, d_r: int, act_bits: int, wire_bits: int = 8) -> float:
    """Feature-volume compression vs. shipping the raw boundary tensor."""
    return (d * act_bits) / (d_r * wire_bits)
