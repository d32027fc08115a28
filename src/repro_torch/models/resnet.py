"""Paper-faithful ResNet-50 (He et al. 2015) with the butterfly unit after
any of the 16 residual blocks (port of ``repro/models/resnet.py``).

The API keeps the JAX package's layouts: activations and images are NHWC,
the wire is ``(B, H, W, d_r)`` int8 codes with ``(B, H, W, 1)`` f32 scales.
Conv kernels are stored OIHW, as ``F.conv2d`` takes them
(``bridge.resnet_to_torch`` turns the JAX package's HWIO kernels into
these).  An NHWC tensor seen through ``permute(0, 3, 1, 2)`` is an NCHW
tensor in ``channels_last`` memory, so every conv and pool runs on cuDNN's
channels-last path with no copy either way.

As in the JAX package, GroupNorm(32) stands in for BatchNorm, and the
butterfly is a 1x1 conv C -> d_r, the int8 wire (quantized per pixel over
its d_r channels), and a 1x1 conv d_r -> C.  The quantization is plain
PyTorch, as it is plain jnp in the reference: the ResNet path reaches no
kernel.  ``forward_resnet``'s wire is ``fake_quant``, whose gradient is
straight through, so the network and its butterfly train end to end.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import device as dev_lib
from repro_torch.configs.resnet50 import ResNetConfig
from repro_torch.core.quantization import dequantize, fake_quant, quantize
from repro_torch.models.common import trunc_normal

# ---------------------------------------------------------------------------
# primitives (NHWC in, NHWC out)
# ---------------------------------------------------------------------------


def _same_pads(n: int, k: int, stride: int):
    """XLA's ``"SAME"`` padding of one spatial axis: (low, high), the odd
    pixel at the high end (asymmetric at stride 2 on an even size)."""
    total = max((math.ceil(n / stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _conv_init(gen, kh, kw, cin, cout, dtype, device) -> torch.Tensor:
    fan_in = kh * kw * cin
    return trunc_normal(gen, (cout, cin, kh, kw), 2.0 / fan_in, dtype, device)


def conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """x (B, H, W, Cin), w (Cout, Cin, kh, kw) -> (B, H', W', Cout) with
    ``"SAME"`` padding: symmetric through the conv where XLA's is, an
    explicit ``F.pad`` where it is not."""
    k = w.shape[-1]
    (hlo, hhi), (wlo, whi) = (_same_pads(n, k, stride) for n in x.shape[1:3])
    pad = 0
    if hlo == hhi and wlo == whi:
        pad = hlo
    else:
        x = F.pad(x, (0, 0, wlo, whi, hlo, hhi))
    y = F.conv2d(x.permute(0, 3, 1, 2), w, stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1)


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over NHWC: ``g = min(groups, C)``, stepped down until it
    divides C; f32 statistics (population variance) and affine, then the
    cast back."""
    B, H, W, C = x.shape
    g = min(groups, C)
    while C % g:
        g -= 1
    xg = x.float().reshape(B, H * W, g, C // g)
    var, mean = torch.var_mean(xg, dim=(1, 3), correction=0, keepdim=True)
    xg = (xg - mean) * torch.rsqrt(var + eps)
    return (xg.reshape(B, H, W, C) * scale.float() + bias.float()).to(x.dtype)


def _norm_params(c, dtype, device):
    return {"scale": torch.ones((c,), dtype=dtype, device=device),
            "bias": torch.zeros((c,), dtype=dtype, device=device)}


def max_pool(x: torch.Tensor, window: int = 3, stride: int = 2) -> torch.Tensor:
    """Max pool over NHWC with ``"SAME"`` padding by -inf."""
    (hlo, hhi), (wlo, whi) = (_same_pads(n, window, stride) for n in x.shape[1:3])
    x = F.pad(x, (0, 0, wlo, whi, hlo, hhi), value=-math.inf)
    return F.max_pool2d(x.permute(0, 3, 1, 2), window, stride).permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# bottleneck residual block
# ---------------------------------------------------------------------------


def init_block(gen, cin, cout, stride, device, dtype=torch.float32) -> dict:
    mid = cout // 4
    p = {
        "conv1": _conv_init(gen, 1, 1, cin, mid, dtype, device),
        "n1": _norm_params(mid, dtype, device),
        "conv2": _conv_init(gen, 3, 3, mid, mid, dtype, device),
        "n2": _norm_params(mid, dtype, device),
        "conv3": _conv_init(gen, 1, 1, mid, cout, dtype, device),
        "n3": _norm_params(cout, dtype, device),
    }
    if cin != cout or stride != 1:
        p["proj"] = _conv_init(gen, 1, 1, cin, cout, dtype, device)
        p["np"] = _norm_params(cout, dtype, device)
    return p


def apply_block(p, x: torch.Tensor, stride: int) -> torch.Tensor:
    h = F.relu(group_norm(conv(x, p["conv1"]), **p["n1"]))
    h = F.relu(group_norm(conv(h, p["conv2"], stride), **p["n2"]))
    h = group_norm(conv(h, p["conv3"]), **p["n3"])
    if "proj" in p:
        x = group_norm(conv(x, p["proj"], stride), **p["np"])
    return F.relu(x + h)


# ---------------------------------------------------------------------------
# butterfly unit (paper Fig. 1/2: 1x1 conv down, wire, 1x1 conv up)
# ---------------------------------------------------------------------------


def init_butterfly_conv(gen, c, d_r, device, dtype=torch.float32) -> dict:
    return {"reduce": _conv_init(gen, 1, 1, c, d_r, dtype, device),
            "restore": _conv_init(gen, 1, 1, d_r, c, dtype, device)}


def apply_butterfly_conv(p, x: torch.Tensor, wire_bits: int = 8) -> torch.Tensor:
    """In-graph wire: reduce conv, quantize-dequantize, restore conv."""
    r = fake_quant(conv(x, p["reduce"]), wire_bits)
    return conv(r, p["restore"])


# ---------------------------------------------------------------------------
# full network
# ---------------------------------------------------------------------------


def _strides(cfg: ResNetConfig) -> list:
    """Each residual block's stride: 2 for a stage's first block after the
    first stage."""
    return [2 if (bi == 0 and si > 0) else 1
            for si, (blocks, _) in enumerate(cfg.stages) for bi in range(blocks)]


def init_resnet(gen: torch.Generator, cfg: ResNetConfig, *, device="cuda") -> dict:
    """Random params from ``gen``, in the JAX tree's layout with OIHW conv
    kernels, on ``device`` in ``cfg.dtype``."""
    device = dev_lib.resolve(device)
    dtype = dev_lib.torch_dtype(cfg.dtype)
    width = cfg.stages[-1][1]
    params = {
        "stem": _conv_init(gen, 7, 7, 3, cfg.stem_channels, dtype, device),
        "stem_n": _norm_params(cfg.stem_channels, dtype, device),
        "blocks": [],
        "head": trunc_normal(gen, (width, cfg.num_classes), 1.0 / width, dtype,
                             device),
    }
    cin = cfg.stem_channels
    for stride, cout in zip(_strides(cfg), cfg.block_channels()):
        params["blocks"].append(init_block(gen, cin, cout, stride, device, dtype))
        cin = cout
    if cfg.butterfly is not None:
        c = cfg.block_channels()[cfg.butterfly.layer - 1]
        params["butterfly"] = init_butterfly_conv(gen, c, cfg.butterfly.d_r,
                                                  device, dtype)
    return params


def _stem(params, images: torch.Tensor) -> torch.Tensor:
    return max_pool(F.relu(group_norm(conv(images, params["stem"], 2),
                                      **params["stem_n"])))


def _head(params, x: torch.Tensor) -> torch.Tensor:
    return x.mean(dim=(1, 2)) @ params["head"]


def forward_resnet(params, images: torch.Tensor, cfg: ResNetConfig,
                   train: bool = True) -> torch.Tensor:
    """images (B, H, W, 3) -> logits (B, num_classes), the butterfly's wire
    in-graph (``fake_quant``) where the config has one.  ``train`` changes
    nothing, as in the JAX package: GroupNorm keeps no running statistics,
    and the wire is ``fake_quant`` either way."""
    x = _stem(params, images)
    for b, stride in enumerate(_strides(cfg), start=1):
        x = apply_block(params["blocks"][b - 1], x, stride)
        if cfg.butterfly is not None and b == cfg.butterfly.layer:
            x = apply_butterfly_conv(params["butterfly"], x,
                                     cfg.butterfly.wire_bits)
    return _head(params, x)


def edge_half(params, images: torch.Tensor, cfg: ResNetConfig) -> dict:
    """The edge: stem, blocks ``[1, split]``, reduce conv and quantize.
    Returns the wire, ``{"codes": (B, H, W, d_r) int8, "scales": (B, H, W,
    1) f32}``, the only data that leaves the device."""
    if cfg.butterfly is None:
        raise ValueError(f"{cfg.name} has no butterfly to split at")
    strides = _strides(cfg)
    x = _stem(params, images)
    for b in range(cfg.butterfly.layer):
        x = apply_block(params["blocks"][b], x, strides[b])
    codes, scales = quantize(conv(x, params["butterfly"]["reduce"]),
                             cfg.butterfly.wire_bits)
    return {"codes": codes, "scales": scales}


def cloud_half(params, wire: dict, cfg: ResNetConfig, dtype) -> torch.Tensor:
    """The cloud: dequantize, restore conv, blocks ``(split, 16]``, pool and
    head -> logits (B, num_classes)."""
    strides = _strides(cfg)
    x = conv(dequantize(wire["codes"], wire["scales"], dtype),
             params["butterfly"]["restore"])
    for b in range(cfg.butterfly.layer, cfg.num_blocks):
        x = apply_block(params["blocks"][b], x, strides[b])
    return _head(params, x)


def edge_cloud_split(params, images: torch.Tensor, cfg: ResNetConfig):
    """Run the split explicitly: the edge half's quantized wire, then the
    cloud half on it.  Returns (logits, wire)."""
    wire = edge_half(params, images, cfg)
    return cloud_half(params, wire, cfg, images.dtype), wire
