"""The paper's own architecture: ResNet-50 (16 residual blocks) for the
faithful reproduction of Fig. 4/5/7 and Tables IV/V. [He et al. 2015; paper 3]

These are conv configs, handled by ``models/resnet.py`` rather than the
transformer stack; registered here so ``--arch resnet50`` works everywhere.
(Port of ``repro/configs/resnet50.py``; the cost model and
``models/resnet.py`` read it.)
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional

from repro_torch.configs.base import ButterflyConfig, register


@dataclass(frozen=True)
class ResNetConfig:
    name: str = "resnet50"
    arch_type: str = "resnet"
    # stage spec: (blocks, out_channels) per stage; ResNet-50 = 3,4,6,3
    stages: tuple = ((3, 256), (4, 512), (6, 1024), (3, 2048))
    stem_channels: int = 64
    num_classes: int = 100           # miniImageNet: 100 classes
    image_size: int = 224
    butterfly: Optional[ButterflyConfig] = None   # layer == residual-block index (1-based "after RB j")
    dtype: str = "float32"
    source: str = "arXiv:1512.03385; paper Figs. 4-6"

    @property
    def num_blocks(self) -> int:
        return sum(b for b, _ in self.stages)     # 16 for ResNet-50

    def block_channels(self) -> list[int]:
        """Output channel size of each residual block (paper's C_i)."""
        out = []
        for blocks, ch in self.stages:
            out += [ch] * blocks
        return out

    def block_spatial(self) -> list[int]:
        """Output spatial size (square) of each residual block for 224 input."""
        out, size = [], self.image_size // 4       # stem: conv s2 + pool s2 -> 56
        for si, (blocks, _) in enumerate(self.stages):
            if si > 0:
                size //= 2                          # first block of stage downsamples
            out += [size] * blocks
        return out

    def feature_bytes(self, block: int, bits: int = 8, channels: Optional[int] = None) -> int:
        """Wire bytes if offloading after residual block ``block`` (1-based)."""
        ch = channels if channels is not None else self.block_channels()[block - 1]
        sp = self.block_spatial()[block - 1]
        return (sp * sp * ch * bits + 7) // 8      # ceil: sub-byte wires pack

    def with_butterfly(self, block: int, d_r: int, wire_bits: int = 8) -> "ResNetConfig":
        return replace(self, butterfly=ButterflyConfig(layer=block, d_r=d_r, wire_bits=wire_bits))

    def reduced(self) -> "ResNetConfig":
        return replace(
            self, name=self.name + "-reduced",
            stages=((1, 32), (1, 64)), stem_channels=16,
            num_classes=10, image_size=32,
            butterfly=ButterflyConfig(layer=1, d_r=4) if self.butterfly else None,
        )


@register("resnet50")
def resnet50() -> ResNetConfig:
    return ResNetConfig()


# Minimal D_r per split reported by the paper (Fig. 7): RB1-3 -> 1, RB4-7 -> 2,
# RB8-13 -> 5, RB14-16 -> 10, for <2% accuracy loss on miniImageNet.
PAPER_MIN_DR = {**{rb: 1 for rb in (1, 2, 3)},
                **{rb: 2 for rb in (4, 5, 6, 7)},
                **{rb: 5 for rb in range(8, 14)},
                **{rb: 10 for rb in (14, 15, 16)}}
