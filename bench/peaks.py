"""Published peaks of the cards the benchmark runs on (NVIDIA's data sheet,
dense rates without sparsity, at the full power limit)."""
from __future__ import annotations

from typing import Optional

# H100 SXM: 989 TFLOP/s bf16, 67 TFLOP/s f32 outside the tensor cores,
# 3.35 TB/s of HBM3
H100 = {"bf16_flops": 989e12, "f32_flops": 67e12, "hbm_bytes_per_s": 3.35e12}


def for_device(kind: str) -> Optional[dict]:
    """The peaks of the card named ``kind`` (``torch.cuda.get_device_name``),
    or None for a card this table does not know."""
    return H100 if "H100" in kind else None
