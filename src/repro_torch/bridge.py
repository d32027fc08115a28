"""Carry weights across from the JAX package.

The JAX param tree (``M.init_model(jax.random.key(seed), built)``) and the
per-split butterflies (``fold_in(key(seed), split)``) arrive as numpy
arrays in the same nested dict/list layout the port uses, so the bridge is
one tree map (and, for the ResNet, a transpose of each conv kernel).  It
takes numpy only: the caller does the ``np.asarray`` on the JAX side, and
the port never imports JAX.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import device as dev_lib
from repro_torch.tree import tree_map


def _to_tensor(a: np.ndarray) -> torch.Tensor:
    a = np.array(a)                         # a writable, contiguous copy
    if a.dtype.name == "bfloat16":          # ml_dtypes bf16: reinterpret bits
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def to_torch(tree, *, device="cuda", dtype: Optional[torch.dtype] = None):
    """Numpy tree -> tensor tree on ``device``; floating leaves are cast to
    ``dtype`` when it is given."""
    device = dev_lib.resolve(device)

    def conv(a):
        t = _to_tensor(a)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(device)

    return tree_map(conv, tree)


def resnet_to_torch(params_np, *, device="cuda",
                    dtype: Optional[torch.dtype] = None):
    """The JAX package's ResNet tree (numpy; HWIO conv kernels, ``(C,)``
    norm vectors, the ``(C, classes)`` head) -> the port's, whose conv
    kernels are OIHW (``models/resnet.py``)."""
    oihw = lambda a: np.transpose(a, (3, 2, 0, 1)) if np.ndim(a) == 4 else a
    return to_torch(tree_map(oihw, params_np), device=device, dtype=dtype)
