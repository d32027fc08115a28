"""Production rank grids (port of ``repro/launch/mesh.py``).

Functions, never module-level constants, as in the JAX package: a grid is a
description (``models.parallel.RankGrid``, the counterpart of a
``jax.sharding.Mesh``), and building its process groups needs a
``torch.distributed`` world of that many ranks (``parallel.make_context``).
"""
from __future__ import annotations

import numpy as np

from repro_torch.models.parallel import RankGrid


def make_production_mesh(*, multi_pod: bool = False) -> RankGrid:
    """(16, 16) over ``("data", "model")``, or (2, 16, 16) over ``("pod",
    "data", "model")`` with ``multi_pod``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return RankGrid(shape, axes)


def make_local_mesh() -> RankGrid:
    """A one-rank grid with the production axis names."""
    return RankGrid((1, 1), ("data", "model"))


def mesh_chips(mesh: RankGrid) -> int:
    return int(np.prod(mesh.shape))
