"""Param and cache trees: nested dicts and lists with tensors at the leaves,
the layout of the JAX package's pytrees, so a weight bridge or a layer-range
slice is one map over the tree."""
from __future__ import annotations

from typing import Callable, List


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` leafwise over trees of one structure (None stays None)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves(tree) -> List:
    if isinstance(tree, dict):
        return [l for v in tree.values() for l in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [l for v in tree for l in tree_leaves(v)]
    return [] if tree is None else [tree]
