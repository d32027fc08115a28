"""Numpy ``.npz`` checkpoints in the JAX package's format (port of
``repro/training/checkpoint.py``), so either package restores what the
other saved.

Keys are ``params/<path>`` and ``opt/<path>``, the path the tree's dict
keys and list indices joined by ``/``; beside the archive, ``<path>.meta.json``
holds ``step`` and the caller's metadata.  A bf16 leaf is stored as the JAX
package stores it: its bits as a 2-byte void array (``dtype('V2')``), which
restore reinterprets as bf16.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch


def _map_with_paths(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` over a tree of dicts and lists, the path its keys
    and indices joined by ``/`` (the JAX package's key names)."""
    if isinstance(tree, dict):
        return {k: _map_with_paths(fn, v, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_with_paths(fn, v, f"{prefix}{i}/") for i, v in enumerate(tree)]
    return fn(prefix[:-1], tree)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _from_numpy(a: np.ndarray) -> torch.Tensor:
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:      # bf16 bits
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def save_checkpoint(path: str, params, opt_state=None, step: int = 0,
                    metadata: dict | None = None) -> str:
    if not path.endswith(".npz"):
        path = path + ".npz"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {}

    def put(key, leaf):
        payload[key] = _to_numpy(leaf)
    _map_with_paths(put, params, "params/")
    if opt_state is not None:
        _map_with_paths(put, opt_state, "opt/")
    np.savez(path, **payload)
    meta = dict(metadata or {}, step=step)
    with open(path + ".meta.json", "w") as f:
        json.dump(meta, f)
    return path


def restore_checkpoint(path: str, params_template, opt_template=None):
    """(params, opt state or None, metadata), each leaf in its template
    leaf's dtype and on its device; a leaf whose shape differs from the
    template's raises."""
    if not path.endswith(".npz"):
        path = path + ".npz"

    with np.load(path) as data:
        def leaf(key, like):
            t = _from_numpy(data[key])
            if t.shape != like.shape:
                raise ValueError(f"{key}: checkpoint shape {tuple(t.shape)}, "
                                 f"template {tuple(like.shape)}")
            return t.to(device=like.device, dtype=like.dtype)

        params = _map_with_paths(leaf, params_template, "params/")
        opt = None if opt_template is None else \
            _map_with_paths(leaf, opt_template, "opt/")
    meta = {}
    if os.path.exists(path + ".meta.json"):
        with open(path + ".meta.json") as f:
            meta = json.load(f)
    return params, opt, meta
