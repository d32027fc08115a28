"""Data pipelines (port of ``repro/data/pipeline.py``; offline: procedurally
generated datasets, numpy only, so the arrays are the JAX package's exactly).

LM stream       — a Zipfian Markov-chain language whose bigram structure a
                  small LM can learn (loss decreases measurably in ~100 steps),
                  used by the end-to-end training example.
Image dataset   — the synthetic classification task for the ResNet/butterfly
                  reproduction of the paper's Fig. 7: each class is a distinct
                  oriented-grating + color pattern with additive noise, so
                  accuracy is a meaningful signal at small scale.

Both pipelines are deterministic in seed and yield numpy; ``shard_batch``
moves a batch to its device, and under an automatic ``ParallelContext``
keeps only this rank's block of it.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np

# ---------------------------------------------------------------------------
# LM stream
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LMStreamConfig:
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    branching: int = 4       # out-degree of the Markov chain


class MarkovLMStream:
    """Zipfian Markov chain over the vocab: learnable synthetic language."""

    def __init__(self, cfg: LMStreamConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        V, B = cfg.vocab_size, cfg.branching
        self.next_tokens = rng.integers(0, V, size=(V, B), dtype=np.int32)
        probs = 1.0 / np.arange(1, B + 1)
        self.next_probs = probs / probs.sum()
        self.rng = rng

    def _walk(self, n: int) -> np.ndarray:
        V, B = self.cfg.vocab_size, self.cfg.branching
        out = np.empty(n, np.int32)
        tok = int(self.rng.integers(0, V))
        choices = self.rng.choice(B, size=n, p=self.next_probs)
        for i in range(n):
            out[i] = tok
            tok = int(self.next_tokens[tok, choices[i]])
        return out

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        c = self.cfg
        toks = np.stack([self._walk(c.seq_len + 1) for _ in range(c.batch_size)])
        return {"tokens": toks[:, :-1].astype(np.int32),
                "targets": toks[:, 1:].astype(np.int32)}


def lm_batches(vocab_size: int, seq_len: int, batch_size: int, seed: int = 0):
    return MarkovLMStream(LMStreamConfig(vocab_size, seq_len, batch_size, seed))


# ---------------------------------------------------------------------------
# synthetic image classification (ResNet / Fig. 7 reproduction)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ImageTaskConfig:
    num_classes: int = 10
    image_size: int = 32
    noise: float = 0.35
    seed: int = 0


class SyntheticImages:
    """Class = (orientation, frequency, color) grating + noise."""

    def __init__(self, cfg: ImageTaskConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        n = cfg.num_classes
        self.angles = rng.uniform(0, np.pi, n)
        self.freqs = rng.uniform(2.0, 6.0, n)
        self.colors = rng.uniform(0.3, 1.0, (n, 3))
        self.phases = rng.uniform(0, 2 * np.pi, n)

    def batch(self, batch_size: int, rng: np.random.Generator):
        c = self.cfg
        ys = rng.integers(0, c.num_classes, batch_size)
        xs = np.empty((batch_size, c.image_size, c.image_size, 3), np.float32)
        grid = np.linspace(-1, 1, c.image_size)
        gx, gy = np.meshgrid(grid, grid)
        for i, y in enumerate(ys):
            a, f, ph = self.angles[y], self.freqs[y], self.phases[y]
            pattern = np.sin(f * (np.cos(a) * gx + np.sin(a) * gy) * np.pi + ph)
            img = pattern[..., None] * self.colors[y][None, None, :]
            img = img + rng.normal(0, c.noise, img.shape)
            xs[i] = img
        return xs.astype(np.float32), ys.astype(np.int32)


def image_batches(batch_size: int, cfg: Optional[ImageTaskConfig] = None,
                  seed: int = 1) -> Iterator[tuple]:
    cfg = cfg or ImageTaskConfig()
    task = SyntheticImages(cfg)
    rng = np.random.default_rng(seed)
    while True:
        yield task.batch(batch_size, rng)


# ---------------------------------------------------------------------------
# device placement over the data axes
# ---------------------------------------------------------------------------


def shard_batch(batch: dict, pctx=None, *, device="cuda") -> dict:
    """The batch's leaves (numpy arrays or tensors) as tensors on
    ``device``.  With an automatic context (``models.parallel.make_context``)
    each leaf keeps this rank's block of its leading dim over the data
    axes, pod-major (block ``pod * |data| + data``, as ``P(("pod",
    "data"))`` lays it out); a batch smaller than the data axes stays whole
    on every rank (run it under ``pctx.for_batch(B)``), and one they do not
    divide raises ValueError."""
    import torch

    from repro_torch import device as dev_lib
    from repro_torch.tree import tree_leaves, tree_map
    device = dev_lib.resolve(device)
    out = tree_map(lambda a: torch.as_tensor(np.asarray(a) if not
                                             isinstance(a, torch.Tensor) else a,
                                             device=device), batch)
    if pctx is None or pctx.grid is None:
        return out
    B = tree_leaves(out)[0].shape[0]
    if not pctx.batch_sharded(B):
        return out
    n = B // pctx.dp_size
    return tree_map(lambda t: t[pctx.data_rank * n:(pctx.data_rank + 1) * n],
                    out)
