"""The one traffic generator: turns a traffic file's parameters and a seed
into the calls a driver serves.

A mix lists its prompt lengths; each cycle of calls sends every length
once, in an order drawn from the seed, so every seed offers the same work
in another order.  A call is a (batch, length) block of token ids, drawn
uniformly from the vocabulary.  Warm-up calls draw their ids from a
stream of their own, so the window's calls do not depend on them.
"""
from __future__ import annotations

from typing import Iterator, List, Tuple

import numpy as np
import torch

# independent random streams of one seed
ORDER, TOKENS, WARMUP, SAMPLE, KEEP = 1, 2, 3, 4, 5


def rng(seed: int, stream: int, *more: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 64), stream, *more])


class Traffic:
    def __init__(self, mix: dict, vocab: int, seed: int):
        self.mix, self.vocab, self.seed = mix, vocab, seed
        self.batch = int(mix["batch"])
        self.lengths = [int(n) for n in mix["lengths"]]

    def _tokens(self, stream: int, index: int, length: int) -> torch.Tensor:
        ids = rng(self.seed, stream, index).integers(
            0, self.vocab, size=(self.batch, length), dtype=np.int64)
        return torch.from_numpy(ids)

    def length(self, index: int) -> int:
        n = len(self.lengths)
        order = rng(self.seed, ORDER, index // n).permutation(n)
        return self.lengths[order[index % n]]

    def call(self, index: int) -> torch.Tensor:
        """Call ``index``'s prompts (batch, length), int64 on the host."""
        return self._tokens(TOKENS, index, self.length(index))

    def calls(self) -> Iterator[Tuple[int, torch.Tensor]]:
        """(index, prompts) of every call, in order, without end."""
        index = 0
        while True:
            yield index, self.call(index)
            index += 1

    def warmup(self) -> List[torch.Tensor]:
        return [self._tokens(WARMUP, i, int(n))
                for i, n in enumerate(self.mix["warmup_lengths"])]
