"""The comparison that decides ``correct``.

Once the window has closed and the program's state is freed, a sample of
the requests the window finished (the longest among them, the rest drawn
from the seed one batch slot after another) is run through the plain reference in float32, on the
prompts the program served.  Two numbers are compared, each the worst
over the sample:

- ``logit_rel_err``: ``||p - r|| / ||r||`` of the program's last-position
  logits ``p`` (as the timed path returned them) against the reference's
  ``r``: covers the edge layers, the wire and the cloud layers with the
  head;
- ``token_gap``: ``(max r - r[t]) / std r`` of the first token ``t`` the
  timed path served (greedy): how far below the reference's best the
  served token's logit lies, in units of the logits' spread.

The control (``control_numbers``) reads the same two numbers for the
reference computed in a lower precision, put in the program's place.
"""
from __future__ import annotations

from collections import Counter, defaultdict
from dataclasses import dataclass
from typing import Dict, List

import torch

from bench.generator import SAMPLE, rng

BLOCK = 32                    # rows of one length the reference takes at once


@dataclass
class Row:
    """One request the window finished: its prompt, what was served."""
    call: int
    row: int
    tokens: torch.Tensor          # (S,) int64, host
    served: int                   # the first token served
    logits: torch.Tensor          # (V,) float32, host: the program's

    @property
    def length(self) -> int:
        return self.tokens.shape[0]


def sample(rows: List[Row], seed: int, k: int) -> List[Row]:
    """The longest row (the first of them) and ``k - 1`` others drawn from
    ``seed`` slot by slot: no batch slot gives a second row before every
    slot the rows hold has given one, so ``k`` at least the batch covers
    every slot."""
    longest = max(rows, key=lambda r: (r.length, -r.call, -r.row))
    taken = Counter({longest.row: 1})
    ranked = []
    for i in rng(seed, SAMPLE).permutation(len(rows)):
        r = rows[i]
        if r is not longest:
            ranked.append((taken[r.row], len(ranked), r))
            taken[r.row] += 1
    ranked.sort(key=lambda t: t[:2])
    pick = sorted((t[2] for t in ranked[:k - 1]), key=lambda r: (r.call, r.row))
    return [longest] + pick


def reference_logits(ref, params, butterfly, cfg: dict, rows: List[Row],
                     mm=None) -> List[torch.Tensor]:
    """The reference's last-position logits (V,) of each row, on the host;
    rows of one length go through in blocks of :data:`BLOCK`."""
    mm = ref.f32_mm if mm is None else mm
    by_length: Dict[int, List[int]] = defaultdict(list)
    for i, r in enumerate(rows):
        by_length[r.length].append(i)
    out: List[torch.Tensor] = [None] * len(rows)
    for idx in by_length.values():
        for j in range(0, len(idx), BLOCK):
            part = idx[j:j + BLOCK]
            toks = torch.stack([rows[i].tokens for i in part])
            logits = ref.last_logits(params, butterfly, cfg, toks, mm=mm)
            for i, row in zip(part, logits.cpu()):
                out[i] = row
    return out


def _gap(r: torch.Tensor, token: int) -> float:
    return float((r.max() - r[token]) / r.std())


def numbers(rows: List[Row], ref: List[torch.Tensor]) -> Dict[str, float]:
    """The program's two numbers over ``rows`` against the reference."""
    rel = max(float((r.logits - q).norm() / q.norm()) for r, q in zip(rows, ref))
    gap = max(_gap(q, r.served) for r, q in zip(rows, ref))
    return {"logit_rel_err": rel, "token_gap": gap}


def control_numbers(control: List[torch.Tensor],
                    ref: List[torch.Tensor]) -> Dict[str, float]:
    """The same numbers for the control's logits, its greedy token taken
    where the program's served one is."""
    rel = max(float((c - q).norm() / q.norm()) for c, q in zip(control, ref))
    gap = max(_gap(q, int(c.argmax())) for c, q in zip(control, ref))
    return {"logit_rel_err": rel, "token_gap": gap}


def judge(found: Dict[str, float], limits: Dict[str, dict]):
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit; a number that is not finite fails."""
    table = {name: {"value": found[name], "limit": lim["limit"]}
             for name, lim in limits.items()}
    ok = all(v["value"] <= v["limit"] for v in table.values())
    return ok, table
