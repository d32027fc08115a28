"""A cell at a size the CPU runs in a second: the qwen3-8b configuration
cut in every width and the depth, traffic of the cells' shapes cut to
match, and the cells' own limits."""
from __future__ import annotations

import copy
import json

from bench.harness import BENCH, ROOT, Cell, _json


def config() -> dict:
    cfg = _json(BENCH / "configs" / "qwen3-8b.json")
    cfg.update(name="qwen3-tiny", hidden_size=64, head_dim=16,
               intermediate_size=128, num_attention_heads=4,
               num_key_value_heads=2, num_hidden_layers=6, vocab_size=256)
    cfg["split"] = dict(cfg["split"], layer=2, d_r=16)
    return cfg


def cell(traffic: str) -> Cell:
    """A tiny cell with the traffic mix ``traffic`` cut to short prompts
    and the limits of the qwen3-8b cell that uses the mix."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    wl = next(w for w in spec["workloads"] if w["traffic"] == traffic)
    full = Cell.load(wl["name"], spec)
    mix = copy.deepcopy(full.mix)
    mix["lengths"] = [max(4, n // 64) for n in mix["lengths"]]
    mix["warmup_lengths"] = [max(4, n // 64) for n in mix["warmup_lengths"]]
    mix["batch"] = min(mix["batch"], 8)
    mix["trace_calls"] = 2
    return Cell(name=full.name, chips=1, cfg=config(), mix=mix,
                limits=full.limits, end_to_end=full.end_to_end,
                per_layer=full.per_layer)
