"""One run of one cell: set-up, the measured window, the traced segment,
the correctness check, and the metrics by their readers.

The cell's parts are found by name (see ``bench/__init__.py``); nothing
here names a configuration, a traffic mix or a metric.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, List, Optional

import torch

from bench import check as check_lib
from bench import peaks as peaks_lib
from bench import trace as trace_lib
from bench.generator import KEEP, Traffic, rng

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# top-level module names that no run may hold once its window has closed
BANNED = frozenset({"jax", "jaxlib", "flax", "repro"})


def load(path: Path):
    """The module in file ``path`` (names may hold '-' or '.')."""
    name = "bench_" + "_".join(path.relative_to(BENCH).with_suffix("").parts)
    name = name.replace("-", "_").replace(".", "_")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """A workload of ``BENCHMARK.json`` with everything it is made of."""
    name: str
    chips: int
    cfg: dict
    mix: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    @classmethod
    def load(cls, workload: str, spec: Optional[dict] = None) -> "Cell":
        spec = _json(ROOT / "BENCHMARK.json") if spec is None else spec
        wl = next((w for w in spec["workloads"] if w["name"] == workload), None)
        if wl is None:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        conf = next(c for c in spec["configs"] if c["name"] == wl["config"])

        def mine(m):
            return workload in m.get("workloads", [workload])
        return cls(name=workload, chips=wl["chips"],
                   cfg=_json(ROOT / conf["file"]),
                   mix=_json(BENCH / "traffic" / f"{wl['traffic']}.json"),
                   limits=_json(BENCH / "limits" / f"{workload}.json"),
                   end_to_end=[m for m in spec["end_to_end"] if mine(m)],
                   per_layer=[m for m in spec["per_layer"] if mine(m)])


@dataclass
class Call:
    """One call the window issued and completed."""
    index: int
    batch: int
    length: int
    t_issue: float
    t_done: float
    spans: dict

    @property
    def seconds(self) -> float:
        return self.t_done - self.t_issue


@dataclass
class Run:
    """What the metric readers read."""
    cfg: dict
    setup_s: float
    window_s: float
    calls: List[Call]
    peaks: Optional[dict]
    trace: Optional[trace_lib.Trace] = None
    traced_calls: List[Call] = field(default_factory=list)

    @property
    def requests(self) -> int:
        return sum(c.batch for c in self.calls)

    @property
    def tokens(self) -> int:
        return sum(c.batch * c.length for c in self.calls)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _serve(system, index: int, tokens: torch.Tensor) -> tuple:
    t0 = time.perf_counter()
    logits, first, spans = system.serve(tokens)
    call = Call(index, tokens.shape[0], tokens.shape[1], t0,
                time.perf_counter(), spans)
    return call, logits, first


def kept_rows(seed: int, index: int, batch: int, keep: int) -> List[int]:
    """The rows of call ``index`` kept for the check: slot ``index %
    batch``, so that every ``batch`` calls keep every slot, and ``keep - 1``
    others drawn from the seed."""
    first = index % batch
    others = [r for r in range(batch) if r != first]
    pick = rng(seed, KEEP, index).choice(
        len(others), size=min(keep - 1, len(others)), replace=False)
    return sorted([first] + [others[i] for i in pick])


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, plant: Optional[Callable] = None,
             kind: Optional[str] = None,
             inspect: Optional[Callable] = None) -> dict:
    """Run ``cell`` once and return its result (the keys of the result
    line).  ``plant(system)`` may break the system under test, for the
    tests that see ``correct`` come out false; ``inspect(ref, params,
    butterfly, rows, ref_logits)``, called after the check, returns what
    the result keeps under ``"inspect"`` (the control's readings)."""
    device = torch.device(device)
    cfg, mix = cell.cfg, cell.mix
    ref = load(BENCH / "references" / f"{cfg['family']}.py")
    port = load(BENCH / "ports" / f"{cfg['family']}.py")
    driver = load(BENCH / "drivers" / f"{mix['driver']}.py")

    params, butterfly = ref.make_weights(cfg, seed, device)
    system = driver.System(port.model_config(cfg), cfg, params, butterfly,
                           device)
    if plant is not None:
        plant(system)
    traffic = Traffic(mix, cfg["vocab_size"], seed)
    for tokens in traffic.warmup():
        system.serve(tokens)
    _sync(device)
    setup_s = time.perf_counter() - t_start

    calls: List[Call] = []
    kept: List[check_lib.Row] = []
    stream = traffic.calls()
    # whole cycles of the lengths and of the batch's slots: every seed does
    # the same work and keeps every slot; none starts after ``seconds``
    cycle = math.lcm(len(mix["lengths"]), mix["batch"])
    t0 = time.perf_counter()
    while len(calls) % cycle or time.perf_counter() - t0 < seconds:
        index, tokens = next(stream)
        call, logits, first = _serve(system, index, tokens)
        calls.append(call)
        kept += [check_lib.Row(index, r, tokens[r], int(first[r]),
                               logits[r].clone())
                 for r in kept_rows(seed, index, call.batch,
                                    mix["keep_rows_per_call"])]
    window_s = time.perf_counter() - t0

    run = Run(cfg, setup_s, window_s, calls,
              peaks_lib.for_device(kind) if kind else None)
    t1 = time.perf_counter()
    if trace:
        def segment():
            for _ in range(mix["trace_calls"]):
                run.traced_calls.append(_serve(system, *next(stream))[0])
        run.trace = trace_lib.profiled(segment)
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    del system
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t2 = time.perf_counter()
    rows = check_lib.sample(kept, seed, mix["check_sample"])
    ref_logits = check_lib.reference_logits(ref, params, butterfly, cfg, rows)
    found = check_lib.numbers(rows, ref_logits)
    correct, table = check_lib.judge(found, cell.limits)
    t3 = time.perf_counter()
    seen = inspect(ref, params, butterfly, rows, ref_logits) if inspect else None

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = load(BENCH / "metrics" / f"{m['name']}.py").read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": kind or device.type, "count": cell.chips,
           "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": run.requests, "failed": 0,
              "metrics": metrics, "device": dev}
    if run.trace is not None:
        dev.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
        result["breakdown"] = run.trace.breakdown()
    result["phases_s"] = {"setup": setup_s, "window": window_s,
                          "trace_and_free": t2 - t1, "check": t3 - t2}
    if seen is not None:
        result["inspect"] = seen
    result["check"] = table
    return result


def banned_modules() -> List[str]:
    """Top-level names in ``sys.modules`` that no run may load."""
    return sorted({m.split(".")[0] for m in sys.modules} & BANNED)
