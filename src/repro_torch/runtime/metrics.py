"""Time-series metrics + wall-clock jit profiling for the split runtime.

Three layers:

* :class:`MetricsRegistry` — named counters / gauges / histograms.
  ``Telemetry.counters`` is now a :class:`CountersView` over a registry, so
  every existing ``counters["x"] += 1`` call site keeps working while the
  same numbers become scrapeable alongside gauges and histograms.
* :class:`MetricsSampler` — a fixed-interval sampler scheduled on the
  :class:`~repro_torch.runtime.clock.EventLoop` (virtual time): each tick polls a
  dict of named sources (queue depths, per-direction wire backlog and
  windowed goodput, cloud batch size / occupancy, per-cell in-flight
  counts) into one row; rows export as JSONL (``--metrics-out``).
  Sampling is *passive*: sources only read simulator state, so a sampled
  run's telemetry is identical to an unsampled one.

The fault layer (:mod:`repro_torch.runtime.faults`) reports through the same
registry: ``fault_*`` counters (injections, retries, migrations, drops,
fallbacks) and the ``fault_backoff_s`` histogram of retry backoff delays.
* :class:`JitProfiler` — **wall-clock** compile-vs-execute attribution per
  jit cache entry (first call = compile + execute, later calls = steady
  state) for ``SplitModelBank`` / ``ServingEngine`` hot paths.  Wall time
  is host-dependent and therefore *never* enters virtual-clock traces or
  default telemetry: profiling is opt-in (``SimConfig.profile_jit``) and
  surfaces as a separate ``jit_profile`` section in the telemetry JSON —
  making "the sim says X ms but wall time is dominated by recompiles"
  visible.
"""
from __future__ import annotations

import json
import time
from typing import Callable, Dict, List, MutableMapping, Optional

import torch

METRICS_FORMAT = "runtime-metrics-v1"


# ---------------------------------------------------------------------------
# registry: counters / gauges / histograms
# ---------------------------------------------------------------------------


class Counter:
    """Cumulative value.  ``set`` exists for migration call sites that
    assign totals directly (e.g. ``counters["x"] = n``)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        self.value += v

    def set(self, v: float) -> None:
        self.value = float(v)


class Gauge:
    """Point-in-time value (last write wins)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Exact distribution (runs are bounded, so observations are kept and
    percentiles are deterministic — no bucket-boundary artifacts)."""

    __slots__ = ("values",)

    def __init__(self):
        self.values: List[float] = []

    def observe(self, v: float) -> None:
        self.values.append(float(v))

    def summary(self) -> Dict[str, float]:
        from repro_torch.runtime.telemetry import percentile
        xs = self.values
        return {"count": len(xs), "sum": sum(xs),
                "mean": sum(xs) / len(xs) if xs else float("nan"),
                "p50": percentile(xs, 50), "p95": percentile(xs, 95),
                "max": max(xs) if xs else float("nan")}


class MetricsRegistry:
    """Get-or-create named instruments; one registry per simulation."""

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        if name not in self._counters:
            self._counters[name] = Counter()
        return self._counters[name]

    def gauge(self, name: str) -> Gauge:
        if name not in self._gauges:
            self._gauges[name] = Gauge()
        return self._gauges[name]

    def histogram(self, name: str) -> Histogram:
        if name not in self._histograms:
            self._histograms[name] = Histogram()
        return self._histograms[name]

    @property
    def counters(self) -> "CountersView":
        return CountersView(self)

    def counter_names(self) -> List[str]:
        return list(self._counters)

    def to_dict(self) -> Dict[str, dict]:
        return {
            "counters": {k: c.value for k, c in self._counters.items()},
            "gauges": {k: g.value for k, g in self._gauges.items()},
            "histograms": {k: h.summary()
                           for k, h in self._histograms.items()},
        }


class CountersView(MutableMapping):
    """``defaultdict(float)``-compatible dict view over a registry's
    counters — the back-compat face of ``Telemetry.counters``: reads
    auto-create at 0.0, ``+=`` and plain assignment both work, and
    ``dict(view)`` snapshots the values."""

    __slots__ = ("_registry",)

    def __init__(self, registry: MetricsRegistry):
        self._registry = registry

    def __getitem__(self, name: str) -> float:
        return self._registry.counter(name).value

    def __setitem__(self, name: str, value: float) -> None:
        self._registry.counter(name).set(value)

    def __delitem__(self, name: str) -> None:
        del self._registry._counters[name]

    def __iter__(self):
        return iter(self._registry.counter_names())

    def __len__(self) -> int:
        return len(self._registry._counters)

    def __repr__(self) -> str:
        return f"CountersView({dict(self)!r})"


# ---------------------------------------------------------------------------
# fixed-interval sampler on the virtual clock
# ---------------------------------------------------------------------------


class MetricsSampler:
    """Snapshot named sources every ``interval_s`` of *virtual* time.

    ``sources`` maps a metric name to a ``f(now) -> float`` reader; each
    tick evaluates every source (in insertion order) into one row and
    mirrors the values into the registry's gauges.  The sampler arms on
    :meth:`start` (sampling t=0 immediately) and disarms on :meth:`stop`
    — the simulation stops it when the last request completes, so the
    event loop drains."""

    def __init__(self, loop, registry: MetricsRegistry, *,
                 interval_s: float = 0.01,
                 sources: Optional[Dict[str, Callable[[float], float]]]
                 = None):
        assert interval_s > 0, interval_s
        self.loop = loop
        self.registry = registry
        self.interval_s = interval_s
        self.sources: Dict[str, Callable[[float], float]] = dict(sources
                                                                 or {})
        self.rows: List[dict] = []
        self._cancel: Optional[Callable[[], None]] = None

    def add_source(self, name: str, fn: Callable[[float], float]) -> None:
        self.sources[name] = fn

    def start(self) -> None:
        assert self._cancel is None, "sampler already running"
        self._cancel = self.loop.schedule_every(
            self.interval_s, self._tick, first_delay=0.0)

    def stop(self) -> None:
        if self._cancel is not None:
            self._cancel()
            self._cancel = None

    def _tick(self) -> None:
        now = self.loop.now
        row = {"t": now}
        for name, fn in self.sources.items():
            v = float(fn(now))
            row[name] = v
            self.registry.gauge(name).set(v)
        self.rows.append(row)

    # ---------------------------------------------------------------- export
    def to_jsonl(self) -> str:
        header = {"format": METRICS_FORMAT, "interval_s": self.interval_s,
                  "n": len(self.rows), "sources": list(self.sources)}
        lines = [json.dumps(header, sort_keys=True)]
        lines += [json.dumps(row, sort_keys=True) for row in self.rows]
        return "\n".join(lines) + "\n"

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_jsonl())


def read_metrics_jsonl(path: str) -> List[dict]:
    """Rebuild sampler rows from a ``--metrics-out`` file (header
    validated)."""
    with open(path) as f:
        header = json.loads(f.readline())
        assert header.get("format") == METRICS_FORMAT, \
            f"{path}: not a metrics timeline (header {header!r})"
        rows = [json.loads(line) for line in f if line.strip()]
    assert len(rows) == header["n"], \
        f"{path}: truncated ({len(rows)} of {header['n']} rows)"
    return rows


# ---------------------------------------------------------------------------
# wall-clock jit profiling (opt-in; never enters virtual-clock artifacts)
# ---------------------------------------------------------------------------


class JitProfiler:
    """Per-jit-cache-entry wall-clock attribution.

    A key is the bank's compile-cache tuple ``(kind, split, mp, B, S)`` (or
    an engine's ``("engine_step", split, mp)``): the first timed call of a
    key is the first-call path (the JAX package compiles there; the port
    pays its first-use costs, such as a kernel build or cuBLAS heuristics),
    every later call is steady state.  ``timed`` synchronises ``device``
    (``torch.cuda.synchronize`` on a CUDA device, nothing on the CPU, where
    PyTorch runs synchronously) so wall times are honest — which is exactly
    why profiling is opt-in."""

    def __init__(self, device=None):
        self.entries: Dict[tuple, dict] = {}
        self.device = device

    def _sync(self) -> None:
        if self.device is not None and torch.device(self.device).type == "cuda":
            torch.cuda.synchronize(self.device)

    def timed(self, key: tuple, fn, *args):
        self._sync()
        t0 = time.perf_counter()
        out = fn(*args)
        self._sync()
        dt = time.perf_counter() - t0
        e = self.entries.get(key)
        if e is None:
            self.entries[key] = {"first_call_s": dt, "calls": 1,
                                 "steady_s": 0.0}
        else:
            e["calls"] += 1
            e["steady_s"] += dt
        return out

    @property
    def first_calls(self) -> int:
        return len(self.entries)

    @property
    def steady_calls(self) -> int:
        return sum(e["calls"] - 1 for e in self.entries.values())

    @property
    def compile_wall_s(self) -> float:
        """Total first-call wall time (compile + one execute per entry)."""
        return sum(e["first_call_s"] for e in self.entries.values())

    @property
    def steady_wall_s(self) -> float:
        return sum(e["steady_s"] for e in self.entries.values())

    def summary(self) -> Dict[str, dict]:
        """JSON-ready per-entry attribution, keyed ``kind/split/mp/B/S``."""
        out = {}
        for key, e in sorted(self.entries.items(), key=lambda kv: str(kv[0])):
            steady = e["calls"] - 1
            out["/".join(str(k) for k in key)] = {
                "calls": e["calls"],
                "first_call_ms": round(e["first_call_s"] * 1e3, 3),
                "steady_calls": steady,
                "steady_mean_ms": round(e["steady_s"] / steady * 1e3, 3)
                if steady else None,
                "steady_total_ms": round(e["steady_s"] * 1e3, 3),
            }
        return out

    def headline(self) -> Dict[str, float]:
        """The one-line takeaway: how much wall time went to first calls
        (recompiles) vs steady-state execution."""
        total = self.compile_wall_s + self.steady_wall_s
        return {
            "entries": self.first_calls,
            "calls": self.first_calls + self.steady_calls,
            "compile_wall_ms": round(self.compile_wall_s * 1e3, 3),
            "steady_wall_ms": round(self.steady_wall_s * 1e3, 3),
            "compile_fraction": round(self.compile_wall_s / total, 4)
            if total > 0 else float("nan"),
        }
