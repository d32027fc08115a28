"""Per-request traces and fleet-level aggregates for the split runtime.

Every request records absolute virtual timestamps at each hop; the breakdown
(edge queue / edge compute / uplink / cloud queue / cloud compute) is derived
so the invariant ``sum(breakdown) == latency`` holds by construction and is
asserted in tests.  Aggregates report p50/p95/p99 latency, wire bytes, and
mobile energy — the paper's Table V quantities at request-stream scale.
"""
from __future__ import annotations

import json
import math
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional

from repro_torch.runtime.metrics import MetricsRegistry

# version of the ``to_json()`` document layout.  Bumped when keys move or
# change meaning so downstream consumers (the CI runtime-table job, the
# aggregate.py perf ratchet) can reject drift explicitly instead of
# misreading a stale schema.  v2 = adds schema_version itself + the
# registry-backed counters + optional jit_profile section.  v3 = request
# outcomes (outcome/failure/retries/migrations/fallback), latency
# aggregates partitioned to completed requests, availability/failure
# counts in the summary, and the controller decision reason.  v4 = the
# serving gateway (runtime/gateway.py): per-request SLO class
# (slo_class/hedges/cache_hit on the trace), the "shed" outcome with
# conservation counts (n_done + n_failed + n_shed == n_requests), and the
# per-class "classes" aggregate section.  v5 = the entropy-coded wire
# (core/wire_codec.py): per-trace coded_bytes/nominal_bytes accounting plus
# the summary's compression_ratio / mean_coded_bytes_per_token — the trace
# fields are zero and the summary keys absent outside wire_mode="entropy".
SCHEMA_VERSION = 5


@dataclass
class RequestTrace:
    uid: int
    device: int
    mode: str                          # split | cloud | edge
    wire_mode: str                     # raw | reduced | int8 (split mode)
    split: int                         # partition point used (0 = no split)
    prompt_len: int
    cell: str = "cell0"                # topology cell that emitted the request
    transport: str = "cache_handoff"   # decode transport (split mode)
    new_tokens: int = 0
    wire_bytes: float = 0.0            # uplink bytes (codes, cache, rows)
    downlink_bytes: float = 0.0        # sampled token ids back to the mobile
    # entropy-wire accounting (schema v5) — both stay 0.0 outside
    # wire_mode="entropy", so fixed-rate runs serialize identically modulo
    # the keys.  coded counts the rANS prefill payloads actually charged to
    # the wire (real encoder size in numerics mode, the nominal-rate
    # prediction in timing-only runs); nominal is the int8 fixed-rate
    # equivalent of those same payloads, so nominal/coded is the codec gain
    coded_bytes: float = 0.0
    nominal_bytes: float = 0.0
    mobile_energy_mj: float = 0.0
    # streamed-decode loop accounting (one entry per generated token after
    # the first: edge step -> row uplink -> cloud turn -> token downlink)
    stream_steps: int = 0
    stream_rtt_s: float = 0.0          # total row-sent -> token-back time
    # absolute virtual timestamps (seconds)
    t_arrival: float = 0.0
    t_edge_start: float = 0.0
    t_edge_done: float = 0.0
    t_uplink_start: float = 0.0        # transfer admitted to the link
    t_uplink_done: float = 0.0
    t_cloud_start: float = 0.0         # admitted into the batch server
    t_first_token: float = 0.0
    t_cloud_done: float = 0.0          # cloud's last involvement
    t_done: float = 0.0                # response fully at the mobile
    # fault/recovery outcome (schema v3) — all defaults describe the
    # no-fault world, so calm runs serialize identically modulo the keys
    outcome: str = "done"              # done | failed | shed
    failure: str = ""                  # reason when outcome != "done"
    retries: int = 0                   # timeout-driven resends
    migrations: int = 0                # device-to-device migrations
    fallback: str = ""                 # "edge" when degraded to edge-only
    # serving-gateway fields (schema v4) — defaults describe the
    # no-gateway world, same contract as the fault block above
    slo_class: str = "interactive"     # interactive | batch
    hedges: int = 0                    # duplicate payload sends raced
    cache_hit: bool = False            # served from the LRU response cache

    # -- derived breakdown --------------------------------------------------
    @property
    def edge_queue_s(self) -> float:
        return self.t_edge_start - self.t_arrival

    @property
    def edge_compute_s(self) -> float:
        return self.t_edge_done - self.t_edge_start

    @property
    def uplink_wait_s(self) -> float:
        return self.t_uplink_start - self.t_edge_done

    @property
    def uplink_s(self) -> float:
        return self.t_uplink_done - self.t_uplink_start

    @property
    def cloud_queue_s(self) -> float:
        return self.t_cloud_start - self.t_uplink_done

    @property
    def cloud_s(self) -> float:
        """Cloud phase: prefill + decode turns (for the streamed transport
        this window interleaves edge steps, row uplinks and token downlinks;
        ``stream_rtt_s``/``mean_stream_rtt`` expose the per-token loop)."""
        return self.t_cloud_done - self.t_cloud_start

    @property
    def downlink_s(self) -> float:
        """Final response downlink (the whole id batch for cache handoff,
        the last streamed token for streamed decode)."""
        return self.t_done - self.t_cloud_done

    @property
    def latency_s(self) -> float:
        return self.t_done - self.t_arrival

    @property
    def ttft_s(self) -> float:
        return self.t_first_token - self.t_arrival

    def clamp_chain(self) -> None:
        """Forward-max the timestamp chain so every derived phase is
        non-negative and ``sum(breakdown) == latency`` holds even for
        requests that failed, fell back, or skipped phases (a request that
        never reached the cloud leaves those legs at exactly zero).  A
        monotone chain is untouched, so calling this on a normally
        completed request is a byte-exact no-op."""
        prev = self.t_arrival
        for name in ("t_edge_start", "t_edge_done", "t_uplink_start",
                     "t_uplink_done", "t_cloud_start", "t_cloud_done",
                     "t_done"):
            v = getattr(self, name)
            if v < prev:
                setattr(self, name, prev)
            else:
                prev = v

    def breakdown(self) -> Dict[str, float]:
        return {
            "edge_queue_s": self.edge_queue_s,
            "edge_compute_s": self.edge_compute_s,
            "uplink_wait_s": self.uplink_wait_s,
            "uplink_s": self.uplink_s,
            "cloud_queue_s": self.cloud_queue_s,
            "cloud_s": self.cloud_s,
            "downlink_s": self.downlink_s,
        }


def percentile(values: List[float], p: float) -> float:
    """Deterministic linear-interpolation percentile (numpy 'linear')."""
    if not values:
        return float("nan")
    xs = sorted(values)
    if len(xs) == 1:
        return xs[0]
    rank = (p / 100.0) * (len(xs) - 1)
    lo = math.floor(rank)
    hi = math.ceil(rank)
    frac = rank - lo
    return xs[lo] * (1 - frac) + xs[hi] * frac


@dataclass
class ControlDecision:
    t: float
    cloud_load: float
    link_bytes_per_s: float
    old_split: int
    new_split: int
    transport: str = "cache_handoff"   # decode transport picked alongside
    cell: str = "cell0"                # which cell's controller decided
    reason: str = "tick"               # tick | handover | ... (why now)


class Telemetry:
    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self.traces: List[RequestTrace] = []
        self.decisions: List[ControlDecision] = []
        # free-form runtime counters (numerics batch sizes, decode steps,
        # compile-cache entries ...) — populated by the actors/simulator.
        # Backed by the metrics registry so the same numbers are scrapeable
        # next to gauges/histograms; the view keeps the defaultdict(float)
        # semantics every call site relies on.
        self.registry = registry if registry is not None else MetricsRegistry()
        self.counters = self.registry.counters
        # wall-clock jit attribution (JitProfiler.summary()+headline());
        # opt-in and host-dependent, so only set when SimConfig.profile_jit
        self.jit_profile: Optional[Dict[str, object]] = None

    def record(self, trace: RequestTrace) -> None:
        self.traces.append(trace)

    def record_decision(self, d: ControlDecision) -> None:
        self.decisions.append(d)

    # -- aggregates ---------------------------------------------------------
    def summary(self) -> Dict[str, float]:
        # latency/ttft/breakdown/throughput aggregate the *completed*
        # requests only — a fast failure must not improve p95.  Byte,
        # energy, and RTT totals cover every request (failed ones still
        # burned radio).  In a no-fault run done == traces, so every
        # pre-existing number is unchanged.
        done = [t for t in self.traces if t.outcome == "done"]
        lat = [t.latency_s for t in done]
        ttft = [t.ttft_s for t in done]
        out: Dict[str, float] = {"n_requests": len(self.traces)}
        for name, xs in (("latency", lat), ("ttft", ttft)):
            for p in (50, 95, 99):
                out[f"{name}_p{p}_ms"] = percentile(xs, p) * 1e3
            out[f"{name}_mean_ms"] = (sum(xs) / len(xs) * 1e3) if xs else float("nan")
        if self.traces:
            for key in ("edge_queue_s", "edge_compute_s", "uplink_wait_s",
                        "uplink_s", "cloud_queue_s", "cloud_s", "downlink_s"):
                out[f"mean_{key[:-2]}_ms"] = (sum(
                    t.breakdown()[key] for t in done) / len(done) * 1e3) \
                    if done else float("nan")
            out["total_wire_mb"] = sum(t.wire_bytes for t in self.traces) / 1e6
            out["mean_wire_kb"] = sum(
                t.wire_bytes for t in self.traces) / len(self.traces) / 1e3
            out["total_downlink_kb"] = sum(
                t.downlink_bytes for t in self.traces) / 1e3
            out["mean_downlink_b"] = sum(
                t.downlink_bytes for t in self.traces) / len(self.traces)
            steps = sum(t.stream_steps for t in self.traces)
            out["mean_stream_rtt_ms"] = (sum(
                t.stream_rtt_s for t in self.traces) / steps * 1e3) if steps \
                else 0.0
            out["mean_mobile_energy_mj"] = sum(
                t.mobile_energy_mj for t in self.traces) / len(self.traces)
            # entropy-wire aggregates (schema v5): emitted only when some
            # trace carried a coded payload — fixed-rate runs keep their
            # exact pre-v5 summary (and nan never enters dict comparisons)
            coded = sum(t.coded_bytes for t in self.traces)
            if coded > 0:
                nominal = sum(t.nominal_bytes for t in self.traces)
                ctoks = sum(t.prompt_len for t in self.traces
                            if t.coded_bytes > 0)
                out["compression_ratio"] = nominal / coded
                out["mean_coded_bytes_per_token"] = coded / ctoks \
                    if ctoks > 0 else float("nan")
            span = (max(t.t_done for t in done) -
                    min(t.t_arrival for t in done)) if done else 0.0
            # span == 0 (single request, or all requests at one instant)
            # has no defined rate — nan, not inf, so JSON consumers and
            # the aggregate table render it as missing rather than blowing
            # up comparisons
            out["throughput_rps"] = len(done) / span if span > 0 \
                else float("nan")
            # outcome counts (schema v3): availability counts degraded
            # edge-fallback completions as served — they got an answer.
            # Shed (v4) partitions out of failed: the gateway REFUSED these
            # by policy, it did not lose them — and the three outcomes are
            # conserved: n_done + n_failed + n_shed == n_requests.
            shed = sum(1 for t in self.traces if t.outcome == "shed")
            out["n_done"] = len(done)
            out["n_failed"] = len(self.traces) - len(done) - shed
            out["n_shed"] = shed
            out["n_migrated"] = sum(1 for t in self.traces if t.migrations)
            out["n_retried"] = sum(1 for t in self.traces if t.retries)
            out["n_fallback"] = sum(1 for t in self.traces if t.fallback)
            out["n_hedged"] = sum(1 for t in self.traces if t.hedges)
            out["n_cache_hits"] = sum(1 for t in self.traces if t.cache_hit)
            out["availability_pct"] = 100.0 * len(done) / len(self.traces)
        return out

    def class_summary(self) -> Dict[str, Dict[str, float]]:
        """Per-SLO-class aggregates (schema v4): latency percentiles over
        the completed requests of each class plus its outcome counts — the
        view the gateway benchmark's shed-on/shed-off comparison reads."""
        out: Dict[str, Dict[str, float]] = {}
        classes: List[str] = []
        for t in self.traces:
            if t.slo_class not in classes:
                classes.append(t.slo_class)
        for cls in classes:
            ts = [t for t in self.traces if t.slo_class == cls]
            done = [t for t in ts if t.outcome == "done"]
            shed = sum(1 for t in ts if t.outcome == "shed")
            lat = [t.latency_s for t in done]
            out[cls] = {
                "n_requests": len(ts),
                "n_done": len(done),
                "n_failed": len(ts) - len(done) - shed,
                "n_shed": shed,
                "latency_p50_ms": percentile(lat, 50) * 1e3,
                "latency_p95_ms": percentile(lat, 95) * 1e3,
                "latency_p99_ms": percentile(lat, 99) * 1e3,
                "latency_mean_ms": (sum(lat) / len(lat) * 1e3) if lat
                else float("nan"),
            }
        return out

    def split_trajectory(self) -> List[Dict[str, float]]:
        return [{"t": d.t, "cloud_load": d.cloud_load,
                 "link_bytes_per_s": d.link_bytes_per_s,
                 "split": d.new_split, "transport": d.transport,
                 "cell": d.cell, "reason": d.reason}
                for d in self.decisions]

    # -- per-cell aggregates / fairness -------------------------------------
    @property
    def cells(self) -> List[str]:
        """Cell names in first-trace order (stable across replays)."""
        seen: List[str] = []
        for t in self.traces:
            if t.cell not in seen:
                seen.append(t.cell)
        return seen

    def cell_summary(self) -> Dict[str, Dict[str, float]]:
        """Per-cell latency/energy/bytes aggregates — the per-cell view the
        fairness report (and the topology benchmark) is built from."""
        out: Dict[str, Dict[str, float]] = {}
        for cell in self.cells:
            ts = [t for t in self.traces if t.cell == cell]
            done = [t for t in ts if t.outcome == "done"]
            shed = sum(1 for t in ts if t.outcome == "shed")
            lat = [t.latency_s for t in done]
            out[cell] = {
                "n_requests": len(ts),
                "n_failed": len(ts) - len(done) - shed,
                "n_shed": shed,
                "latency_p50_ms": percentile(lat, 50) * 1e3,
                "latency_p95_ms": percentile(lat, 95) * 1e3,
                "latency_mean_ms": (sum(lat) / len(lat) * 1e3) if lat
                else float("nan"),
                "mean_uplink_wait_ms": (sum(
                    t.uplink_wait_s for t in done) / len(done) * 1e3)
                if done else float("nan"),
                "mean_wire_kb": sum(t.wire_bytes for t in ts) / len(ts) / 1e3,
                "downlink_kb": sum(t.downlink_bytes for t in ts) / 1e3,
                "mean_mobile_energy_mj": sum(
                    t.mobile_energy_mj for t in ts) / len(ts),
            }
        return out

    def fairness(self) -> Dict[str, float]:
        """Topology-level fairness across cells: max/min spread of the mean
        and p95 latencies plus Jain's fairness index over per-cell mean
        latency (1.0 = perfectly even service, ->1/n as one cell starves).
        Single-cell runs are trivially fair."""
        cells = self.cell_summary()
        # a cell whose every request failed has nan latencies — it cannot
        # enter the spread/Jain math (nan poisons every comparison)
        means = [c["latency_mean_ms"] for c in cells.values()
                 if math.isfinite(c["latency_mean_ms"])]
        p95s = [c["latency_p95_ms"] for c in cells.values()
                if math.isfinite(c["latency_p95_ms"])]
        if not means or not p95s:
            return {}
        sq = sum(m * m for m in means)
        return {
            "n_cells": len(means),
            "max_min_latency_ratio": max(means) / max(min(means), 1e-12),
            "p95_spread_ms": max(p95s) - min(p95s),
            "jain_index": (sum(means) ** 2) / max(len(means) * sq, 1e-12),
        }

    # -- rendering ----------------------------------------------------------
    _COLS = ("uid", "dev", "cell", "split", "tport", "S", "edgeq_ms",
             "edge_ms", "upwait_ms", "uplink_ms", "cloudq_ms", "cloud_ms",
             "dlink_ms", "total_ms", "wire_kb", "down_b", "energy_mj")

    def table(self) -> str:
        """Per-request latency-breakdown table (the CLI's main output)."""
        rows = [" ".join(f"{c:>9s}" for c in self._COLS)]
        for t in self.traces:
            tport = {"streamed": "stream",
                     "progressive": "prgrsv"}.get(t.transport, "handoff")
            vals = (t.uid, t.device, t.cell[:9], t.split, tport,
                    t.prompt_len,
                    t.edge_queue_s * 1e3, t.edge_compute_s * 1e3,
                    t.uplink_wait_s * 1e3, t.uplink_s * 1e3,
                    t.cloud_queue_s * 1e3, t.cloud_s * 1e3,
                    t.downlink_s * 1e3, t.latency_s * 1e3,
                    t.wire_bytes / 1e3, t.downlink_bytes,
                    t.mobile_energy_mj)
            rows.append(" ".join(
                f"{v:>9d}" if isinstance(v, int) else
                f"{v:>9s}" if isinstance(v, str) else f"{v:>9.3f}"
                for v in vals))
        return "\n".join(rows)

    def to_json(self) -> str:
        doc = {
            "schema_version": SCHEMA_VERSION,
            "summary": self.summary(),
            "classes": self.class_summary(),
            "cells": self.cell_summary(),
            "fairness": self.fairness(),
            "counters": dict(self.counters),
            "decisions": self.split_trajectory(),
            "traces": [dict(asdict(t), **{k: round(v, 9) for k, v in
                                          t.breakdown().items()})
                       for t in self.traces],
        }
        if self.jit_profile is not None:
            doc["jit_profile"] = self.jit_profile
        return json.dumps(doc, indent=2, sort_keys=True)
