"""Adaptive split control — the paper's Sec. III-C load-adaptation protocol,
closed-loop.

Periodically (the mobile "pings the server"), the controller samples the
cloud's congestion level and the uplink's *observed* goodput (nominal
bandwidth derated by contention, over the Wire's trailing window) and
re-runs Algorithm 1's selection phase (core/planner.select_split_online)
over the hosted partition points.  New requests are then routed to the
winning split: congestion pushes the split deeper — more layers stay on the
edge — while still shipping less than the raw input.

When ``transport_mode="auto"`` the selection phase also scores both decode
transports per split — cache handoff's prompt-proportional KV bytes vs the
streamed transport's per-token RTT x ``new_tokens`` — and the controller
routes new arrivals to the winning (split, transport) pair.

In a multi-cell topology each cell runs its OWN controller instance against
its own Wire and device class (``cell`` labels its decisions); all
instances observe the same shared CloudServer load, so cross-cell
congestion is the coupling signal.  ``objective`` names a registered
selection objective (planner.SELECTION_OBJECTIVES) — ``latency``,
``energy``, or ``energy_under_slo`` with ``slo_s``.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

from repro_torch.core.planner import select_split_online
from repro_torch.core.profiler import HardwareProfile
from repro_torch.runtime.clock import EventLoop
from repro_torch.runtime.telemetry import ControlDecision, Telemetry
from repro_torch.runtime.tracing import NULL_TRACER
from repro_torch.runtime.wire import Wire


class AdaptiveSplitController:
    def __init__(self, *, loop: EventLoop, uplink: Wire,
                 cloud_load: Callable[[float], float],
                 cfg, d_r: int, seq: int,
                 candidate_splits: Sequence[int],
                 edge: HardwareProfile, cloud: HardwareProfile,
                 wire_mode: str, telemetry: Telemetry,
                 set_split: Callable[[int], None],
                 get_split: Callable[[], int],
                 interval_s: float = 0.05,
                 handoff_bytes_per_layer: float = 0.0,
                 objective: str = "latency",
                 slo_s: Optional[float] = None,
                 transport_mode: str = "cache_handoff",
                 new_tokens: int = 1,
                 set_transport: Optional[Callable[[str], None]] = None,
                 get_transport: Optional[Callable[[], str]] = None,
                 edge_mp: int = 1, cloud_mp: int = 1,
                 cell: str = "cell0", tracer=NULL_TRACER):
        # "auto" keeps scoring the classic pair; "progressive" is explicitly
        # selectable so existing auto-routed trajectories stay byte-identical
        assert transport_mode in ("cache_handoff", "streamed", "progressive",
                                  "auto"), transport_mode
        self.handoff_bytes_per_layer = handoff_bytes_per_layer
        self.cell = cell
        self.slo_s = slo_s
        # score with the same model-axis degrees the CostModel charges, so
        # the controller's picks stay consistent with simulated durations
        self.edge_mp = edge_mp
        self.cloud_mp = cloud_mp
        self.loop = loop
        self.uplink = uplink
        self.cloud_load = cloud_load
        self.cfg = cfg
        self.d_r = d_r
        self.seq = seq
        self.candidates = list(candidate_splits)
        self.edge = edge
        self.cloud = cloud
        self.wire_mode = wire_mode
        self.telemetry = telemetry
        self.set_split = set_split
        self.get_split = get_split
        self.interval_s = interval_s
        self.objective = objective
        self.transport_mode = transport_mode
        self.new_tokens = new_tokens
        self.set_transport = set_transport
        self.get_transport = get_transport or (lambda: "cache_handoff")
        self.tracer = tracer
        self.running = False

    def start(self) -> None:
        self.running = True
        self.loop.schedule(0.0, self._tick)

    def stop(self) -> None:
        self.running = False

    def poke(self, now: float, reason: str = "poke") -> None:
        """Out-of-band re-score (e.g. the fault layer after a link
        handover): decide immediately instead of waiting for the tick."""
        if self.running:
            self.decide(now, reason=reason)

    def decide(self, now: float, reason: str = "tick") -> int:
        load = self.cloud_load(now)
        link_bps = self.uplink.observed_bytes_per_s(now)
        transports = ("cache_handoff", "streamed") \
            if self.transport_mode == "auto" else (self.transport_mode,)
        best, _ = select_split_online(
            self.cfg, self.seq, self.d_r,
            candidate_splits=self.candidates,
            edge=self.edge, cloud=self.cloud,
            link_bytes_per_s=link_bps, cloud_load=load,
            wire_mode=self.wire_mode,
            link_energy_mj_per_byte=self.uplink.transfer_energy_mj(1.0),
            handoff_bytes_per_layer=self.handoff_bytes_per_layer,
            objective=self.objective, slo_s=self.slo_s,
            transports=transports, new_tokens=self.new_tokens,
            downlink_bytes_per_s=self.uplink.observed_down_bytes_per_s(now),
            downlink_energy_mj_per_byte=self.uplink.downlink_energy_mj(1.0),
            edge_mp=self.edge_mp, cloud_mp=self.cloud_mp)
        old = self.get_split()
        self.telemetry.record_decision(ControlDecision(
            t=now, cloud_load=load, link_bytes_per_s=link_bps,
            old_split=old, new_split=best["split"],
            transport=best["transport"], cell=self.cell, reason=reason))
        self.tracer.instant(
            f"ctl/{self.cell}", "decision", now, cat="control",
            args={"split": best["split"], "transport": best["transport"],
                  "cloud_load": load, "link_bytes_per_s": link_bps,
                  "reason": reason})
        if best["split"] != old:
            self.set_split(best["split"])
        if self.set_transport is not None and \
                best["transport"] != self.get_transport():
            self.set_transport(best["transport"])
        return best["split"]

    def _tick(self) -> None:
        if not self.running:
            return
        self.decide(self.loop.now)
        self.loop.schedule(self.interval_s, self._tick)
