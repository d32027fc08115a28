"""Fault injection and recovery for the split runtime (DESIGN.md section 15).

A :class:`FaultSchedule` is a seeded, declarative list of events — device
churn (join/leave), link handover (3g→wifi mid-request, with the controller
re-scoring transports), transient wire blackouts, and cloud outage windows —
fired on the virtual clock, so a chaotic run is exactly as deterministic and
replayable as a calm one.  The schedule serializes into the arrival-trace
JSONL header (arrival-trace-v2), so a recorded chaotic run replays
byte-for-byte, fault sequence included.

Recovery is a per-request state machine driven by :class:`FaultInjector`:

* every send (prefill payload, streamed row, streamed token, final ids) arms
  a per-phase timeout; retries resend through the *original* send path with
  capped exponential backoff, and exhausted retries either fail the request
  or degrade it to edge-only fallback when the cloud is dark;
* an evicted device's in-flight requests *migrate* to another device in the
  cell — a mid-decode streamed request is checkpointed
  (:class:`DecodeCheckpoint`: edge stage-0 cache, cloud stage-1 cache,
  sampling state) and resumed on the target bitwise-identically to the
  uninterrupted run;
* a watchdog sweep on the virtual clock fails lost/stuck requests after
  ``request_timeout_s``, so ``Simulation.run`` terminates under any schedule.

Everything here is gated on ``injector is not None``: with no schedule
configured, no timer is armed, no counter is touched, and telemetry is
byte-identical to a build without this module.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

import numpy as np

FAULT_KINDS = ("device_leave", "device_join", "handover", "blackout",
               "cloud_outage")

_ALIASES = {
    "leave": "device_leave", "device_leave": "device_leave",
    "join": "device_join", "device_join": "device_join",
    "handover": "handover",
    "blackout": "blackout",
    "outage": "cloud_outage", "cloud_outage": "cloud_outage",
}


@dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault.  Which fields matter depends on ``kind``:

    ======================  ==========================================
    ``device_leave``        ``device`` (global device index)
    ``device_join``         ``cell`` (cell name to grow)
    ``handover``            ``cell``, ``network`` (new link model)
    ``blackout``            ``cell``, ``duration`` (seconds dark)
    ``cloud_outage``        ``duration`` (seconds of ingress blackout)
    ======================  ==========================================
    """

    t: float
    kind: str
    cell: str = ""
    device: int = -1
    network: str = ""
    duration: float = 0.0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")

    def to_obj(self) -> dict:
        obj = {"t": self.t, "kind": self.kind}
        if self.cell:
            obj["cell"] = self.cell
        if self.device >= 0:
            obj["device"] = self.device
        if self.network:
            obj["network"] = self.network
        if self.duration:
            obj["duration"] = self.duration
        return obj

    @classmethod
    def from_obj(cls, obj: dict) -> "FaultEvent":
        return cls(t=float(obj["t"]), kind=str(obj["kind"]),
                   cell=str(obj.get("cell", "")),
                   device=int(obj.get("device", -1)),
                   network=str(obj.get("network", "")),
                   duration=float(obj.get("duration", 0.0)))


@dataclass(frozen=True)
class FaultSchedule:
    """An immutable, time-sorted tuple of :class:`FaultEvent`."""

    events: Tuple[FaultEvent, ...] = ()

    def __iter__(self):
        return iter(self.events)

    def __len__(self):
        return len(self.events)

    def to_obj(self) -> list:
        return [ev.to_obj() for ev in self.events]

    @classmethod
    def from_obj(cls, obj: list) -> "FaultSchedule":
        return cls(tuple(FaultEvent.from_obj(o) for o in obj))

    @classmethod
    def parse(cls, spec: str) -> "FaultSchedule":
        """Parse the ``--faults`` DSL: comma-separated ``kind@t[:arg][+dur]``.

        Examples::

            leave@0.05:2                 device 2 leaves at t=0.05
            join@0.2:3g-jet              a device joins cell "3g-jet"
            handover@0.1:3g-jet>wifi     cell's wire re-links to wifi
            blackout@0.15:3g-jet+0.05    cell's wire dark for 50 ms
            outage@0.3+0.2               cloud ingress dark for 200 ms
        """
        events: List[FaultEvent] = []
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            kind_s, _, rest = part.partition("@")
            kind = _ALIASES.get(kind_s.strip())
            if kind is None:
                raise ValueError(f"unknown fault kind {kind_s!r} in {part!r}")
            duration = 0.0
            if "+" in rest:
                rest, dur_s = rest.rsplit("+", 1)
                duration = float(dur_s)
            t_s, _, arg = rest.partition(":")
            t = float(t_s)
            cell, device, network = "", -1, ""
            if kind == "device_leave":
                device = int(arg)
            elif kind == "device_join":
                cell = arg
            elif kind == "handover":
                cell, _, network = arg.partition(">")
                if not network:
                    raise ValueError(
                        f"handover needs cell>network, got {arg!r}")
            elif kind == "blackout":
                cell = arg
                if duration <= 0:
                    raise ValueError(f"blackout needs +duration: {part!r}")
            elif kind == "cloud_outage":
                if duration <= 0:
                    raise ValueError(f"outage needs +duration: {part!r}")
            events.append(FaultEvent(t=t, kind=kind, cell=cell, device=device,
                                     network=network, duration=duration))
        return cls(tuple(sorted(events, key=lambda e: (e.t, e.kind))))

    @classmethod
    def random(cls, seed: int, *, cells: Tuple[str, ...] = ("cell0",),
               num_devices: int = 4,
               networks: Tuple[str, ...] = ("3g", "4g", "wifi"),
               n_events: int = 6, horizon: float = 0.4) -> "FaultSchedule":
        """A seeded random schedule for chaos sweeps (namespaced rng so the
        same seed never collides with the arrival-process streams)."""
        rng = np.random.default_rng([0xFA, int(seed)])
        events: List[FaultEvent] = []
        for _ in range(int(n_events)):
            t = float(rng.uniform(0.0, horizon))
            kind = FAULT_KINDS[int(rng.integers(0, len(FAULT_KINDS)))]
            cell = str(cells[int(rng.integers(0, len(cells)))])
            if kind == "device_leave":
                events.append(FaultEvent(
                    t=t, kind=kind, device=int(rng.integers(0, num_devices))))
            elif kind == "device_join":
                events.append(FaultEvent(t=t, kind=kind, cell=cell))
            elif kind == "handover":
                net = str(networks[int(rng.integers(0, len(networks)))])
                events.append(FaultEvent(t=t, kind=kind, cell=cell,
                                         network=net))
            elif kind == "blackout":
                events.append(FaultEvent(
                    t=t, kind=kind, cell=cell,
                    duration=float(rng.uniform(0.01, 0.05))))
            else:  # cloud_outage
                events.append(FaultEvent(
                    t=t, kind=kind, duration=float(rng.uniform(0.02, 0.1))))
        return cls(tuple(sorted(events, key=lambda e: (e.t, e.kind))))


@dataclass(frozen=True)
class RecoveryPolicy:
    """Timeout / retry / fallback knobs for the request state machine."""

    phase_timeout_s: float = 0.5       # armed per send; ack cancels via epoch
    retry_base_s: float = 0.02         # backoff = base * 2^(retries-1) ...
    retry_cap_s: float = 0.2           # ... capped here
    max_retries: int = 4               # cumulative across phases, per request
    edge_fallback: bool = True         # degrade to edge-only when cloud dark
    migration_delay_s: float = 0.02    # checkpoint transfer + warmup cost
    request_timeout_s: float = 10.0    # watchdog hard deadline per request
    watchdog_interval_s: float = 0.5   # sweep period on the virtual clock


@dataclass
class DecodeCheckpoint:
    """Everything needed to resume an in-flight streamed decode elsewhere,
    bitwise-identically: edge stage-0 KV cache + position, cloud stage-1
    cache + position, the sampling state (last token, generated ids), and
    the duplicate-suppression counters of the token protocol.  Caches move
    by reference — the byte cost of moving them is modeled by
    ``RecoveryPolicy.migration_delay_s``, not re-simulated."""

    uid: int
    split: int
    transport: str
    prompt_len: int
    edge_pos: int
    cloud_pos: int
    produced: int
    sent_down: int
    cloud_served_upto: int
    last_token: Optional[int]
    last_sent: Optional[tuple]
    generated: tuple
    edge_cache: object = None
    cloud_cache: object = None
    stream_row: object = None

    @classmethod
    def capture(cls, req) -> "DecodeCheckpoint":
        t = req.trace
        generated = tuple(req.engine_req.generated) if req.engine_req else ()
        return cls(uid=t.uid, split=t.split, transport=t.transport,
                   prompt_len=t.prompt_len, edge_pos=req.edge_pos,
                   cloud_pos=req.cloud_pos, produced=req.produced,
                   sent_down=req.sent_down,
                   cloud_served_upto=req.cloud_served_upto,
                   last_token=req.last_token, last_sent=req.last_sent,
                   generated=generated, edge_cache=req.edge_cache,
                   cloud_cache=req.cloud_cache, stream_row=req.stream_row)

    def restore(self, req) -> None:
        assert req.trace.uid == self.uid, "checkpoint/request uid mismatch"
        req.edge_pos = self.edge_pos
        req.cloud_pos = self.cloud_pos
        req.produced = self.produced
        req.sent_down = self.sent_down
        req.cloud_served_upto = self.cloud_served_upto
        req.last_token = self.last_token
        req.last_sent = self.last_sent
        req.edge_cache = self.edge_cache
        req.cloud_cache = self.cloud_cache
        req.stream_row = self.stream_row


class FaultInjector:
    """Fires a :class:`FaultSchedule` on the simulation's event loop and
    owns the recovery state machine (timeouts, retries, migration, fallback,
    watchdog).  Built only when a schedule/policy is configured, so the
    no-fault path never touches it."""

    def __init__(self, sim, schedule: FaultSchedule,
                 policy: Optional[RecoveryPolicy] = None):
        self.sim = sim
        self.loop = sim.loop
        self.server = sim.server
        self.telemetry = sim.telemetry
        self.schedule = schedule
        self.policy = policy or RecoveryPolicy()
        self._cancel_watchdog: Optional[Callable[[], None]] = None

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        for ev in self.schedule:
            self.loop.schedule_at(max(ev.t, self.loop.now),
                                  (lambda e=ev: self._fire(e)))
        self._cancel_watchdog = self.loop.schedule_every(
            self.policy.watchdog_interval_s, self._watchdog)

    def stop(self) -> None:
        if self._cancel_watchdog is not None:
            self._cancel_watchdog()
            self._cancel_watchdog = None

    def _fire(self, ev: FaultEvent) -> None:
        self.telemetry.counters[f"fault_{ev.kind}s"] += 1
        if self.sim.tracer.enabled:
            self.sim.tracer.instant(
                "faults/sched", ev.kind, self.loop.now, cat="fault",
                args={"kind": ev.kind, "cell": ev.cell, "device": ev.device,
                      "network": ev.network, "duration": ev.duration})
        getattr(self, f"_{ev.kind}")(ev)

    # ------------------------------------------------------------ events

    def _device_leave(self, ev: FaultEvent) -> None:
        if not (0 <= ev.device < len(self.sim.devices)):
            return
        dev = self.sim.devices[ev.device]
        if dev.evicted:
            return
        dev.evicted = True
        self.loop.cancel_owner(dev)
        target = self._target(dev.cell_index)
        pol = self.policy
        for req in self.sim.requests:
            if req.finished or req.home != dev.dev_id:
                continue
            if target is None:
                self.fail(req, "device_lost")
                continue
            req.trace.migrations += 1
            self.telemetry.counters["fault_migrations"] += 1
            req.home = target.dev_id
            tgt = target
            if req.state == "edge_compute":
                if req in dev._numerics_pending:
                    dev._numerics_pending.remove(req)
                self.loop.schedule(pol.migration_delay_s,
                                   (lambda r=req, d=tgt:
                                    d.restart_prefill(r)), owner=tgt)
            elif req.state == "edge_decode":
                # checkpoint once; a re-eviction before resume reuses it
                ckpt = req.checkpoint or DecodeCheckpoint.capture(req)
                req.checkpoint = ckpt
                req.edge_cache = req.cloud_cache = req.stream_row = None
                self.telemetry.counters["fault_decode_migrations"] += 1

                def resume(r=req, d=tgt, c=ckpt):
                    if r.finished:
                        return
                    c.restore(r)
                    r.checkpoint = None
                    from repro_torch.runtime.transports import get_transport
                    get_transport(r.trace.transport)._schedule_edge_step(d, r)

                self.loop.schedule(pol.migration_delay_s, resume, owner=tgt)
            elif req.state == "edge_fallback":
                self.loop.schedule(pol.migration_delay_s,
                                   (lambda r=req, d=tgt:
                                    d.fallback_local(r)), owner=tgt)
            # uplink / await_token / cloud / downlink: frames already in
            # flight (or cloud-side); re-homing is enough — resends and
            # deliveries resolve the device via server.device_for at fire
            # time, and the phase timers cover lost frames.

    def _device_join(self, ev: FaultEvent) -> None:
        from repro_torch.runtime.actors import EdgeDevice
        cell = next((c for c in self.sim.cells if c.name == ev.cell), None)
        if cell is None:
            return
        sc = self.sim.sim_cfg
        dev = EdgeDevice(
            len(self.sim.devices), loop=self.loop, cost=cell.cost,
            uplink=cell.wire, server=self.server, bank=self.sim.bank,
            mode=sc.mode, wire_mode=sc.wire_mode, d_r=sc.d_r,
            telemetry=self.telemetry, numerics_split=cell.current_split,
            cell=cell.name, cell_index=cell.index)
        dev.free_at = self.loop.now
        dev.tracer = self.sim.tracer
        dev.injector = self
        if self.sim.tracer.enabled:
            self.sim.tracer.track(dev.track)
        # shared list: the server's delivery targets grow with the fleet
        self.sim.devices.append(dev)

    def _handover(self, ev: FaultEvent) -> None:
        cell = next((c for c in self.sim.cells if c.name == ev.cell), None)
        if cell is None:
            return
        wire = cell.wire
        wire.handover(ev.network)
        # every controller whose cell shares this wire re-scores transports
        for c in self.sim.cells:
            if c.wire is wire and c.controller is not None:
                c.controller.poke(self.loop.now, reason="handover")

    def _blackout(self, ev: FaultEvent) -> None:
        cell = next((c for c in self.sim.cells if c.name == ev.cell), None)
        if cell is None:
            return
        wire = cell.wire
        wire.blackout(self.loop.now, ev.duration)
        lost = self.loop.cancel_owner(wire)
        if lost:
            self.telemetry.counters["fault_lost_frames"] += lost

    def _cloud_outage(self, ev: FaultEvent) -> None:
        srv = self.server
        srv.outage_until = max(srv.outage_until, self.loop.now + ev.duration)
        if srv.pending:
            self.telemetry.counters["fault_outage_dropped_payloads"] += \
                len(srv.pending)
            srv.pending.clear()
        if srv.stream_ready:
            self.telemetry.counters["fault_outage_dropped_rows"] += \
                len(srv.stream_ready)
            srv.stream_ready.clear()

    # ------------------------------------------------------------ routing

    def route(self, dev_id: int) -> int:
        """Arrival-time rerouting: an evicted device's arrivals land on the
        lowest live device in its cell (or -1 when the cell is empty)."""
        dev = self.sim.devices[dev_id]
        if not dev.evicted:
            return dev_id
        self.telemetry.counters["fault_rerouted_arrivals"] += 1
        target = self._target(dev.cell_index)
        return -1 if target is None else target.dev_id

    def _target(self, cell_index: int):
        for d in self.sim.devices:
            if d.cell_index == cell_index and not d.evicted:
                return d
        return None

    # ------------------------------------------------------- state machine

    def arm(self, req, resend: Callable[[], None], label: str) -> None:
        """Arm a per-phase timeout for the send that just happened.  The
        matching ack is an epoch bump (:meth:`ack`); a stale or finished
        timer is a no-op.  On expiry: capped-exponential-backoff resend
        through the original send path, until the per-request retry budget
        runs out — then edge fallback (cloud phases, nothing streamed yet)
        or failure."""
        epoch = req.epoch
        pol = self.policy

        def fire():
            if req.finished or req.epoch != epoch:
                return
            if req.retries >= pol.max_retries:
                if (pol.edge_fallback and req.produced == 0
                        and req.trace.mode == "split"
                        and label in ("payload", "token")):
                    self.fallback(req)
                else:
                    self.fail(req, f"{label}_retries_exhausted")
                return
            req.retries += 1
            req.trace.retries += 1
            self.telemetry.counters["fault_retries"] += 1
            backoff = min(pol.retry_base_s * (2.0 ** (req.retries - 1)),
                          pol.retry_cap_s)
            self.sim.registry.histogram("fault_backoff_s").observe(backoff)

            def go():
                if req.finished or req.epoch != epoch:
                    return
                resend()

            self.loop.schedule(backoff, go)

        self.loop.schedule(pol.phase_timeout_s, fire)

    def ack(self, req) -> None:
        """Progress happened — invalidate every timer armed before now."""
        req.epoch += 1

    def fallback(self, req) -> None:
        """Degrade to edge-only: abandon the cloud half and run the full
        model locally on a live device in the request's cell."""
        if req.finished:
            return
        req.epoch += 1
        if req.slot >= 0:
            self.server.release_slot(req)
        if req in self.server.pending:
            self.server.pending.remove(req)
        dev = self.server.device_for(req)
        if dev is None or dev.evicted:
            dev = self._target(dev.cell_index) if dev is not None else None
            if dev is None:
                self.fail(req, "no_device_for_fallback")
                return
            req.home = dev.dev_id
        req.trace.fallback = "edge"
        self.telemetry.counters["fault_edge_fallbacks"] += 1
        dev.fallback_local(req)

    def fail(self, req, reason: str) -> None:
        if req.finished:
            return
        req.epoch += 1
        t = req.trace
        t.outcome = "failed"
        t.failure = reason
        t.t_done = self.loop.now
        t.clamp_chain()
        self.telemetry.counters["fault_failed_requests"] += 1
        if req.slot >= 0:
            self.server.release_slot(req)
        self.telemetry.record(t)
        self.server.sim_request_done(req)

    def _watchdog(self) -> None:
        deadline = self.policy.request_timeout_s
        now = self.loop.now
        for req in self.sim.requests:
            if req.finished or req.state == "new":
                continue
            if now - req.trace.t_arrival > deadline:
                self.fail(req, "request_timeout")
