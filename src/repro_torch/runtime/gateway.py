"""Serving gateway in front of the cloud: SLO classes, admission control,
resilience, and autoscaling (DESIGN.md section 17).

The paper motivates the split by the "considerable computational and
communication load" offloading imposes on the cloud server — this module
models the serving front-end that load actually hits.  A
:class:`Gateway` wraps the :class:`~repro_torch.runtime.actors.CloudServer`'s
ingress with:

  * a priority job queue (:class:`JobQueue`) — ``interactive`` requests are
    never queued behind ``batch`` ones (the SLO class rides on the
    :class:`~repro_torch.runtime.simulator.Arrival` and into the
    :class:`~repro_torch.runtime.telemetry.RequestTrace`),
  * admission control that sheds a request at payload arrival when the
    predicted queue delay would violate its class SLO
    (``outcome="shed"``; telemetry conserves done+failed+shed == submitted),
  * per-cell circuit breakers (:class:`CircuitBreaker`) with half-open
    recovery, driven by the existing fault/health signals (request
    outcomes + outage-dropped payloads),
  * hedged retries for interactive requests (a duplicate payload send races
    the first; the cloud dedupes whichever lands second),
  * an LRU response cache (:class:`ResponseCache`) keyed on the prompt —
    hits return the byte-identical generated ids without touching the
    accelerator (``gateway_cache_hits``),
  * autoscaling cloud replicas with modeled spin-up lag; the replica count
    grows the slot pool and feeds ``CloudServer.current_load``.

Every knob lives on one frozen :class:`GatewayPolicy`.  The default policy
is ALL-OFF: a run with ``SimConfig(gateway=GatewayPolicy())`` is
byte-identical to ``gateway=None`` (asserted in tests/test_gateway.py, the
same contract the fault layer makes for ``faults=None``), and every
decision is a function of virtual-clock state, so chaos + gateway runs
record -> replay byte-identically.
"""
from __future__ import annotations

import heapq
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

SLO_CLASSES = ("interactive", "batch")


# ---------------------------------------------------------------------------
# policy
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class GatewayPolicy:
    """All gateway knobs, one frozen dataclass.  The default (everything
    off) reproduces the legacy infinite-queue FIFO byte-for-byte; each
    feature is opt-in.  ``parse`` accepts the CLI grammar — a comma list of
    flags / ``key=value`` pairs, e.g.
    ``"priority,shed,slo=40/400,reserve=1,cache=64,hedge=0.03,breaker,autoscale"``.
    """
    # priority queue: interactive ranks ahead of batch
    priority: bool = False
    # admission control: shed when predicted queue delay > the class SLO
    shed: bool = False
    slo_interactive_ms: float = 250.0
    slo_batch_ms: Optional[float] = 2000.0   # None = batch never shed
    reserved_slots: int = 0                  # slots batch may not occupy
    # per-cell circuit breakers (closed -> open -> half_open -> closed)
    breaker: bool = False
    breaker_fail_threshold: int = 3          # consecutive failures to open
    breaker_halfopen_after_s: float = 0.5    # open -> half_open cooldown
    breaker_probes: int = 2                  # successes to close again
    # hedged retries: duplicate an interactive payload send still stuck in
    # the uplink phase after this long (the cloud drops the loser)
    hedge: bool = False
    hedge_delay_s: float = 0.05
    # LRU response cache (numerics mode: keyed on prompt ids; 0 = off)
    cache_size: int = 0
    # autoscaling replicas: each replica adds a max_concurrent-sized slot
    # pool after spin_up_s; scale-down is immediate once the tail drains
    autoscale: bool = False
    max_replicas: int = 4
    scale_up_load: float = 0.85
    scale_down_load: float = 0.30
    spin_up_s: float = 0.25
    autoscale_interval_s: float = 0.05

    def __post_init__(self):
        assert self.breaker_fail_threshold >= 1
        assert self.breaker_probes >= 1
        assert self.max_replicas >= 1
        assert 0 <= self.scale_down_load < self.scale_up_load <= 1.0

    @property
    def slo_s(self) -> Dict[str, Optional[float]]:
        return {"interactive": self.slo_interactive_ms / 1e3,
                "batch": self.slo_batch_ms / 1e3
                if self.slo_batch_ms is not None else None}

    @classmethod
    def parse(cls, spec: str) -> "GatewayPolicy":
        kw: Dict[str, object] = {}
        for part in (p.strip() for p in spec.split(",") if p.strip()):
            key, _, val = part.partition("=")
            if key in ("priority", "shed", "breaker", "hedge", "autoscale"):
                kw[key] = True
                if key == "hedge" and val:
                    kw["hedge_delay_s"] = float(val)
            elif key == "slo":
                inter, _, batch = val.partition("/")
                kw["slo_interactive_ms"] = float(inter)
                kw["slo_batch_ms"] = float(batch) if batch and \
                    batch != "inf" else None
                kw["shed"] = True
            elif key == "reserve":
                kw["reserved_slots"] = int(val)
            elif key == "cache":
                kw["cache_size"] = int(val)
            elif key == "replicas":
                kw["max_replicas"] = int(val)
                kw["autoscale"] = True
            elif key == "spinup":
                kw["spin_up_s"] = float(val)
            else:
                raise ValueError(
                    f"bad gateway spec token {part!r}: expected "
                    f"priority|shed|breaker|hedge[=delay_s]|autoscale|"
                    f"slo=<int_ms>/<batch_ms|inf>|reserve=<n>|cache=<n>|"
                    f"replicas=<n>|spinup=<s>")
        return cls(**kw)


# ---------------------------------------------------------------------------
# priority job queue
# ---------------------------------------------------------------------------


class JobQueue:
    """The cloud's pending queue: FIFO by default, (class-rank, arrival-seq)
    when ``priority`` is on — so an interactive request is NEVER queued
    behind a batch one, while ties stay strictly FIFO.  Implements the
    deque surface the server and fault layer use (append/popleft/peek/
    remove/clear/contains/len/iter); removal is O(1) via tombstones."""

    def __init__(self, priority: bool = False):
        self.priority = priority
        self._heap: List[list] = []          # [rank, seq, req, alive]
        self._entries: Dict[int, list] = {}  # uid -> heap entry
        self._seq = 0

    def _rank(self, req) -> int:
        if not self.priority:
            return 0
        return 0 if req.trace.slo_class == "interactive" else 1

    def append(self, req) -> None:
        e = [self._rank(req), self._seq, req, True]
        self._seq += 1
        self._entries[req.trace.uid] = e
        heapq.heappush(self._heap, e)

    def _prune(self) -> None:
        while self._heap and not self._heap[0][3]:
            heapq.heappop(self._heap)

    def peek(self):
        self._prune()
        return self._heap[0][2] if self._heap else None

    def popleft(self):
        self._prune()
        if not self._heap:
            raise IndexError("pop from an empty JobQueue")
        e = heapq.heappop(self._heap)
        e[3] = False
        del self._entries[e[2].trace.uid]
        return e[2]

    def remove(self, req) -> None:
        e = self._entries.pop(req.trace.uid, None)
        if e is None:
            raise ValueError(f"request {req.trace.uid} not queued")
        e[3] = False

    def clear(self) -> None:
        for e in self._entries.values():
            e[3] = False
        self._entries.clear()

    def __contains__(self, req) -> bool:
        return req.trace.uid in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    def __iter__(self):
        return iter([e[2] for e in
                     sorted(self._entries.values(), key=lambda e: e[:2])])


# ---------------------------------------------------------------------------
# circuit breaker
# ---------------------------------------------------------------------------


class CircuitBreaker:
    """Per-cell breaker: ``closed`` (serving) -> ``open`` after
    ``fail_threshold`` consecutive failures (requests from the cell are
    shed instead of queued) -> ``half_open`` after the cooldown (admit up
    to ``probes`` trial requests) -> ``closed`` again once that many
    successes land; any half-open failure re-opens.  Pure virtual-time
    state machine — every transition is a function of (event, now)."""

    def __init__(self, fail_threshold: int, halfopen_after_s: float,
                 probes: int):
        self.fail_threshold = fail_threshold
        self.halfopen_after_s = halfopen_after_s
        self.probes = probes
        self.state = "closed"
        self.failures = 0                    # consecutive, while closed
        self.opened_at = float("-inf")
        self._probe_budget = 0
        self._probe_successes = 0

    def _maybe_half_open(self, now: float) -> None:
        if self.state == "open" and \
                now >= self.opened_at + self.halfopen_after_s:
            self.state = "half_open"
            self._probe_budget = self.probes
            self._probe_successes = 0

    def allow(self, now: float) -> bool:
        """May a request from this cell enter the queue at ``now``?"""
        self._maybe_half_open(now)
        if self.state == "closed":
            return True
        if self.state == "half_open" and self._probe_budget > 0:
            self._probe_budget -= 1
            return True
        return False

    def record_success(self, now: float) -> bool:
        """Returns True when this success CLOSES a half-open breaker."""
        self._maybe_half_open(now)
        if self.state == "half_open":
            self._probe_successes += 1
            if self._probe_successes >= self.probes:
                self.state = "closed"
                self.failures = 0
                return True
        elif self.state == "closed":
            self.failures = 0
        return False

    def record_failure(self, now: float) -> bool:
        """Returns True when this failure OPENS the breaker."""
        self._maybe_half_open(now)
        if self.state == "half_open":
            self.state = "open"
            self.opened_at = now
            return True
        if self.state == "closed":
            self.failures += 1
            if self.failures >= self.fail_threshold:
                self.state = "open"
                self.opened_at = now
                return True
        return False

    def is_open(self, now: float) -> bool:
        self._maybe_half_open(now)
        return self.state == "open"


# ---------------------------------------------------------------------------
# LRU response cache
# ---------------------------------------------------------------------------


class ResponseCache:
    """LRU over (prompt ids, max_new_tokens) -> generated ids.  Only
    meaningful in numerics mode (timing-only arrivals carry no prompt);
    a hit replays the byte-identical response without accelerator time."""

    def __init__(self, size: int):
        self.size = size
        self._od: "OrderedDict[Tuple, Tuple[int, ...]]" = OrderedDict()

    @staticmethod
    def key(req) -> Optional[Tuple]:
        if req.tokens is None:
            return None
        return (req.tokens.tobytes(), req.max_new_tokens)

    def get(self, key) -> Optional[Tuple[int, ...]]:
        if key is None or key not in self._od:
            return None
        self._od.move_to_end(key)
        return self._od[key]

    def put(self, key, ids) -> None:
        if key is None or self.size <= 0:
            return
        self._od[key] = tuple(int(x) for x in ids)
        self._od.move_to_end(key)
        while len(self._od) > self.size:
            self._od.popitem(last=False)

    def __len__(self) -> int:
        return len(self._od)


# ---------------------------------------------------------------------------
# the gateway
# ---------------------------------------------------------------------------


class Gateway:
    """Attaches to a CloudServer: swaps its pending deque for the policy's
    JobQueue and intercepts ingress/egress.  With the default all-off
    policy every hook degenerates to the legacy path."""

    def __init__(self, policy: GatewayPolicy, *, loop, server, telemetry):
        self.policy = policy
        self.loop = loop
        self.server = server
        self.telemetry = telemetry
        self.queue = JobQueue(priority=policy.priority)
        self.cache = ResponseCache(policy.cache_size)
        self.breakers: Dict[str, CircuitBreaker] = {}
        # per-cell controller pokes (simulator wires these): breaker
        # transitions nudge the cell's split controller off-cycle, the same
        # reactive path link handovers use
        self.pokes: Dict[str, Callable[[float, str], None]] = {}
        self._svc_ewma: Optional[float] = None   # observed cloud service time
        self._target_replicas = 1
        self._cancel_autoscale: Optional[Callable[[], None]] = None
        assert policy.reserved_slots < server.max_concurrent, \
            f"reserved_slots={policy.reserved_slots} leaves no slot a " \
            f"batch request may ever take (pool size " \
            f"{server.max_concurrent}) — the queue would deadlock"
        server.gateway = self
        server.pending = self.queue

    # -- wiring -------------------------------------------------------------
    def start(self) -> None:
        if self.policy.autoscale:
            self._cancel_autoscale = self.loop.schedule_every(
                self.policy.autoscale_interval_s, self._autoscale_tick)

    def stop(self) -> None:
        if self._cancel_autoscale is not None:
            self._cancel_autoscale()
            self._cancel_autoscale = None

    def _breaker(self, cell: str) -> CircuitBreaker:
        if cell not in self.breakers:
            p = self.policy
            self.breakers[cell] = CircuitBreaker(
                p.breaker_fail_threshold, p.breaker_halfopen_after_s,
                p.breaker_probes)
        return self.breakers[cell]

    def cell_load_fn(self, cell: str) -> Callable[[float], float]:
        """The load signal a cell's controller should read: the shared
        cloud occupancy, ceilinged while this cell's breaker is open (the
        cloud is unreachable FOR THIS CELL, so its controller routes
        edge-heavy — the same signal shape a cloud outage produces)."""
        def load(now: float) -> float:
            if self.policy.breaker and self._breaker(cell).is_open(now):
                return 0.99
            return self.server.current_load(now)
        return load

    # -- ingress ------------------------------------------------------------
    def admit(self, req) -> bool:
        """Gate one payload arrival.  Returns True to enqueue; False when
        the gateway fully handled it (cache hit, breaker shed, admission
        shed)."""
        now = self.loop.now
        t = req.trace
        hit = self.cache.get(self.cache.key(req))
        if hit is not None:
            self._serve_cached(req, hit, now)
            return False
        if self.policy.breaker and not self._breaker(t.cell).allow(now):
            self.telemetry.counters["gateway_breaker_shed"] += 1
            self._shed(req, "breaker_open", now)
            return False
        if self.policy.shed:
            slo = self.policy.slo_s[t.slo_class]
            if slo is not None and \
                    self.predicted_delay_s(t.slo_class, now) > slo:
                self._shed(req, "admission", now)
                return False
        return True

    def may_start(self, req, free_slots: int) -> bool:
        """May the queue head enter a slot?  Interactive always; batch only
        when it would leave ``reserved_slots`` free ones behind."""
        if req.trace.slo_class == "interactive":
            return True
        return free_slots > self.policy.reserved_slots

    def predicted_delay_s(self, slo_class: str, now: float) -> float:
        """Predicted queueing delay for a request of ``slo_class`` arriving
        now: the serial-accelerator backlog plus how many service
        generations of the slot pool must drain before it starts, scaled
        by the observed (EWMA) per-request cloud service time.  With the
        priority queue on, an interactive request only waits behind
        interactive ones — exactly why batch absorbs the shed."""
        srv = self.server
        rank = 0 if (slo_class == "interactive" and self.policy.priority) \
            else 1
        q = srv.pending
        if isinstance(q, JobQueue) and self.policy.priority and rank == 0:
            ahead = sum(1 for e in q._entries.values() if e[0] <= rank)
        else:
            ahead = len(q)
        cap = max(len(srv.slots), 1)
        if slo_class == "batch":
            cap = max(cap - self.policy.reserved_slots, 1)
        free = sum(1 for s in srv.slots if s is None)
        waves = max(ahead + 1 - free, 0) / cap
        frontier = max(0.0, srv._prefill_busy_until - now)
        return frontier + waves * (self._svc_ewma or 0.0)

    def _shed(self, req, reason: str, now: float) -> None:
        t = req.trace
        t.outcome = "shed"
        t.failure = reason
        t.t_done = now
        t.clamp_chain()
        self.telemetry.counters["gateway_shed"] += 1
        self.telemetry.counters[f"gateway_shed_{t.slo_class}"] += 1
        self.telemetry.record(t)
        self.server.sim_request_done(req)

    def _serve_cached(self, req, ids: Tuple[int, ...], now: float) -> None:
        """Byte-identical reply from the LRU: the generated ids ship down
        the wire immediately; no slot, no accelerator time."""
        t = req.trace
        t.cache_hit = True
        t.new_tokens = len(ids)
        t.t_cloud_start = t.t_cloud_done = now
        req.cached_ids = ids
        req.state = "cloud"
        self.telemetry.counters["gateway_cache_hits"] += 1
        self.server._ship_ids(req)

    # -- hedged retries -----------------------------------------------------
    def wants_hedge(self, req) -> bool:
        return self.policy.hedge and \
            req.trace.slo_class == "interactive" and \
            req.max_new_tokens >= 1

    def arm_hedge(self, device, req) -> None:
        """Duplicate the payload send if the first is still stuck in the
        uplink phase after the hedge delay — racing loss/blackout, not the
        queue; the server's dedup drops whichever copy lands second."""
        def fire() -> None:
            if req.finished or req.state != "uplink":
                return
            req.trace.hedges += 1
            self.telemetry.counters["gateway_hedges"] += 1
            device.send_payload(req)
        self.loop.schedule(self.policy.hedge_delay_s, fire)

    # -- health/outcome signals ---------------------------------------------
    def note_outcome(self, req) -> None:
        """Terminal-request hook (every path funnels through
        ``sim_request_done``): feeds the breaker state machines, the
        service-time EWMA, and the response cache."""
        t = req.trace
        now = self.loop.now
        if t.outcome == "done":
            if t.t_cloud_done > t.t_cloud_start and not t.cache_hit:
                obs = t.t_cloud_done - t.t_cloud_start
                self._svc_ewma = obs if self._svc_ewma is None else \
                    0.8 * self._svc_ewma + 0.2 * obs
            if self.policy.breaker and not t.fallback:
                if self._breaker(t.cell).record_success(now):
                    self.telemetry.counters["gateway_breaker_closes"] += 1
                    self._poke(t.cell, now)
            if req.engine_req is not None and \
                    getattr(req.engine_req, "generated", None):
                self.cache.put(self.cache.key(req), req.engine_req.generated)
        elif t.outcome == "failed":
            self._note_failure(t.cell, now)

    def note_dropped_payload(self, cell: str) -> None:
        """Outage-dropped ingress: a health signal the breaker counts even
        though the request itself is still retrying."""
        self._note_failure(cell, self.loop.now)

    def _note_failure(self, cell: str, now: float) -> None:
        if self.policy.breaker and \
                self._breaker(cell).record_failure(now):
            self.telemetry.counters["gateway_breaker_opens"] += 1
            self._poke(cell, now)

    def _poke(self, cell: str, now: float) -> None:
        cb = self.pokes.get(cell)
        if cb is not None:
            cb(now, "breaker")

    # -- autoscaling --------------------------------------------------------
    def _autoscale_tick(self) -> None:
        now = self.loop.now
        srv = self.server
        p = self.policy
        load = srv.current_load(now)
        if load >= p.scale_up_load and self._target_replicas < p.max_replicas:
            self._target_replicas += 1
            self.telemetry.counters["gateway_scale_up_decisions"] += 1
            self.loop.schedule(p.spin_up_s, self._replica_up)
        elif load <= p.scale_down_load and self._target_replicas > 1 and \
                srv.replicas > 1:
            base = srv.max_concurrent
            if all(s is None for s in srv.slots[-base:]):
                del srv.slots[-base:]
                srv.replicas -= 1
                self._target_replicas -= 1
                self.telemetry.counters["gateway_scale_downs"] += 1

    def _replica_up(self) -> None:
        srv = self.server
        if srv.replicas >= self._target_replicas:
            return                       # a scale-down already retracted it
        srv.replicas += 1
        srv.slots.extend([None] * srv.max_concurrent)
        self.telemetry.counters["gateway_scale_ups"] += 1
        srv._kick()                      # fresh capacity: drain the queue
