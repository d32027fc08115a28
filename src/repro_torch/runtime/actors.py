"""Edge-device fleet and cloud continuous-batching server.

EdgeDevice is a serial processor (one prefill at a time, like a phone's NPU):
requests queue at the device, run the edge half (layers [0, split) + the
butterfly reduce/quantize), then contend for the shared uplink.  Virtual
time stays serial per request, but the *numerics* coalesce: when a burst
queues at the device, one batched ``edge_half`` call computes every queued
request's payload (results are sliced back per request), so the numerics
hot path runs at (B, S) instead of B separate batch-1 dispatches.

CloudServer is a serial accelerator running a continuous-batching loop over
the hosted partitioned models (ServingEngines over one shared-weight
``SplitModelBank`` backbone): each service turn admits every pending
prefill the slot pool can hold (serial cumulative durations — same virtual
timeline as one-at-a-time admission), then serves any streamed decode rows
that arrived over the wire, then runs batched decode steps over the active
cache-handoff slots, with service times derated by ``1/(1 - load)`` (the
paper's K_cloud congestion knob).  Cloud-half numerics batch the same way
the edge does: the first ``_prefill_done`` of a burst computes restore +
layers [split, N) for every in-flight payload of that split in one call.

The decode phase of a multi-token split request follows its
:mod:`~repro_torch.runtime.transports` transport — ``cache_handoff`` (stage-0
cache up, decode in the engine's slot pool, ids down at completion) or
``streamed`` (edge keeps its cache, one butterfly row up and one id down
per token); both end with the response crossing the Wire's downlink.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.costs import TOKEN_BYTES
from repro_torch.runtime.clock import EventLoop
from repro_torch.runtime.gateway import JobQueue
from repro_torch.runtime.split_exec import CostModel, SplitModelBank
from repro_torch.runtime.telemetry import RequestTrace, Telemetry
from repro_torch.runtime.tracing import NULL_TRACER
from repro_torch.runtime.transports import get_transport
from repro_torch.runtime.wire import Wire
from repro_torch.tree import tree_map


@dataclass
class SimRequest:
    trace: RequestTrace
    tokens: Optional[np.ndarray] = None       # prompt (numerics mode)
    max_new_tokens: int = 1
    payload: Optional[tuple] = None           # (codes, scales, stage0_cache)
    engine_req: object = None                 # serving.engine.Request
    slot: int = -1                            # cloud slot (virtual accounting)
    # streamed-transport state (see runtime/transports.py)
    edge_cache: object = None                 # stage-0 decode cache (edge)
    edge_pos: int = 0
    cloud_cache: object = None                # stage-1 decode cache (cloud)
    cloud_pos: int = 0
    stream_row: Optional[tuple] = None        # last (payload, scales) row
    last_token: int = -1
    produced: int = 0                         # ids RECEIVED at the mobile
    stream_t0: Optional[float] = None         # RTT accounting anchor
    # progressive-transport state: the refinement bitplanes have landed
    # (always True outside progressive), and the first sampled token held
    # back while they were still in flight
    refine_done: bool = True
    gated_token: Optional[int] = None
    # fault/recovery state machine (runtime/faults.py) — inert without an
    # injector: home mirrors the arrival device, state advances, and the
    # rest stays at its default
    home: int = -1                            # current serving device
    state: str = "new"                        # lifecycle phase (see faults.py)
    finished: bool = False                    # terminal (done or failed)
    epoch: int = 0                            # phase-timer invalidation token
    retries: int = 0                          # cumulative resend budget used
    sent_down: int = 0                        # fresh ids shipped by the cloud
    cloud_served_upto: int = 0                # highest edge_pos served (dedupe)
    last_sent: Optional[tuple] = None         # (tok, seq) for resends
    checkpoint: object = None                 # DecodeCheckpoint mid-migration
    # gateway response cache: the generated ids a cache hit replayed
    # (byte-identical to the original computation — asserted in tests)
    cached_ids: Optional[tuple] = None

    @property
    def uid(self) -> int:
        return self.trace.uid


class EdgeDevice:
    """Serial edge processor feeding a shared uplink."""

    def __init__(self, dev_id: int, *, loop: EventLoop, cost: CostModel,
                 uplink: Wire, server: "CloudServer",
                 bank: Optional[SplitModelBank], mode: str, wire_mode: str,
                 d_r: int, telemetry: Telemetry, numerics_split: int = 1,
                 cell: str = "cell0", cell_index: int = 0):
        self.dev_id = dev_id
        self.numerics_split = numerics_split
        self.loop = loop
        self.cost = cost                    # this cell's cost model (edge hw)
        self.uplink = uplink                # this cell's Wire
        self.server = server
        self.bank = bank
        self.mode = mode
        self.wire_mode = wire_mode
        self.d_r = d_r
        self.telemetry = telemetry
        self.cell = cell                    # topology cell this device lives in
        self.cell_index = cell_index
        self.edge_mp = cost.edge_mp
        self.free_at = 0.0
        self.evicted = False                # set by FaultInjector on churn
        self.injector = None                # FaultInjector when faults are on
        self._local_engine = None
        self._numerics_pending: List[SimRequest] = []
        # flight recorder (simulator swaps in a live tracer when tracing);
        # dev_id is fleet-global, so the track is unique per device
        self.tracer = NULL_TRACER
        self.track = f"edge/{cell}/dev{dev_id}"
        # (t_edge_start, t_edge_done) of recent arrivals — the sampler's
        # queue-depth source (how many requests are waiting or computing)
        self._recent_starts: deque = deque()

    def runner(self, split: int):
        """This cell's view of the bank: the edge half runs at the cell's
        model-axis degree (the cloud degree is fleet-global)."""
        return self.bank.runner(split, edge_mp=self.edge_mp)

    def queue_depth(self, now: float) -> int:
        """Arrivals whose edge compute has not started by ``now`` — the
        device-queue gauge the metrics sampler snapshots."""
        while self._recent_starts and self._recent_starts[0][1] <= now:
            self._recent_starts.popleft()
        return sum(1 for s, _ in self._recent_starts if s > now)

    def on_arrival(self, req: SimRequest) -> None:
        t = req.trace
        t.t_arrival = self.loop.now
        req.home = self.dev_id
        req.state = "edge_compute"
        if self.mode == "split" and self.bank is not None:
            self._numerics_pending.append(req)
        start = max(self.loop.now, self.free_at)
        S = t.prompt_len
        if self.mode == "split":
            dur = self.cost.edge_prefill_s(t.split, S, self.d_r)
        elif self.mode == "edge":
            dur = self.cost.full_prefill_s(S, where="edge")
            dur += sum(self.cost.decode_step_s(1, where="edge")
                       for _ in range(max(req.max_new_tokens - 1, 0)))
        else:                                   # cloud-only: capture + ship
            dur = 0.0
        t.t_edge_start = start
        t.t_edge_done = start + dur
        self.free_at = t.t_edge_done
        self._recent_starts.append((start, t.t_edge_done))
        if self.tracer.enabled:
            self.tracer.async_span(f"req/{self.cell}", "edge_queue", t.uid,
                                   t.t_arrival, start)
            if dur > 0:
                name = "prefill" if self.mode == "split" else "local_infer"
                self.tracer.complete(self.track, name, start, start + dur,
                                     cat="edge", args={"uid": t.uid, "S": S})
        self.loop.schedule_at(t.t_edge_done, lambda: self._edge_done(req),
                              owner=self)

    def _edge_done(self, req: SimRequest) -> None:
        if req.finished:
            return
        t = req.trace
        t.mobile_energy_mj += self.cost.edge_energy_mj(t.edge_compute_s)
        if self.mode == "split" and self.bank is not None and \
                req.payload is None:
            self._compute_edge_batch(req)
        if self.mode == "edge":
            self._finish_local(req)
            return
        get_transport(t.transport).after_edge_prefill(self, req)
        self.send_payload(req, first=True)

    def send_payload(self, req: SimRequest, first: bool = False) -> None:
        """Ship the prefill payload up the cell's wire.  Retries re-enter
        here (``first=False``): the bytes accumulate, the uplink timestamps
        re-stamp, and the phase timer re-arms."""
        if req.finished:
            return
        t = req.trace
        transport = get_transport(t.transport)
        nbytes = transport.prefill_uplink_bytes(self, req)
        t.wire_bytes += nbytes
        if transport.name == "progressive" and self.mode == "split":
            start, done = self._send_progressive(req, nbytes)
        else:
            start, done = self.uplink.transfer(nbytes, self.loop.now,
                                               uid=t.uid, tag="prefill")
            self.loop.schedule_at(done, lambda: self.server.on_payload(req),
                                  owner=self.uplink)
        t.t_uplink_start, t.t_uplink_done = start, done
        t.mobile_energy_mj += self.uplink.transfer_energy_mj(nbytes)
        if first and self.tracer.enabled:
            self.tracer.async_span(f"req/{self.cell}", "uplink_wait", t.uid,
                                   t.t_edge_done, start)
        req.state = "uplink"
        gw = self.server.gateway
        if first and gw is not None and gw.wants_hedge(req):
            gw.arm_hedge(self, req)
        if self.injector is not None:
            self.injector.arm(
                req, lambda: self.server.device_for(req).send_payload(req),
                "payload")

    def _send_progressive(self, req: SimRequest, nbytes: float) -> tuple:
        """Two back-to-back FIFO uplink chunks: the coarse bitplanes plus
        scales first, the refinement planes right behind.  ``on_payload``
        fires at the COARSE landing — the cloud prefill overlaps the
        refinement tail — and the refine landing unfreezes the first
        token.  ``t_uplink_done`` stamps the coarse landing (when the
        cloud can start), keeping the breakdown chain monotone; the tail
        overlaps the cloud_queue/cloud legs."""
        from repro_torch.core import wire_codec

        t = req.trace
        now = self.loop.now
        scale_bytes = t.prompt_len * 4
        code_bytes = max(int(nbytes) - scale_bytes, 0)
        coarse, refine = wire_codec.split_coarse_refine(code_bytes,
                                                        scale_bytes)
        # the two-chunk split costs a second stream header beyond the
        # single-shot payload: count what actually crosses the wire
        t.wire_bytes += (coarse + refine) - float(nbytes)
        start, c_done = self.uplink.transfer(coarse, now, uid=t.uid,
                                             tag="prefill")
        _, r_done = self.uplink.transfer(refine, now, uid=t.uid,
                                         tag="refine")
        req.refine_done = False
        self.loop.schedule_at(c_done, lambda: self.server.on_payload(req),
                              owner=self.uplink)
        self.loop.schedule_at(r_done, lambda: self._refine_landed(req),
                              owner=self.uplink)
        return start, c_done

    def _refine_landed(self, req: SimRequest) -> None:
        if req.finished:
            return
        get_transport("progressive").release_gated(self.server, req)

    def restart_prefill(self, req: SimRequest) -> None:
        """Migration target: redo the edge prefill for a request whose home
        device was evicted mid-compute.  The queue timestamps re-stamp (the
        work really runs twice), so sum(breakdown) == latency still holds."""
        if req.finished or self.evicted:
            return
        t = req.trace
        if self.mode == "split" and self.bank is not None and \
                req.payload is None and req not in self._numerics_pending:
            self._numerics_pending.append(req)
        start = max(self.loop.now, self.free_at)
        S = t.prompt_len
        if self.mode == "split":
            dur = self.cost.edge_prefill_s(t.split, S, self.d_r)
        elif self.mode == "edge":
            dur = self.cost.full_prefill_s(S, where="edge")
            dur += sum(self.cost.decode_step_s(1, where="edge")
                       for _ in range(max(req.max_new_tokens - 1, 0)))
        else:
            dur = 0.0
        t.t_edge_start = start
        t.t_edge_done = start + dur
        self.free_at = t.t_edge_done
        self._recent_starts.append((start, t.t_edge_done))
        req.home = self.dev_id
        req.state = "edge_compute"
        if self.tracer.enabled and dur > 0:
            name = "prefill" if self.mode == "split" else "local_infer"
            self.tracer.complete(self.track, name, start, start + dur,
                                 cat="edge", args={"uid": t.uid, "S": S})
        self.loop.schedule_at(t.t_edge_done, lambda: self._edge_done(req),
                              owner=self)

    def fallback_local(self, req: SimRequest) -> None:
        """Degraded edge-only service for a split request whose cloud half
        is unreachable: run the FULL model on this device."""
        if req.finished or self.evicted:
            return
        t = req.trace
        start = max(self.loop.now, self.free_at)
        dur = self.cost.full_prefill_s(t.prompt_len, where="edge")
        dur += sum(self.cost.decode_step_s(1, where="edge")
                   for _ in range(max(req.max_new_tokens - 1, 0)))
        self.free_at = start + dur
        self._recent_starts.append((start, start + dur))
        req.home = self.dev_id
        req.state = "edge_fallback"
        if self.tracer.enabled:
            self.tracer.complete(self.track, "local_infer", start,
                                 start + dur, cat="edge",
                                 args={"uid": t.uid, "S": t.prompt_len})
        self.loop.schedule_at(start + dur,
                              lambda: self._fallback_done(req, dur),
                              owner=self)

    def _fallback_done(self, req: SimRequest, dur: float) -> None:
        if req.finished:
            return
        t = req.trace
        t.mobile_energy_mj += self.cost.edge_energy_mj(dur)
        if self.bank is not None and req.tokens is not None:
            eng = self._ensure_local_engine()
            req.engine_req = eng.submit(req.tokens,
                                        max_new_tokens=req.max_new_tokens)
            eng.run()
            t.new_tokens = len(req.engine_req.generated)
        else:
            t.new_tokens = req.max_new_tokens
        t.t_first_token = t.t_done = self.loop.now
        t.clamp_chain()
        self.telemetry.record(t)
        self.server.sim_request_done(req)

    def _compute_edge_batch(self, req: SimRequest) -> None:
        """One batched edge_half over every queued arrival sharing this
        request's split + prompt shape; results slice back per request.
        Numerics are time-invariant, so computing a queued request's payload
        at the head request's completion instant is exact."""
        # MoE routes all tokens of a batch into one shared expert-capacity
        # pool, so stacking independent requests would change each one's
        # numerics — coalesce only where batch rows are independent
        if self.bank.batch_numerics_ok:
            group = [r for r in self._numerics_pending
                     if r.trace.split == req.trace.split and
                     r.tokens.shape == req.tokens.shape]
        else:
            group = [req]
        runner = self.runner(req.trace.split)
        toks = np.stack([r.tokens for r in group])
        payload, scales, cache0 = runner.edge_half(runner.params, toks)
        for i, r in enumerate(group):
            r.payload = (payload[i:i + 1], scales[i:i + 1],
                         tree_map(lambda a: a[:, i:i + 1], cache0))
            self._numerics_pending.remove(r)
        self.telemetry.counters["edge_numerics_batches"] += 1
        self.telemetry.counters["edge_numerics_requests"] += len(group)
        self.tracer.instant(self.track, "coalesce", self.loop.now,
                            args={"group": len(group),
                                  "split": req.trace.split})

    def _finish_local(self, req: SimRequest) -> None:
        """Mobile-only baseline: everything already ran on the device."""
        t = req.trace
        t.t_uplink_start = t.t_uplink_done = t.t_cloud_start = t.t_edge_done
        t.t_first_token = t.t_cloud_done = t.t_done = t.t_edge_done
        if self.bank is not None:
            eng = self._ensure_local_engine()
            req.engine_req = eng.submit(req.tokens,
                                        max_new_tokens=req.max_new_tokens)
            eng.run()
            t.new_tokens = len(req.engine_req.generated)
        else:
            t.new_tokens = req.max_new_tokens
        self.telemetry.record(t)
        self.server.sim_request_done(req)

    def _ensure_local_engine(self):
        """Mobile-only / fallback runs the same hosted model (split is a
        no-op for numerics when both halves share a device); one engine per
        device, reused across its serial requests.  It lives on the DEVICE:
        run it at the edge degree, so local inference runs on the edge's
        model axis (its group of ranks, or whole on each rank at degree 1),
        never the cloud's."""
        if self._local_engine is None:
            runner = self.runner(self.numerics_split)
            self._local_engine = runner.make_engine(
                max_batch=1, max_len=self.server.max_len,
                mp=runner.edge_mp)
        return self._local_engine


@dataclass(frozen=True)
class CloudSpec:
    """What a cloud deployment IS (bank, cost model, limits) — as opposed
    to how it is wired into a particular simulation (loop, telemetry,
    wire, callbacks), which stays keyword arguments on
    :class:`CloudServer`.  Frozen: a spec can be shared and compared
    across runs."""
    cost: CostModel
    bank: Optional[SplitModelBank] = None
    mode: str = "split"                       # split | cloud | edge
    d_r: int = 16
    max_concurrent: int = 8                   # slot-pool size per replica
    background_load: Optional[Callable[[float], float]] = None
    engine_seed: int = 0
    max_len: int = 256
    numerics_split: int = 1


class CloudServer:
    """Serial accelerator + slot pool running continuous batching."""

    def __init__(self, spec: CloudSpec, *, loop: EventLoop,
                 telemetry: Telemetry,
                 wire: Optional[Wire] = None,
                 on_done: Optional[Callable[[SimRequest], None]] = None):
        self.spec = spec
        self.numerics_split = spec.numerics_split
        self.loop = loop
        self.cost = spec.cost
        self.bank = spec.bank
        self.mode = spec.mode
        self.d_r = spec.d_r
        self.telemetry = telemetry
        self.max_concurrent = spec.max_concurrent
        self.background_load = spec.background_load or (lambda t: 0.0)
        self.max_len = spec.max_len
        self.engine_seed = spec.engine_seed
        self.on_done = on_done
        self.wire = wire                          # downlink fallback (1 cell)
        self.devices: List[object] = []           # filled by the simulator
        # a FIFO JobQueue is deque-identical; an attached Gateway swaps in
        # its priority queue (runtime/gateway.py)
        self.pending: JobQueue = JobQueue()
        self.stream_ready: deque[SimRequest] = deque()  # rows awaiting a turn
        self.slots: List[Optional[SimRequest]] = [None] * spec.max_concurrent
        self.slot_history: List[tuple] = []       # (uid, slot) admissions
        self._engines: Dict[int, object] = {}     # split -> ServingEngine
        self._virtual_left: Dict[int, int] = {}   # uid -> decode steps left
        self._cloud_results: Dict[int, tuple] = {}  # uid -> (logits, c1, c0)
        self._busy = False
        self._prefill_busy_until = 0.0            # serial accelerator frontier
        self.peak_active = 0
        self.tracer = NULL_TRACER                 # swapped in by the simulator
        self.injector = None                      # FaultInjector when faults on
        self.gateway = None                       # Gateway when a policy is set
        # autoscaled replica count: each replica contributes one
        # max_concurrent slot pool and one accelerator's worth of parallel
        # service capacity (the gateway's autoscaler mutates this)
        self.replicas = 1
        # cloud-outage window: ingress (payloads, rows) is dropped while
        # now < outage_until; work already admitted finishes decoding —
        # the modeled outage is an ingress blackout, not engine surgery
        self.outage_until = float("-inf")

    # -- load signal --------------------------------------------------------
    @property
    def num_active(self) -> int:
        return sum(1 for r in self.slots if r is not None)

    @property
    def num_decoding(self) -> int:
        """Slots decoding locally (cache handoff); token-streaming slots
        (streamed/progressive) wait for rows from the edge and take no
        batched decode turns."""
        return sum(1 for r in self.slots
                   if r is not None and
                   not get_transport(r.trace.transport).streams_tokens)

    def current_load(self, now: float) -> float:
        """Combined congestion the mobile observes when it pings the server:
        external tenants (background) plus this fleet's own occupancy.
        During a cloud outage the ping itself fails — the controller reads
        the ceiling and routes work edge-heavy."""
        if now < self.outage_until:
            return 0.99
        bg = min(max(self.background_load(now), 0.0), 0.99)
        # the denominator is the LIVE slot pool: an autoscaled replica
        # coming online visibly drops the load the controllers observe
        occ = self.num_active / len(self.slots)
        return min(1.0 - (1.0 - bg) * (1.0 - occ), 0.99)

    def device_for(self, req: SimRequest) -> Optional[object]:
        """The device currently serving ``req`` — its migration home when
        the fault layer re-homed it, else the arrival device."""
        if not self.devices:
            return None
        return self.devices[req.home if req.home >= 0 else req.trace.device]

    def wire_for(self, req: SimRequest) -> Optional[Wire]:
        """The Wire serving ``req``'s cell (responses go back down the same
        link the request came up — per-cell downlink contention)."""
        dev = self.device_for(req)
        return dev.uplink if dev is not None else self.wire

    # -- request flow -------------------------------------------------------
    def on_payload(self, req: SimRequest) -> None:
        if req.finished:
            return
        if self.injector is not None:
            if self.loop.now < self.outage_until:
                self.telemetry.counters["fault_outage_dropped_payloads"] += 1
                if self.gateway is not None:
                    # the breaker counts dropped ingress as a health signal
                    self.gateway.note_dropped_payload(req.trace.cell)
                return
            if req.slot >= 0 or req in self.pending:
                # a spurious retry: the original made it after all
                self.telemetry.counters["fault_duplicate_payloads"] += 1
                return
        elif self.gateway is not None and \
                (req.slot >= 0 or req in self.pending):
            # the losing copy of a hedged send
            self.telemetry.counters["gateway_duplicate_payloads"] += 1
            return
        if self.gateway is not None and not self.gateway.admit(req):
            return            # shed, or served from the response cache
        req.state = "cloud"
        self.pending.append(req)
        self._kick()

    def on_stream_row(self, req: SimRequest) -> None:
        """A streamed decode row arrived over the uplink."""
        if req.finished:
            return
        if self.injector is not None:
            if self.loop.now < self.outage_until:
                self.telemetry.counters["fault_outage_dropped_rows"] += 1
                return
            if req in self.stream_ready:
                self.telemetry.counters["fault_duplicate_stream_rows"] += 1
                return
        self.stream_ready.append(req)
        self._kick()

    def _kick(self) -> None:
        if not self._busy:
            self._busy = True
            self.loop.schedule(0.0, self._service)

    def _engine(self, split: int):
        if self.bank is None:
            return None
        if self.mode != "split":
            split = self.numerics_split   # cloud-only runs one hosted model
        if split not in self._engines:
            self._engines[split] = self.bank.runner(split).make_engine(
                max_batch=self.max_concurrent, max_len=self.max_len,
                seed=self.engine_seed)
        return self._engines[split]

    def _free_slot(self) -> int:
        for i, r in enumerate(self.slots):
            if r is None:
                return i
        return -1

    def _service(self) -> None:
        now = self.loop.now
        # admit every pending prefill the slot pool can hold in one service
        # turn; durations stay serial (cumulative past the busy frontier),
        # so the accelerator never runs two prefills — or a prefill and a
        # decode — at once, exactly like one-at-a-time admission
        start = max(now, self._prefill_busy_until)
        admitted = 0
        while self.pending and now >= self.outage_until:
            slot = self._free_slot()
            if slot < 0:
                break
            if self.gateway is not None and not self.gateway.may_start(
                    self.pending.peek(),
                    sum(1 for s in self.slots if s is None)):
                # head is batch-class and would eat a reserved slot; the
                # priority queue guarantees nothing interactive is behind it
                break
            req = self.pending.popleft()
            start = self._admit(req, slot, start)
            admitted += 1
        if admitted:
            self._prefill_busy_until = start
            if admitted > 1:
                self.telemetry.counters["cloud_prefill_bursts"] += 1
            return
        if now < self._prefill_busy_until:
            return                      # mid-burst: next _prefill_done rearms
        if self.stream_ready:
            self._stream_turn(now)
            return
        if self.num_decoding > 0:
            self._decode_step(now)
            return
        self._busy = False

    def _admit(self, req: SimRequest, slot: int, start: float) -> float:
        """Place ``req`` in ``slot`` with its prefill starting at ``start``;
        returns the prefill completion time (the next admission's start)."""
        t = req.trace
        t.t_cloud_start = start
        load = min(max(self.background_load(start), 0.0), 0.99)
        S = t.prompt_len
        if self.mode == "split":
            dur = self.cost.cloud_prefill_s(t.split, S, self.d_r, load)
        else:
            dur = self.cost.full_prefill_s(S, where="cloud", load=load)
        req.slot = slot
        self.slots[slot] = req
        self.slot_history.append((t.uid, slot))
        self.peak_active = max(self.peak_active, self.num_active)
        if self.injector is not None:
            self.injector.ack(req)          # payload made it: cancel retries
        if self.tracer.enabled:
            self.tracer.async_span(f"req/{t.cell}", "cloud_queue", t.uid,
                                   t.t_uplink_done, start)
            self.tracer.complete("cloud/accel", "prefill", start, start + dur,
                                 cat="cloud", args={"uid": t.uid,
                                                    "split": t.split,
                                                    "slot": slot})
        self.loop.schedule_at(start + dur, lambda: self._prefill_done(req))
        # with R autoscaled replicas, R prefills run concurrently in
        # aggregate: each request still takes its full duration, but the
        # serial frontier the NEXT admission queues behind advances at R
        # times the rate (replicas == 1 reduces to the serial accelerator)
        return start + dur / self.replicas

    def _cloud_numerics(self, req: SimRequest) -> tuple:
        """(last logits row, cache1 slice, cache0) for ``req``; the first
        call of a burst batches the cloud half over every in-flight payload
        of the same split (admitted or still pending) in one call."""
        if req.uid not in self._cloud_results:
            split = req.trace.split
            group = [req]
            if self.bank.batch_numerics_ok:   # see _compute_edge_batch
                group += [
                    r for r in list(self.slots) + list(self.pending)
                    if r is not None and r is not req
                    and r.payload is not None and r.trace.split == split
                    and r.payload[0].shape == req.payload[0].shape]
            runner = self.bank.runner(split)
            payload = torch.cat([r.payload[0] for r in group])
            scales = torch.cat([r.payload[1] for r in group])
            logits, cache1 = runner.cloud_half(runner.params, payload, scales)
            for i, r in enumerate(group):
                self._cloud_results[r.uid] = (
                    logits[i], tree_map(lambda a: a[:, i:i + 1], cache1),
                    r.payload[2])
                r.payload = None
            self.telemetry.counters["cloud_numerics_batches"] += 1
            self.telemetry.counters["cloud_numerics_prefills"] += len(group)
        return self._cloud_results.pop(req.uid)

    def _prefill_done(self, req: SimRequest) -> None:
        if not req.finished:       # failed mid-prefill: drop the result
            get_transport(req.trace.transport).start_cloud_decode(self, req)
        self.loop.schedule(0.0, self._service)

    def _stream_turn(self, now: float) -> None:
        """Serve every arrived streamed row in one serial-accelerator turn:
        rows of the same split batch into one charged step; numerics run
        when the turn completes."""
        batch = list(self.stream_ready)
        self.stream_ready.clear()
        load = min(max(self.background_load(now), 0.0), 0.99)
        dur = 0.0
        for split in sorted({r.trace.split for r in batch}):
            k = sum(1 for r in batch if r.trace.split == split)
            dur += self.cost.cloud_decode_step_s(split, self.d_r, k, load)
        dur /= self.replicas
        self.telemetry.counters["stream_cloud_turns"] += 1
        self.telemetry.counters["stream_rows"] += len(batch)
        self.tracer.complete("cloud/accel", "stream_turn", now, now + dur,
                             cat="cloud", args={"rows": len(batch)})
        self.loop.schedule(dur, lambda: self._stream_turn_done(batch))

    def _stream_turn_done(self, batch: List[SimRequest]) -> None:
        # progressive inherits the streamed row service unchanged (the
        # coarse/refine choreography only touches the prefill upload), so
        # one singleton serves mixed batches without reordering the turn
        get_transport("streamed").serve_rows(self, batch)
        self.loop.schedule(0.0, self._service)

    def _decode_step(self, now: float) -> None:
        batch = self.num_decoding
        load = min(max(self.background_load(now), 0.0), 0.99)
        # replicas split the decode batch: each runs its share in parallel
        dur = self.cost.decode_step_s(-(-batch // self.replicas),
                                      where="cloud", load=load)
        self.tracer.complete("cloud/accel", "decode_turn", now, now + dur,
                             cat="cloud", args={"batch": batch})
        self.loop.schedule(dur, self._decode_done)

    def _decode_done(self) -> None:
        handoff = [r for r in self.slots
                   if r is not None and
                   not get_transport(r.trace.transport).streams_tokens]
        if self.bank is not None:
            stepped = set()
            for req in handoff:
                eng = self._engine(req.trace.split)
                if id(eng) not in stepped:
                    eng.step()
                    stepped.add(id(eng))
            for req in handoff:
                if req.engine_req.done:
                    self._complete(req)
        else:
            for req in handoff:
                left = self._virtual_left.get(req.uid)
                if left is None:
                    # replicas > 1: the aggregate prefill frontier advances
                    # faster than each request's own prefill, so a slot can
                    # sit in the pool before its decode state exists — it
                    # joins the batch on the turn after its prefill lands
                    continue
                self._virtual_left[req.uid] = left - 1
                if left <= 1:
                    self._complete(req)
        self.loop.schedule(0.0, self._service)

    def _complete(self, req: SimRequest) -> None:
        """Cloud-side decode finished (cache-handoff / cloud-only): free the
        slot and ship the whole sampled-id batch down the Wire; the request
        is delivered — and recorded — when the downlink drains."""
        if req.finished:
            return
        t = req.trace
        t.t_cloud_done = self.loop.now
        if req.engine_req is not None:
            t.new_tokens = len(req.engine_req.generated)
        else:
            t.new_tokens = req.max_new_tokens
        if req.slot >= 0:
            self.release_slot(req, self.loop.now)
        self._ship_ids(req)

    def _ship_ids(self, req: SimRequest) -> None:
        """Ship the whole id batch down; retries re-enter here."""
        if req.finished:
            return
        t = req.trace
        wire = self.wire_for(req)
        if wire is None:                    # no modeled downlink: instant
            self._deliver(req)
            return
        nbytes = TOKEN_BYTES * t.new_tokens
        t.downlink_bytes += nbytes
        start, done = wire.transfer_down(nbytes, self.loop.now, uid=t.uid,
                                         tag="ids")
        t.mobile_energy_mj += wire.downlink_energy_mj(nbytes)
        req.state = "downlink"
        self.loop.schedule_at(done, lambda: self._deliver(req), owner=wire)
        if self.injector is not None:
            self.injector.arm(req, lambda: self._ship_ids(req), "ids")

    def release_slot(self, req: SimRequest,
                     now: Optional[float] = None) -> None:
        """Free ``req``'s engine slot, closing its residency span (admission
        prefill start -> release) on the slot's trace track."""
        now = self.loop.now if now is None else now
        slot = req.slot
        self.slots[slot] = None
        req.slot = -1
        if self.tracer.enabled:
            t = req.trace
            self.tracer.complete(f"cloud/slot{slot}", f"u{t.uid}",
                                 t.t_cloud_start, now, cat="slot",
                                 args={"uid": t.uid, "split": t.split,
                                       "transport": t.transport})

    def _deliver(self, req: SimRequest) -> None:
        if req.finished:
            return
        t = req.trace
        t.t_done = self.loop.now
        # batch return: the mobile sees its first token when the whole id
        # shipment lands — the same observation point streamed TTFT uses
        t.t_first_token = t.t_done
        t.clamp_chain()
        self.telemetry.record(t)
        self.sim_request_done(req)

    def sim_request_done(self, req: SimRequest) -> None:
        if req.finished:
            return
        req.finished = True
        req.state = "done"
        if self.gateway is not None:
            # every terminal outcome funnels through here: feed the
            # breaker/EWMA/cache health signals
            self.gateway.note_outcome(req)
        if self.on_done is not None:
            self.on_done(req)
