"""Pluggable decode transports: how a multi-token split request moves its
decode phase between the edge and the cloud.

``cache_handoff``  (prefill/decode disaggregation, the runtime's historical
behavior, extracted here): the edge ships its stage-0 KV cache up with the
prefill codes, the cloud decodes whole tokens locally in the batch engine,
and the sampled ids come back in one downlink shipment at completion.
Uplink cost grows with prompt length (the cache), decode steps are cheap
(no wire on the token path).

``streamed``  (decode over the wire, DESIGN.md section 8.6): the edge keeps
a decode cache for layers [0, j) and, per generated token, embeds the
token, runs its half, and sends ONE fused-quantized ``(1, d_r)`` row
through the butterfly; the cloud applies restore + layers [j, N) against
its own cache and returns the sampled id over the downlink.  Uplink cost is
flat in prompt length; every token pays one RTT (row up + cloud turn + id
down).

JointDNN's observation that generation workloads want a different
partition/transport than one-shot inference is exactly this trade: long
prompt + long generation favors ``streamed`` (the handoff cache dominates),
short prompt + fat RTT favors ``cache_handoff``.  The controller can pick
per request (``transport="auto"``) via the same online selection phase that
picks the split (core/planner.select_split_online).

``progressive``  (entropy-coded upload/prefill overlap, DESIGN.md section
18): streamed decode plus a two-chunk prefill upload — the high-order
coarse bitplanes (and scales) ship first, the refinement planes queue
right behind on the same FIFO uplink, and the cloud starts its prefill as
soon as the coarse chunk lands, overlapping the accelerator with the
upload tail.  The first sampled token is gated on the refinement landing,
so decode numerics always see the FULL codes — bitwise parity with
``streamed`` — while TTFT stops paying for the serialized tail.

The transport objects are stateless singletons: they own the per-request
choreography (what crosses which wire when, who keeps which cache) while
the actors keep the machinery (serial frontiers, slot pools, batched
service turns).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core import wire_codec
from repro_torch.core.costs import TOKEN_BYTES

# deployment-default rANS prior shared by every entropy-wire request of a
# given width (the same default the codec benchmarks train against); cached
# because WirePrior.default builds a fresh frequency table per call
_DEFAULT_PRIORS: dict = {}


def _default_prior(d_r: int, bits: int = 8) -> wire_codec.WirePrior:
    key = (d_r, bits)
    if key not in _DEFAULT_PRIORS:
        _DEFAULT_PRIORS[key] = wire_codec.WirePrior.default(d_r, bits)
    return _DEFAULT_PRIORS[key]


def _entropy_payload_adjust(device, req) -> float:
    """Entropy-wire byte accounting (schema v5): swap the planner's
    nominal-rate prediction for the ACTUAL rANS size of this request's
    codes when they exist (numerics mode), stamping the trace's
    ``coded_bytes``/``nominal_bytes`` fields either way.  Returns the
    delta to add to the predicted uplink total.  Timing-only runs (no
    bank) keep the deterministic nominal prediction — delta 0.0 — so
    record->replay stays byte-identical in both modes (the encoder is a
    pure function of the codes)."""
    from repro_torch.core.planner import wire_mode_bytes

    t = req.trace
    predicted = wire_mode_bytes(device.cost.cfg, t.prompt_len, device.d_r,
                                "entropy")
    raw_int8 = wire_mode_bytes(device.cost.cfg, t.prompt_len, device.d_r,
                               "int8")
    coded = predicted
    delta = 0.0
    if req.payload is not None and req.payload[0] is not None:
        # (S, d_r) int8: the one host copy of the entropy wire
        codes = req.payload[0][0].cpu().numpy()
        actual = wire_codec.coded_nbytes(
            codes, _default_prior(device.d_r)) + t.prompt_len * 4
        # same escape hatch as the planner: the edge ships raw int8 codes
        # when coding would expand the payload
        actual = float(min(actual, raw_int8))
        delta = actual - predicted
        coded = actual
    t.coded_bytes += coded
    t.nominal_bytes += raw_int8
    return delta


class DecodeTransport:
    """Per-request decode choreography; subclasses are stateless."""

    name: str = "?"
    streams_tokens: bool = False

    def prefill_uplink_bytes(self, device, req) -> float:
        t = req.trace
        total = device.cost.payload_bytes(
            device.mode, device.wire_mode, t.prompt_len, device.d_r,
            t.split, req.max_new_tokens, transport=self.name)
        if device.wire_mode == "entropy" and device.mode == "split":
            total += _entropy_payload_adjust(device, req)
        return total

    def after_edge_prefill(self, device, req) -> None:
        """Hook between the edge prefill numerics and the uplink."""

    def start_cloud_decode(self, server, req) -> None:
        raise NotImplementedError


class CacheHandoffTransport(DecodeTransport):
    """Ship the stage-0 cache up; decode entirely cloud-side.  The sampled
    ids come down in one shipment at completion, so the mobile's first
    token arrives with the last — TTFT is stamped at delivery
    (CloudServer._deliver), the same observation point the streamed
    transport uses."""

    name = "cache_handoff"

    def start_cloud_decode(self, server, req) -> None:
        t = req.trace
        eng = server._engine(t.split)
        if eng is not None:
            if server.mode == "split":
                logits_row, cache1, cache0 = server._cloud_numerics(req)
                req.engine_req = eng.submit_prefilled(
                    t.prompt_len, [cache0, cache1], logits_row,
                    max_new_tokens=req.max_new_tokens)
            else:
                req.engine_req = eng.submit(
                    req.tokens, max_new_tokens=req.max_new_tokens)
            req.payload = None
            if req.engine_req.done:
                server._complete(req)
        else:
            server._virtual_left[t.uid] = req.max_new_tokens - 1
            if server._virtual_left[t.uid] <= 0:
                server._complete(req)


class StreamedTransport(DecodeTransport):
    """Keep the stage-0 cache on the edge; stream one row per token."""

    name = "streamed"
    streams_tokens = True

    # -- edge side ----------------------------------------------------------
    def after_edge_prefill(self, device, req) -> None:
        """The edge retains its stage-0 cache (padded to decode capacity)
        instead of shipping it; only codes + scales cross the uplink."""
        t = req.trace
        req.edge_pos = t.prompt_len
        if device.bank is not None and req.payload is not None:
            codes, scales, cache0 = req.payload
            runner = device.runner(t.split)
            req.edge_cache = runner.pad_decode_cache(
                cache0, 0, device.server.max_len)
            req.payload = (codes, scales, None)

    def token_at_device(self, device, req, tok, seq=None) -> None:
        """A sampled id reached the mobile: either the response is complete,
        or the edge runs its per-token half and streams the next row.
        ``seq`` (1-based, set by the fault-aware send path) makes delivery
        idempotent: a retried token the original beat is dropped."""
        t = req.trace
        now = device.loop.now
        if req.finished:
            return
        if seq is not None and seq <= req.produced:
            device.telemetry.counters["fault_duplicate_tokens"] += 1
            return
        req.produced = seq if seq is not None else req.produced + 1
        if device.injector is not None:
            device.injector.ack(req)        # progress: stale timers die
        if req.stream_t0 is not None:
            t.stream_rtt_s += now - req.stream_t0
            t.stream_steps += 1
            req.stream_t0 = None
        if req.produced == 1:
            t.t_first_token = now
        req.last_token = tok
        if req.produced >= req.max_new_tokens:
            t.new_tokens = req.produced
            t.t_done = now
            t.clamp_chain()
            device.telemetry.record(t)
            device.server.sim_request_done(req)
            return
        self._schedule_edge_step(device, req)

    def _schedule_edge_step(self, device, req) -> None:
        """Charge one edge decode step on ``device`` and schedule its
        completion — also the migration resume point: a checkpointed decode
        restarts here on its new home."""
        t = req.trace
        now = device.loop.now
        start = max(now, device.free_at)
        dur = device.cost.edge_decode_step_s(t.split, device.d_r)
        device.free_at = start + dur
        t.mobile_energy_mj += device.cost.edge_energy_mj(dur)
        device.tracer.complete(device.track, "decode_step", start,
                               start + dur, cat="edge",
                               args={"uid": t.uid, "pos": req.edge_pos})
        req.state = "edge_decode"
        device.loop.schedule_at(start + dur,
                                lambda: self.edge_step_done(device, req),
                                owner=device)

    def edge_step_done(self, device, req) -> None:
        if req.finished:
            return
        t = req.trace
        if device.bank is not None:
            runner = device.runner(t.split)
            tok = np.asarray([[req.last_token]], np.int32)
            payload, scales, req.edge_cache = runner.edge_step(
                runner.params, tok, req.edge_cache, [req.edge_pos])
            req.stream_row = (payload, scales)
        req.edge_pos += 1
        device.telemetry.counters["stream_edge_steps"] += 1
        self.send_row(device, req)

    def send_row(self, device, req) -> None:
        """One quantized row up the wire; retries re-enter here (the RTT
        anchor keeps the FIRST send time, so a retried token honestly pays
        the loss in its RTT)."""
        if req.finished:
            return
        t = req.trace
        now = device.loop.now
        nbytes = device.cost.stream_row_bytes(device.wire_mode, device.d_r)
        t.wire_bytes += nbytes
        if req.stream_t0 is None:
            req.stream_t0 = now                  # RTT: row ready -> id back
        start, done = device.uplink.transfer(nbytes, now, uid=t.uid,
                                             tag="row")
        t.mobile_energy_mj += device.uplink.transfer_energy_mj(nbytes)
        req.state = "await_token"
        device.loop.schedule_at(done,
                                lambda: device.server.on_stream_row(req),
                                owner=device.uplink)
        if device.injector is not None:
            device.injector.arm(
                req,
                lambda: self.send_row(device.server.device_for(req), req),
                "row")

    # -- cloud side ---------------------------------------------------------
    def start_cloud_decode(self, server, req) -> None:
        """Cloud prefill finished: sample the first token and send it down.
        The first-token timestamp is set when the id reaches the mobile —
        the streamed transport's TTFT honestly includes the downlink."""
        t = req.trace
        if server.bank is not None:
            logits_row, cache1, _ = server._cloud_numerics(req)
            runner = server.bank.runner(t.split)
            req.cloud_cache = runner.pad_decode_cache(cache1, 1,
                                                      server.max_len)
            req.cloud_pos = t.prompt_len
            eng = server._engine(t.split)
            req.engine_req = eng.submit_streamed(
                t.prompt_len, logits_row, max_new_tokens=req.max_new_tokens)
            req.payload = None
            tok = req.engine_req.generated[0]
        else:
            tok = 0
        self.send_token(server, req, tok)

    def serve_rows(self, server, batch) -> None:
        """One serial-accelerator turn over the arrived rows: numerics run
        per request through the engine's single-slot streamed entry (the
        bank-shared compiled cloud step); the turn's duration was already
        charged by the server per split group."""
        for req in batch:
            t = req.trace
            if req.finished:
                continue
            if req.edge_pos <= req.cloud_served_upto:
                # a retried row for a position already served: don't step
                # the numerics again — resend the token it produced
                server.telemetry.counters["fault_duplicate_rows"] += 1
                tok, seq = req.last_sent
                self.send_token(server, req, tok, seq=seq)
                continue
            if server.bank is not None:
                runner = server.bank.runner(t.split)
                payload, scales = req.stream_row
                tok, req.cloud_cache = runner.stream_step(
                    server._engine(t.split), req.engine_req, req.cloud_cache,
                    payload, scales, req.cloud_pos)
            else:
                tok = 0
            req.cloud_pos += 1
            req.cloud_served_upto = req.edge_pos
            self.send_token(server, req, tok)

    def send_token(self, server, req, tok, seq=None) -> None:
        """One sampled id over the downlink to the mobile; on the last token
        the cloud's involvement ends here (slot + cache released before the
        downlink completes).  A fresh send (``seq=None``) assigns the next
        sequence number; a resend reuses the original's, so the device can
        drop duplicates.  Cloud-side bookkeeping (completion stamp, slot
        release, cache drop) runs on the FRESH send only."""
        if req.finished:
            return
        t = req.trace
        now = server.loop.now
        fresh = seq is None
        if fresh:
            req.sent_down += 1
            seq = req.sent_down
            req.last_sent = (int(tok), seq)
        wire = server.wire_for(req)
        t.downlink_bytes += TOKEN_BYTES
        start, done = wire.transfer_down(TOKEN_BYTES, now, uid=t.uid,
                                         tag="token")
        t.mobile_energy_mj += wire.downlink_energy_mj(TOKEN_BYTES)
        if fresh and seq >= req.max_new_tokens:
            t.t_cloud_done = now
            if req.slot >= 0:
                server.release_slot(req, now)
            req.cloud_cache = None
        # resolve the device at FIRE time: a migrated request's token lands
        # on its new home
        server.loop.schedule_at(
            done,
            lambda: self.token_at_device(server.device_for(req), req, tok,
                                         seq),
            owner=wire)
        if server.injector is not None and fresh and seq == 1:
            # the first token has no device-side row timer guarding it
            server.injector.arm(
                req, lambda: self.resend_last_token(server, req), "token")

    def resend_last_token(self, server, req) -> None:
        if req.finished or req.last_sent is None:
            return
        tok, seq = req.last_sent
        self.send_token(server, req, tok, seq=seq)
        server.injector.arm(
            req, lambda: self.resend_last_token(server, req), "token")


class ProgressiveTransport(StreamedTransport):
    """Streamed decode + progressive prefill upload: coarse bitplanes
    first, cloud prefill overlapping the refinement tail.

    The edge side (EdgeDevice._send_progressive) splits the prefill
    payload into two back-to-back FIFO uplink transfers; ``on_payload``
    fires at the COARSE landing, so the cloud's serial prefill frontier
    starts ``refine/link`` seconds earlier than under ``streamed``.  The
    cloud side below runs the exact streamed numerics — the payload object
    always holds the full-precision codes, so generated ids are bitwise
    identical to ``streamed`` — but holds the first sampled token until
    the refinement chunk has landed (``req.refine_done``), keeping the
    modeled timeline honest: no token can depend on planes still in
    flight."""

    name = "progressive"

    def start_cloud_decode(self, server, req) -> None:
        t = req.trace
        if server.bank is not None:
            logits_row, cache1, _ = server._cloud_numerics(req)
            runner = server.bank.runner(t.split)
            req.cloud_cache = runner.pad_decode_cache(cache1, 1,
                                                      server.max_len)
            req.cloud_pos = t.prompt_len
            eng = server._engine(t.split)
            req.engine_req = eng.submit_streamed(
                t.prompt_len, logits_row, max_new_tokens=req.max_new_tokens)
            req.payload = None
            tok = int(req.engine_req.generated[0])
        else:
            tok = 0
        if not req.refine_done:
            # the overlapped prefill beat the refinement tail: hold the
            # token; the refine-landing event releases it (release_gated)
            req.gated_token = tok
            server.telemetry.counters["progressive_gated_tokens"] += 1
            return
        self.send_token(server, req, tok)

    def release_gated(self, server, req) -> None:
        """Refinement landed: unfreeze decode, sending the held first
        token if the prefill already produced one."""
        req.refine_done = True
        if req.finished or req.gated_token is None:
            return
        tok = req.gated_token
        req.gated_token = None
        self.send_token(server, req, tok)


TRANSPORTS = {
    "cache_handoff": CacheHandoffTransport(),
    "streamed": StreamedTransport(),
    "progressive": ProgressiveTransport(),
}


def get_transport(name: str) -> DecodeTransport:
    try:
        return TRANSPORTS[name]
    except KeyError:
        raise KeyError(f"unknown decode transport {name!r}; "
                       f"known: {sorted(TRANSPORTS)}") from None
