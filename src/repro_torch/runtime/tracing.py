"""Flight-recorder span tracing for the split runtime.

A :class:`Tracer` collects begin/end spans stamped on the *virtual* clock —
one track per edge device, per wire direction, per cloud engine slot, the
cloud accelerator, and per cell controller — and exports them as Chrome
trace-event JSON (load the file in Perfetto / ``chrome://tracing``).  The
runtime emits:

  ``edge/<cell>/dev<N>``   serial device occupancy: ``prefill`` /
                           ``local_infer`` / ``decode_step`` compute spans,
                           ``coalesce`` instant events (numerics batching)
  ``wire/<name>/up|down``  one ``xfer`` span per FIFO transfer (admission
                           wait recorded in ``args.wait_ms``)
  ``cloud/accel``          serial accelerator turns: ``prefill`` /
                           ``decode_turn`` / ``stream_turn``
  ``cloud/slot<N>``        slot residency (``u<uid>`` spans, admission ->
                           release)
  ``ctl/<cell>``           controller decisions as instant events
  ``faults/sched``         injected fault events (``cat="fault"`` instants
                           carrying ``args.kind`` — validated below)
  request-scoped phases    async spans keyed on the request uid
                           (``request`` / ``edge_queue`` / ``uplink_wait`` /
                           ``cloud_queue``) — the span *tree* each thread
                           track's spans nest inside

Determinism: every timestamp is a virtual-clock value and events append in
event-loop order, so a record -> replay pair produces **byte-identical**
trace files (asserted in CI and tests/test_observability.py).  Wall-clock
quantities (jit compile times etc.) never enter a trace — they live in
:mod:`repro_torch.runtime.metrics`.

Tracing is opt-out by default: :data:`NULL_TRACER` swallows every call with
no allocation, and a simulation built without ``trace=True`` runs the exact
pre-tracing path (telemetry-equality regression test).

``python -m repro_torch.runtime.tracing <trace.json>`` validates a trace file
against the trace-event schema (required fields, non-negative durations,
per-track monotonic non-overlapping spans, minimum track-type coverage) —
the CI smoke runs it on every topology trace artifact.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

TRACE_SCHEMA_VERSION = 1

# track-type = first path segment of a track name; the CI smoke requires a
# topology trace to cover at least these four
CORE_TRACK_TYPES = ("edge", "wire", "cloud", "ctl")


def _us(t: float) -> float:
    """Virtual seconds -> trace-event microseconds.  Durations are computed
    as ``_us(t1) - _us(t0)`` so a span's end lands *exactly* on the next
    adjacent span's start (no float re-association drift)."""
    return t * 1e6


class Tracer:
    """Collects trace events on the virtual clock.

    Tracks are registered lazily (:meth:`track`) in first-use order — which
    is event-loop order, hence deterministic — and map to Chrome trace
    ``(pid, tid)`` pairs: one pid per track *type* (``edge``, ``wire``,
    ``cloud``, ``ctl``), one tid per track, both named via metadata events.
    """

    enabled = True

    def __init__(self):
        self.events: List[dict] = []
        self._tracks: Dict[str, Tuple[int, int]] = {}
        self._pids: Dict[str, int] = {}
        self._next_tid = 1

    # ----------------------------------------------------------- track setup
    def track(self, name: str) -> Tuple[int, int]:
        """(pid, tid) of ``name`` (``"<type>/<instance...>"``), registering
        it — and its naming metadata — on first use."""
        if name in self._tracks:
            return self._tracks[name]
        kind = name.split("/", 1)[0]
        if kind not in self._pids:
            pid = len(self._pids) + 1
            self._pids[kind] = pid
            self.events.append({"ph": "M", "name": "process_name",
                                "pid": pid, "tid": 0, "ts": 0.0,
                                "args": {"name": kind}})
        pid = self._pids[kind]
        tid = self._next_tid
        self._next_tid += 1
        self._tracks[name] = (pid, tid)
        self.events.append({"ph": "M", "name": "thread_name",
                            "pid": pid, "tid": tid, "ts": 0.0,
                            "args": {"name": name}})
        return self._tracks[name]

    # ---------------------------------------------------------------- events
    def complete(self, track: str, name: str, t0: float, t1: float, *,
                 cat: str = "span", args: Optional[dict] = None) -> None:
        """One begin/end span ``[t0, t1]`` on a thread track (trace-event
        ``X``).  Thread tracks model serial resources: their spans must not
        overlap (validated by :func:`validate_chrome_trace`)."""
        assert t1 >= t0, (name, t0, t1)
        pid, tid = self.track(track)
        ev = {"ph": "X", "name": name, "cat": cat, "pid": pid, "tid": tid,
              "ts": _us(t0), "dur": _us(t1) - _us(t0)}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def instant(self, track: str, name: str, t: float, *,
                cat: str = "event", args: Optional[dict] = None) -> None:
        """A zero-duration marker (trace-event ``i``, thread scope)."""
        pid, tid = self.track(track)
        ev = {"ph": "i", "name": name, "cat": cat, "pid": pid, "tid": tid,
              "ts": _us(t), "s": "t"}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def async_span(self, track: str, name: str, span_id: int, t0: float,
                   t1: float, *, cat: str = "request",
                   args: Optional[dict] = None) -> None:
        """A begin/end pair on an id-scoped async timeline (trace-event
        ``b``/``e``): request-phase spans that legitimately overlap across
        requests (queues, lifetimes) without breaking the serial-track
        invariant."""
        assert t1 >= t0, (name, t0, t1)
        pid, tid = self.track(track)
        ident = f"0x{span_id:x}"
        b = {"ph": "b", "name": name, "cat": cat, "pid": pid, "tid": tid,
             "ts": _us(t0), "id": ident}
        if args:
            b["args"] = args
        self.events.append(b)
        self.events.append({"ph": "e", "name": name, "cat": cat, "pid": pid,
                            "tid": tid, "ts": _us(t1), "id": ident})

    def counter(self, track: str, name: str, t: float,
                values: Dict[str, float]) -> None:
        """A counter sample (trace-event ``C``) — renders as a stacked
        time-series lane in Perfetto."""
        pid, _ = self.track(track)
        self.events.append({"ph": "C", "name": name, "cat": "metric",
                            "pid": pid, "tid": 0, "ts": _us(t),
                            "args": dict(values)})

    # ---------------------------------------------------------------- export
    def to_json(self) -> str:
        return json.dumps({"displayTimeUnit": "ms",
                           "otherData": {"schema_version":
                                         TRACE_SCHEMA_VERSION},
                           "traceEvents": self.events},
                          indent=1, sort_keys=True)

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())
            f.write("\n")

    @property
    def track_names(self) -> List[str]:
        return list(self._tracks)


class _NullTracer(Tracer):
    """Opt-out default: swallows every call, allocates nothing."""

    enabled = False

    def __init__(self):
        self.events = []
        self._tracks = {}

    def track(self, name):                                   # pragma: no cover
        return (0, 0)

    def complete(self, *a, **k):
        pass

    def instant(self, *a, **k):
        pass

    def async_span(self, *a, **k):
        pass

    def counter(self, *a, **k):
        pass


NULL_TRACER = _NullTracer()


# ---------------------------------------------------------------------------
# validation: the CI gate on every trace artifact
# ---------------------------------------------------------------------------


def validate_chrome_trace(doc: dict, *, min_track_types: int = 4,
                          eps_us: float = 1e-6) -> Dict[str, int]:
    """Validate a Chrome trace-event document; raises ``ValueError`` on the
    first violation, returns coverage stats otherwise.

    Checks: the ``traceEvents`` envelope; required fields per phase
    (name/ph/ts/pid/tid, ``dur >= 0`` and a category on ``X`` spans,
    matched ``b``/``e`` pairs per (cat, id, name)); per-track monotonic,
    non-overlapping ``X`` spans (thread tracks are serial resources); and
    at least ``min_track_types`` distinct track types among
    :data:`CORE_TRACK_TYPES`-style prefixes.
    """
    events = doc.get("traceEvents")
    if not isinstance(events, list) or not events:
        raise ValueError("no traceEvents list")
    tracks: Dict[Tuple[int, int], List[Tuple[float, float]]] = {}
    names: Dict[Tuple[int, int], str] = {}
    open_async: Dict[Tuple[str, str, str], int] = {}
    counts = {"X": 0, "i": 0, "b": 0, "e": 0, "C": 0, "M": 0}
    for i, ev in enumerate(events):
        for field in ("ph", "ts", "pid", "tid"):
            if field not in ev:
                raise ValueError(f"event {i}: missing {field!r}: {ev}")
        ph = ev["ph"]
        if ph not in counts:
            raise ValueError(f"event {i}: unknown phase {ph!r}")
        counts[ph] += 1
        if ph != "M" and "name" not in ev:
            raise ValueError(f"event {i}: missing name: {ev}")
        if ph == "M":
            if ev["name"] == "thread_name":
                names[(ev["pid"], ev["tid"])] = ev["args"]["name"]
            continue
        if "cat" not in ev:
            raise ValueError(f"event {i}: missing cat: {ev}")
        if ev["cat"] == "fault" and "kind" not in ev.get("args", {}):
            raise ValueError(f"event {i}: fault event missing args.kind: "
                             f"{ev}")
        if ph == "X":
            if ev.get("dur", -1) < 0:
                raise ValueError(f"event {i}: X span needs dur >= 0: {ev}")
            tracks.setdefault((ev["pid"], ev["tid"]), []).append(
                (ev["ts"], ev["ts"] + ev["dur"]))
        elif ph in ("b", "e"):
            key = (ev["cat"], str(ev.get("id")), ev["name"])
            open_async[key] = open_async.get(key, 0) + (1 if ph == "b" else -1)
            if open_async[key] < 0:
                raise ValueError(f"event {i}: async end before begin: {ev}")
    dangling = {k: n for k, n in open_async.items() if n != 0}
    if dangling:
        raise ValueError(f"unmatched async begin/end pairs: {dangling}")
    for key, spans in tracks.items():
        track = names.get(key, str(key))
        last_end = None
        for ts, end in spans:
            if last_end is not None and ts < last_end - eps_us:
                raise ValueError(
                    f"track {track!r}: overlapping/non-monotonic spans "
                    f"(start {ts} < previous end {last_end})")
            last_end = end
    types = {n.split("/", 1)[0] for n in names.values()}
    if len(types) < min_track_types:
        raise ValueError(f"only {sorted(types)} track types present; "
                         f"need >= {min_track_types}")
    return {"events": len(events), "tracks": len(names),
            "track_types": len(types), **counts}


def main(argv=None) -> None:                                 # pragma: no cover
    import argparse
    ap = argparse.ArgumentParser(
        description="validate a Chrome trace-event JSON file")
    ap.add_argument("trace")
    ap.add_argument("--min-track-types", type=int, default=4)
    args = ap.parse_args(argv)
    with open(args.trace) as f:
        doc = json.load(f)
    stats = validate_chrome_trace(doc,
                                  min_track_types=args.min_track_types)
    print(f"{args.trace}: OK — {stats['events']} events on "
          f"{stats['tracks']} tracks ({stats['track_types']} track types; "
          f"{stats['X']} spans, {stats['i']} instants, "
          f"{stats['b']} async, {stats['C']} counters)")


if __name__ == "__main__":                                   # pragma: no cover
    main()
