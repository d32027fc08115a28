"""Deterministic discrete-event simulation core.

A single virtual clock advances only when events fire; equal-time events run
in submission order (FIFO tie-break), so a simulation with a fixed seed
produces bit-identical traces on every host — the property the runtime tests
and the benchmark's cloud-only/split comparisons rely on.

One-shot events are cancellable: :meth:`EventLoop.schedule_at` /
:meth:`EventLoop.schedule` return a cancel callable (the same handle pattern
:meth:`EventLoop.schedule_every` has always used), and events scheduled with
an ``owner`` can be revoked in bulk via :meth:`EventLoop.cancel_owner` — how
the fault layer kills the pending completion callbacks of an evicted edge
device or a blacked-out wire without the callbacks firing for an actor that
no longer exists.  A cancelled event is popped from the heap unexecuted and
does not advance the clock or the event budget.
"""
from __future__ import annotations

import heapq
import itertools
from typing import Callable, Dict, List, Optional, Tuple


class _Scheduled:
    """One heap entry; ``fn = None`` marks it cancelled (or already fired),
    which also releases the closure for GC."""

    __slots__ = ("fn",)

    def __init__(self, fn: Callable[[], None]):
        self.fn = fn

    def cancel(self) -> None:
        self.fn = None


class EventLoop:
    """Min-heap of ``(time, seq, event)``; ``seq`` makes ordering total."""

    def __init__(self, start: float = 0.0):
        self.now = float(start)
        self._heap: List[Tuple[float, int, _Scheduled]] = []
        self._seq = itertools.count()
        self._processed = 0
        # owner -> its pending events (pruned lazily as they fire)
        self._owned: Dict[object, List[_Scheduled]] = {}

    def schedule_at(self, t: float, fn: Callable[[], None],
                    owner: Optional[object] = None) -> Callable[[], None]:
        """Schedule ``fn`` at virtual time ``t``; returns a cancel callable.
        ``owner`` registers the event for bulk revocation via
        :meth:`cancel_owner` (e.g. the device or wire whose completion this
        event represents)."""
        if t < self.now:
            raise ValueError(f"cannot schedule at {t} < now {self.now}")
        ev = _Scheduled(fn)
        heapq.heappush(self._heap, (float(t), next(self._seq), ev))
        if owner is not None:
            pending = self._owned.setdefault(owner, [])
            pending.append(ev)
            if len(pending) > 64:                     # lazy prune of fired
                pending[:] = [e for e in pending if e.fn is not None]
        return ev.cancel

    def schedule(self, delay: float, fn: Callable[[], None],
                 owner: Optional[object] = None) -> Callable[[], None]:
        if delay < 0:
            raise ValueError(f"negative delay {delay}")
        return self.schedule_at(self.now + delay, fn, owner=owner)

    def cancel_owner(self, owner: object) -> int:
        """Cancel every pending event registered to ``owner``; returns the
        number of events revoked."""
        n = 0
        for ev in self._owned.pop(owner, []):
            if ev.fn is not None:
                ev.cancel()
                n += 1
        return n

    def schedule_every(self, interval: float, fn: Callable[[], None],
                       first_delay: Optional[float] = None) -> Callable[[], None]:
        """Fire ``fn`` every ``interval`` of virtual time until the returned
        cancel callable is invoked.  The periodic event re-arms itself, so a
        caller (e.g. the metrics sampler) MUST cancel it when the workload
        drains — otherwise :meth:`run` never sees an empty queue."""
        if interval <= 0:
            raise ValueError(f"non-positive interval {interval}")
        live = [True]

        def tick() -> None:
            if not live[0]:
                return
            fn()
            self.schedule(interval, tick)

        self.schedule(interval if first_delay is None else first_delay, tick)
        return lambda: live.__setitem__(0, False)

    def empty(self) -> bool:
        return not self._heap

    @property
    def events_processed(self) -> int:
        return self._processed

    def step(self) -> bool:
        """Fire the next event; returns False when the queue is empty.
        Cancelled events are discarded without running, counting against
        the budget, or advancing the clock."""
        while self._heap:
            t, _, ev = heapq.heappop(self._heap)
            if ev.fn is None:
                continue
            self.now = t
            self._processed += 1
            fn, ev.fn = ev.fn, None           # mark fired (prunable)
            fn()
            return True
        return False

    def run(self, until: Optional[float] = None,
            max_events: int = 10_000_000) -> float:
        """Drain the queue (or stop at virtual time ``until``); returns the
        final clock value."""
        while self._heap and self._processed < max_events:
            if until is not None and self._heap[0][0] > until:
                self.now = until
                return self.now
            self.step()
        if self._heap and any(ev.fn is not None for _, _, ev in self._heap):
            raise RuntimeError(f"event budget exhausted ({max_events})")
        return self.now
