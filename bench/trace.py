"""Reduction of a ``torch.profiler`` trace to what the readers and the
result line take: the device's busy time (the union of its kernel, copy
and set intervals), its time by operation name, and its idle gaps named
by what the host was doing when each began (the innermost host operation
then running on the thread that drives the device, under the
benchmark's own ``bench.*`` range)."""
from __future__ import annotations

import time
from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch

Interval = Tuple[str, float, float]          # (name, start s, end s)


@dataclass
class Trace:
    window_s: float                          # the traced window, host clock
    busy_s: float                            # union of device intervals
    device_events: List[Interval]            # every device operation
    op_seconds: Dict[str, float] = field(default_factory=dict)
    idle_seconds: Dict[str, float] = field(default_factory=dict)

    def top(self, table: Dict[str, float], n: int = 10) -> list:
        return [[name, s] for name, s in
                sorted(table.items(), key=lambda kv: -kv[1])[:n]]

    def breakdown(self) -> dict:
        return {"device_ops": self.top(self.op_seconds),
                "idle_gaps": self.top(self.idle_seconds)}


def union(intervals: List[Interval]) -> List[Tuple[float, float]]:
    """The merged (start, end) spans of ``intervals``, in order."""
    merged: List[List[float]] = []
    for _, s, e in sorted(intervals, key=lambda iv: iv[1]):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def reduce(device: List[Interval], host: List[Interval],
           window_s: float) -> Trace:
    """``device`` and ``host`` intervals in seconds on one clock; ``host``
    only the driving thread's.  Gaps are taken inside the benchmark's
    spans: from the first ``bench.*`` range's start to the last one's end."""
    spans = [iv for iv in host if iv[0].startswith("bench.")]
    lo = min((s for _, s, _ in spans), default=0.0)
    hi = max((e for _, _, e in spans), default=0.0)
    merged = union(device)
    busy = sum(e - s for s, e in merged)
    ops: Counter = Counter()
    for name, s, e in device:
        ops[name[:120]] += e - s
    host = sorted(host, key=lambda iv: (iv[1], -iv[2]))
    idle: Counter = Counter()
    stack: List[Tuple[str, float]] = []      # running host ops, outermost first
    j, edge = 0, lo
    for s, e in merged + [(hi, hi)]:
        gap_lo, gap_hi = max(edge, lo), min(s, hi)
        edge = max(edge, e)
        if gap_hi <= gap_lo:
            continue
        t = gap_lo + 1e-9
        while j < len(host) and host[j][1] <= t:
            name, hs, he = host[j]
            while stack and stack[-1][1] <= hs:
                stack.pop()
            stack.append((name, he))
            j += 1
        names = [n for n, he in stack if he > t]
        span = next((n for n in names if n.startswith("bench.")), "host")
        op = names[-1] if names and names[-1] != span else "-"
        idle[f"{span} {op}"] += gap_hi - gap_lo
    return Trace(window_s=window_s, busy_s=busy, device_events=device,
                 op_seconds=dict(ops), idle_seconds=dict(idle))


def profiled(fn) -> Trace:
    """Run ``fn`` once under ``torch.profiler`` (host and CUDA activity)
    and reduce its trace.  The raw events are read as the profiler left
    them (``kineto_results``): building its event tree would take longer
    than the traced window.  The device's own copies of the ``bench.*``
    ranges are annotations, not work, and are left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    device, host, threads = [], [], Counter()
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        start = ev.start_ns() * 1e-9
        iv = (name, start, start + ev.duration_ns() * 1e-9)
        if ev.device_type() == DeviceType.CUDA:
            if not (name.startswith("bench.")
                    or getattr(ev, "is_user_annotation", lambda: False)()):
                device.append(iv)
        elif ev.device_type() == DeviceType.CPU:
            host.append((iv, ev.start_thread_id()))
            if name.startswith("bench."):
                threads[ev.start_thread_id()] += 1
    main = threads.most_common(1)[0][0] if threads else None
    return reduce(device, [iv for iv, th in host if th == main], window_s)
