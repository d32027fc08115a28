"""ttft_p95_ms: the 95th percentile over every request of the window of
the time from its issue to its first token on the host (every request of
a call gets the call's time), linear between order statistics."""


def percentile(values, q):
    v = sorted(values)
    if not v:
        return None
    pos = (len(v) - 1) * q
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def read(run):
    return percentile([c.seconds * 1e3 for c in run.calls
                       for _ in range(c.batch)], 0.95)
