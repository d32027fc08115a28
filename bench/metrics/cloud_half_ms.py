"""cloud_half_ms: the benchmark's span around ``SplitRunner.cloud_half``
(restore, layers [split, N), the head; ended by a synchronize), summed
over the window and divided by its requests."""


def read(run):
    if not run.calls:
        return None
    return sum(c.spans["cloud_s"] for c in run.calls) * 1e3 / run.requests
