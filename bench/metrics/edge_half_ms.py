"""edge_half_ms: the benchmark's span around ``SplitRunner.edge_half``
(embedding, layers [0, split), reduce + quantize; ended by a
synchronize), summed over the window and divided by its requests."""


def read(run):
    if not run.calls:
        return None
    return sum(c.spans["edge_s"] for c in run.calls) * 1e3 / run.requests
