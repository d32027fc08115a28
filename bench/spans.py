"""The program's own spans and counts of the traced segment: the records
that ``repro_torch.runtime.metrics.SPANS`` keeps while ``torch.profiler``
records (a root ``split.<kind>`` for each dispatch of a split half,
counting its real and computed positions; ``mixer.attn``,
``mixer.attn.core`` and ``ffn.mlp`` inside it).  A program without the
recorder gives nothing, and its readers return nothing."""


def records(run):
    """The span records of the traced segment, or None (no trace, or no
    recorder, or no record)."""
    if run.trace is None:
        return None
    try:
        from repro_torch.runtime.metrics import SPANS
    except ImportError:
        return None
    return SPANS.records or None


def stream_ms_per_request(run, name: str):
    """Stream time of every span ``name`` over the traced segment's
    requests, in ms a request; None where no span has that name."""
    recs = records(run)
    requests = sum(c.batch for c in run.traced_calls)
    if recs is None or not requests:
        return None
    mine = [r.stream_ms for r in recs if r.name == name]
    return sum(mine) / requests if mine else None
