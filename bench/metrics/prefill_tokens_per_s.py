"""prefill_tokens_per_s: the real prompt tokens (no padding) of every
request the window completed, over the window's time (its last call
completes after the window's nominal length; the window ends with it)."""


def read(run):
    return run.tokens / run.window_s if run.calls else None
