"""wire_bytes_per_token: the bytes of codes and scales that crossed from
the edge half to the cloud half, over the real prompt tokens."""


def read(run):
    if not run.calls:
        return None
    return sum(c.spans["wire_bytes"] for c in run.calls) / run.tokens
