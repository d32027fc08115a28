"""attention_ms: stream time of the program's ``mixer.attn`` spans (each
attention layer from its norm to its residual add) in the traced segment,
over its requests, in ms a request."""
from bench.spans import stream_ms_per_request


def read(run):
    return stream_ms_per_request(run, "mixer.attn")
