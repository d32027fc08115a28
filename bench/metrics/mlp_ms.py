"""mlp_ms: stream time of the program's ``ffn.mlp`` spans (each MLP
block from its norm to its residual add) in the traced segment, over its
requests, in ms a request."""
from bench.spans import stream_ms_per_request


def read(run):
    return stream_ms_per_request(run, "ffn.mlp")
