"""attention_core_ms: stream time of the program's ``mixer.attn.core``
spans (attention's core: the S×S scores, mask, scale, softmax and
values, or the flash kernel) in the traced segment, over its requests, in
ms a request."""
from bench.spans import stream_ms_per_request


def read(run):
    return stream_ms_per_request(run, "mixer.attn.core")
