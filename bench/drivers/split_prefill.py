"""Split prefill through the port's ``SplitModelBank`` and its
``SplitRunner``: the paper's deployment, first token only.

One call serves a (B, S) block of prompts:

1. ``edge_half(params, tokens)``: embedding, layers ``[0, split)``,
   reduce + int8 quantize -> (codes, scales, cache0);
2. the codes and scales cross through host memory (device -> host ->
   device), where a deployment's link would land them;
3. ``cloud_half(params, codes, scales)``: restore, layers ``[split, N)``,
   the LM head -> last-position logits (B, V);
4. the logits come to the host, where greedy argmax picks each first
   token.

Each step is a span of the benchmark's own, ended by a synchronize (the
host copies that follow wait for the device anyway), and a
``record_function`` range that a trace shows.
"""
from __future__ import annotations

import time

import torch
from torch.profiler import record_function


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class System:
    """The system under test for one configuration on one device."""

    def __init__(self, model_cfg, cfg: dict, params: dict, butterfly: dict,
                 device):
        from repro_torch.runtime.split_exec import SplitModelBank

        wire = cfg["split"]
        self.device = torch.device(device)
        self.bank = SplitModelBank(
            model_cfg, wire["d_r"], wire_bits=wire["wire_bits"],
            wire_mode=wire["wire"], device=self.device, params=params,
            butterfly={wire["layer"]: butterfly})
        self.runner = self.bank.runner(wire["layer"])
        self.params = self.runner.params

    def cross(self, payload, scales):
        """The link: codes and scales to host memory and back."""
        payload, scales = payload.to("cpu"), scales.to("cpu")
        nbytes = payload.nbytes + scales.nbytes
        return payload.to(self.device), scales.to(self.device), nbytes

    def first_tokens(self, logits: torch.Tensor) -> torch.Tensor:
        """Greedy first tokens (B,) of host logits (B, V)."""
        return logits.argmax(dim=-1)

    def serve(self, tokens: torch.Tensor):
        """Serve host prompts ``tokens`` (B, S) int64.  Returns (host
        logits (B, V) float32, first tokens (B,), the two halves' spans in
        seconds and the bytes that crossed)."""
        clock = time.perf_counter
        t0 = clock()
        with record_function("bench.edge_half"):
            payload, scales, _ = self.runner.edge_half(self.params, tokens)
            _sync(self.device)
        t1 = clock()
        with record_function("bench.wire"):
            payload, scales, nbytes = self.cross(payload, scales)
        t2 = clock()
        with record_function("bench.cloud_half"):
            logits, _ = self.runner.cloud_half(self.params, payload, scales)
            _sync(self.device)
        t3 = clock()
        with record_function("bench.first_token"):
            logits = logits.to("cpu", torch.float32)
            first = self.first_tokens(logits)
        return logits, first, {"edge_s": t1 - t0, "cloud_s": t3 - t2,
                               "wire_bytes": nbytes}
