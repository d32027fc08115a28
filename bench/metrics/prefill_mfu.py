"""prefill_mfu: analytic forward FLOPs of the window's real prompt tokens
(causal attention counted once; ``bench/flops.py``) over the window's
time times the card's bf16 peak, in percent."""
from bench.flops import dense_prefill_flops


def read(run):
    if run.peaks is None or not run.calls:
        return None
    flops = sum(c.batch * dense_prefill_flops(run.cfg, c.length)
                for c in run.calls)
    return 100.0 * flops / (run.window_s * run.peaks["bf16_flops"])
