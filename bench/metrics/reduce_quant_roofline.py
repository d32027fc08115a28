"""reduce_quant_roofline: the fused reduce + quantize kernel
(``csrc/butterfly.cu`` ``reduce_quant_kernel``) in the traced segment:
the least time of the work its calls needed (each call's real tokens,
``bench/flops.reduce_quant_cost`` at the card's peaks) over the device
time of its launches, in percent.  Rows the program pads count as work
not needed."""
from bench.flops import least_seconds, reduce_quant_cost, widths

KERNEL = "reduce_quant_kernel"


def read(run):
    t = run.trace
    if t is None or run.peaks is None:
        return None
    spent = sum(e - s for name, s, e in t.device_events if KERNEL in name)
    if spent <= 0:
        return None
    d, d_r = run.cfg["hidden_size"], run.cfg["split"]["d_r"]
    act, code = widths(run.cfg)
    least = sum(least_seconds(reduce_quant_cost(c.batch * c.length, d, d_r,
                                                act, code), run.peaks)
                for c in run.traced_calls)
    return 100.0 * least / spent
