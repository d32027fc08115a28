"""dequant_restore_roofline: the fused dequantize + restore kernel
(``csrc/butterfly.cu`` ``dequant_restore_*_kernel``, not the one fused
with a norm) in the traced segment: the least time of the work its calls
needed (each call's real tokens, ``bench/flops.dequant_restore_cost`` at
the card's peaks) over the device time of its launches, in percent.
Rows the program pads count as work not needed."""
from bench.flops import dequant_restore_cost, least_seconds, widths


def _mine(name: str) -> bool:
    return "dequant_restore" in name and "norm" not in name


def read(run):
    t = run.trace
    if t is None or run.peaks is None:
        return None
    spent = sum(e - s for name, s, e in t.device_events if _mine(name))
    if spent <= 0:
        return None
    d, d_r = run.cfg["hidden_size"], run.cfg["split"]["d_r"]
    act, code = widths(run.cfg)
    least = sum(least_seconds(dequant_restore_cost(c.batch * c.length, d,
                                                   d_r, act, code), run.peaks)
                for c in run.traced_calls)
    return 100.0 * least / spent
