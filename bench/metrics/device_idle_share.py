"""device_idle_share: 100 * (1 - (union of the device's kernel, copy and
set intervals) / the traced window), from ``torch.profiler``."""


def read(run):
    t = run.trace
    if t is None or not t.device_events or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
