"""The ``flash_core_share`` reader: its arithmetic on span records made by
hand, and on the records of the tiny system served under the CPU profiler,
where every core runs the plain path (the flash kernel runs only on the
card)."""
import pytest
from torch.profiler import ProfilerActivity, profile

from bench.generator import Traffic
from bench.harness import BENCH, Call, Run, _serve, load
from bench.peaks import H100
from bench.tests import tiny
from bench.trace import Trace


def read(run):
    return load(BENCH / "metrics" / "flash_core_share.py").read(run)


def _run(traced, trace=True):
    return Run(tiny.config(), 1.0, 2.0, [], H100,
               Trace(window_s=1.0, busy_s=0.5, device_events=[])
               if trace else None, traced)


def _record(name, sid, parent, root, ms, **counts):
    from repro_torch.runtime.metrics import SpanRecord
    rec = SpanRecord(name, sid, parent, root, counts, None)
    rec.start_ns, rec.end_ns = 0, int(ms * 1e6)
    return rec


@pytest.mark.parametrize("flash, want", [
    ((1, 1, 1), 100.0), ((0, 0, 0), 0.0), ((1, 0, 0, 1), 50.0), ((), None),
    ((None, None), None)])
def test_flash_core_share_on_records_made_by_hand(monkeypatch, flash, want):
    """All cores on the kernel read 100, none 0; no core span, or core
    spans that count no ``flash`` (a program without the count), nothing."""
    from repro_torch.runtime import metrics
    recs = [_record("split.cloud", 1, None, 1, 10.0, real_positions=16,
                    computed_positions=16)]
    for i, f in enumerate(flash):
        counts = {} if f is None else {"flash": f}
        recs += [_record("mixer.attn", 2 + 2 * i, 1, 1, 2.0),
                 _record("mixer.attn.core", 3 + 2 * i, 2 + 2 * i, 1, 1.0,
                         **counts)]
    monkeypatch.setattr(metrics.SPANS, "records", recs)
    run = _run([Call(0, 1, 16, 0.0, 1.0, {})])
    assert read(run) == want
    assert read(_run(run.traced_calls, trace=False)) is None


def test_flash_core_share_of_the_tiny_system_on_the_cpu():
    """Served under the CPU profiler, the tiny system's cores all take the
    plain path: the share reads 0, not nothing."""
    cell = tiny.cell("prefill-long")
    cfg, seed = cell.cfg, 2**33 + 29
    ref = load(BENCH / "references" / "qwen3.py")
    port = load(BENCH / "ports" / "qwen3.py")
    driver = load(BENCH / "drivers" / "split_prefill.py")
    params, butterfly = ref.make_weights(cfg, seed, "cpu")
    system = driver.System(port.model_config(cfg), cfg, params, butterfly,
                           "cpu")
    stream = Traffic(cell.mix, cfg["vocab_size"], seed).calls()
    system.serve(next(stream)[1])
    with profile(activities=[ProfilerActivity.CPU]):
        traced = [_serve(system, *next(stream))[0] for _ in range(2)]
    assert read(_run(traced)) == 0.0
