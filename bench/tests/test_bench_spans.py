"""The readers of the program's spans and counts: their arithmetic on
records made by hand, and on the records of the tiny system served under
the CPU profiler, where the padded share is the bank's bucket arithmetic
of the prompts' lengths and the layer spans fit inside the halves."""
import pytest
from torch.profiler import ProfilerActivity, profile

from bench.generator import Traffic
from bench.harness import BENCH, Call, Run, _serve, load
from bench.peaks import H100
from bench.tests import tiny
from bench.trace import Trace

READERS = ("padded_position_share", "attention_ms", "attention_core_ms",
           "mlp_ms")


def read(name, run):
    return load(BENCH / "metrics" / f"{name}.py").read(run)


def _run(traced, trace=True):
    return Run(tiny.config(), 1.0, 2.0, [], H100,
               Trace(window_s=1.0, busy_s=0.5, device_events=[])
               if trace else None, traced)


def _record(name, sid, parent, root, ms, **counts):
    from repro_torch.runtime.metrics import SpanRecord
    rec = SpanRecord(name, sid, parent, root, counts, None)
    rec.start_ns, rec.end_ns = 0, int(ms * 1e6)
    return rec


def test_readers_on_records_made_by_hand(monkeypatch):
    from repro_torch.runtime import metrics
    recs = [_record("split.edge", 1, None, 1, 10.0, real_positions=26,
                    computed_positions=32),
            _record("mixer.attn", 2, 1, 1, 6.0),
            _record("mixer.attn.core", 3, 2, 1, 4.0),
            _record("ffn.mlp", 4, 1, 1, 3.0),
            _record("split.cloud", 5, None, 5, 20.0, real_positions=26,
                    computed_positions=32),
            _record("mixer.attn", 6, 5, 5, 8.0),
            _record("mixer.attn.core", 7, 6, 5, 5.0),
            _record("ffn.mlp", 8, 5, 5, 9.0),
            _record("engine.step", 9, None, 9, 1.0)]
    monkeypatch.setattr(metrics.SPANS, "records", recs)
    run = _run([Call(0, 2, 13, 0.0, 1.0, {})])
    assert read("padded_position_share", run) == pytest.approx(100 * 12 / 64)
    assert read("attention_ms", run) == pytest.approx(14.0 / 2)
    assert read("attention_core_ms", run) == pytest.approx(9.0 / 2)
    assert read("mlp_ms", run) == pytest.approx(12.0 / 2)
    # no trace, or no record, reads nothing; a bucket that pads nothing, 0
    assert all(read(n, _run(run.traced_calls, trace=False)) is None
               for n in READERS)
    monkeypatch.setattr(metrics.SPANS, "records", [])
    assert all(read(n, run) is None for n in READERS)
    monkeypatch.setattr(metrics.SPANS, "records", [
        _record("split.cloud", 1, None, 1, 1.0, real_positions=16,
                computed_positions=16)])
    assert read("padded_position_share", run) == 0.0
    assert read("mlp_ms", run) is None


def _bucket(n: int, lo: int) -> int:
    return max(lo, 1 << (n - 1).bit_length())


@pytest.mark.parametrize("mix", ["prefill-long", "prefill-batch-conv"])
def test_tiny_system_under_the_cpu_profiler(mix):
    cell = tiny.cell(mix)
    cfg, seed = cell.cfg, 2**33 + 11
    ref = load(BENCH / "references" / "qwen3.py")
    port = load(BENCH / "ports" / "qwen3.py")
    driver = load(BENCH / "drivers" / "split_prefill.py")
    params, butterfly = ref.make_weights(cfg, seed, "cpu")
    system = driver.System(port.model_config(cfg), cfg, params, butterfly,
                           "cpu")
    stream = Traffic(cell.mix, cfg["vocab_size"], seed).calls()
    system.serve(next(stream)[1])                # served with no profiler
    traced = []
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(len(cell.mix["lengths"])):
            traced.append(_serve(system, *next(stream))[0])
    run = _run(traced)

    computed = sum(_bucket(c.batch, 1) * _bucket(c.length, 16) for c in traced)
    real = sum(c.batch * c.length for c in traced)
    assert read("padded_position_share", run) == \
        pytest.approx(100 * (computed - real) / computed, abs=1e-12)
    if mix == "prefill-batch-conv":
        assert read("padded_position_share", run) == 0.0
    attention, core = read("attention_ms", run), read("attention_core_ms", run)
    mlp = read("mlp_ms", run)
    halves = sum(c.spans["edge_s"] + c.spans["cloud_s"] for c in traced) \
        * 1e3 / sum(c.batch for c in traced)
    assert 0 < core <= attention
    assert 0 < mlp and attention + mlp < halves
