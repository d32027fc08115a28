"""The harness's control flow at a tiny size on the CPU: a whole run of
each traffic mix, the metric readers' arithmetic on a run made by hand,
and the command's refusal without a card."""
import time

import pytest

from bench import run as run_cli
from bench.harness import BENCH, Call, Run, load, run_cell
from bench.peaks import H100
from bench.tests import tiny
from bench.trace import Trace

MIXES = ["prefill-long", "prefill-batch-conv"]


@pytest.mark.parametrize("mix", MIXES)
def test_tiny_run_is_correct_and_reports_every_end_to_end_metric(mix):
    cell = tiny.cell(mix)
    result = run_cell(cell, 2**33 + 7, 0.05, False, "cpu", time.perf_counter())
    assert result["correct"] is True
    assert list(result)[-1] == "check"
    assert set(result["check"]) == set(cell.limits)
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(m["value"] > 0 for m in result["metrics"].values())
    cycle = len(cell.mix["lengths"]) * cell.mix["batch"]
    assert result["attempted"] > 0 and result["attempted"] % cycle == 0


def _run(trace=None, traced=()):
    cfg = tiny.config()
    calls = [Call(0, 1, 100, 0.0, 0.5, {"edge_s": 0.1, "cloud_s": 0.3,
                                         "wire_bytes": 100 * 20}),
             Call(1, 2, 50, 0.5, 1.0, {"edge_s": 0.2, "cloud_s": 0.2,
                                        "wire_bytes": 100 * 20})]
    return Run(cfg, 1.0, 2.0, calls, H100, trace, list(traced))


def read(name, run):
    return load(BENCH / "metrics" / f"{name}.py").read(run)


def test_span_and_count_readers():
    run = _run()
    assert run.requests == 3 and run.tokens == 200
    assert read("prefill_tokens_per_s", run) == pytest.approx(100.0)
    assert read("edge_half_ms", run) == pytest.approx(100.0)
    assert read("cloud_half_ms", run) == pytest.approx(500 / 3)
    assert read("wire_bytes_per_token", run) == pytest.approx(20.0)
    assert read("setup_s", run) == 1.0
    # three requests at 500 ms: every percentile is 500
    assert read("ttft_p95_ms", run) == pytest.approx(500.0)


def test_trace_readers():
    kernels = [("void reduce_quant_kernel<Body<8>>(ReduceArgs)", 0.0, 2e-5),
               ("void dequant_restore_mma_kernel<64>(RestoreArgs, int)", 3e-5, 4e-5),
               ("void dequant_restore_norm_kernel<bf16>(RestoreArgs)", 4e-5, 9e-5),
               ("sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x64x8", 1e-4, 4e-4),
               ("nvjet_tst_192x192_64x3_2x1_v_bz_coopB_NNN", 4e-4, 1e-3)]
    trace = Trace(window_s=2e-3, busy_s=9.9e-4, device_events=kernels)
    traced = [Call(9, 1, 100, 0.0, 1.0, {})]
    run = _run(trace, traced)
    assert read("device_idle_share", run) == pytest.approx(50.5)
    assert read("f32_gemm_share", run) == pytest.approx(100 * 3e-4 / 9.8e-4)
    d, d_r = run.cfg["hidden_size"], run.cfg["split"]["d_r"]
    rq = 100 * (100 * d * 2 + d * d_r * 2 + 100 * d_r + 400) / 3.35e12 / 2e-5
    assert read("reduce_quant_roofline", run) == pytest.approx(rq)
    dr = 100 * (100 * d_r + 400 + d_r * d * 2 + 100 * d * 2) / 3.35e12 / 1e-5
    assert read("dequant_restore_roofline", run) == pytest.approx(dr)
    # a trace without the kernel reads nothing, never 0
    bare = _run(Trace(window_s=1.0, busy_s=0.5, device_events=kernels[3:]),
                traced)
    assert read("reduce_quant_roofline", bare) is None
    assert read("dequant_restore_roofline", bare) is None
    assert read("device_idle_share", _run()) is None


def test_mfu_reader_counts_the_window_real_tokens():
    run = _run()
    from bench.flops import dense_prefill_flops
    want = (dense_prefill_flops(run.cfg, 100) + 2 * dense_prefill_flops(run.cfg, 50))
    assert read("prefill_mfu", run) == pytest.approx(100 * want / (2.0 * 989e12))
    assert read("prefill_mfu", Run(run.cfg, 1.0, 2.0, run.calls, None)) is None


def test_command_refuses_without_enough_cards(capsys, monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    code = run_cli.main(["--workload", "qwen3-8b.prefill-long", "--seed", "1",
                         "--seconds", "1"])
    out = capsys.readouterr()
    assert code == 2 and out.out == "" and "CUDA" in out.err
