"""The port's program spans (``runtime.metrics.span``) on the split halves
of a 4-layer reduced qwen3-8b bank split after layer 2, on the CPU:

  * with no profiler the halves open no profiler range, make no CUDA
    event, read no clock and record nothing;
  * under ``torch.profiler`` an edge/cloud pair at S = 13 gives one
    ``split.edge`` and one ``split.cloud`` root counting 13 real and 16
    computed positions, and each layer of a half one ``mixer.attn``
    holding one ``mixer.attn.core``, and one ``ffn.mlp``, inside their
    parents, under their root's id;
  * each record's host start is on the profiler's clock;
  * the logits are bit-identical with the profiler on and off;
  * a second profiler session keeps only its own records;
  * the bank's prefill halves take the flash kernel (``kops.flash_attention``,
    a counting stand-in here) once a layer where ``split_exec.flash_core``
    finds bf16 on the card (the device check faked), and each
    ``mixer.attn.core`` span counts ``flash`` 1 there and 0 on the plain
    path; an f32 bank, a CPU bank and ``reference_prefill`` never take it.
"""
import dataclasses
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.kernels import ops as kops
from repro_torch.runtime import metrics, split_exec
from repro_torch.runtime.split_exec import SplitModelBank

SPLIT, LAYERS, S = 2, 4, 13


@pytest.fixture(scope="module")
def runner():
    cfg = dataclasses.replace(get_config("qwen3-8b").reduced(),
                              num_layers=LAYERS)
    return SplitModelBank(cfg, 16, device="cpu", seed=0).runner(SPLIT)


@pytest.fixture(scope="module")
def toks():
    return torch.randint(0, 512, (1, S),
                         generator=torch.Generator().manual_seed(3))


def _halves(runner, toks):
    payload, scales, _ = runner.edge_half(runner.params, toks)
    logits, _ = runner.cloud_half(runner.params, payload, scales)
    return logits


def _profiled(runner, toks):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        logits = _halves(runner, toks)
    return logits, prof


def test_no_profiler_no_range_no_event_no_clock_no_record(runner, toks,
                                                          monkeypatch):
    def boom(*a, **k):
        raise AssertionError("a span did work with no profiler recording")

    class NoClock:
        time_ns = perf_counter = staticmethod(boom)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", boom)
    monkeypatch.setattr(torch.cuda, "Event", boom)
    monkeypatch.setattr(metrics, "time", NoClock)
    metrics.SPANS.clear()
    _halves(runner, toks)
    assert metrics.SPANS.records == []
    assert metrics.span("a") is metrics.span("b", torch.zeros(1), n=1)


def test_roots_layers_clock_and_bit_identical_logits(runner, toks):
    # the process's first profiler range pays a one-time set-up (about a
    # millisecond): a session before the one read keeps it out
    _profiled(runner, toks)
    off = _halves(runner, toks)
    on, prof = _profiled(runner, toks)
    assert torch.equal(on, off)

    recs = metrics.SPANS.records
    roots = [r for r in recs if r.parent is None]
    assert [r.name for r in roots] == ["split.edge", "split.cloud"]
    for r in roots:
        assert r.counts == {"real_positions": S, "computed_positions": 16}
        assert r.root == r.id
    by_id = {r.id: r for r in recs}
    for root, layers in zip(roots, (SPLIT, LAYERS - SPLIT)):
        mine = [r for r in recs if r.root == root.id and r is not root]
        names = [r.name for r in mine]
        assert names == ["mixer.attn", "mixer.attn.core", "ffn.mlp"] * layers
        for r in mine:
            parent = by_id[r.parent]
            assert parent.name == ("mixer.attn" if r.name == "mixer.attn.core"
                                   else root.name)
            assert parent.start_ns <= r.start_ns <= r.end_ns <= parent.end_ns
            assert r.stream_ms == r.host_ms > 0

    events = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.name().startswith(metrics.SPAN_PREFIX):
            events.setdefault(ev.name(), []).append(ev.start_ns())
    for name, starts in events.items():
        mine = [r.start_ns for r in recs
                if metrics.SPAN_PREFIX + r.name == name]
        assert len(mine) == len(starts)
        for ours, theirs in zip(sorted(mine), sorted(starts)):
            assert abs(ours - theirs) < 1_000_000, (name, ours - theirs)
    assert sum(map(len, events.values())) == len(recs)


def test_each_session_reads_only_its_own_records(runner, toks):
    metrics.SPANS.clear()
    _profiled(runner, toks)
    first = {r.id for r in metrics.SPANS.records}
    assert len(first) == 2 + 3 * LAYERS
    _halves(runner, toks)
    assert {r.id for r in metrics.SPANS.records} == first
    _profiled(runner, toks)
    second = {r.id for r in metrics.SPANS.records}
    assert len(second) == len(first) and not second & first


@pytest.mark.parametrize("dtype, device, want", [
    (torch.bfloat16, "cuda", True), (torch.float32, "cuda", False),
    (torch.float16, "cuda", False), (torch.bfloat16, "cpu", False),
    (torch.float32, "cpu", False)])
def test_flash_core_follows_dtype_and_device(dtype, device, want):
    x = types.SimpleNamespace(dtype=dtype, device=torch.device(device))
    assert split_exec.flash_core(x) is want


@pytest.fixture(scope="module")
def runner_bf16(runner):
    cfg = dataclasses.replace(runner.bank.base_cfg, dtype="bfloat16")
    return SplitModelBank(cfg, 16, device="cpu", seed=0).runner(SPLIT)


def _count_flash(monkeypatch, on_card: bool):
    """A counting stand-in for the flash kernel that forwards to the plain
    result; with ``on_card`` the bank's device check sees a CUDA device."""
    calls = []
    plain = kops.flash_attention

    def flash(q, k, v, **kw):
        calls.append(q.shape)
        return plain(q, k, v, **kw)

    monkeypatch.setattr(kops, "flash_attention", flash)
    if on_card:
        real = split_exec.flash_core
        monkeypatch.setattr(split_exec, "flash_core", lambda x: real(
            types.SimpleNamespace(dtype=x.dtype, device=torch.device("cuda"))))
    return calls


def _core_flash_counts():
    return [r.counts for r in metrics.SPANS.records
            if r.name == "mixer.attn.core"]


@pytest.mark.parametrize("dtype, on_card, takes", [
    ("bfloat16", True, True), ("float32", True, False),
    ("bfloat16", False, False)])
def test_prefill_halves_take_the_flash_kernel_where_it_fits(
        runner, runner_bf16, toks, monkeypatch, dtype, on_card, takes):
    r = runner_bf16 if dtype == "bfloat16" else runner
    calls = _count_flash(monkeypatch, on_card)
    off = _halves(r, toks)
    assert len(calls) == (LAYERS if takes else 0)
    assert all(shape == (1, 16, 4, 64) for shape in calls)
    on, _ = _profiled(r, toks)
    assert torch.equal(on, off)
    assert _core_flash_counts() == [{"flash": int(takes)}] * LAYERS
    r._engine_prefill(r.params, toks)
    assert len(calls) == (3 * LAYERS if takes else 0)
    r.reference_prefill(toks)
    assert len(calls) == (3 * LAYERS if takes else 0)
