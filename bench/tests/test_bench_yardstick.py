"""The yardstick's arithmetic against shapes worked by hand: FLOPs of a
prefill, bytes of the two wire kernels, the trace's busy union and idle
gaps, the traffic generator and the check's sample."""
import math

import pytest
import torch

from bench import check, flops
from bench.generator import Traffic
from bench import harness
from bench.harness import BENCH, _json, load
from bench.peaks import H100
from bench.trace import reduce, union

QWEN = _json(BENCH / "configs" / "qwen3-8b.json")


def test_prefill_flops_of_qwen3_8b_by_hand():
    S = 256
    proj = 2 * S * 4096 * 128 * (2 * 32 + 2 * 8)       # 21.47 GFLOP
    attn = 2 * 32 * 128 * S * (S + 1)                  # causal, counted once
    mlp = 6 * S * 4096 * 12288
    want = 36 * (proj + attn + mlp) + 4 * S * 4096 * 64 + 2 * 4096 * 151936
    assert flops.dense_prefill_flops(QWEN, S) == want
    # about 13.97 GFLOP a token at 256 tokens
    assert want / S == pytest.approx(13.97e9, rel=2e-3)


def test_wire_kernel_costs_by_hand():
    f, b = flops.reduce_quant_cost(4096, 4096, 64)
    assert f == 2 * 4096 * 4096 * 64
    assert b == 4096 * 4096 * 2 + 4096 * 64 * 2 + 4096 * 64 + 4096 * 4
    f, b = flops.dequant_restore_cost(4096, 4096, 64)
    assert f == 2 * 4096 * 64 * 4096
    assert b == 4096 * 64 + 4096 * 4 + 64 * 4096 * 2 + 4096 * 4096 * 2
    # memory-bound: 34.4 MB at 3.35 TB/s against 2.1 GFLOP at 989 TFLOP/s
    assert flops.least_seconds((f, b), H100) == pytest.approx(b / 3.35e12)
    assert flops.least_seconds((1e15, 1.0), H100) == pytest.approx(1e15 / 989e12)
    assert flops.widths(QWEN) == (2, 1)


def test_union_and_idle_gaps_named_by_the_host():
    dev = [("k1", 0.0, 1.0), ("k2", 0.5, 2.0), ("k3", 4.0, 5.0)]
    assert union(dev) == [(0.0, 2.0), (4.0, 5.0)]
    host = [("bench.edge_half", 0.0, 3.0), ("aten::mm", 1.5, 2.5),
            ("bench.cloud_half", 3.0, 6.0), ("cudaDeviceSynchronize", 5.0, 6.0)]
    t = reduce(dev, host, window_s=6.0)
    assert t.busy_s == pytest.approx(3.0)
    # a gap is named by what ran on the host when it began: 2.0-4.0 began
    # inside aten::mm, 5.0-6.0 (the spans' end) inside the synchronize
    assert t.idle_seconds == pytest.approx({
        "bench.edge_half aten::mm": 2.0,
        "bench.cloud_half cudaDeviceSynchronize": 1.0})
    assert t.breakdown()["device_ops"][0] == ["k2", 1.5]


def test_traffic_offers_every_seed_the_same_work():
    mix = _json(BENCH / "traffic" / "prefill-long.json")
    n = len(mix["lengths"])
    a, b = Traffic(mix, 1000, 2**33 + 1), Traffic(mix, 1000, 5)
    for cycle in range(3):
        la = [a.length(cycle * n + i) for i in range(n)]
        lb = [b.length(cycle * n + i) for i in range(n)]
        assert sorted(la) == sorted(lb) == sorted(mix["lengths"])
    assert [a.length(i) for i in range(n)] != [b.length(i) for i in range(n)]
    assert torch.equal(a.call(3), Traffic(mix, 1000, 2**33 + 1).call(3))
    assert a.call(3).shape == (1, a.length(3))
    assert int(a.call(3).max()) < 1000
    assert [w.shape[1] for w in a.warmup()] == mix["warmup_lengths"]


def test_sample_holds_the_longest_and_is_drawn_from_the_seed():
    rows = [check.Row(i, 0, torch.zeros(n, dtype=torch.long), 0, torch.zeros(4))
            for i, n in enumerate([5, 9, 3, 9, 7, 4, 6])]
    s = check.sample(rows, 11, 4)
    assert len(s) == 4 and s[0].call == 1
    assert [r.call for r in s] == [r.call for r in check.sample(rows, 11, 4)]
    assert len({r.call for r in s}) == 4


def test_sample_covers_every_batch_slot():
    rows = [check.Row(c, r, torch.zeros(6, dtype=torch.long), 0, torch.zeros(4))
            for c in range(20) for r in (c % 8, (c + 3) % 8)]
    for seed in (1, 2**33 + 5, 77):
        s = check.sample(rows, seed, 8)
        assert sorted(r.row for r in s) == list(range(8))
        s = check.sample(rows, seed, 16)
        assert sorted(r.row for r in s) == sorted(2 * list(range(8)))


def test_kept_rows_cover_every_slot_each_batch_of_calls():
    for seed in (3, 2**33 + 9):
        kept = [harness.kept_rows(seed, i, 8, 2) for i in range(8)]
        assert all(len(k) == 2 == len(set(k)) for k in kept)
        assert {k_i for k in kept for k_i in k} == set(range(8))
    assert harness.kept_rows(5, 3, 1, 1) == [0]


def test_numbers_and_judge():
    ref = [torch.tensor([0.0, 1.0, 3.0, 2.0])]
    row = check.Row(0, 0, torch.zeros(3, dtype=torch.long), 3,
                    torch.tensor([0.0, 1.0, 3.0, 2.5]))
    found = check.numbers([row], ref)
    assert found["logit_rel_err"] == pytest.approx(0.5 / math.sqrt(14))
    assert found["token_gap"] == pytest.approx(1.0 / float(ref[0].std()))
    ok, table = check.judge(found, {"logit_rel_err": {"limit": 0.2},
                                    "token_gap": {"limit": 0.5}})
    assert not ok and table["token_gap"]["limit"] == 0.5
    ok, _ = check.judge({"logit_rel_err": float("nan"), "token_gap": 0.0},
                        {"logit_rel_err": {"limit": 1.0}, "token_gap": {"limit": 1.0}})
    assert not ok


def test_reference_rope_and_wire_by_hand():
    ref = load(BENCH / "references" / "qwen3.py")
    x = torch.zeros(1, 2, 1, 4)
    x[0, :, 0, 0] = 1.0                                  # the pair (x0, x2)
    out = ref.rope(x, theta=10000.0)
    assert out[0, 0, 0].tolist() == [1.0, 0.0, 0.0, 0.0]
    assert out[0, 1, 0, 0] == pytest.approx(math.cos(1.0))
    assert out[0, 1, 0, 2] == pytest.approx(math.sin(1.0))
    bf = {"w_reduce": torch.eye(4)[:, :2], "w_restore": torch.eye(4)[:2]}
    x = torch.tensor([[[254.0, -127.4, 9.0, 9.0]]])
    got = ref.wire(x, bf, ref.f32_mm)                    # scale 2, codes 127, -64
    assert got.tolist() == [[[254.0, -128.0, 0.0, 0.0]]]
