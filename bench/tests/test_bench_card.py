"""The harness on the card at the tiny size: a traced run reports every
per-layer metric and stays correct (skips without a card)."""
import time

import pytest
import torch

from bench.harness import run_cell
from bench.tests import tiny


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.cuda.get_device_name(0)


@pytest.mark.cuda
@pytest.mark.parametrize("mix", ["prefill-long", "prefill-batch-conv"])
def test_traced_run_on_the_card(card, mix):
    cell = tiny.cell(mix)
    result = run_cell(cell, 2**33 + 3, 0.5, True, "cuda", time.perf_counter(),
                      kind=card)
    assert result["correct"] is True
    assert set(result["metrics"]) == {m["name"] for m in cell.per_layer}
    dev = result["device"]
    assert 0 < dev["busy_s"] <= dev["window_s"]
    assert 0 < result["metrics"]["reduce_quant_roofline"]["value"] <= 105
    assert 0 < result["metrics"]["dequant_restore_roofline"]["value"] <= 105
