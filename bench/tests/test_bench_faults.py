"""The check fails what it must, at a tiny size on the CPU: a whole run
with the timed path broken underneath (a served token altered where it
is produced, the crossing between the halves left out, half of a batch
left out, one batch slot's row wrong) comes out not correct, and so does the control, the plain
reference computed in float8 put in the program's place."""
import time

import pytest
import torch

from bench.harness import BENCH, load, run_cell
from bench.tests import tiny

SEED = 2**33 + 21
# one cycle of the long mix; a few calls of the batched one
SECONDS = {"prefill-long": 0.01, "prefill-batch-conv": 0.1}


def _result(mix, plant):
    return run_cell(tiny.cell(mix), SEED, SECONDS[mix], False, "cpu",
                    time.perf_counter(), plant=plant)


def alter_token(system):
    vocab = system.bank.base_cfg.vocab_size
    system.first_tokens = lambda logits: (logits.argmax(-1) + 1) % vocab


def drop_crossing(system):
    cross = system.cross

    def dropped(payload, scales):
        payload, scales, nbytes = cross(payload, scales)
        return torch.zeros_like(payload), scales, nbytes
    system.cross = dropped


def drop_half_batch(system):
    cloud = system.runner.cloud_half

    def half(params, payload, scales):
        n = payload.shape[0] // 2
        logits, cache = cloud(params, payload[:n], scales[:n])
        return torch.cat([logits, logits]), cache
    system.runner.cloud_half = half


def wrong_last_row(system):
    """A fault in one batch slot: the last row's logits are another row's."""
    cloud = system.runner.cloud_half

    def shifted(params, payload, scales):
        logits, cache = cloud(params, payload, scales)
        logits = logits.clone()
        logits[-1] = logits[0]
        return logits, cache
    system.runner.cloud_half = shifted


def fp8_control(system):
    """The control in the program's place: the reference's float8 logits
    on the weights the program was handed."""
    ref = load(BENCH / "references" / "qwen3.py")
    cfg = tiny.config()
    params, butterfly = system.params, system.params["butterfly"]

    def serve(tokens):
        logits = ref.last_logits(params, butterfly, cfg, tokens, mm=ref.fp8_mm)
        return logits, logits.argmax(-1), {"edge_s": 0.0, "cloud_s": 0.0,
                                           "wire_bytes": 0}
    system.serve = serve


@pytest.mark.parametrize("mix,plant", [
    ("prefill-long", alter_token), ("prefill-batch-conv", alter_token),
    ("prefill-long", drop_crossing), ("prefill-batch-conv", drop_crossing),
    ("prefill-batch-conv", drop_half_batch),
    ("prefill-batch-conv", wrong_last_row),
    ("prefill-long", fp8_control), ("prefill-batch-conv", fp8_control)])
def test_a_broken_run_is_not_correct(mix, plant):
    result = _result(mix, plant)
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["check"].values())


@pytest.mark.parametrize("mix", ["prefill-long", "prefill-batch-conv"])
def test_the_same_run_unbroken_is_correct(mix):
    assert _result(mix, None)["correct"] is True
