"""The port's two-pod decode pipeline against JAX's on a two-host-device
mesh: reduced qwen3-moe (its MoE layers on the local path, as JAX's manual
path runs them at model-axis degree 1), zamba2 and xLSTM (moved from
``test_torch_pipeline.py``; the subprocess code is
``test_torch_pipeline_jax.PARITY_CODE``).
"""
import pytest

from test_torch_pipeline_jax import _parity


@pytest.mark.subprocess
def test_moe_pipeline_matches_jax_two_pods():
    """The same on reduced qwen3-moe (3 layers, 4 experts top-2, default
    capacity, butterfly after layer 1): each microbatch's prefill and
    decode ticks route as JAX's manual path routes them at model-axis
    degree 1, so greedy ids are identical, pipelined and serial, with and
    without ``use_kernel`` (the int8 wire; int4 changes nothing past the
    wire, which the qwen3 and gemma3 cases hold)."""
    _parity("make_decode_pipeline", "qwen3-moe-235b-a22b")


@pytest.mark.subprocess
@pytest.mark.parametrize("arch", ["zamba2-7b", "xlstm-125m"])
def test_recurrent_pipeline_matches_jax_two_pods(arch):
    """The same on reduced zamba2 (4 layers, [mamba, shared attn] twice,
    the shared block on both pods) and xLSTM (4 layers, [mLSTM, sLSTM]
    twice), butterfly after layer 1 (inside a unit): greedy ids identical to
    JAX's, pipelined with ``use_kernel`` at int8 and serial without it at
    int4; and after the drain every microbatch's edge and cloud caches
    (the SSM, conv, C, n and sLSTM states, and zamba2's shared-layer KV)
    within rtol/atol 1e-5 of JAX's: the port skips JAX's warm-up tick,
    whose gated write leaves them untouched."""
    _parity("make_decode_pipeline", arch)
