"""The port's butterfly wrappers against the JAX package's Pallas kernels
(interpret mode on the CPU) and pure-jnp oracles, on the same numpy inputs.

On a CPU tensor the port's wrappers run the plain PyTorch versions: f32
codes must equal JAX's exactly, bf16 codes may differ by 1 (the two f32
products sum in different orders), scales and restores agree within rtol
1e-5.  The kernel-vs-plain cases need the card: they live in
``test_torch_cuda.py``, which imports no JAX so that it runs on the card's
machine."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import butterfly as jbf
from repro.kernels import ops as jops, ref as jref
from repro_torch.core import butterfly as tbf
from repro_torch.kernels import butterfly_kernel, ops

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a: np.ndarray, dtype: str):
    jd, td = DTYPES[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def _rq_inputs(T, d, d_r, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, d)).astype(np.float32)
    w = (rng.standard_normal((d, d_r)) * 0.05).astype(np.float32)
    return _pair(x, dtype), _pair(w, dtype)


@pytest.mark.parametrize("T,d,d_r", [(32, 128, 8), (64, 256, 32), (100, 128, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reduce_quant_matches_jax(T, d, d_r, dtype):
    (xj, xt), (wj, wt) = _rq_inputs(T, d, d_r, dtype)
    codes, scales = ops.butterfly_reduce_quant(xt, wt)
    assert codes.dtype == torch.int8 and scales.dtype == torch.float32
    for cj, sj in (jops.butterfly_reduce_quant(xj, wj, block_t=32),
                   jref.butterfly_reduce_quant_ref(xj, wj)):
        diff = np.abs(codes.numpy().astype(np.int32) - np.asarray(cj, np.int32))
        assert diff.max() <= (0 if dtype == "float32" else 1)
        np.testing.assert_allclose(scales.numpy(), np.asarray(sj),
                                   rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("T,d,d_r", [(32, 128, 8), (48, 256, 16)])
def test_dequant_restore_matches_jax(T, d, d_r):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((T, d)).astype(np.float32)
    w = (rng.standard_normal((d, d_r)) * 0.05).astype(np.float32)
    wr = (rng.standard_normal((d_r, d)) * 0.05).astype(np.float32)
    codes, scales = jref.butterfly_reduce_quant_ref(jnp.asarray(x), jnp.asarray(w))
    out = ops.butterfly_dequant_restore(
        torch.tensor(np.asarray(codes)), torch.tensor(np.asarray(scales)),
        torch.from_numpy(wr))
    for want in (jops.butterfly_dequant_restore(codes, scales, jnp.asarray(wr),
                                                block_t=16),
                 jref.butterfly_dequant_restore_ref(codes, scales, jnp.asarray(wr))):
        np.testing.assert_allclose(out.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


def test_wrappers_keep_leading_axes():
    """(B, S, d) in, (B, S, d_r) codes and (B, S, 1) scales out, like the JAX
    wrappers; a round trip through both wrappers keeps the shape."""
    (_, xt), (_, wt) = _rq_inputs(6, 64, 8, "float32", seed=2)
    x3 = xt.reshape(2, 3, 64)
    codes, scales = ops.butterfly_reduce_quant(x3, wt)
    assert codes.shape == (2, 3, 8) and scales.shape == (2, 3, 1)
    out = ops.butterfly_dequant_restore(codes, scales, wt.t().contiguous())
    assert out.shape == (2, 3, 64)


def test_roundtrip_error_bound():
    """|x - deq(quant(x))| <= scale/2 per element (symmetric rounding)."""
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (64, 128)).astype(np.float32))
    codes, scales = ops.butterfly_reduce_quant(x, torch.eye(128))
    back = codes.float() * scales
    assert float((back - x).abs().max()) <= float(scales.max()) * 0.5 + 1e-6


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("bits", [8, 4])
def test_butterfly_unit_matches_jax(use_kernel, bits):
    """reduce_unit / restore_unit / apply_butterfly (inference form) with
    the JAX package's weights, both the unfused and the fused wire."""
    from repro.configs.base import ButterflyConfig
    d = 64
    params, _ = jbf.init_butterfly(jax.random.key(3), d,
                                   ButterflyConfig(layer=1, d_r=16), jnp.float32)
    tparams = {k: torch.tensor(np.asarray(v)) for k, v in params.items()}
    x = np.random.default_rng(4).standard_normal((2, 5, d)).astype(np.float32)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    cj, sj = jbf.reduce_unit(params, xj, use_kernel=use_kernel, wire_bits=bits)
    ct, st = tbf.reduce_unit(tparams, xt, use_kernel=use_kernel, wire_bits=bits)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-6)
    rj = jbf.restore_unit(params, cj, sj, jnp.float32, use_kernel=use_kernel)
    rt = tbf.restore_unit(tparams, ct, st, torch.float32, use_kernel=use_kernel)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=1e-5, atol=1e-6)
    yj = jbf.apply_butterfly(params, xj, wire_bits=bits, train=False,
                             use_kernel=use_kernel)
    yt = tbf.apply_butterfly(tparams, xt, wire_bits=bits, use_kernel=use_kernel)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5, atol=1e-6)


def test_cpu_tensor_takes_the_plain_version():
    """A CPU tensor never reaches the kernel: the launch counters stay put,
    and the launch wrappers themselves refuse CPU tensors."""
    before = (butterfly_kernel.reduce_quant.launches,
              butterfly_kernel.dequant_restore.launches)
    (_, xt), (_, wt) = _rq_inputs(40, 128, 16, "bfloat16")
    codes, scales = ops.butterfly_reduce_quant(xt, wt)
    ops.butterfly_dequant_restore(codes, scales, wt.t().contiguous(),
                                  out_dtype=torch.bfloat16)
    assert (butterfly_kernel.reduce_quant.launches,
            butterfly_kernel.dequant_restore.launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        butterfly_kernel.reduce_quant(xt, wt)
    with pytest.raises(ValueError, match="CUDA"):
        butterfly_kernel.dequant_restore(codes, scales, wt.t().contiguous())


@pytest.mark.parametrize("use_kernel", [False, True])
def test_fused_codec_refuses_wider_than_int8(use_kernel):
    """The fused codec emits int8 codes: a wider wire raises, on every
    device, rather than taking an unfused path.  The unfused ops still
    quantize it (int16 codes)."""
    (_, xt), (_, wt) = _rq_inputs(8, 64, 16, "float32")
    params = {"w_reduce": wt, "w_restore": wt.t().contiguous()}
    if use_kernel:
        with pytest.raises(ValueError, match="int8"):
            tbf.apply_butterfly(params, xt, wire_bits=16, use_kernel=True)
    else:
        codes, _ = tbf.reduce_unit(params, xt, wire_bits=16)
        assert codes.dtype == torch.int16
