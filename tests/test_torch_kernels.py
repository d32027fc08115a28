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
from repro.kernels import butterfly_kernel as jbk, ops as jops, ref as jref
from repro_torch.core import butterfly as tbf
from repro_torch.kernels import butterfly_kernel, ops, ref

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


@pytest.mark.parametrize("d_r", [16, 60, 64])
def test_tensor_core_order_matches_jax_kernel(d_r):
    """The bf16 restore kernel's order of operations (codes exact in bf16,
    f32 sums of the exact products, the row's scale once after them, one
    rounding to bf16; ``ref.butterfly_dequant_restore_tc_ref``) against the
    JAX Pallas kernel in interpret mode, which scales the codes first:
    within one bf16 ulp (rtol 2**-7, atol 1e-3), the card tests' bound."""
    T, d = 48, 96
    rng = np.random.default_rng(d_r)
    codes = rng.integers(-128, 128, (T, d_r)).astype(np.int8)
    scales = rng.uniform(0.01, 0.1, (T, 1)).astype(np.float32)
    wr = (rng.standard_normal((d_r, d)) / np.sqrt(d_r)).astype(np.float32)
    wj, wt = _pair(wr, "bfloat16")
    want = jbk.butterfly_dequant_restore_kernel(
        jnp.asarray(codes), jnp.asarray(scales), wj, out_dtype=jnp.bfloat16,
        block_t=16, interpret=True)
    got = ref.butterfly_dequant_restore_tc_ref(
        torch.from_numpy(codes), torch.from_numpy(scales), wt, torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == (T, d)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2 ** -7, atol=1e-3)


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
@pytest.mark.parametrize("bits", [8, 4, 16])
def test_butterfly_unit_matches_jax(use_kernel, bits):
    """reduce_unit / restore_unit / apply_butterfly (inference form) with
    the JAX package's weights, both the unfused and the fused wire.  At 16
    bits JAX's fused codec refuses (its Pallas kernel emits int8 codes) and
    its wire runs unfused, so the port's fused int16 wire is held to JAX's
    unfused one: the f32 products sum in different orders, and at 15 bits a
    step is 1/32,767 of the row's absmax, so a code may differ by 1 and
    the dequantized values by one scale step."""
    from repro.configs.base import ButterflyConfig
    d = 64
    params, _ = jbf.init_butterfly(jax.random.key(3), d,
                                   ButterflyConfig(layer=1, d_r=16), jnp.float32)
    tparams = {k: torch.tensor(np.asarray(v)) for k, v in params.items()}
    x = np.random.default_rng(4).standard_normal((2, 5, d)).astype(np.float32)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    jkernel = use_kernel and bits <= 8
    cj, sj = jbf.reduce_unit(params, xj, use_kernel=jkernel, wire_bits=bits)
    ct, st = tbf.reduce_unit(tparams, xt, use_kernel=use_kernel, wire_bits=bits)
    assert ct.dtype == (torch.int16 if bits == 16 else torch.int8)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-6)
    step = np.asarray(sj)
    if bits == 16:
        assert np.abs(ct.numpy().astype(np.int32) - np.asarray(cj, np.int32)).max() <= 1
        deq = ct.numpy() * st.numpy() - np.asarray(cj) * np.asarray(sj)
        assert (np.abs(deq) <= step * (1 + 1e-6)).all()
    else:
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    rj = jbf.restore_unit(params, cj, sj, jnp.float32, use_kernel=jkernel)
    rt = tbf.restore_unit(tparams, torch.tensor(np.asarray(cj)),
                          torch.tensor(np.asarray(sj)), torch.float32,
                          use_kernel=use_kernel)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=1e-5, atol=1e-6)
    yj = jbf.apply_butterfly(params, xj, wire_bits=bits, train=False,
                             use_kernel=use_kernel)
    yt = tbf.apply_butterfly(tparams, xt, wire_bits=bits, use_kernel=use_kernel)
    # a code one step apart moves an output by its scale times |w_restore|
    slack = float(step.max()) * float(np.abs(np.asarray(params["w_restore"])).sum(0).max()) \
        if bits == 16 else 0.0
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5,
                               atol=1e-6 + slack)


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
    """The name is from when the fused codec stopped at int8.  It emits
    int8 codes at 1-8 bits and int16 codes at 16 (the 16-bit wire) and
    raises at any width between, on every device, rather than take an
    unfused path.  The unfused ops quantize the 16-bit wire too (int16
    codes)."""
    (_, xt), (_, wt) = _rq_inputs(8, 64, 16, "float32")
    params = {"w_reduce": wt, "w_restore": wt.t().contiguous()}
    if use_kernel:
        codes, scales = tbf.reduce_unit(params, xt, use_kernel=True,
                                        wire_bits=16)
        assert codes.dtype == torch.int16
        assert int(codes.abs().max()) == 32767
        y = tbf.apply_butterfly(params, xt, wire_bits=16, use_kernel=True)
        assert y.shape == xt.shape and torch.isfinite(y).all()
        for bits in range(9, 16):
            with pytest.raises(ValueError, match="int16 codes at 16 bits"):
                tbf.apply_butterfly(params, xt, wire_bits=bits, use_kernel=True)
    else:
        codes, _ = tbf.reduce_unit(params, xt, wire_bits=16)
        assert codes.dtype == torch.int16
