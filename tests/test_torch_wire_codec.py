"""The port's entropy wire against the JAX package's.

``repro_torch/core/wire_codec`` against ``repro/core/wire_codec`` on the
same numpy codes: the rANS payload bytes are identical and both decoders
round-trip them exactly (bits 8 and 4; a prior fit on the data, one fit on
other data, the deployment default), and the prior tables, the size
estimate and prediction, the bitplane split and the histogram agree
exactly.  The port's ``ops.butterfly_reduce_quant_bincount`` on the CPU
(its plain version) against JAX's, which runs the Pallas kernel in
interpret mode, on ``tests/test_kernels.py``'s shapes: codes and counts
identical, scales within 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import wire_codec as jwc
from repro.kernels import ops as jops
from repro_torch.core import wire_codec as twc
from repro_torch.kernels import ops as tops


def _codes(shape, bits, seed, spread=3.0):
    """Roughly Gaussian signed codes, the shape butterfly rows produce."""
    rng = np.random.default_rng(seed)
    qmax = 2 ** (bits - 1) - 1
    c = np.round(rng.normal(0.0, qmax / spread, size=shape))
    return np.clip(c, -qmax - 1, qmax).astype(np.int8)


def _priors(wc, codes, bits, kind):
    d_r = codes.shape[-1]
    if kind == "matched":
        return wc.WirePrior.from_counts(wc.channel_counts(codes, bits), bits)
    if kind == "mismatched":
        other = _codes(codes.shape, bits, seed=99, spread=20.0)
        return wc.WirePrior.from_counts(wc.channel_counts(other, bits), bits)
    return wc.WirePrior.default(d_r, bits)


@pytest.mark.parametrize("prior", ["matched", "mismatched", "default"])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("T,d_r", [(1, 16), (37, 8), (256, 32)])
def test_encode_bytes_identical_and_both_decode(T, d_r, bits, prior):
    codes = _codes((T, d_r), bits, seed=T * 100 + d_r, spread=1.5)
    jp, tp = _priors(jwc, codes, bits, prior), _priors(twc, codes, bits, prior)
    data = twc.encode(codes, tp)
    assert data == jwc.encode(codes, jp)
    assert np.array_equal(twc.decode(data, tp, codes.shape), codes)
    assert np.array_equal(jwc.decode(data, jp, codes.shape), codes)
    assert twc.coded_nbytes(codes, tp) == jwc.coded_nbytes(codes, jp)


@pytest.mark.parametrize("bits", [8, 4])
def test_priors_estimates_and_schedule_equal(bits):
    codes = _codes((128, 16), bits, seed=5)
    counts = twc.channel_counts(codes, bits)
    assert np.array_equal(counts, jwc.channel_counts(codes, bits))
    probs = np.random.default_rng(1).random((16, 1 << bits))
    pairs = [(twc.WirePrior.from_probs(probs, bits),
              jwc.WirePrior.from_probs(probs, bits)),
             (twc.WirePrior.from_counts(counts, bits),
              jwc.WirePrior.from_counts(counts, bits)),
             (twc.WirePrior.default(16, bits), jwc.WirePrior.default(16, bits))]
    for tp, jp in pairs:
        assert tp.bits == jp.bits
        assert np.array_equal(tp.freqs, jp.freqs)
        assert np.array_equal(tp.cumex, jp.cumex)
        assert twc.estimate_coded_bytes(counts, tp) == \
            jwc.estimate_coded_bytes(counts, jp)
        assert twc.expected_bits_per_symbol(counts, tp) == \
            jwc.expected_bits_per_symbol(counts, jp)
    assert np.array_equal(twc.quantize_freqs(probs), jwc.quantize_freqs(probs))
    assert np.array_equal(twc.coarse_codes(codes, bits=bits),
                          jwc.coarse_codes(codes, bits=bits))
    for n in (0, 1, 17, 4096, 123457):
        assert twc.predicted_code_bytes(n) == jwc.predicted_code_bytes(n)
        assert twc.split_coarse_refine(n, 4 * 32) == \
            jwc.split_coarse_refine(n, 4 * 32)
    assert twc.payload_overhead_bytes(64) == jwc.payload_overhead_bytes(64)


@pytest.mark.parametrize("T,d,d_r", [(32, 128, 8),     # kernel grid path
                                     (100, 128, 16),   # padded grid (count fix)
                                     (4, 128, 16)])    # decode-row fast path
@pytest.mark.parametrize("bits", [8, 4])
def test_bincount_entry_point_matches_jax(T, d, d_r, bits):
    k1, k2 = jax.random.split(jax.random.key(9))
    x = np.array(jax.random.normal(k1, (T, d), jnp.float32))
    w = np.array(jax.random.normal(k2, (d, d_r), jnp.float32) * 0.05)
    jc, js, jn = (np.asarray(a) for a in jops.butterfly_reduce_quant_bincount(
        jnp.asarray(x), jnp.asarray(w), bits=bits, block_t=32))
    tc, ts, tn = tops.butterfly_reduce_quant_bincount(
        torch.from_numpy(x), torch.from_numpy(w), bits=bits)
    assert tc.dtype == torch.int8 and tn.dtype == torch.int32
    assert np.array_equal(tc.numpy(), jc)
    assert np.array_equal(tn.numpy(), jn)
    np.testing.assert_allclose(ts.numpy(), js, rtol=1e-6, atol=0)
    assert int(tn.sum()) == T * d_r
    assert np.array_equal(tn.numpy(), twc.channel_counts(tc.numpy(), bits))


def test_bincount_entry_point_keeps_leading_dims_and_refuses_wide_codes():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 5, 64)).astype(np.float32))
    w = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (64, 16)).astype(np.float32) * 0.1)
    codes, scales, counts = tops.butterfly_reduce_quant_bincount(x, w)
    assert codes.shape == (2, 5, 16) and scales.shape == (2, 5, 1)
    assert counts.shape == (16, 256)
    c2, s2 = tops.butterfly_reduce_quant(x, w)
    assert torch.equal(codes, c2) and torch.equal(scales, s2)
    with pytest.raises(ValueError):
        tops.butterfly_reduce_quant_bincount(x, w, bits=16)


def test_int16_codes_refused_as_jax_refuses_them():
    """The entropy wire over the 16-bit wire's int16 codes: the JAX
    package's coder refuses them, with an 8-bit prior (codes out of its
    alphabet) and with a 16-bit one (65,536 symbols exceed its probability
    scale), and the port's refuses them the same way."""
    rng = np.random.default_rng(3)
    codes = np.clip(np.round(rng.normal(0, 3000, (6, 16))), -32768,
                    32767).astype(np.int16)
    for bits in (8, 16):
        errors = []
        for wc in (jwc, twc):
            with pytest.raises(ValueError) as err:
                wc.coded_nbytes(codes, wc.WirePrior.default(16, bits))
            errors.append(str(err.value))
        assert errors[0] == errors[1]
