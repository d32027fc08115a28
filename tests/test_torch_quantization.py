"""The port's wire quantization against the JAX package's, on the same
numpy inputs: quantize/dequantize, the int4 nibble packing (bit for bit)
and the wire byte count."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantization as jq
from repro_torch.core import quantization as tq


@pytest.mark.parametrize("bits", [4, 8, 16])
def test_quantize_dequantize_match_jax(bits):
    rng = np.random.default_rng(bits)
    x = (rng.standard_normal((3, 7, 16)) * rng.uniform(0.01, 10, (3, 7, 1))
         ).astype(np.float32)
    x[0, 0] = 0.0                                    # an all-zero row
    cj, sj = jq.quantize(jnp.asarray(x), bits)
    ct, st = tq.quantize(torch.from_numpy(x), bits)
    assert ct.dtype == (torch.int8 if bits <= 8 else torch.int16)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(
        tq.dequantize(ct, st).numpy(), np.asarray(jq.dequantize(cj, sj)))


def test_quantize_rounds_half_to_even():
    """Ties go to the even code, as jnp.round does: with absmax 127 the
    scale is exactly 1, so x.5 inputs are exact ties."""
    x = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5]], np.float32)
    ct, _ = tq.quantize(torch.from_numpy(x), 8)
    assert ct.tolist() == [[127, 0, 2, 2, 0, -2, -2, 4]]
    cj, _ = jq.quantize(jnp.asarray(x), 8)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))


def test_int4_pack_unpack_bit_for_bit():
    codes = np.random.default_rng(0).integers(-8, 8, (4, 5, 16)).astype(np.int8)
    codes[0, 0, :16] = np.arange(-8, 8)                 # every nibble value
    pj = np.asarray(jq.pack_int4(jnp.asarray(codes)))
    pt = tq.pack_int4(torch.from_numpy(codes))
    assert pt.dtype == torch.int8 and pt.shape == (4, 5, 8)
    np.testing.assert_array_equal(pt.numpy(), pj)
    np.testing.assert_array_equal(tq.unpack_int4(pt).numpy(), codes)
    np.testing.assert_array_equal(
        tq.unpack_int4(torch.from_numpy(pj)).numpy(),
        np.asarray(jq.unpack_int4(jnp.asarray(pj))))


@pytest.mark.parametrize("shape,bits", [((1, 16, 64), 8), ((2, 33, 16), 4),
                                        ((5, 7), 16), ((3, 1, 15), 4)])
def test_wire_bytes_match_jax(shape, bits):
    assert tq.wire_bytes(shape, bits) == jq.wire_bytes(shape, bits)
