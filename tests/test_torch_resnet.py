"""The port's ResNet-50 split inference (``repro_torch/models/resnet.py``)
against the JAX package's, in f32 on the CPU, with the JAX params carried
across by ``bridge.resnet_to_torch`` (HWIO conv kernels -> OIHW):

  * ``conv`` (k 1, 3, 7; strides 1, 2) and ``max_pool`` on spatial sizes
    7, 8, 32 and 33, whose odd and even sizes give XLA's asymmetric
    ``"SAME"`` padding at stride 2, within 1e-5;
  * ``group_norm`` at C 16, 48 (32 groups step down to 24) and 64, within
    1e-5;
  * ``fake_quant``'s forward bit for bit, and its refusal of a tensor that
    requires grad (no straight-through backward yet);
  * ``forward_resnet`` (the in-graph wire) within 1e-4, and
    ``edge_cloud_split``: codes equal (at most 1 apart on at most 0.1% of
    entries, rounded up to a whole entry: the f32 convs sum in another
    order), scales within rtol 1e-5 and an atol of 1e-5 of the largest
    scale (at d_r = 1 a scale is one pixel's |r| / 127, so a pixel whose
    r is small carries the conv's absolute rounding as a larger relative
    one), logits within 1e-4 (the JAX test's
    tolerance, ``tests/test_engine_and_resnet.py``), on the reduced config
    and on the full-width ``resnet50()`` at 64x64, split after RB3 and
    RB16 with the paper's least d_r.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.resnet50 import resnet50 as jresnet50
from repro.core import quantization as JQ
from repro.models import resnet as JR
from repro_torch import bridge
from repro_torch.configs.resnet50 import PAPER_MIN_DR, resnet50
from repro_torch.core import butterfly as TB, quantization as TQ
from repro_torch.models import resnet as TR
from repro_torch.tree import tree_leaves, tree_map

SIZES = (7, 8, 32, 33)


def _rng(seed):
    return np.random.default_rng(seed)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("stride", (1, 2))
@pytest.mark.parametrize("k", (1, 3, 7))
def test_conv_same_padding_matches_jax(k, stride, size):
    rng = _rng(100 * k + 10 * stride + size)
    x = rng.standard_normal((2, size, size, 5)).astype(np.float32)
    w = rng.standard_normal((k, k, 5, 6)).astype(np.float32) / k
    want = np.asarray(JR.conv(jnp.asarray(x), jnp.asarray(w), stride))
    got = TR.conv(_t(x), _t(w.transpose(3, 2, 0, 1)), stride)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("stride", (1, 2))
def test_max_pool_matches_jax(stride, size):
    x = _rng(size).standard_normal((2, size, size, 4)).astype(np.float32)
    want = np.asarray(JR.max_pool(jnp.asarray(x), 3, stride))
    got = TR.max_pool(_t(x), 3, stride)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("C", (16, 48, 64))
def test_group_norm_matches_jax(C):
    rng = _rng(C)
    x = (rng.standard_normal((2, 5, 7, C)) * 3 + 1).astype(np.float32)
    scale = rng.standard_normal(C).astype(np.float32)
    bias = rng.standard_normal(C).astype(np.float32)
    want = np.asarray(JR.group_norm(jnp.asarray(x), jnp.asarray(scale),
                                    jnp.asarray(bias)))
    got = TR.group_norm(_t(x), _t(scale), _t(bias))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bits", (4, 8, 16))
def test_fake_quant_forward_is_bit_for_bit_jax(bits):
    x = _rng(bits).standard_normal((3, 5, 7, 12)).astype(np.float32)
    x[0, 0, 0] = 0.0                               # an all-zero row
    want = np.asarray(JQ.fake_quant(jnp.asarray(x), bits))
    np.testing.assert_array_equal(TQ.fake_quant(_t(x), bits).numpy(), want)


def test_fake_quant_refuses_a_tensor_that_requires_grad():
    x = torch.ones((2, 4), requires_grad=True)
    with pytest.raises(NotImplementedError):
        TQ.fake_quant(x)
    with torch.no_grad():
        assert TQ.fake_quant(x).shape == (2, 4)


def test_compression_ratio_and_scale_bytes_match_jax():
    from repro.core.butterfly import compression_ratio as jratio
    assert TB.compression_ratio(256, 1, 8, 8) == 256
    for args in ((256, 1, 8, 8), (2048, 10, 32), (4096, 64, 16, 4)):
        assert TB.compression_ratio(*args) == jratio(*args)
    assert TQ.scale_dtype_bytes() == JQ.scale_dtype_bytes() == 4
    assert TQ.scale_dtype_bytes(torch.bfloat16) == \
        JQ.scale_dtype_bytes(jnp.bfloat16) == 2


def test_resnet50_structure_matches_paper_and_jax():
    cfg = resnet50()
    assert cfg.num_blocks == 16                        # paper Fig. 4
    assert cfg.block_channels()[:3] == [256] * 3       # stage 1
    assert cfg.block_channels()[-1] == 2048
    assert cfg.block_spatial()[0] == 56                # 224/4
    assert cfg.block_spatial()[-1] == 7
    for tc, jc in ((cfg, jresnet50()),
                   (cfg.reduced().with_butterfly(1, 4),
                    jresnet50().reduced().with_butterfly(1, 4))):
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)


def _models(jcfg, tcfg, seed=0):
    jparams = JR.init_resnet(jax.random.key(seed), jcfg)
    tparams = bridge.resnet_to_torch(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    return jparams, tparams


def test_init_resnet_tree_matches_jax_layout():
    """The port's own init gives the JAX tree's structure, with each conv
    kernel OIHW, and the same trunc-normal scales."""
    jcfg = jresnet50().reduced().with_butterfly(1, 4)
    tcfg = resnet50().reduced().with_butterfly(1, 4)
    jparams, bridged = _models(jcfg, tcfg)
    tparams = TR.init_resnet(torch.Generator().manual_seed(0), tcfg, device="cpu")
    shapes = lambda tree: tree_map(lambda a: tuple(a.shape), tree)
    assert shapes(tparams) == shapes(bridged)
    assert shapes(bridged) == tree_map(
        lambda a: tuple(a.shape[i] for i in (3, 2, 0, 1)) if a.ndim == 4
        else tuple(a.shape), jax.tree.map(np.asarray, jparams))
    assert all(t.dtype == torch.float32 for t in tree_leaves(tparams))
    stem = tparams["stem"]                             # fan_in 7*7*3
    assert float(stem.abs().max()) <= 2 * math.sqrt(2 / 147) + 1e-6
    again = TR.init_resnet(torch.Generator().manual_seed(0), tcfg, device="cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(tparams), tree_leaves(again)))


def _check_split(jcfg, tcfg, images, seed=0):
    jparams, tparams = _models(jcfg, tcfg, seed)
    ji, ti = jnp.asarray(images), _t(images)
    jl = JR.forward_resnet(jparams, ji, jcfg, train=True)
    tl = TR.forward_resnet(tparams, ti, tcfg)
    assert tuple(tl.shape) == (images.shape[0], tcfg.num_classes)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)

    jsl, jwire = JR.edge_cloud_split(jparams, ji, jcfg)
    tsl, twire = TR.edge_cloud_split(tparams, ti, tcfg)
    codes, scales = twire["codes"], twire["scales"]
    assert codes.dtype == torch.int8 and scales.dtype == torch.float32
    assert tuple(codes.shape) == jwire["codes"].shape
    assert codes.shape[-1] == tcfg.butterfly.d_r and scales.shape[-1] == 1
    diff = (codes.int() - _t(jwire["codes"]).int()).abs()
    assert int(diff.max()) <= 1
    assert int((diff > 0).sum()) <= math.ceil(1e-3 * diff.numel())
    jscales = np.asarray(jwire["scales"])
    np.testing.assert_allclose(scales.numpy(), jscales, rtol=1e-5,
                               atol=1e-5 * float(np.abs(jscales).max()))
    np.testing.assert_allclose(tsl.numpy(), np.asarray(jsl), rtol=1e-4, atol=1e-4)
    # the cloud half on JAX's wire, and the in-graph form against the split
    wire = {k: _t(v) for k, v in jwire.items()}
    cl = TR.cloud_half(tparams, wire, tcfg, torch.float32)
    np.testing.assert_allclose(cl.numpy(), np.asarray(jsl), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tl.numpy(), tsl.numpy(), rtol=1e-4, atol=1e-4)


def test_reduced_resnet_forward_and_split_match_jax():
    jcfg = jresnet50().reduced().with_butterfly(1, 4)
    tcfg = resnet50().reduced().with_butterfly(1, 4)
    images = _rng(1).standard_normal((2, 32, 32, 3)).astype(np.float32)
    _check_split(jcfg, tcfg, images)


@pytest.mark.parametrize("split", (3, 16))
def test_full_width_resnet50_split_matches_jax(split):
    """Every stage at its published width (256-2,048 channels, stem 64) on
    one 64x64 image, split after RB3 (d_r 1) and RB16 (d_r 10)."""
    jcfg = jresnet50().with_butterfly(split, PAPER_MIN_DR[split])
    tcfg = resnet50().with_butterfly(split, PAPER_MIN_DR[split])
    images = _rng(split).standard_normal((1, 64, 64, 3)).astype(np.float32)
    _check_split(jcfg, tcfg, images)
