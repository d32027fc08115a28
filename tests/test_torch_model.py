"""The port's dense model against the JAX package's, with the JAX weights
carried across by ``repro_torch.bridge``: forward_train / forward_prefill
logits within 1e-5 (forward_train's aux within rtol 1e-6), forward_decode after prefill within 1e-4, at the
reduced 4-layer qwen3-8b config in f32."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import model as JM
from repro_torch import bridge
from repro_torch.configs import get_config as tget_config
from repro_torch.models import model as TM
from repro_torch.tree import tree_leaves, tree_map


def _cfgs(butterfly=None):
    jc = dataclasses.replace(jget_config("qwen3-8b").reduced(), num_layers=4)
    tc = dataclasses.replace(tget_config("qwen3-8b").reduced(), num_layers=4)
    if butterfly is not None:
        jc, tc = jc.with_butterfly(*butterfly), tc.with_butterfly(*butterfly)
    return jc, tc


def _models(butterfly=None, seed=0):
    jc, tc = _cfgs(butterfly)
    jbuilt, tbuilt = JM.build(jc), TM.build(tc)
    jparams, _ = JM.init_model(jax.random.key(seed), jbuilt)
    tparams = bridge.to_torch(jax.tree.map(np.asarray, jparams), device="cpu")
    return jbuilt, jparams, tbuilt, tparams


def _np(tree):
    return tree_map(lambda t: t.numpy(), tree)


TOKS = np.random.default_rng(0).integers(0, 512, (2, 12)).astype(np.int32)


def test_configs_and_segmentation_match_jax():
    jc, tc = _cfgs((2, 16))
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert [[(len(s.unit), s.repeats) for s in st] for st in JM.build(jc).stages] \
        == [[(len(s.unit), s.repeats) for s in st] for st in TM.build(tc).stages]


def test_init_model_tree_matches_jax_layout():
    """The port's own init (torch generator) gives the JAX tree's structure,
    shapes and dtype, with trunc-normal leaves of the JAX scale."""
    jbuilt, jparams, tbuilt, _ = _models((2, 16))
    gen = torch.Generator().manual_seed(0)
    tparams = TM.init_model(gen, tbuilt, device="cpu")
    jshapes = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jparams)
    tshapes = tree_map(lambda a: (tuple(a.shape), str(a.dtype)[6:]), tparams)
    assert tshapes == jax.tree.map(lambda s: s, jshapes,
                                   is_leaf=lambda s: isinstance(s, tuple))
    wq = tparams["stages"][0][0][0]["mixer"]["wq"]
    d = tbuilt.cfg.d_model
    assert float(wq.abs().max()) <= 2.0 / d ** 0.5 + 1e-6       # truncated at 2 std
    assert abs(float(wq.std()) * d ** 0.5 - 0.88) < 0.05         # trunc-normal std
    again = TM.init_model(torch.Generator().manual_seed(0), tbuilt, device="cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(tparams), tree_leaves(again)))


def test_forward_train_matches_jax():
    jbuilt, jparams, tbuilt, tparams = _models()
    jl, _ = JM.forward_train(jparams, jbuilt, {"tokens": jnp.asarray(TOKS)})
    tl, _ = TM.forward_train(tparams, tbuilt, {"tokens": torch.from_numpy(TOKS)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-5)


@pytest.mark.parametrize("butterfly", [None, (2, 16)])
def test_forward_prefill_matches_jax(butterfly):
    jbuilt, jparams, tbuilt, tparams = _models(butterfly)
    jl, jc = JM.forward_prefill(jparams, jbuilt, {"tokens": jnp.asarray(TOKS)})
    tl, tc = TM.forward_prefill(tparams, tbuilt, {"tokens": torch.from_numpy(TOKS)})
    assert tl.shape == (2, 1, tbuilt.cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-5)
    for a, b in zip(tree_leaves(_np(tc)), jax.tree.leaves(jc)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-5)


def test_forward_train_refuses_the_training_wire():
    """The name is from when the port refused the training wire; now
    forward_train with a butterfly, without and with the rate term, gives
    JAX's logits within 1e-5 and its three aux terms (zeros but the rate)
    within rtol 1e-6."""
    for rate_weight in (0.0, 0.01):
        jc, tc = _cfgs()
        jc = jc.with_butterfly(2, 16, rate_weight=rate_weight)
        tc = tc.with_butterfly(2, 16, rate_weight=rate_weight)
        jbuilt, tbuilt = JM.build(jc), TM.build(tc)
        jparams, _ = JM.init_model(jax.random.key(0), jbuilt)
        tparams = bridge.to_torch(jax.tree.map(np.asarray, jparams), device="cpu")
        jl, jaux = JM.forward_train(jparams, jbuilt, {"tokens": jnp.asarray(TOKS)})
        tl, taux = TM.forward_train(tparams, tbuilt, {"tokens": torch.from_numpy(TOKS)})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-5)
        assert set(taux) == set(jaux) == {"load_balance", "router_z",
                                          "wire_rate_bits"}
        for k, v in taux.items():
            assert v.dtype == torch.float32 and v.dim() == 0
            np.testing.assert_allclose(float(v), float(jaux[k]), rtol=1e-6)
        assert (float(taux["wire_rate_bits"]) > 0) == (rate_weight > 0)


@pytest.mark.parametrize("butterfly", [None, (2, 16)])
def test_forward_decode_after_prefill_matches_jax(butterfly):
    """Prefill 12 tokens, pad the caches to 16 rows, then decode three greedy
    tokens with a scalar position in both packages."""
    jbuilt, jparams, tbuilt, tparams = _models(butterfly)
    jl, jc = JM.forward_prefill(jparams, jbuilt, {"tokens": jnp.asarray(TOKS)})
    _, tc = TM.forward_prefill(tparams, tbuilt, {"tokens": torch.from_numpy(TOKS)})
    pad = lambda a: np.pad(np.asarray(a), [(0, 0), (0, 0), (0, 4), (0, 0), (0, 0)])
    jc = jax.tree.map(lambda a: jnp.asarray(pad(a)), jc)
    tc = tree_map(lambda a: torch.from_numpy(pad(a.numpy())), tc)
    tok = np.array(jnp.argmax(jl[:, -1], axis=-1), np.int32)[:, None]
    for pos in range(12, 15):
        jl, jc = JM.forward_decode(jparams, jbuilt, jnp.asarray(tok), jc, pos)
        tl, tc = TM.forward_decode(tparams, tbuilt, torch.from_numpy(tok), tc, pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)
        tok = np.array(jnp.argmax(jl[:, -1], axis=-1), np.int32)[:, None]
    for a, b in zip(tree_leaves(_np(tc)), jax.tree.leaves(jc)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-4)


def test_ragged_decode_positions_match_jax():
    """A (B,) position vector (the serving engine's ragged decode) writes each
    row at its own slot, as the JAX scatter path does."""
    jbuilt, jparams, tbuilt, tparams = _models()
    jl, jc = JM.forward_prefill(jparams, jbuilt, {"tokens": jnp.asarray(TOKS)})
    _, tc = TM.forward_prefill(tparams, tbuilt, {"tokens": torch.from_numpy(TOKS)})
    pad = lambda a: np.pad(np.asarray(a), [(0, 0), (0, 0), (0, 4), (0, 0), (0, 0)])
    jc = jax.tree.map(lambda a: jnp.asarray(pad(a)), jc)
    tc = tree_map(lambda a: torch.from_numpy(pad(a.numpy())), tc)
    tok = np.array([[5], [7]], np.int32)
    pos = np.array([12, 9], np.int32)
    jl, jc = JM.forward_decode(jparams, jbuilt, jnp.asarray(tok), jc,
                               jnp.asarray(pos))
    tl, tc = TM.forward_decode(tparams, tbuilt, torch.from_numpy(tok), tc,
                               torch.from_numpy(pos))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)
    for a, b in zip(tree_leaves(_np(tc)), jax.tree.leaves(jc)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-4)


def test_kernel_prefill_with_16_bit_wire_matches_jax():
    """forward_prefill(use_kernel=True) under a 16-bit butterfly: the port's
    fused wire quantizes to int16 codes (the kernels' int16 variants on the
    card, their plain versions here), where JAX's fused codec stops at 8
    bits and its kernel prefill takes the unfused 16-bit wire.  The f32
    products sum in different orders, so a code may land one step (1/32,767
    of its row's absmax) apart: the same greedy tokens, and logits within
    1e-4."""
    jbuilt, jparams, tbuilt, tparams = _models((2, 16, 16))
    assert tbuilt.cfg.butterfly.wire_bits == 16
    toks = np.random.default_rng(5).integers(0, 512, (2, 64)).astype(np.int32)
    jl, _ = JM.forward_prefill(jparams, jbuilt, {"tokens": jnp.asarray(toks)},
                               use_kernel=True)
    tl, _ = TM.forward_prefill(tparams, tbuilt, {"tokens": torch.from_numpy(toks)},
                               use_kernel=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)
    assert np.array_equal(tl.numpy().argmax(-1), np.asarray(jl).argmax(-1))
