"""The port's windowed family (gemma3) against the JAX package's: the
config, ring-order prefill caches (``to_ring``), ring-buffer decode, and
the reduced gemma3-12b served through ``forward_prefill(use_kernel=True)``
and greedy ``forward_decode`` past the window, with the JAX weights
carried across by ``repro_torch.bridge``.  Prefill logits and caches agree
within 1e-5, decode logits and caches within 1e-4 (f32), and the greedy
tokens are identical.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import attention as jattn, model as JM, transformer as jtfm
from repro_torch import bridge
from repro_torch.configs import get_config as tget_config
from repro_torch.models import attention as tattn, model as TM, transformer as ttfm
from repro_torch.tree import tree_leaves, tree_map

WINDOW = 64
# the JAX side's decode steps, compiled once (eagerly each step takes ~1 s)
_jattn_decode = jax.jit(jattn.attention_decode, static_argnames=("cfg", "window"))
_jforward_decode = jax.jit(JM.forward_decode, static_argnames=("built", "use_kernel"))


def test_gemma3_config_matches_jax():
    jc, tc = jget_config("gemma3-12b"), tget_config("gemma3-12b")
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert dataclasses.asdict(jc.reduced()) == dataclasses.asdict(tc.reduced())
    windows = [d.window for d in ttfm.build_layer_defs(tc)]
    assert windows == [d.window for d in jtfm.build_layer_defs(jc)]
    assert windows.count(None) == 8 and windows.count(1024) == 40


@pytest.mark.parametrize("S,W", [(10, 4), (4, 4), (3, 4), (13, 6)])
def test_to_ring_matches_jax(S, W):
    a = np.random.default_rng(S).standard_normal((2, S, 1, 4)).astype(np.float32)
    kv = {"k": a, "v": a * 2}
    want = jtfm.to_ring({n: jnp.asarray(x) for n, x in kv.items()}, W)
    got = ttfm.to_ring({n: torch.from_numpy(x) for n, x in kv.items()}, W)
    for n in kv:
        np.testing.assert_array_equal(got[n].numpy(), np.asarray(want[n]))


@pytest.mark.parametrize("window,pre,extra", [(4, 3, 6), (4, 10, 5), (6, 6, 7)])
def test_ring_decode_matches_jax(window, pre, extra):
    """Prefill ``pre`` tokens, put the cache in ring order padded to the
    window, then decode ``extra`` tokens with the ring buffer in both
    packages: outputs and caches agree at every step."""
    jc = dataclasses.replace(jget_config("gemma3-12b").reduced(), num_heads=2,
                             num_kv_heads=1, head_dim=16)
    tc = dataclasses.replace(tget_config("gemma3-12b").reduced(), num_heads=2,
                             num_kv_heads=1, head_dim=16)
    jparams, _ = jattn.init_attention(jax.random.key(0), jc, jnp.float32)
    tparams = bridge.to_torch(jax.tree.map(np.asarray, jparams), device="cpu")
    x = (np.random.default_rng(1).standard_normal((1, pre + extra, jc.d_model))
         * 0.3).astype(np.float32)
    _, jkv = jattn.attention_fullseq(jparams, jnp.asarray(x[:, :pre]), cfg=jc,
                                     window=window)
    _, tkv = tattn.attention_fullseq(tparams, torch.from_numpy(x[:, :pre]),
                                     cfg=tc, window=window)
    pad = max(0, window - min(pre, window))
    jcache = {n: jnp.pad(a, ((0, 0), (0, pad), (0, 0), (0, 0)))
              for n, a in jtfm.to_ring(jkv, window).items()}
    tcache = ttfm.pad_to_template(
        ttfm.to_ring(tkv, window),
        tattn.init_kv_cache(tc, 1, window, torch.float32, "meta"))
    for t in range(pre, pre + extra):
        jo, jcache = _jattn_decode(jparams, jnp.asarray(x[:, t:t + 1]), jcache,
                                   jnp.asarray(t, jnp.int32), cfg=jc,
                                   window=window)
        to, tcache = tattn.attention_decode(tparams, torch.from_numpy(x[:, t:t + 1]),
                                            tcache, t, cfg=tc, window=window)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=1e-5)
        for n in ("k", "v"):
            np.testing.assert_allclose(tcache[n].numpy(), np.asarray(jcache[n]),
                                       rtol=0, atol=1e-5)


@functools.cache
def _gemma_models():
    """Reduced gemma3-12b: 4 layers (local, global, local, global), window
    64, a d_r=16 butterfly after layer 2, f32.  Shared by the tests of this
    file, which never write to the params."""
    def cut(cfg):
        cfg = dataclasses.replace(cfg.reduced(), num_layers=4,
                                  sliding_window=WINDOW, global_every=2)
        return cfg.with_butterfly(2, 16)
    jc, tc = cut(jget_config("gemma3-12b")), cut(tget_config("gemma3-12b"))
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    jbuilt, tbuilt = JM.build(jc), TM.build(tc)
    jparams, _ = JM.init_model(jax.random.key(0), jbuilt)
    tparams = bridge.to_torch(jax.tree.map(np.asarray, jparams), device="cpu")
    return jbuilt, jparams, tbuilt, tparams


def _np(tree):
    return tree_map(lambda t: t.numpy(), tree)


@pytest.mark.parametrize("S", [128, 50])
def test_reduced_gemma3_kernel_prefill_and_decode_match_jax(S):
    """S=128 prefills past the window, so the ring caches wrap at once;
    S=50 prefills short of it and wraps during the 20 decode steps, and its
    ring caches still pad to exactly the window."""
    new_tokens = 20
    jbuilt, jparams, tbuilt, tparams = _gemma_models()
    toks = np.random.default_rng(S).integers(0, tbuilt.cfg.vocab_size,
                                             (2, S)).astype(np.int32)
    jl, jc = JM.forward_prefill(jparams, jbuilt, {"tokens": jnp.asarray(toks)},
                                use_kernel=True)
    tl, tc = TM.forward_prefill(tparams, tbuilt, {"tokens": torch.from_numpy(toks)},
                                use_kernel=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-5)
    for a, b in zip(tree_leaves(_np(tc)), jax.tree.leaves(jc)):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-5)

    cap = S + new_tokens
    tc = TM.pad_decode_caches(tbuilt, tc, cap)
    lengths = sorted({leaf.shape[2] for leaf in tree_leaves(tc)})
    assert lengths == sorted({min(cap, WINDOW), cap})
    templates = [jtfm.init_stage_cache(list(segs), jbuilt.cfg, 2, cap, jnp.float32)
                 for segs in jbuilt.stages]
    jc = jax.tree.map(lambda a, t: jnp.pad(a, [(0, ts - s) for s, ts in
                                               zip(a.shape, t.shape)]),
                      jc, templates)

    tokens = []
    tok = np.asarray(jnp.argmax(jl[:, -1], axis=-1), np.int32)[:, None]
    assert np.array_equal(tok[:, 0], tl[:, -1].argmax(-1).numpy())
    for pos in range(S, cap):
        jl, jc = _jforward_decode(jparams, built=jbuilt, tokens=jnp.asarray(tok),
                                  caches=jc, pos=jnp.asarray(pos, jnp.int32),
                                  use_kernel=True)
        tl, tc = TM.forward_decode(tparams, tbuilt, torch.tensor(tok), tc,
                                   pos, use_kernel=True)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)
        tok = np.asarray(jnp.argmax(jl[:, -1], axis=-1), np.int32)[:, None]
        assert np.array_equal(tok[:, 0], tl[:, -1].argmax(-1).numpy())
        tokens.append(tok[:, 0])
    for a, b in zip(tree_leaves(_np(tc)), jax.tree.leaves(jc)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-4)
    assert len(tokens) == new_tokens
