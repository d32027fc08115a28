"""The attention families this slice ports, against the JAX package in f32
on the CPU with the JAX weights carried across by ``repro_torch.bridge``:
qwen3-moe-235b-a22b and llama4-maverick-400b-a17b (MoE), pixtral-12b
(patch embeddings before the tokens) and whisper-base (encoder-decoder,
sinusoid positions, cross attention).

  * every config field and ``costs.param_count`` equal JAX's;
  * the counterparts of ``tests/test_archs_smoke.py``'s three tests, held
    to JAX rather than only finite: the reduced forward's logits within
    rtol/atol 1e-5 and its MoE aux within rtol 1e-6; one AdamW step's loss
    and grad norm within rtol 1e-5; the butterfly variant's logits within
    1e-5;
  * prefill + one decode step equals the full forward (as
    ``tests/test_prefill_decode.py``, MoE at capacity_factor 100, within
    its 2e-3), and the decode logits are JAX's within 1e-5;
  * the kernel prefill (``use_kernel=True``) of reduced pixtral and whisper
    with a butterfly against JAX's, whose Pallas kernels run in interpret
    mode: last-position logits within 1e-5, caches within 1e-5.  Whisper's
    encoder is the first non-causal flash call on a path; JAX's kernel
    needs its blocks to divide S, so at whisper's ragged shapes (1,500
    frames on the card) the port's plain flash is held to JAX's reference
    instead, within rtol/atol 2e-5 (``test_torch_flash.py``'s);
  * the split bank refuses an encoder-decoder, as its edge half has no
    encoder output (the JAX bank fails the same way).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core import costs as jcosts
from repro.kernels import ref as jref
from repro.models import model as JM
from repro.training import optimizer as JO, train_loop as JT
from repro_torch import bridge
from repro_torch.configs import get_config as tget
from repro_torch.core import costs as tcosts
from repro_torch.kernels import ops
from repro_torch.models import model as TM
from repro_torch.runtime.split_exec import SplitModelBank
from repro_torch.training import optimizer as TO, train_loop as TT
from repro_torch.tree import tree_leaves, tree_map

ARCHS = ["qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b", "pixtral-12b",
         "whisper-base"]
B, S = 2, 32


def _cfgs(arch, butterfly=None, cf=None):
    out = []
    for get in (jget, tget):
        c = get(arch).reduced()
        if cf is not None and c.moe is not None:
            c = dataclasses.replace(c, moe=dataclasses.replace(c.moe, capacity_factor=cf))
        out.append(c.with_butterfly(*butterfly) if butterfly else c)
    return out


def _models(arch, **kw):
    jc, tc = _cfgs(arch, **kw)
    jbuilt, tbuilt = JM.build(jc), TM.build(tc)
    jparams, _ = JM.init_model(jax.random.key(0), jbuilt)
    tparams = bridge.to_torch(jax.tree.map(np.asarray, jparams), device="cpu")
    return jbuilt, jparams, tbuilt, tparams


def _batch(cfg, seq=S, seed=1):
    """test_archs_smoke.py's batch, from numpy: (B, seq - n_patches) tokens,
    patches and frames where the config takes them, and targets."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size,
                                    (B, seq - cfg.num_patches)).astype(np.int32)}
    if cfg.num_patches:
        batch["patches"] = rng.standard_normal(
            (B, cfg.num_patches, cfg.d_model)).astype(np.float32)
    if cfg.is_encdec:
        batch["frames"] = rng.standard_normal(
            (B, cfg.encoder_frames, cfg.d_model)).astype(np.float32)
    batch["targets"] = rng.integers(0, cfg.vocab_size, (B, seq)).astype(np.int32)
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_param_count_match_jax(arch):
    jc, tc = jget(arch), tget(arch)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert dataclasses.asdict(tc.reduced()) == dataclasses.asdict(jc.reduced())
    assert tcosts.param_count(tc) == jcosts.param_count(jc)


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_forward_matches_jax(arch):
    jbuilt, jparams, tbuilt, tparams = _models(arch)
    cfg = tbuilt.cfg
    assert cfg.num_layers == 2 and cfg.d_model <= 512
    if cfg.is_encdec:
        assert len(tbuilt.enc_segments) == len(jbuilt.enc_segments) == 1
        assert set(tparams["encoder"]) == {"segments", "final_norm"}
        assert {"norm_cross", "cross"} <= set(tparams["stages"][0][0][0])
    jb, tb = _batch(cfg)
    jl, jaux = JM.forward_train(jparams, jbuilt, jb)
    tl, taux = TM.forward_train(tparams, tbuilt, tb)
    assert tl.shape == (B, S, cfg.vocab_size) and bool(torch.isfinite(tl).all())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)
    for k in ("load_balance", "router_z"):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=1e-6)
        assert (float(taux[k]) > 0) == (cfg.moe is not None)


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_train_step_matches_jax(arch):
    jbuilt, jparams, tbuilt, tparams = _models(arch)
    jb, tb = _batch(tbuilt.cfg)
    jstep = jax.jit(JT.make_train_step(jbuilt, JO.AdamWConfig(lr=JO.constant_schedule(1e-3))))
    tstep = TT.make_train_step(tbuilt, TO.AdamWConfig(lr=TO.constant_schedule(1e-3)))
    before = [t.clone() for t in tree_leaves(tparams)]     # the step is in place
    _, _, jm = jstep(jparams, JO.adamw_init(jparams), jb)
    tparams, _, tm = tstep(tparams, TO.adamw_init(tparams), tb)
    for k in ("loss", "grad_norm", "load_balance", "router_z", "total"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5)
    assert np.isfinite(float(tm["loss"])) and np.isfinite(float(tm["grad_norm"]))
    assert any(not torch.equal(a, b) for a, b in zip(before, tree_leaves(tparams)))


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_butterfly_variant_matches_jax(arch):
    """The paper's technique on every family: a d_r = 16 butterfly after
    layer 1 (the decoder's, for whisper)."""
    jbuilt, jparams, tbuilt, tparams = _models(arch, butterfly=(1, 16))
    assert len(tbuilt.stages) == 2 and "butterfly" in tparams
    jb, tb = _batch(tbuilt.cfg)
    jl, _ = JM.forward_train(jparams, jbuilt, jb)
    tl, _ = TM.forward_train(tparams, tbuilt, tb)
    assert tl.shape == (B, S, tbuilt.cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_plus_decode_equals_full(arch):
    """Prefill S-1 tokens (after the patches), pad the caches by one row,
    decode the last token at position S-1 + n_patches."""
    jbuilt, jparams, tbuilt, tparams = _models(arch, cf=100.0)
    cfg = tbuilt.cfg
    seq = 16 + cfg.num_patches
    jb, tb = _batch(cfg, seq=seq)
    tl_full, _ = TM.forward_train(tparams, tbuilt, tb)
    toks = tb["tokens"]
    tp = dict(tb, tokens=toks[:, :-1])
    jp = dict(jb, tokens=jb["tokens"][:, :-1])
    _, tcache = TM.forward_prefill(tparams, tbuilt, tp)
    _, jcache = JM.forward_prefill(jparams, jbuilt, jp)
    tcache = TM.pad_decode_caches(tbuilt, tcache, seq)
    jcache = jax.tree.map(
        lambda a: jnp.pad(a, [(0, 0), (0, 0), (0, seq - a.shape[2]), (0, 0), (0, 0)])
        if a.shape[2] == seq - 1 else a, jcache)
    pos = seq - 1
    tl, _ = TM.forward_decode(tparams, tbuilt, toks[:, -1:], tcache, pos)
    jl, _ = JM.forward_decode(jparams, jbuilt, jb["tokens"][:, -1:], jcache,
                              jnp.asarray(pos, jnp.int32))
    np.testing.assert_allclose(tl[:, 0].numpy(), tl_full[:, -1].numpy(),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ["pixtral-12b", "whisper-base"])
def test_kernel_prefill_matches_jax(arch):
    """forward_prefill(use_kernel=True) with a d_r = 16 butterfly after
    layer 1, against JAX's on its interpret-mode Pallas kernels: flash in
    every attention layer (whisper's encoder non-causal at 16 frames), the
    fused butterfly kernels at the wire."""
    jbuilt, jparams, tbuilt, tparams = _models(arch, butterfly=(1, 16))
    jb, tb = _batch(tbuilt.cfg)
    jb.pop("targets"), tb.pop("targets")
    jl, jc = JM.forward_prefill(jparams, jbuilt, jb, use_kernel=True)
    tl, tc = TM.forward_prefill(tparams, tbuilt, tb, use_kernel=True)
    plain, _ = TM.forward_prefill(tparams, tbuilt, tb)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tl.numpy(), plain.numpy(), rtol=1e-5, atol=1e-5)
    def same(t, j):
        assert tuple(t.shape) == j.shape
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-5)
    tree_map(same, tc, jc)


@pytest.mark.parametrize("S", [150, 37])
def test_whisper_encoder_flash_ragged_matches_jax_reference(S):
    """Whisper's encoder attention, non-causal, one query head a key head
    at head dim 64, at frame counts no flash block divides."""
    rng = np.random.default_rng(S)
    q, k, v = (rng.standard_normal((1, S, 8, 64)).astype(np.float32) for _ in range(3))
    out = ops.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=False)
    want = jref.flash_attention_ref(*map(jnp.asarray, (q, k, v)), causal=False)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_bank_refuses_an_encoder_decoder():
    cfg = dataclasses.replace(tget("whisper-base").reduced(), num_layers=3)
    with pytest.raises(NotImplementedError, match="encoder"):
        SplitModelBank(cfg, 16, device="cpu")
