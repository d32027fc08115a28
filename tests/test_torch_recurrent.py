"""The recurrent families against the JAX package, in f32 on the CPU with
the JAX weights carried across by ``repro_torch.bridge``: zamba2-7b
(Mamba2 layers and one shared attention block) and xlstm-125m (mLSTM and
sLSTM).  Tolerances: rtol/atol 1e-5 on logits and states (f32 sums in
another order) unless a test says why not; greedy ids exact.

  * the counterparts of ``tests/test_ssm_oracles.py``'s four tests: the
    chunked forms equal the sequential decode steps (mamba at chunks 4, 8
    and 16, mLSTM at 4 and 8, sLSTM's full sequence against its steps) and
    mamba is chunk-size invariant, each within the oracle's tolerance, and
    each output and state within 1e-5 of JAX's on the same inputs;
  * a sequence that is no multiple of its chunk raises, as JAX asserts;
  * every config, ``build_layer_defs``, ``segmentize`` and
    ``supports_shape`` of the ``ASSIGNED`` archs at full size equal JAX's;
  * the counterparts of ``tests/test_archs_smoke.py``'s three tests, held to
    JAX: the reduced forward, one AdamW step (loss and grad norm within rtol
    1e-5) with the loss's grads (every leaf, ``shared_attn``'s included,
    within 2e-5 of its largest entry, as ``test_torch_training.py``), and
    the butterfly variant;
  * prefill + one decode step equals the full forward (within
    ``tests/test_prefill_decode.py``'s 2e-3), and the decode logits and
    caches are JAX's;
  * the kernel prefill (``use_kernel=True``) against JAX's on its
    interpret-mode Pallas kernels;
  * a bf16 tree keeps every recurrent f32 leaf f32 through the bridge;
  * the reduced model in bf16 lies within JAX's own bf16 rounding of JAX's
    bf16 logits, and its caches have JAX's dtypes after prefill and decode;
  * the split bank at every split of 4-layer xLSTM and at the splits of
    6-layer reduced zamba2 inside its repeat units: edge and cloud caches and
    cloud logits, and at split 1 the engine's greedy ids (cache handoff and
    streamed), equal JAX's, and so do the compile-cache keys: the bank
    compiles per exact (B, S);
  * the engine reuses a slot and keeps nothing of its last request;
  * the plain flash version at zamba2's head dim 112 against JAX's Pallas
    kernel in interpret mode.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import INPUT_SHAPES as JSHAPES, get_config as jget, \
    supports_shape as jsupports
from repro.configs.all import ASSIGNED as JASSIGNED
from repro.core import costs as jcosts
from repro.kernels import ops as jops
from repro.models import model as JM, ssm as jssm, transformer as jtfm, \
    xlstm as jxlstm
from repro.runtime.split_exec import SplitModelBank as JBank
from repro.serving.engine import ServingEngine as JEngine
from repro.training import train_loop as JT
from repro_torch import bridge
from repro_torch.configs import INPUT_SHAPES as TSHAPES, get_config as tget, \
    supports_shape as tsupports
from repro_torch.configs.all import ASSIGNED
from repro_torch.core import costs as tcosts
from repro_torch.kernels import ops
from repro_torch.models import model as TM, ssm as tssm, transformer as ttfm, \
    xlstm as txlstm
from repro_torch.runtime.split_exec import SplitModelBank as TBank
from repro_torch.serving.engine import ServingEngine as TEngine
from repro_torch.training import optimizer as TO, train_loop as TT
from repro_torch.tree import tree_leaves, tree_map

ARCHS = ["zamba2-7b", "xlstm-125m"]
B, S = 2, 32
TOL = dict(rtol=1e-5, atol=1e-5)
to_np = lambda tree: jax.tree.map(np.asarray, tree)
# JAX's model entry points, jitted (``built`` is static)
jforward_train = jax.jit(JM.forward_train, static_argnums=1)
jforward_prefill = jax.jit(JM.forward_prefill, static_argnums=1)


def _close(t, j, **tol):
    t = t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    np.testing.assert_allclose(t, np.asarray(j, np.float32), **(tol or TOL))


def _close_tree(t, j, **tol):
    """Leaf by leaf, matched by key and index (JAX flattens dicts in sorted
    key order, the port in insertion order)."""
    assert len(tree_leaves(t)) == len(jax.tree.leaves(j))

    def one(a, b):
        assert tuple(a.shape) == b.shape
        _close(a, b, **tol)
    tree_map(one, t, to_np(j))


# ----------------------------------------------------------------- oracles
def _mixer_cfgs(arch, **kw):
    """The reduced config of ``arch`` with its ssm or xlstm sub-config
    replaced by ``kw``, from each package."""
    out = []
    for get in (jget, tget):
        c = get(arch).reduced()
        sub = "ssm" if c.ssm is not None else "xlstm"
        out.append(dataclasses.replace(c, **{sub: dataclasses.replace(
            getattr(c, sub), **kw)}))
    return out


MIXERS = {
    "mamba": ("zamba2-7b", jssm.init_mamba, jssm.init_ssm_state,
              jssm.mamba_fullseq, jssm.mamba_decode, tssm.init_ssm_state,
              tssm.mamba_fullseq, tssm.mamba_decode),
    "mlstm": ("xlstm-125m", jxlstm.init_mlstm, jxlstm.init_mlstm_state,
              jxlstm.mlstm_fullseq, jxlstm.mlstm_decode,
              txlstm.init_mlstm_state, txlstm.mlstm_fullseq,
              txlstm.mlstm_decode),
    "slstm": ("xlstm-125m", jxlstm.init_slstm, jxlstm.init_slstm_state,
              jxlstm.slstm_fullseq, jxlstm.slstm_decode,
              txlstm.init_slstm_state, txlstm.slstm_fullseq,
              txlstm.slstm_decode),
}


def _mixer_runs(kind, seq, **cfg_kw):
    """One mixer on the same weights and inputs in both packages: the full
    sequence with its final state, and ``seq`` decode steps from the zero
    state.  Returns ((full, state, steps, step state) of JAX, of the
    port)."""
    arch, jinit, jstate, jfull, jdec, tstate, tfull, tdec = MIXERS[kind]
    jcfg, tcfg = _mixer_cfgs(arch, **cfg_kw) if cfg_kw else \
        (jget(arch).reduced(), tget(arch).reduced())
    jp, _ = jinit(jax.random.key(0), jcfg, jnp.float32)
    tp = bridge.to_torch(to_np(jp), device="cpu")
    x = (0.5 * np.random.default_rng(1).standard_normal(
        (2, seq, jcfg.d_model))).astype(np.float32)
    jfull = jax.jit(functools.partial(jfull, cfg=jcfg, return_state=True))
    jdec = jax.jit(functools.partial(jdec, cfg=jcfg))
    tfull = functools.partial(tfull, cfg=tcfg, return_state=True)
    tdec = functools.partial(tdec, cfg=tcfg)
    runs = []
    for pkg, p, cfg, init, full, dec, xs in (
            ("jax", jp, jcfg, jstate, jfull, jdec, jnp.asarray(x)),
            ("torch", tp, tcfg, tstate, tfull, tdec, torch.from_numpy(x))):
        out, st = full(p, xs)
        state = init(cfg, 2, jnp.float32) if pkg == "jax" else \
            init(cfg, 2, torch.float32, "cpu")
        steps = []
        for t in range(seq):
            o, state = dec(p, xs[:, t:t + 1], state)
            steps.append(np.asarray(o) if pkg == "jax" else o.numpy())
        runs.append((out, st, np.concatenate(steps, axis=1), state))
    return runs


@pytest.mark.parametrize("kind,chunk,tol", [("mamba", 4, 2e-4), ("mamba", 8, 2e-4),
                                            ("mamba", 16, 2e-4), ("mlstm", 4, 3e-4),
                                            ("mlstm", 8, 3e-4), ("slstm", None, 2e-5)])
def test_chunked_equals_sequential_and_jax(kind, chunk, tol):
    """The full-sequence form equals the decode steps (the JAX oracle
    test's tolerance), and each output and state equals JAX's within
    1e-5."""
    kw = {} if chunk is None else dict(chunk_size=chunk)
    (jfull, jst, jsteps, jstep_st), (tfull, tst, tsteps, tstep_st) = \
        _mixer_runs(kind, 12 if kind == "slstm" else 16, **kw)
    np.testing.assert_allclose(tfull.numpy(), tsteps, rtol=tol, atol=tol)
    for name in tst:
        if name != "conv":            # the decode conv state is the raw tail
            np.testing.assert_allclose(tst[name].numpy(), tstep_st[name].numpy(),
                                       rtol=tol, atol=tol)
    _close(tfull, jfull)
    _close(tsteps, jsteps)
    for name in jst:
        _close(tst[name], jst[name])
        _close(tstep_st[name], jstep_st[name])
        assert tst[name].dtype == tstep_st[name].dtype


def test_mamba_chunk_size_invariance():
    outs = []
    for chunk in (4, 8, 16):
        (jfull, *_), (tfull, *_) = _mixer_runs("mamba", 16, chunk_size=chunk)
        _close(tfull, jfull)
        outs.append(tfull.numpy())
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(outs[0], outs[2], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kind", ["mamba", "mlstm"])
def test_sequence_off_the_chunk_raises(kind):
    """S % min(chunk, S) != 0 raises, as JAX asserts: no padding, no other
    chunk (reduced chunks: mamba 32, mLSTM 16)."""
    arch, *_, tfull, _ = MIXERS[kind]
    cfg = tget(arch).reduced()
    p = (tssm.init_mamba if kind == "mamba" else txlstm.init_mlstm)(
        torch.Generator().manual_seed(0), cfg, torch.float32, "cpu")
    with pytest.raises(ValueError, match="chunk"):
        tfull(p, torch.zeros((1, 40, cfg.d_model)), cfg=cfg)


# -------------------------------------------------------- configs and defs
@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_param_count_match_jax(arch):
    jc, tc = jget(arch), tget(arch)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert dataclasses.asdict(tc.reduced()) == dataclasses.asdict(jc.reduced())
    assert tcosts.param_count(tc) == jcosts.param_count(jc)


def test_layer_defs_segments_and_shapes_match_jax():
    """Every ASSIGNED arch at full size (no init), in both long modes."""
    assert ASSIGNED == JASSIGNED
    for arch in ASSIGNED:
        for long_mode in (False, True):
            jd = jtfm.build_layer_defs(jget(arch), long_mode=long_mode)
            td = ttfm.build_layer_defs(tget(arch), long_mode=long_mode)
            assert [dataclasses.asdict(d) for d in td] == \
                [dataclasses.asdict(d) for d in jd], arch
            assert [(tuple(map(dataclasses.asdict, s.unit)), s.repeats)
                    for s in ttfm.segmentize(td)] == \
                [(tuple(map(dataclasses.asdict, s.unit)), s.repeats)
                 for s in jtfm.segmentize(jd)], arch
        for name, shape in TSHAPES.items():
            assert tsupports(tget(arch), shape) == jsupports(jget(arch),
                                                             JSHAPES[name])
    assert tsupports(tget("zamba2-7b"), TSHAPES["long_500k"])[0]
    assert not tsupports(tget("qwen3-8b"), TSHAPES["long_500k"])[0]
    defs = ttfm.build_layer_defs(tget("zamba2-7b"))
    assert sum(d.shared for d in defs) == 13 and len(defs) == 81


# ------------------------------------------------------ the archs, reduced
@functools.lru_cache(maxsize=None)
def _built_models(arch, butterfly=None, **kw):
    cfgs = []
    for get in (jget, tget):
        c = dataclasses.replace(get(arch).reduced(), **kw)
        cfgs.append(c.with_butterfly(*butterfly) if butterfly else c)
    jbuilt, tbuilt = JM.build(cfgs[0]), TM.build(cfgs[1])
    jparams, _ = JM.init_model(jax.random.key(0), jbuilt)
    tparams = bridge.to_torch(to_np(jparams), device="cpu")
    return jbuilt, jparams, tbuilt, tparams


def _models(arch, butterfly=None, **kw):
    """Both packages' reduced ``arch`` from one JAX init, built once a
    module; the port's params are a fresh copy each call (a step may
    update them in place)."""
    jbuilt, jparams, tbuilt, tparams = _built_models(arch, butterfly, **kw)
    return jbuilt, jparams, tbuilt, tree_map(torch.clone, tparams)


def _batch(cfg, seq=S, seed=1):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, seq)).astype(np.int32),
             "targets": rng.integers(0, cfg.vocab_size, (B, seq)).astype(np.int32)}
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_forward_matches_jax(arch):
    jbuilt, jparams, tbuilt, tparams = _models(arch)
    assert ("shared_attn" in tparams) == (arch == "zamba2-7b")
    if arch == "zamba2-7b":       # a shared layer holds its norms only
        assert set(tparams["stages"][0][0][1]) == {"norm1", "norm2"}
    jb, tb = _batch(tbuilt.cfg)
    jl, _ = jforward_train(jparams, jbuilt, jb)
    tl, _ = TM.forward_train(tparams, tbuilt, tb)
    assert tl.shape == (B, S, tbuilt.cfg.vocab_size)
    _close(tl, jl)


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_train_step_and_grads_match_jax(arch):
    jbuilt, jparams, tbuilt, tparams = _models(arch)
    jb, tb = _batch(tbuilt.cfg)
    (jtotal, jmetrics), jg = jax.jit(jax.value_and_grad(JT.make_loss_fn(jbuilt),
                                                        has_aux=True))(jparams, jb)
    (_, _), tg = TT.value_and_grad(TT.make_loss_fn(tbuilt))(tparams, tb)

    def within(t, j):                 # 2e-5 of the leaf's largest entry
        j = np.asarray(j, np.float32)
        np.testing.assert_allclose(t.numpy(), j, rtol=0,
                                   atol=2e-5 * max(np.abs(j).max(), 1e-12))
    tree_map(within, tg, to_np(jg))
    if arch == "zamba2-7b":           # the shared block's grad sums its uses
        assert float(tg["shared_attn"]["mixer"]["wq"].abs().max()) > 0
    # one AdamW step: its loss, total and grad norm are JAX's (the step's
    # update itself is held to JAX's in test_torch_training.py)
    tstep = TT.make_train_step(tbuilt, TO.AdamWConfig(lr=TO.constant_schedule(1e-3)))
    before = [t.clone() for t in tree_leaves(tparams)]
    tparams, _, tm = tstep(tparams, TO.adamw_init(tparams), tb)
    jnorm = np.sqrt(sum(float(np.sum(np.asarray(g, np.float64) ** 2))
                        for g in jax.tree.leaves(jg)))
    for k, want in (("loss", jmetrics["loss"]), ("total", jtotal), ("grad_norm", jnorm)):
        np.testing.assert_allclose(float(tm[k]), float(want), rtol=1e-5)
    assert all(not torch.equal(a, b) for a, b in zip(before, tree_leaves(tparams))
               if a.dim() > 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_butterfly_variant_matches_jax(arch):
    jbuilt, jparams, tbuilt, tparams = _models(arch, butterfly=(1, 16))
    assert len(tbuilt.stages) == 2
    jb, tb = _batch(tbuilt.cfg)
    jl, _ = jforward_train(jparams, jbuilt, jb)
    tl, _ = TM.forward_train(tparams, tbuilt, tb)
    _close(tl, jl)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_plus_decode_equals_full(arch):
    """Prefill 15 tokens, pad the caches to 16 (state passes through),
    decode the 16th."""
    jbuilt, jparams, tbuilt, tparams = _models(arch)
    seq = 16
    jb, tb = _batch(tbuilt.cfg, seq=seq)
    tl_full, _ = TM.forward_train(tparams, tbuilt, tb)
    _, tcache = TM.forward_prefill(tparams, tbuilt, {"tokens": tb["tokens"][:, :-1]})
    _, jcache = jforward_prefill(jparams, jbuilt, {"tokens": jb["tokens"][:, :-1]})
    _close_tree(tcache, jcache)
    padded = TM.pad_decode_caches(tbuilt, tcache, seq)
    for a, b in zip(tree_leaves(padded), tree_leaves(tcache)):
        if a.dim() != 5 or a.shape[2] != seq:        # recurrent state: untouched
            assert a is b
    jcache = jax.tree.map(
        lambda a: jnp.pad(a, [(0, 0), (0, 0), (0, 1), (0, 0), (0, 0)])
        if a.ndim == 5 and a.shape[2] == seq - 1 and a.shape[3] == jbuilt.cfg.num_kv_heads
        else a, jcache)
    tl, tcache = TM.forward_decode(tparams, tbuilt, tb["tokens"][:, -1:], padded, seq - 1)
    jl, jcache = JM.forward_decode(jparams, jbuilt, jb["tokens"][:, -1:], jcache,
                                   jnp.asarray(seq - 1, jnp.int32))
    np.testing.assert_allclose(tl[:, 0].numpy(), tl_full[:, -1].numpy(),
                               rtol=2e-3, atol=2e-3)
    _close(tl, jl)
    _close_tree(tcache, jcache)


@pytest.mark.parametrize("arch", ARCHS)
def test_kernel_prefill_matches_jax(arch):
    """forward_prefill(use_kernel=True) with a d_r = 16 butterfly after
    layer 1, against JAX's on its interpret-mode Pallas kernels: flash in
    zamba2's shared layer, the fused butterfly kernels at the wire."""
    jbuilt, jparams, tbuilt, tparams = _models(arch, butterfly=(1, 16))
    jb, tb = _batch(tbuilt.cfg)
    jl, jc = JM.forward_prefill(jparams, jbuilt, {"tokens": jb["tokens"]},
                                use_kernel=True)
    tl, tc = TM.forward_prefill(tparams, tbuilt, {"tokens": tb["tokens"]},
                                use_kernel=True)
    plain, _ = TM.forward_prefill(tparams, tbuilt, {"tokens": tb["tokens"]})
    _close(tl, jl)
    _close(tl, plain)
    _close_tree(tc, jc)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_tree_keeps_the_recurrent_f32_leaves(arch):
    """dt_bias, A_log and D (mamba), w_if and b_if (mLSTM), w_in, r and b
    (sLSTM) stay f32 in a bf16 model, through the bridge and the port's own
    init, as in JAX; every other leaf is bf16."""
    jc = dataclasses.replace(jget(arch).reduced(), dtype="bfloat16")
    tc = dataclasses.replace(tget(arch).reduced(), dtype="bfloat16")
    jparams, _ = JM.init_model(jax.random.key(0), JM.build(jc))
    bridged = bridge.to_torch(to_np(jparams), device="cpu")
    own = TM.init_model(torch.Generator().manual_seed(0), TM.build(tc), device="cpu")
    f32 = {"dt_bias", "A_log", "D", "w_if", "b_if", "w_in", "r", "b"}
    seen = set()
    for tree in (bridged, own):
        for unit in tree["stages"][0]:
            for layer in unit:
                for name, leaf in layer.get("mixer", {}).items():
                    if "shared_attn" in tree and layer is unit[1]:
                        continue
                    want = torch.float32 if name in f32 else torch.bfloat16
                    assert leaf.dtype == want, (name, leaf.dtype)
                    seen.add(name)
    assert seen & f32
    tree_map(lambda t, j: (t.dtype == torch.float32) == (j.dtype == np.float32)
             or pytest.fail(f"{t.dtype} vs {j.dtype}"), bridged, to_np(jparams))


def _same_dtypes(t, j):
    """The port's tree has JAX's dtypes, leaf by leaf."""
    tree_map(lambda a, b: str(a.dtype).replace("torch.", "") == str(b.dtype)
             or pytest.fail(f"{a.dtype} vs {b.dtype}"), t, to_np(j))


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_model_matches_jax_within_its_rounding(arch):
    """The reduced model in bf16, the port's and JAX's from one JAX init.
    bf16 rounds differently in the two (XLA fuses and may skip roundings
    that eager PyTorch makes), so their logits are not held to each other
    at f32's 1e-5 but to JAX's own bf16 rounding: e_jax = max|JAX bf16 -
    JAX f32| on the same weights (cast exactly) and tokens.  The port's
    bf16 logits lie within e_jax of JAX's, and no further from the f32
    logits than 1.25 e_jax; the logits, the prefill caches and the caches
    after a decode step have JAX's dtypes leaf by leaf (the conv tails in
    bf16, SSM, mLSTM and sLSTM states in f32)."""
    jbuilt, jparams, tbuilt, tparams = _models(arch, dtype="bfloat16")
    jb, tb = _batch(tbuilt.cfg)
    j16, _ = jforward_train(jparams, jbuilt, jb)
    t16, _ = TM.forward_train(tparams, tbuilt, tb)
    jbuilt32 = JM.build(dataclasses.replace(jbuilt.cfg, dtype="float32"))
    j32, _ = jforward_train(jax.tree.map(lambda a: a.astype(jnp.float32), jparams),
                            jbuilt32, jb)
    assert str(t16.dtype).replace("torch.", "") == str(j16.dtype)
    t16, j16, j32 = t16.float().numpy(), np.asarray(j16, np.float32), np.asarray(j32)
    e_jax = np.abs(j16 - j32).max()
    assert 0 < e_jax < 0.1 * np.abs(j32).max()
    assert np.abs(t16 - j16).max() <= e_jax
    assert np.abs(t16 - j32).max() <= 1.25 * e_jax
    _, tcache = TM.forward_prefill(tparams, tbuilt, {"tokens": tb["tokens"]})
    _, jcache = jforward_prefill(jparams, jbuilt, {"tokens": jb["tokens"]})
    _same_dtypes(tcache, jcache)
    seq = tb["tokens"].shape[1]
    padded = TM.pad_decode_caches(tbuilt, tcache, seq + 1)
    _, tcache = TM.forward_decode(tparams, tbuilt, tb["tokens"][:, -1:], padded, seq)
    _same_dtypes(tcache, jcache)


# ----------------------------------------------------------------- the bank
BANK_LAYERS = {"xlstm-125m": 4, "zamba2-7b": 6}
PROMPT = np.random.default_rng(3).integers(0, 512, (1, 12)).astype(np.int32)
MAX_LEN, NEW = 24, 4


def _banks(arch):
    cfgs = [dataclasses.replace(get(arch).reduced(), num_layers=BANK_LAYERS[arch])
            for get in (jget, tget)]
    jb = JBank(cfgs[0], 16, wire_mode="int8", seed=0)
    tb = TBank(cfgs[1], 16, wire_mode="int8", seed=0, device="cpu",
               params=bridge.to_torch(to_np(jb.params), device="cpu"),
               butterfly={s: bridge.to_torch(to_np(jb.butterfly_params(s)),
                                             device="cpu")
                          for s in jb.candidates})
    return jb, tb


def _split(runner, params):
    """Edge -> wire -> cloud: (cache0, logits, cache1)."""
    payload, scales, c0 = runner.edge_half(params, PROMPT)
    return (c0, *runner.cloud_half(params, payload, scales))


def _serve(runner, params):
    """NEW tokens by cache handoff in a 2-slot engine and NEW streamed:
    (handoff ids, streamed ids)."""
    c0, logits, c1 = _split(runner, params)
    eng = runner.make_engine(max_batch=2, max_len=MAX_LEN, seed=0)
    req = eng.submit_prefilled(PROMPT.shape[1], [c0, c1], logits[0],
                               max_new_tokens=NEW)
    eng.run()
    # the streamed request's caches: decode writes the port's in place, and
    # its recurrent state is not copied by the padding
    S = PROMPT.shape[1]
    payload, scales, c0 = runner.edge_half(params, PROMPT)
    _, c1s = runner.cloud_half(params, payload, scales)
    c0 = runner.pad_decode_cache(c0, 0, MAX_LEN)
    c1s = runner.pad_decode_cache(c1s, 1, MAX_LEN)
    sreq = eng.submit_streamed(S, logits[0], max_new_tokens=NEW)
    pos = S
    while not sreq.done:
        tok = np.array([[sreq.generated[-1]]], np.int32)
        payload, scales, c0 = runner.edge_step(params, tok, c0,
                                               np.array([pos], np.int32))
        _, c1s = runner.stream_step(eng, sreq, c1s, payload, scales, pos)
        pos += 1
    return req.generated, sreq.generated


@pytest.mark.parametrize("arch", ARCHS)
def test_bank_every_split_matches_jax(arch):
    """Every split of 4-layer xLSTM (units [mLSTM, sLSTM]) and the splits
    of 6-layer reduced zamba2 (units [mamba, shared attn]) that land inside
    a unit (odd splits, which peel).  Edge and cloud caches and cloud logits
    within 1e-5 of JAX's and the reference prefill's greedy token at every
    split tried; at split
    1 (inside the first unit) the engine's handoff and streamed greedy ids
    equal JAX's; the compile-cache keys (exact (B, S): no sequence bucket)
    equal JAX's."""
    jb, tb = _banks(arch)
    assert not tb._seq_bucket_ok and not jb._seq_bucket_ok
    segs = list(tb.built.stages[0])
    assert [(len(s.unit), s.repeats) for s in segs] == \
        [(2, BANK_LAYERS[arch] // 2)]
    splits = tb.candidates if arch == "xlstm-125m" else tb.candidates[::2]
    assert splits[0] == 1
    for split in splits:
        jr, tr = jb.runner(split), tb.runner(split)
        jc0, jl, jc1 = _split(jr, jr.params)
        tc0, tl, tc1 = _split(tr, tr.params)
        _close(tl, jl)
        _close_tree(tc0, jc0)
        _close_tree(tc1, jc1)
        ref, _ = tr.reference_prefill(PROMPT)
        assert int(torch.argmax(tl[0])) == int(torch.argmax(ref[0, -1]))
        peeled = ttfm.range_segments(segs, 0, split)
        assert sum(s.num_layers for s in peeled) == split
        if split == 1:
            th, ts = _serve(tr, tr.params)
            assert (th, ts) == _serve(jr, jr.params)
            assert th[0] == int(torch.argmax(tl[0]))
    assert tb.jit_cache_keys == jb.jit_cache_keys
    assert (tb.cache_hits, tb.cache_misses) == (jb.cache_hits, jb.cache_misses)
    assert {k[4] for k in tb.jit_cache_keys if k[0] in ("edge", "cloud")} == \
        {PROMPT.shape[1]}


def test_engine_slot_reuse_matches_jax():
    """Reduced xlstm in a 2-slot engine (tests/test_engine_and_resnet.py's
    test_engine_slot_reuse): two requests, then a third in a freed slot;
    every request's ids equal JAX's, and the third's equal those of a fresh
    engine, so the reused slot kept no state of its last request."""
    jbuilt, jparams, tbuilt, tparams = _models("xlstm-125m")
    ids = []
    for eng_cls, params, built, kw in (
            (JEngine, jparams, jbuilt, {}),
            (TEngine, tparams, tbuilt, dict(device="cpu"))):
        eng = eng_cls(params, built, max_batch=2, max_len=64, **kw)
        r1 = eng.submit(np.arange(4), max_new_tokens=3)
        r2 = eng.submit(np.arange(5), max_new_tokens=3)
        eng.run()
        r3 = eng.submit(np.arange(6), max_new_tokens=3)
        eng.run()
        assert all(r.done for r in (r1, r2, r3))
        ids.append([r.generated for r in (r1, r2, r3)])
    assert ids[0] == ids[1]
    fresh = TEngine(tparams, tbuilt, max_batch=2, max_len=64, device="cpu")
    r4 = fresh.submit(np.arange(6), max_new_tokens=3)
    fresh.run()
    assert r4.generated == ids[1][2]


# -------------------------------------------------------- flash at hd 112
@pytest.mark.parametrize("causal,window", [(True, None), (True, 32), (False, None)])
def test_plain_flash_hd112_matches_jax_kernel(causal, window):
    """zamba2's head dim through the port's plain flash version (what a CPU
    tensor takes) against JAX's Pallas kernel in interpret mode, at (1, 128,
    4, 4, 112): within 2e-5 (test_torch_flash.py's f32 tolerance)."""
    rng = np.random.default_rng(112)
    q, k, v = (rng.standard_normal((1, 128, 4, 112)).astype(np.float32)
               for _ in range(3))
    out = ops.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                              window=window)
    want = jops.flash_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                                window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
