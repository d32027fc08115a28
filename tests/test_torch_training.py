"""The port's training path against the JAX package's, on the CPU in f32,
with the JAX weights carried across by ``repro_torch.bridge``:

  * the schedules at steps 0-120 within rtol 1e-6 (f32 ``cos`` may differ
    in its last bit);
  * ``adamw_update`` on a tree of f32 and bf16 leaves, stacked ``(reps, d)``
    norms among them, with the clip on and off: params, moments and the
    grad norm within rtol 1e-6 (f32 ``pow`` and sums in another order), the
    bf16 params equal (one rounding of an f32 value that agrees);
  * ``rate_bits``'s value within rtol 1e-6 and its grads, in ``r`` and in
    ``prior_logits``, within 1e-5 of each leaf's largest, at bits 8 and 4,
    on rows whose positive absmax lands on the top symbol;
  * ``lm_loss`` with masked targets within 1e-6;
  * one ``value_and_grad`` of the loss of the reduced qwen3 with a butterfly,
    with and without the rate term: the loss within rtol 1e-6, every grad
    leaf within 2e-5 of its largest entry (f32 sums in another order);
  * 10 ``make_train_step`` steps: losses, grad norms and rate terms within
    rtol 1e-3, the params within 5e-4.  The gap grows as a few wire codes
    flip, and how soon depends on the CPU's sum order: after 10 steps it
    measured 1.2e-5 (params 2.2e-5) at 2 or 8 threads and 1.5e-4 (5.4e-5)
    at 1 or 3;
  * ``remat`` and ``accum_steps=2`` against the plain step: metrics within
    rtol 1e-5, the first step's moments within 1e-5 of each leaf's
    largest, and the kernel path refused;
  * the data streams and checkpoints exactly, both ways;
  * the launcher's logged losses and grad norms (see its test).  The
    quickstart's are held in ``test_torch_train_resnet.py``.
"""
import dataclasses
import re
import runpy
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.wire_codec import rate_bits as jrate_bits
from repro.data import pipeline as JD
from repro.models import model as JM
from repro.training import optimizer as JO, train_loop as JT
from repro.training import checkpoint as JC
from repro_torch import bridge
from repro_torch.configs import get_config as tget_config
from repro_torch.core.wire_codec import rate_bits as trate_bits
from repro_torch.data import pipeline as TD
from repro_torch.models import model as TM
from repro_torch.training import optimizer as TO, train_loop as TT
from repro_torch.training import checkpoint as TC
from repro_torch.tree import tree_leaves, tree_map

ROOT = Path(__file__).resolve().parent.parent


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _cfgs(rate_weight=0.0, vocab=64):
    jc = dataclasses.replace(jget_config("qwen3-8b").reduced(), vocab_size=vocab)
    tc = dataclasses.replace(tget_config("qwen3-8b").reduced(), vocab_size=vocab)
    return (jc.with_butterfly(1, 16, rate_weight=rate_weight),
            tc.with_butterfly(1, 16, rate_weight=rate_weight))


def _models(rate_weight=0.0, seed=0):
    jc, tc = _cfgs(rate_weight)
    jbuilt, tbuilt = JM.build(jc), TM.build(tc)
    jparams, _ = JM.init_model(jax.random.key(seed), jbuilt)
    tparams = bridge.to_torch(jax.tree.map(np.asarray, jparams), device="cpu")
    return jbuilt, jparams, tbuilt, tparams


def _close_tree(tree_t, tree_j, rel):
    """Every leaf within ``rel`` of its JAX leaf's largest entry."""
    def check(t, j):
        j = np.asarray(j, np.float32)
        np.testing.assert_allclose(_np(t), j, rtol=0,
                                   atol=rel * max(float(np.abs(j).max()), 1e-30))
    tree_map(check, tree_t, tree_j)


# ---------------------------------------------------------------------------
# schedules and AdamW
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["cosine", "constant"])
def test_schedules_match_jax(kind):
    if kind == "cosine":
        j, t = JO.cosine_schedule(3e-3, 10, 100), TO.cosine_schedule(3e-3, 10, 100)
    else:
        j, t = JO.constant_schedule(3e-3), TO.constant_schedule(3e-3)
    steps = np.arange(0, 121, dtype=np.int32)
    want = np.array([float(j(jnp.int32(s))) for s in steps], np.float32)
    got = np.array([float(t(torch.tensor(s, dtype=torch.int32))) for s in steps],
                   np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
    assert t(torch.tensor(5, dtype=torch.int32)).dtype == torch.float32


def _opt_tree(seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    b = lambda *s: rng.standard_normal(s).astype(ml_dtypes.bfloat16)
    return {"w": f(8, 6), "norm_stacked": f(3, 6), "final_norm": f(6),
            "conv": f(2, 3, 3, 4), "w_bf16": b(5, 4), "norm_bf16": b(4),
            "stages": [{"wq": f(4, 4)}, {"wq": b(4, 4)}]}


@pytest.mark.parametrize("grad_clip", [1.0, None])
def test_adamw_update_matches_jax(grad_clip):
    """Three updates from fresh state (so the bias correction runs at steps
    1-3), the grads 10x the clip so it bites when it is on."""
    p_np = _opt_tree(0)
    jp = jax.tree.map(jnp.asarray, p_np)
    tp = bridge.to_torch(p_np, device="cpu")
    jo, to = JO.adamw_init(jp), TO.adamw_init(tp)
    jcfg = JO.AdamWConfig(lr=JO.cosine_schedule(1e-2, 2, 10), grad_clip=grad_clip)
    tcfg = TO.AdamWConfig(lr=TO.cosine_schedule(1e-2, 2, 10), grad_clip=grad_clip)
    for i in range(3):
        g_np = jax.tree.map(lambda a: np.asarray(a) * 3, _opt_tree(10 + i))
        jp, jo, jn = JO.adamw_update(jcfg, jp, jax.tree.map(jnp.asarray, g_np), jo)
        tp2, to2, tn = TO.adamw_update(tcfg, tp, bridge.to_torch(g_np, device="cpu"), to)
        assert tp2 is tp and to2 is to                # updated in place
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    assert float(jn) > 10 * (grad_clip or 0)
    assert int(to["step"]) == int(jo["step"]) == 3 and to["step"].dtype == torch.int32

    def same(t, j):
        j = np.asarray(j)
        if j.dtype == ml_dtypes.bfloat16:
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(_np(t), j.astype(np.float32))
        else:
            assert t.dtype == torch.float32
            np.testing.assert_allclose(t.numpy(), j, rtol=1e-6, atol=1e-7)
    tree_map(same, tp, jp)
    for k in ("mu", "nu"):
        tree_map(lambda t, j: np.testing.assert_allclose(
            t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-9), to[k], jo[k])
        assert all(t.dtype == torch.float32 for t in tree_leaves(to[k]))


def test_adamw_decays_what_jax_decays():
    """Weight decay alone (zero grads): every leaf of ndim >= 2 shrinks, the
    stacked (reps, d) norm included; a (d,) leaf does not."""
    tp = {"norm_stacked": torch.ones((3, 6)), "final_norm": torch.ones(6),
          "w": torch.ones((4, 4))}
    cfg = TO.AdamWConfig(lr=TO.constant_schedule(0.1), weight_decay=0.5)
    TO.adamw_update(cfg, tp, tree_map(torch.zeros_like, tp), TO.adamw_init(tp))
    assert torch.all(tp["norm_stacked"] == 0.95) and torch.all(tp["w"] == 0.95)
    assert torch.all(tp["final_norm"] == 1.0)


# ---------------------------------------------------------------------------
# the rate term and the loss
# ---------------------------------------------------------------------------


def _rate_inputs(bits, seed):
    rng = np.random.default_rng(seed)
    qmax = 2 ** (bits - 1) - 1
    r = rng.standard_normal((3, 5, 16)).astype(np.float32)
    # rows whose positive absmax divides to qmax exactly: their top entry
    # sits on the last symbol, where jnp.clip's gradient is 0.5
    r[0] = r[0] / np.abs(r[0]).max(axis=-1, keepdims=True) * qmax
    r[0, :, 3] = qmax
    logits = rng.standard_normal((16, 2 ** bits)).astype(np.float32)
    return r, logits


@pytest.mark.parametrize("with_prior", [False, True])
@pytest.mark.parametrize("bits", [8, 4])
def test_rate_bits_value_and_grads_match_jax(bits, with_prior):
    r, logits = _rate_inputs(bits, bits + 7 * with_prior)
    if with_prior:
        jv, (jg, jl) = jax.value_and_grad(
            lambda r, l: jrate_bits(r, bits, l), argnums=(0, 1))(
                jnp.asarray(r), jnp.asarray(logits))
    else:
        jv, jg = jax.value_and_grad(lambda r: jrate_bits(r, bits))(jnp.asarray(r))
    tr = torch.tensor(r, requires_grad=True)
    tl = torch.tensor(logits, requires_grad=True) if with_prior else None
    tv = trate_bits(tr, bits, tl)
    tv.backward()
    assert tv.dtype == torch.float32 and tv.dim() == 0
    np.testing.assert_allclose(tv.item(), float(jv), rtol=1e-6)
    _close_tree(tr.grad, jg, 1e-5)
    # the top symbol's entries get JAX's half gradient, not torch.clamp's
    np.testing.assert_allclose(tr.grad[0, :, 3].numpy(), np.asarray(jg)[0, :, 3],
                               rtol=1e-5, atol=1e-7)
    if with_prior:
        _close_tree(tl.grad, jl, 1e-5)


def test_lm_loss_matches_jax_with_masked_targets():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32) * 3
    targets = rng.integers(0, 11, (2, 5)).astype(np.int32)
    targets[0, :2] = -1
    targets[1, 4] = -1
    jv, jg = jax.value_and_grad(JM.lm_loss)(jnp.asarray(logits), jnp.asarray(targets))
    tl = torch.tensor(logits, requires_grad=True)
    tv = TM.lm_loss(tl, torch.from_numpy(targets))
    tv.backward()
    np.testing.assert_allclose(tv.item(), float(jv), rtol=1e-6)
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(jg), rtol=0, atol=1e-6)
    none = torch.full((2, 5), -1)
    assert float(TM.lm_loss(tl.detach(), none)) == float(
        JM.lm_loss(jnp.asarray(logits), jnp.asarray(none.numpy()))) == 0.0


# ---------------------------------------------------------------------------
# loss, grads and steps of the reduced qwen3 with a butterfly
# ---------------------------------------------------------------------------


def _batch(vocab=64, seq=32, batch=4, seed=0):
    raw = next(JD.lm_batches(vocab, seq, batch, seed))
    return ({k: jnp.asarray(v) for k, v in raw.items()},
            {k: torch.from_numpy(v) for k, v in raw.items()})


@pytest.mark.parametrize("rate_weight", [0.0, 0.01])
def test_loss_value_and_grad_matches_jax(rate_weight):
    jbuilt, jparams, tbuilt, tparams = _models(rate_weight)
    jbatch, tbatch = _batch()
    (jt, jm), jg = jax.jit(jax.value_and_grad(JT.make_loss_fn(jbuilt),
                                              has_aux=True))(jparams, jbatch)
    (tt, tm), tg = TT.value_and_grad(TT.make_loss_fn(tbuilt))(tparams, tbatch)
    np.testing.assert_allclose(float(tt), float(jt), rtol=1e-6)
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)
    assert (float(tm["wire_rate_bits"]) > 0) == (rate_weight > 0)
    _close_tree(tg, jg, 2e-5)
    assert not any(p.requires_grad for p in tree_leaves(tparams))


def _trajectory(jbuilt, jparams, tbuilt, tparams, steps, **kw):
    jcfg = JO.AdamWConfig(lr=JO.cosine_schedule(1e-3, 3, steps))
    tcfg = TO.AdamWConfig(lr=TO.cosine_schedule(1e-3, 3, steps))
    jstep = jax.jit(JT.make_train_step(jbuilt, jcfg, **kw))
    tstep = TT.make_train_step(tbuilt, tcfg, **kw)
    jo, to = JO.adamw_init(jparams), TO.adamw_init(tparams)
    stream = TD.lm_batches(64, 32, 4, seed=1)
    out = []
    for _ in range(steps):
        raw = next(stream)
        jparams, jo, jm = jstep(jparams, jo, {k: jnp.asarray(v) for k, v in raw.items()})
        tparams, to, tm = tstep(tparams, to, {k: torch.from_numpy(v)
                                              for k, v in raw.items()})
        out.append((jm, tm))
    return jparams, tparams, out


def test_ten_train_steps_track_jax():
    """10 steps on lm_batches with the rate term, from bridged weights."""
    jbuilt, jparams, tbuilt, tparams = _models(0.01)
    jparams, tparams, out = _trajectory(jbuilt, jparams, tbuilt, tparams, 10)
    for jm, tm in out:
        assert set(tm) == set(jm)
        for k in ("loss", "grad_norm", "wire_rate_bits", "total"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-3)
            assert tm[k].dim() == 0
    assert float(out[-1][1]["loss"]) < float(out[0][1]["loss"])
    tree_map(lambda t, j: np.testing.assert_allclose(
        t.numpy(), np.asarray(j), rtol=0, atol=5e-4), tparams, jparams)


@pytest.mark.parametrize("variant", [{"remat": True}, {"accum_steps": 2}],
                         ids=["remat", "accum2"])
def test_remat_and_accumulation_match_the_plain_step(variant):
    """Two steps each way from one init: remat recomputes the same forward;
    two microbatches of 2 average to the 4-row batch's loss and grads (every
    row has the same number of targets).  Metrics within rtol 1e-5; the
    moments after the first step (linear and quadratic in its grads) within
    1e-5 of each leaf's largest.  Later moments and the params are not
    compared: Adam divides each gradient by its own RMS, so an entry whose
    gradient is near zero carries the sums' rounding into its step at up
    to the lr's scale, and the next grads differ by that."""
    _, _, tbuilt, tparams = _models(0.01)
    cfg = TO.AdamWConfig(lr=TO.constant_schedule(1e-3))
    runs = []
    for kw in ({}, variant):
        params = tree_map(torch.clone, tparams)
        opt = TO.adamw_init(params)
        step = TT.make_train_step(tbuilt, cfg, **kw)
        stream = TD.lm_batches(64, 32, 4, seed=2)
        ms, first = [], None
        for _ in range(2):
            ms.append(step(params, opt, {k: torch.from_numpy(v)
                                         for k, v in next(stream).items()})[2])
            first = first or {k: tree_map(torch.clone, opt[k]) for k in ("mu", "nu")}
        runs.append((first, ms))
    (o0, m0), (o1, m1) = runs
    for a, b in zip(m0, m1):
        for k in ("loss", "grad_norm", "wire_rate_bits", "total"):
            np.testing.assert_allclose(float(b[k]), float(a[k]), rtol=1e-5)
    for k in ("mu", "nu"):
        _close_tree(o1[k], tree_map(lambda t: t.numpy(), o0[k]), 1e-5)


def test_training_through_the_kernels_is_refused():
    _, _, tbuilt, _ = _models()
    with pytest.raises(NotImplementedError, match="backward"):
        TT.make_train_step(tbuilt, TO.AdamWConfig(lr=TO.constant_schedule(1e-3)),
                           use_kernel=True)


def test_eval_step_matches_jax():
    jbuilt, jparams, tbuilt, tparams = _models(0.01)
    jbatch, tbatch = _batch(seed=4)
    jm = jax.jit(JT.make_eval_step(jbuilt))(jparams, jbatch)
    tm = TT.make_eval_step(tbuilt)(tparams, tbatch)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)


# ---------------------------------------------------------------------------
# data streams and checkpoints
# ---------------------------------------------------------------------------


def test_lm_batches_equal_jax():
    js, ts = JD.lm_batches(97, 33, 3, seed=5), TD.lm_batches(97, 33, 3, seed=5)
    np.testing.assert_array_equal(ts.next_tokens, js.next_tokens)
    for _ in range(3):
        a, b = next(js), next(ts)
        assert set(a) == set(b) == {"tokens", "targets"}
        for k in a:
            assert b[k].dtype == a[k].dtype == np.int32
            np.testing.assert_array_equal(b[k], a[k])


def test_image_batches_equal_jax():
    cfg = dict(num_classes=7, image_size=16, noise=0.2, seed=3)
    js = JD.image_batches(4, JD.ImageTaskConfig(**cfg), seed=2)
    ts = TD.image_batches(4, TD.ImageTaskConfig(**cfg), seed=2)
    for _ in range(2):
        (jx, jy), (tx, ty) = next(js), next(ts)
        assert tx.dtype == np.float32 and ty.dtype == np.int32
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_checkpoint_restores_in_the_port(tmp_path, dtype):
    """JAX saves params and optimizer state; the port restores them exactly
    (bf16 leaves arrive as 2-byte void arrays)."""
    jc, tc = _cfgs()
    jc, tc = dataclasses.replace(jc, dtype=dtype), dataclasses.replace(tc, dtype=dtype)
    jbuilt, tbuilt = JM.build(jc), TM.build(tc)
    jparams, _ = JM.init_model(jax.random.key(1), jbuilt)
    jopt = JO.adamw_init(jparams)
    jopt = dict(jopt, mu=jax.tree.map(lambda a: a + 0.5, jopt["mu"]),
                step=jnp.int32(7))
    path = JC.save_checkpoint(str(tmp_path / "jax"), jparams, jopt, step=7,
                              metadata={"arch": jc.name})
    tparams = TM.init_model(torch.Generator().manual_seed(0), tbuilt, device="cpu")
    params, opt, meta = TC.restore_checkpoint(path, tparams, TO.adamw_init(tparams))
    assert meta == {"arch": jc.name, "step": 7}
    want = jax.tree.map(lambda a: np.asarray(a).astype(np.float32), jparams)
    tree_map(lambda t, j: np.testing.assert_array_equal(_np(t), j), params, want)
    assert all(t.dtype == getattr(torch, dtype) for t in tree_leaves(params))
    tree_map(lambda t, j: np.testing.assert_array_equal(t.numpy(), np.asarray(j)),
             opt, jopt)
    assert opt["step"].dtype == torch.int32


def test_port_checkpoint_restores_in_jax(tmp_path):
    """The port saves f32 params and optimizer state; JAX's restore gives
    them back exactly; a bf16 port checkpoint stores V2 leaves as JAX does,
    and the port's restore rejects a template of another shape."""
    jbuilt, jparams, tbuilt, tparams = _models(seed=2)
    topt = TO.adamw_init(tparams)
    topt["nu"] = tree_map(lambda t: t + 0.25, topt["nu"])
    path = TC.save_checkpoint(str(tmp_path / "port"), tparams, topt, step=3)
    params, opt, meta = JC.restore_checkpoint(path, jparams, JO.adamw_init(jparams))
    assert meta == {"step": 3}
    tree_map(lambda t, j: np.testing.assert_array_equal(np.asarray(j), t.numpy()),
             tparams, params)
    tree_map(lambda t, j: np.testing.assert_array_equal(np.asarray(j), t.numpy()),
             topt, opt)

    bf = tree_map(lambda t: t.to(torch.bfloat16), tparams)
    path = TC.save_checkpoint(str(tmp_path / "bf16"), bf)
    with np.load(path) as data:
        assert data["params/embed"].dtype == np.dtype("V2")
    back, _, _ = TC.restore_checkpoint(path, bf)
    tree_map(lambda a, b: np.testing.assert_array_equal(_np(a), _np(b)), bf, back)
    wrong = dict(tparams, final_norm=torch.zeros(3))
    with pytest.raises(ValueError, match="final_norm"):
        TC.restore_checkpoint(path, wrong)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

LAUNCH_ARGS = ["--steps", "12", "--batch", "4", "--seq", "32", "--vocab", "64",
               "--butterfly-layer", "1", "--d-r", "16", "--log-every", "4"]
STEP_LINE = re.compile(r"step +(\d+) loss ([\d.]+) gnorm ([\d.]+) tok/s")


def _steps(out):
    return [tuple(float(x) for x in m.groups())
            for m in map(STEP_LINE.search, out.splitlines()) if m]


@pytest.mark.parametrize("arch", [None, "pixtral-12b", "whisper-base"])
def test_launcher_matches_jax(arch, tmp_path, monkeypatch, capsys):
    """``repro_torch.launch.train --device cpu``, its init replaced by the
    params JAX's launcher draws (its key 0), logs what JAX's launcher logs
    with the same flags: the same header, steps 0/4/8/11, losses within 2e-4
    and grad norms within 0.011 as printed (4 and 2 decimals); its
    checkpoint holds the step count and arch.  The default arch (reduced
    qwen3-8b), and reduced pixtral (zero patches before the tokens, their
    targets -1) and whisper (zero frames), as JAX's launcher feeds them."""
    args = LAUNCH_ARGS + ([] if arch is None else ["--arch", arch, "--reduced"])
    monkeypatch.setattr(sys, "argv", ["train", *args])
    runpy.run_module("repro.launch.train", run_name="__main__")
    jout = capsys.readouterr().out
    if arch is None:
        jc, _ = _cfgs()
    else:
        jc = dataclasses.replace(jget_config(arch).reduced(),
                                 vocab_size=64).with_butterfly(1, 16)
    jparams, _ = JM.init_model(jax.random.key(0), JM.build(jc))
    tparams = bridge.to_torch(jax.tree.map(np.asarray, jparams), device="cpu")
    monkeypatch.setattr(TM, "init_model", lambda *a, **k: tparams)
    from repro_torch.launch import train as tlaunch
    tlaunch.main([*args, "--device", "cpu",
                  "--checkpoint", str(tmp_path / "out")])
    tout = capsys.readouterr().out
    assert tout.splitlines()[0] == jout.splitlines()[0]
    jsteps, tsteps = _steps(jout), _steps(tout)
    assert [s[0] for s in tsteps] == [s[0] for s in jsteps] == [0, 4, 8, 11]
    for (_, tl, tg), (_, jl, jg) in zip(tsteps, jsteps):
        assert abs(tl - jl) <= 2e-4 and abs(tg - jg) <= 0.011, (tsteps, jsteps)
    _, _, meta = TC.restore_checkpoint(str(tmp_path / "out"), tparams)
    assert meta == {"arch": jc.name, "step": 12}
