"""The port's ResNet training and its two training examples against the JAX
package's, on the CPU in f32, with the JAX params carried across by
``bridge.resnet_to_torch`` (HWIO conv kernels -> OIHW):

  * ``forward_resnet``'s cross entropy within rtol 1e-6 and its grads, the
    butterfly's through the straight-through wire included, within 2e-5 of
    each leaf's largest entry (f32 convs sum in another order);
  * 5 AdamW steps of ``train_resnet_butterfly.make_resnet_step`` against the
    JAX example's step: losses and grad norms within rtol 1e-4, the first
    step's moments within 2e-5 of each leaf's largest;
  * the example's Algorithm 1 selection equal to the JAX example's, and its
    ``main`` printing the same selection lines;
  * the quickstart's logged losses within 2e-3 of the JAX example's
    (ROADMAP's training gate).
"""
import dataclasses
import re
import runpy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.resnet50 import resnet50 as jresnet50
from repro.models import model as JM
from repro.models import resnet as JR
from repro.training import optimizer as JO
from repro_torch import bridge
from repro_torch.configs.resnet50 import resnet50
from repro_torch.data import ImageTaskConfig, image_batches
from repro_torch.examples import train_resnet_butterfly as EX
from repro_torch.models import model as TM
from repro_torch.training import optimizer as TO
from repro_torch.training.train_loop import value_and_grad
from repro_torch.tree import tree_leaves, tree_map

ROOT = Path(__file__).resolve().parent.parent


def _hwio(t):
    """A port grad or param back in the JAX layout (OIHW -> HWIO)."""
    a = t.detach().numpy()
    return np.transpose(a, (2, 3, 1, 0)) if a.ndim == 4 else a


def _close_tree(tree_t, tree_j, rel):
    def check(t, j):
        j = np.asarray(j)
        np.testing.assert_allclose(_hwio(t), j, rtol=0,
                                   atol=rel * max(float(np.abs(j).max()), 1e-30))
    tree_map(check, tree_t, tree_j)


def _jax_loss(params, x, y, cfg):
    """The JAX example's loss (examples/train_resnet_butterfly.py)."""
    logp = jax.nn.log_softmax(JR.forward_resnet(params, x, cfg, train=True))
    return -jnp.mean(jnp.take_along_axis(logp, y[:, None], -1))


def _models(butterfly, seed=0):
    jc, tc = jresnet50().reduced(), resnet50().reduced()
    if butterfly is not None:
        jc, tc = jc.with_butterfly(*butterfly), tc.with_butterfly(*butterfly)
    jparams = JR.init_resnet(jax.random.key(seed), jc)
    tparams = bridge.resnet_to_torch(jax.tree.map(np.asarray, jparams), device="cpu")
    return jc, jparams, tc, tparams


def _batches(cfg, n, batch=8):
    stream = image_batches(batch, ImageTaskConfig(num_classes=cfg.num_classes,
                                                  image_size=cfg.image_size))
    return [next(stream) for _ in range(n)]


@pytest.mark.parametrize("butterfly", [None, (1, 2), (2, 4)],
                         ids=["plain", "RB1-d_r2", "RB2-d_r4"])
def test_loss_and_grads_match_jax(butterfly):
    jc, jparams, tc, tparams = _models(butterfly)
    (x, y), = _batches(tc, 1)
    jv, jg = jax.jit(jax.value_and_grad(_jax_loss), static_argnums=3)(
        jparams, jnp.asarray(x), jnp.asarray(y), jc)
    (tv, _), tg = value_and_grad(EX.resnet_loss)(
        tparams, torch.from_numpy(x), torch.from_numpy(y), tc)
    np.testing.assert_allclose(float(tv), float(jv), rtol=1e-6)
    _close_tree(tg, jg, 2e-5)
    if butterfly is not None:
        assert float(tg["butterfly"]["reduce"].abs().max()) > 0
        assert float(tg["stem"].abs().max()) > 0


def test_five_adamw_steps_match_jax():
    """The example's step (lr 1e-3, weight decay 1e-4) on 5 batches of 8,
    the butterfly after RB1 at d_r 2, against the JAX example's step."""
    jc, jparams, tc, tparams = _models((1, 2))
    jcfg = JO.AdamWConfig(lr=JO.constant_schedule(1e-3), weight_decay=1e-4)
    tcfg = TO.AdamWConfig(lr=TO.constant_schedule(1e-3), weight_decay=1e-4)

    @jax.jit
    def jstep(p, o, x, y):
        l, g = jax.value_and_grad(_jax_loss)(p, x, y, jc)
        p, o, n = JO.adamw_update(jcfg, p, g, o)
        return p, o, l, n

    tstep = EX.make_resnet_step(tc, tcfg)
    jo, to = JO.adamw_init(jparams), TO.adamw_init(tparams)
    for i, (x, y) in enumerate(_batches(tc, 5)):
        jparams, jo, jl, jn = jstep(jparams, jo, jnp.asarray(x), jnp.asarray(y))
        tparams, to, tl, tn = tstep(tparams, to, torch.from_numpy(x),
                                    torch.from_numpy(y))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-4)
        if i == 0:
            for k in ("mu", "nu"):
                _close_tree(to[k], jo[k], 2e-5)
    assert all(t.dtype == torch.float32 for t in tree_leaves(tparams))


def _jax_selection():
    """The JAX example's profiling and selection, as it computes them."""
    from repro.configs.resnet50 import PAPER_MIN_DR
    from repro.core import costs
    from repro.core.planner import (TrainingPhaseResult, profiling_phase,
                                    selection_phase)
    from repro.core.profiler import GTX_1080TI, JETSON_TX2
    from repro.core.wireless import NETWORKS
    full = jresnet50()

    def split_costs(split, d_r):
        ef, cf, wire = costs.resnet_split_flops(full, split, d_r)
        return ef, ef / 10, cf, cf / 10, wire

    trained = [TrainingPhaseResult(s, PAPER_MIN_DR[s], 0.74) for s in range(1, 17)]
    profiles = profiling_phase(trained, split_costs, JETSON_TX2, GTX_1080TI)
    return {(name, obj): selection_phase(profiles, net, obj)
            for name, net in NETWORKS.items() for obj in ("latency", "energy")}


def test_algorithm1_selection_matches_jax():
    want, got = _jax_selection(), EX.algorithm1_selection()
    assert list(got) == list(want)
    for key, sel in want.items():
        g = got[key]
        assert (g.split, g.d_r, g.latency_s, g.energy_mj, g.objective,
                g.network) == (sel.split, sel.d_r, sel.latency_s, sel.energy_mj,
                               sel.objective, sel.network)


def test_resnet_example_prints_the_jax_selection(capsys):
    """The example's main at one step a model: every (split, D_r) trains and
    scores an accuracy, and the selection lines equal the JAX example's."""
    EX.main(["--steps", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    accs = [float(a) for a in re.findall(r"D_r=\d+: ([\d.]+)", out)]
    assert len(accs) == 8 and all(0.0 <= a <= 1.0 for a in accs)
    assert len(re.findall(r"minimal D_r for RB\d", out)) == 2
    want = [f"  {n:5s} {o:8s}: split after RB{s.split} (D_r={s.d_r})  latency "
            f"{s.latency_s*1e3:.2f} ms  energy {s.energy_mj:.2f} mJ"
            for (n, o), s in _jax_selection().items()]
    assert out.rstrip("\n").split("\n")[-6:] == want


def test_quickstart_tracks_jax(capsys, monkeypatch):
    """ROADMAP's training gate: the port's quickstart, its init replaced by
    the params JAX's quickstart draws (its key 0), logs losses at steps
    0/20/40/60/79 within 2e-3 of the JAX example's: those are printed to 3
    decimals (5e-4), and f32 sums in another order flip a few wire codes
    over 80 steps (about 2e-4 by step 40).  Then it round-trips its
    checkpoint and serves three requests of 12 tokens."""
    step_line = re.compile(r"step +(\d+) loss ([\d.]+)")
    runpy.run_path(str(ROOT / "examples" / "quickstart.py"), run_name="__main__")
    jlog = [(int(a), float(b)) for a, b in step_line.findall(capsys.readouterr().out)]
    jcfg = dataclasses.replace(jget_config("qwen3-8b").reduced(), vocab_size=128)
    jparams, _ = JM.init_model(jax.random.key(0),
                               JM.build(jcfg.with_butterfly(layer=1, d_r=16)))
    tparams = bridge.to_torch(jax.tree.map(np.asarray, jparams), device="cpu")
    monkeypatch.setattr(TM, "init_model", lambda *a, **k: tparams)
    from repro_torch.examples import quickstart
    quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    tlog = [(int(a), float(b)) for a, b in step_line.findall(out)]
    assert [s for s, _ in tlog] == [s for s, _ in jlog] == [0, 20, 40, 60, 79]
    for (_, tl), (_, jl) in zip(tlog, jlog):
        assert abs(tl - jl) <= 2e-3, (tlog, jlog)
    assert "checkpoint restored: {'step': 80}" in out
    generated = re.findall(r"request \d+: generated \[([\d, ]+)\]", out)
    assert [len(g.split(", ")) for g in generated] == [12, 12, 12]
    assert all(0 <= int(t) < 128 for g in generated for t in g.split(", "))
