"""The port's mixture-of-experts layer (``repro_torch/models/moe.py``) and
its model paths against the JAX package, in f32 on the CPU with the JAX
weights carried across by ``repro_torch.bridge``.

  * the counterparts of ``tests/test_moe.py``'s six tests, each held to
    JAX's ``apply_moe`` on the same weights and inputs: first the expert ids
    and capacity slots (equal; JAX's are recomputed by ``_jax_route``, the
    routing lines of ``repro.models.moe._moe_shard``), then the output
    within rtol/atol 1e-5 (f32 GEMMs summed in another order) and the aux
    losses within rtol 1e-6; the dense per-token oracle of
    ``test_moe.py`` within its 2e-4 (5e-4 for the dispatch property);
  * ties: a zero router makes every probability equal, and the port picks
    the lower expert id first, as ``lax.top_k`` does;
  * forced routes (``route``'s ``forced``, which the card's reference wire
    uses to route as the kernel path did) equal to the computed ones give
    the same output and aux losses, bit for bit;
  * a bf16 tree: the f32 router survives the bridge and the layer, the
    expert ids equal JAX's;
  * interleaved llama4 (reduced, 4 layers, ``every=2``: a [dense, moe]
    unit repeated twice): logits within 1e-5, aux within rtol 1e-6, and
    prefill + greedy decode within 1e-4 of JAX's with equal tokens;
  * the MoE split bank and serving engine at the JAX bank's default
    capacity, where choices are dropped: the edge-cloud prefill and the
    engine's greedy tokens (cache handoff, with an empty slot competing
    for capacity; and streamed) equal JAX's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import model as JM
from repro.models import moe as jmoe
from repro.models.parallel import LOCAL
from repro.runtime.split_exec import SplitModelBank as JBank
from repro_torch import bridge
from repro_torch.configs import get_config as tget
from repro_torch.models import model as TM
from repro_torch.models import moe as tmoe
from repro_torch.runtime.split_exec import SplitModelBank as TBank

QWEN, LLAMA = "qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b"


def _cfgs(arch=QWEN, **moe_kw):
    out = []
    for get in (jget, tget):
        c = get(arch).reduced()
        out.append(dataclasses.replace(c, moe=dataclasses.replace(c.moe, **moe_kw)))
    return out


def _layer(jcfg, dtype=jnp.float32):
    jp, _ = jmoe.init_moe(jax.random.key(0), jcfg, dtype)
    return jp, bridge.to_torch(jax.tree.map(np.asarray, jp), device="cpu")


def _x(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _jax_route(x_flat, router, m, capacity):
    """Expert ids and capacity slots as ``repro.models.moe._moe_shard``
    computes them (its routing lines, in jnp)."""
    T, k = x_flat.shape[0], m.top_k
    probs = jax.nn.softmax(x_flat.astype(jnp.float32) @ router, axis=-1)
    _, eids = jax.lax.top_k(probs, k)
    flat_e = eids.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    se = flat_e[order]
    group_start = jnp.searchsorted(se, jnp.arange(m.num_experts))
    pos_sorted = jnp.arange(T * k) - group_start[se]
    inv = jnp.zeros_like(order).at[order].set(jnp.arange(T * k))
    return np.asarray(eids), np.asarray(pos_sorted[inv].reshape(T, k))


def _dense_oracle(p, x, m):
    """test_moe.py's per-token loop: every token through its top-k experts."""
    d = x.shape[-1]
    xf = x.reshape(-1, d).astype(np.float64)
    router, wg, wu, wd = (np.asarray(p[k], np.float64) for k in ("router", "wg", "wu", "wd"))
    logits = xf @ router
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    out = np.zeros_like(xf)
    for t in range(xf.shape[0]):
        eids = np.argsort(-probs[t], kind="stable")[:m.top_k]
        gate = probs[t, eids] / probs[t, eids].sum()
        for g_j, e in zip(gate, eids):
            g, u = xf[t] @ wg[e], xf[t] @ wu[e]
            out[t] += g_j * ((g / (1 + np.exp(-g)) * u) @ wd[e])
    return out.reshape(x.shape)


def _both(jcfg, tcfg, jp, tp, x):
    """Run both layers on ``x``; hold the routing, the output and the aux
    losses to JAX's.  Returns (port out, JAX out, port aux, slots)."""
    B, S, d = x.shape
    cap = jmoe._capacity(B * S, jcfg.moe)
    assert tmoe._capacity(B * S, tcfg.moe) == cap
    je, jpos = _jax_route(jnp.asarray(x.reshape(-1, d)), jp["router"], jcfg.moe, cap)
    *_, te, tpos, tdst = tmoe.route(torch.from_numpy(x.reshape(-1, d)),
                                    tp["router"], tcfg.moe, cap)
    np.testing.assert_array_equal(te.numpy(), je)
    np.testing.assert_array_equal(tpos.numpy(), jpos)
    E = tcfg.moe.num_experts
    want_dst = np.where(jpos < cap, je * cap + jpos, E * cap)
    np.testing.assert_array_equal(tdst.numpy(), want_dst)
    jout, jaux = jax.jit(lambda p, xx: jmoe.apply_moe(
        p, xx, cfg=jcfg, pctx=LOCAL, act=jcfg.act))(jp, jnp.asarray(x))
    tout, taux = tmoe.apply_moe(tp, torch.from_numpy(x), cfg=tcfg, act=tcfg.act)
    assert tout.shape == x.shape and tout.dtype == torch.float32
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)
    for k in ("load_balance", "router_z"):
        assert taux[k].dim() == 0 and taux[k].dtype == torch.float32
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=1e-6)
    return tout.numpy(), np.asarray(jout), taux, (tpos.numpy(), cap)


def test_matches_jax_and_dense_oracle_no_drop():
    jcfg, tcfg = _cfgs(top_k=2, num_experts=4, capacity_factor=100.0)
    jp, tp = _layer(jcfg)
    x = _x((2, 8, tcfg.d_model), 1, 0.5)
    out, _, _, (pos, cap) = _both(jcfg, tcfg, jp, tp, x)
    assert int(pos.max()) < cap                      # nothing dropped
    np.testing.assert_allclose(out, _dense_oracle(tp, x, tcfg.moe),
                               rtol=2e-4, atol=2e-4)


def test_capacity_dropping_matches_jax():
    """capacity_factor ~0 leaves one slot an expert: JAX and the port drop
    the same choices, and the output shrinks."""
    jcfg, tcfg = _cfgs(top_k=1, num_experts=4, capacity_factor=100.0)
    jp, tp = _layer(jcfg)
    x = _x((2, 16, tcfg.d_model), 2)
    full, *_ = _both(jcfg, tcfg, jp, tp, x)
    jt, tt = _cfgs(top_k=1, num_experts=4, capacity_factor=1e-9)
    tight, _, _, (pos, cap) = _both(jt, tt, jp, tp, x)
    assert cap == 1 and int((pos >= cap).sum()) >= 32 - 4
    assert np.abs(tight).mean() < np.abs(full).mean()


def test_aux_losses_match_jax():
    jcfg, tcfg = _cfgs()
    jp, tp = _layer(jcfg)
    _, _, aux, _ = _both(jcfg, tcfg, jp, tp, _x((2, 8, tcfg.d_model), 3))
    assert float(aux["load_balance"]) > 0 and float(aux["router_z"]) >= 0


def test_balanced_router_breaks_ties_as_jax():
    """A zero router: every probability 1/E, every top-k a tie, resolved to
    the lowest expert ids as ``lax.top_k`` resolves it; the load-balance
    loss is then exactly its coefficient."""
    jcfg, tcfg = _cfgs(top_k=1, num_experts=4)
    jp, tp = _layer(jcfg)
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    tp = dict(tp, router=torch.zeros_like(tp["router"]))
    x = _x((4, 64, tcfg.d_model), 4)
    _, _, aux, _ = _both(jcfg, tcfg, jp, tp, x)
    *_, eids, _, _ = tmoe.route(torch.from_numpy(x.reshape(-1, tcfg.d_model)),
                                tp["router"], tcfg.moe, 4)
    assert bool((eids == 0).all())
    lb = float(aux["load_balance"]) / tcfg.moe.load_balance_coef
    assert lb == pytest.approx(1.0, rel=1e-6)


@pytest.mark.parametrize("top_k", [1, 2, 3, 4])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dispatch_conservation(top_k, seed):
    """Every kept (token, choice) contributes gate_j * expert(x_t): the
    port equals JAX and the dense oracle (test_moe.py's property, at
    fixed seeds)."""
    jcfg, tcfg = _cfgs(top_k=top_k, num_experts=4, capacity_factor=100.0)
    jp, tp = _layer(jcfg)
    x = _x((1, 8, tcfg.d_model), 10 + seed, 0.3)
    out, *_ = _both(jcfg, tcfg, jp, tp, x)
    np.testing.assert_allclose(out, _dense_oracle(tp, x, tcfg.moe),
                               rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("capacity_factor", [100.0, 0.5])
def test_forced_routes_equal_to_the_computed_ones_change_nothing(
        capacity_factor, monkeypatch):
    """``route(..., forced=(eids, pos))`` with a run's own routes gives that
    run's output and aux losses bit for bit (with and without dropped
    choices); other forced routes are taken as given."""
    _, tcfg = _cfgs(top_k=2, num_experts=4, capacity_factor=capacity_factor)
    _, tp = _layer(_cfgs(top_k=2, num_experts=4)[0])
    x = torch.from_numpy(_x((2, 16, tcfg.d_model), 6, 0.5))
    routes, route = [], tmoe.route

    def record(x_flat, router, mcfg, capacity, forced=None):
        out = route(x_flat, router, mcfg, capacity, forced)
        routes.append((out[3], out[4]))
        return out
    monkeypatch.setattr(tmoe, "route", record)
    out, aux = tmoe.apply_moe(tp, x, cfg=tcfg, act=tcfg.act)
    (eids, pos), = routes
    if capacity_factor < 2:
        assert int((pos >= tmoe._capacity(32, tcfg.moe)).sum()) > 0

    def forcing(given):
        return lambda x_flat, router, mcfg, capacity, forced=None: route(
            x_flat, router, mcfg, capacity, given)
    monkeypatch.setattr(tmoe, "route", forcing((eids, pos)))
    again, aux2 = tmoe.apply_moe(tp, x, cfg=tcfg, act=tcfg.act)
    assert torch.equal(out, again)
    assert all(torch.equal(aux[k], aux2[k]) for k in aux)
    other = (eids + 1) % tcfg.moe.num_experts
    *_, e, p, _ = route(x.reshape(-1, tcfg.d_model), tp["router"], tcfg.moe,
                        8, forced=(other, pos))
    assert torch.equal(e, other) and torch.equal(p, pos)
    monkeypatch.setattr(tmoe, "route", forcing((other, pos)))
    moved, _ = tmoe.apply_moe(tp, x, cfg=tcfg, act=tcfg.act)
    assert not torch.equal(moved, out)


def test_shared_expert_matches_jax():
    jcfg, tcfg = _cfgs(LLAMA, capacity_factor=100.0)
    assert tcfg.moe.shared_expert_ff > 0
    jp, tp = _layer(jcfg)
    assert set(tp["shared"]) == {"w_gate", "w_up", "w_down"}
    x = _x((1, 4, tcfg.d_model), 5, 0.3)
    with_shared, *_ = _both(jcfg, tcfg, jp, tp, x)
    jn, tn = _cfgs(LLAMA, capacity_factor=100.0, shared_expert_ff=0)
    without, *_ = _both(jn, tn, jp, tp, x)
    assert np.abs(with_shared - without).max() > 1e-6


def test_bf16_tree_keeps_the_f32_router():
    """JAX keeps the router f32 in a bf16 model; the bridge and the port's
    init keep it so, and the bf16 layer routes as JAX's does."""
    jcfg, tcfg = (dataclasses.replace(c, dtype="bfloat16") for c in _cfgs())
    jp, tp = _layer(jcfg, jnp.bfloat16)
    assert tp["router"].dtype == torch.float32
    assert {tp[k].dtype for k in ("wg", "wu", "wd")} == {torch.bfloat16}
    gen = torch.Generator().manual_seed(0)
    init = tmoe.init_moe(gen, tcfg, torch.bfloat16, "cpu")
    assert init["router"].dtype == torch.float32 and init["wg"].dtype == torch.bfloat16
    assert {k: tuple(v.shape) for k, v in init.items()} == \
        {k: tuple(v.shape) for k, v in tp.items()}
    x = _x((2, 8, tcfg.d_model), 6).astype(jnp.bfloat16)
    cap = tmoe._capacity(16, tcfg.moe)
    je, jpos = _jax_route(jnp.asarray(x.reshape(16, -1)), jp["router"], jcfg.moe, cap)
    xt = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    *_, te, tpos, _ = tmoe.route(xt.reshape(16, -1), tp["router"], tcfg.moe, cap)
    np.testing.assert_array_equal(te.numpy(), je)
    np.testing.assert_array_equal(tpos.numpy(), jpos)
    out, aux = tmoe.apply_moe(tp, xt, cfg=tcfg, act=tcfg.act)
    assert out.dtype == torch.bfloat16 and aux["router_z"].dtype == torch.float32


# --------------------------------------------------------------- the model
TOKS = np.random.default_rng(0).integers(0, 512, (2, 12)).astype(np.int32)


def _interleaved(capacity_factor=None):
    """Reduced llama4 at 4 layers with MoE every 2nd layer (reduced() sets
    every=1): a [dense, moe] unit repeated twice."""
    out = []
    for get in (jget, tget):
        c = get(LLAMA).reduced()
        m = dataclasses.replace(c.moe, every=2)
        if capacity_factor:
            m = dataclasses.replace(m, capacity_factor=capacity_factor)
        out.append(dataclasses.replace(c, num_layers=4, moe=m))
    return out


def test_interleaved_llama4_matches_jax():
    jc, tc = _interleaved()
    jbuilt, tbuilt = JM.build(jc), TM.build(tc)
    (seg,) = tbuilt.stages[0]
    assert [d.ffn for d in seg.unit] == ["mlp", "moe"] and seg.repeats == 2
    assert [[d.ffn for d in s.unit] for s in jbuilt.stages[0]] == [["mlp", "moe"]]
    jparams, _ = JM.init_model(jax.random.key(0), jbuilt)
    tparams = bridge.to_torch(jax.tree.map(np.asarray, jparams), device="cpu")
    jl, jaux = JM.forward_train(jparams, jbuilt, {"tokens": jnp.asarray(TOKS)})
    tl, taux = TM.forward_train(tparams, tbuilt, {"tokens": torch.from_numpy(TOKS)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)
    for k in ("load_balance", "router_z"):
        assert float(taux[k]) > 0
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=1e-6)


def test_interleaved_llama4_prefill_decode_matches_jax():
    """Prefill 12 tokens, then 4 greedy decode steps from caches padded by
    4 rows, in both packages (default capacity: decode rows compete)."""
    jc, tc = _interleaved()
    jbuilt, tbuilt = JM.build(jc), TM.build(tc)
    jparams, _ = JM.init_model(jax.random.key(0), jbuilt)
    tparams = bridge.to_torch(jax.tree.map(np.asarray, jparams), device="cpu")
    jl, jcache = JM.forward_prefill(jparams, jbuilt, {"tokens": jnp.asarray(TOKS)})
    tl, tcache = TM.forward_prefill(tparams, tbuilt, {"tokens": torch.from_numpy(TOKS)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)
    pad = lambda a: np.pad(np.asarray(a), [(0, 0), (0, 0), (0, 4), (0, 0), (0, 0)])
    jcache = jax.tree.map(lambda a: jnp.asarray(pad(a)), jcache)
    tcache = TM.pad_decode_caches(tbuilt, tcache, 16)
    jtok = np.asarray(jnp.argmax(jl[:, -1], axis=-1), np.int32)[:, None]
    ttok = tl[:, -1].argmax(-1, keepdim=True)
    for pos in range(12, 16):
        assert ttok.numpy().tolist() == jtok.tolist()
        jl, jcache = JM.forward_decode(jparams, jbuilt, jnp.asarray(jtok), jcache, pos)
        tl, tcache = TM.forward_decode(tparams, tbuilt, ttok, tcache, pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)
        jtok = np.asarray(jnp.argmax(jl[:, -1], axis=-1), np.int32)[:, None]
        ttok = tl[:, -1].argmax(-1, keepdim=True)


# ---------------------------------------------------------------- the bank
@pytest.mark.parametrize("arch", [QWEN, LLAMA])
def test_moe_bank_and_engine_match_jax(arch, monkeypatch):
    """Reduced 4-layer MoE at the JAX bank's default capacity (1.25), split
    after layer 2, d_r 16, int8 wire: two prompts of 13 and 9 tokens go
    edge_half -> wire -> cloud_half (the 13-token one padded to 16 rows,
    which compete for capacity in both packages) and decode 5 tokens
    together in a 3-slot engine, its empty slot in the batch; a third
    decodes 4 tokens streamed.  Greedy tokens equal JAX's; some choices
    are dropped on the way."""
    cfgs = [dataclasses.replace(get(arch).reduced(), num_layers=4) for get in (jget, tget)]
    split = 2
    jb = JBank(cfgs[0], 16, wire_mode="int8", seed=0)
    to_np = lambda t: jax.tree.map(np.asarray, t)
    tb = TBank(cfgs[1], 16, wire_mode="int8", seed=0, device="cpu",
               params=bridge.to_torch(to_np(jb.params), device="cpu"),
               butterfly={split: bridge.to_torch(to_np(jb.butterfly_params(split)),
                                                 device="cpu")})
    assert not tb.batch_numerics_ok and not jb._batch_bucket_ok
    dropped = []
    route = tmoe.route

    def counting_route(x_flat, router, mcfg, capacity):
        out = route(x_flat, router, mcfg, capacity)
        dropped.append(int((out[4] >= capacity).sum()))
        return out
    monkeypatch.setattr(tmoe, "route", counting_route)

    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 512, (1, n)).astype(np.int32) for n in (13, 9, 11)]
    got = []
    for runner in (jb.runner(split), tb.runner(split)):
        eng = runner.make_engine(max_batch=3, max_len=24, seed=0)
        reqs, logits0 = [], []
        for p in prompts[:2]:
            payload, scales, c0 = runner.edge_half(runner.params, p)
            logits, c1 = runner.cloud_half(runner.params, payload, scales)
            logits0.append(np.asarray(logits))
            reqs.append(eng.submit_prefilled(p.shape[1], [c0, c1], logits[0],
                                             max_new_tokens=5))
        eng.run()
        # streamed: the edge keeps its cache, one wire row a token
        p = prompts[2]
        S = p.shape[1]
        payload, scales, c0 = runner.edge_half(runner.params, p)
        logits, c1 = runner.cloud_half(runner.params, payload, scales)
        c0, c1 = runner.pad_decode_cache(c0, 0, 24), runner.pad_decode_cache(c1, 1, 24)
        sreq = eng.submit_streamed(S, logits[0], max_new_tokens=4)
        pos = S
        while not sreq.done:
            payload, scales, c0 = runner.edge_step(runner.params,
                                                   [[sreq.generated[-1]]], c0, [pos])
            _, c1 = runner.stream_step(eng, sreq, c1, payload, scales, pos)
            pos += 1
        got.append(([r.generated for r in reqs], sreq.generated, logits0))
    (jt, js, jl), (tt, ts, tl) = got
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
    assert tt == jt and ts == js
    assert all(len(g) == 5 for g in tt) and len(ts) == 4
    assert sum(dropped) > 0
