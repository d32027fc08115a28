"""The port's split bank against the JAX bank (``repro/runtime/split_exec``)
with the JAX backbone and butterflies carried across by the bridge, at the
reduced 4-layer qwen3-8b config in f32, d_r=16, for splits 1 and 2 and the
wire modes raw / reduced / int8 / int4:

  * ``edge_half`` codes equal (at most 1 apart on at most 0.1% of entries,
    rounded up to a whole entry), scales within rtol 1e-5;
  * ``cloud_half`` logits within 1e-4 on the same payload;
  * greedy tokens of ``submit_prefilled`` + ``run`` (cache handoff) and of
    streamed ``edge_step`` / ``stream_step`` identical to JAX's
    (mirroring ``tests/test_runtime.py`` cache-injection parity);
  * the compile-cache keys and hit/miss counts equal.
"""
import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.runtime.split_exec import SplitModelBank as JBank
from repro_torch import bridge
from repro_torch.configs import get_config as tget_config
from repro_torch.core.quantization import unpack_int4
from repro_torch.runtime.split_exec import SplitModelBank as TBank
from repro_torch.tree import tree_leaves

D_R = 16
SPLITS = (1, 2)
WIRE_MODES = ("raw", "reduced", "int8", "int4")
PROMPT = np.random.default_rng(7).integers(0, 512, (1, 13)).astype(np.int32)
MAX_LEN, NEW = 24, 4


def _cfgs():
    return (dataclasses.replace(jget_config("qwen3-8b").reduced(), num_layers=4),
            dataclasses.replace(tget_config("qwen3-8b").reduced(), num_layers=4))


@pytest.fixture(scope="module")
def banks():
    """wire mode -> (JAX bank, port bank fed the JAX weights)."""
    jcfg, tcfg = _cfgs()
    out = {}
    for wm in WIRE_MODES:
        jb = JBank(jcfg, D_R, wire_mode=wm, seed=0)
        to_np = lambda t: jax.tree.map(np.asarray, t)
        tb = TBank(tcfg, D_R, wire_mode=wm, seed=0, device="cpu",
                   params=bridge.to_torch(to_np(jb.params), device="cpu"),
                   butterfly={s: bridge.to_torch(to_np(jb.butterfly_params(s)),
                                                 device="cpu")
                              for s in SPLITS})
        out[wm] = (jb, tb)
    return out


def _codes(payload, wm):
    p = payload if isinstance(payload, torch.Tensor) else \
        torch.tensor(np.asarray(payload))
    return unpack_int4(p) if wm == "int4" else p


def _handoff(runner, c0, c1, logits):
    eng = runner.make_engine(max_batch=2, max_len=MAX_LEN, seed=0)
    req = eng.submit_prefilled(PROMPT.shape[1], [c0, c1], logits[0],
                               max_new_tokens=NEW)
    eng.run()
    assert req.done and eng.num_active == 0
    return req.generated


def _streamed(runner, params, c0, c1, logits):
    eng = runner.make_engine(max_batch=1, max_len=MAX_LEN, seed=0)
    S = PROMPT.shape[1]
    req = eng.submit_streamed(S, logits[0], max_new_tokens=NEW)
    c0 = runner.pad_decode_cache(c0, 0, MAX_LEN)
    c1 = runner.pad_decode_cache(c1, 1, MAX_LEN)
    pos = S
    while not req.done:
        tok = np.array([[req.generated[-1]]], np.int32)
        payload, scales, c0 = runner.edge_step(params, tok, c0,
                                               np.array([pos], np.int32))
        _, c1 = runner.stream_step(eng, req, c1, payload, scales, pos)
        pos += 1
    return req.generated


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("wm", WIRE_MODES)
def test_split_path_matches_jax(banks, wm, split):
    jb, tb = banks[wm]
    jr, tr = jb.runner(split), tb.runner(split)

    jp, js, jc0 = jr.edge_half(jr.params, PROMPT)
    tp, ts, tc0 = tr.edge_half(tr.params, PROMPT)
    assert tuple(tp.shape) == tuple(jp.shape) and tp.dtype == \
        {"raw": torch.float32, "reduced": torch.float32}.get(wm, torch.int8)
    if wm in ("int8", "int4"):
        diff = (_codes(tp, wm).int() - _codes(jp, wm).int()).abs()
        assert int(diff.max()) <= 1
        assert int((diff > 0).sum()) <= math.ceil(1e-3 * diff.numel())
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5)
    else:
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5, atol=1e-5)
    for a, b in zip(tree_leaves(tc0), jax.tree.leaves(jc0)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)

    # the cloud halves on the same (JAX) payload
    jl, jc1 = jr.cloud_half(jr.params, jp, js)
    tl, tc1 = tr.cloud_half(tr.params, np.asarray(jp), np.asarray(js))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    for a, b in zip(tree_leaves(tc1), jax.tree.leaves(jc1)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-4)

    # each package end to end: its own edge -> wire -> cloud, then decode
    tl, tc1 = tr.cloud_half(tr.params, tp, ts)
    want = _handoff(jr, jc0, jc1, jl)
    assert _handoff(tr, tc0, tc1, tl) == want
    assert _streamed(tr, tr.params, tc0, tc1, tl) == \
        _streamed(jr, jr.params, jc0, jc1, jl)
    ref, _ = tr.reference_prefill(PROMPT)
    assert want[0] == int(torch.argmax(ref[0, -1]))


@pytest.mark.parametrize("wm", WIRE_MODES)
def test_cache_keys_and_counts_match_jax(banks, wm):
    """After the same calls, both banks hold the same compile-cache keys and
    count the same hits and misses (the runtime's bank_jit_cache_*
    counters)."""
    jb, tb = banks[wm]
    counts = {}
    for bank in (jb, tb):
        before = (bank.cache_hits, bank.cache_misses)
        r = bank.runner(1)
        for toks in (PROMPT, PROMPT[:, :9], np.concatenate([PROMPT] * 2)):
            r.edge_half(r.params, toks)
        counts[bank] = (bank.cache_hits - before[0], bank.cache_misses - before[1])
    assert tb.jit_cache_keys == jb.jit_cache_keys
    assert counts[tb] == counts[jb]
    assert tb.row_block == jb.row_block


def test_engine_submit_matches_submit_prefilled():
    """The engine's own prefill (the hosted-model graph with the fused wire)
    and the split halves' cache handoff decode the same greedy tokens
    (``tests/test_runtime.py`` cache-injection parity, on the port alone)."""
    _, tcfg = _cfgs()
    bank = TBank(tcfg, D_R, wire_mode="int8", seed=0, device="cpu")
    r = bank.runner(1)
    payload, scales, c0 = r.edge_half(r.params, PROMPT)
    logits, c1 = r.cloud_half(r.params, payload, scales)
    ref, _ = r.reference_prefill(PROMPT)
    np.testing.assert_allclose(logits.numpy(), ref[:, -1].numpy(),
                               rtol=1e-4, atol=1e-4)
    eng = r.make_engine(max_batch=2, max_len=MAX_LEN, seed=0)
    inj = eng.submit_prefilled(PROMPT.shape[1], [c0, c1], logits[0],
                               max_new_tokens=NEW)
    eng.run()
    again = eng.submit(PROMPT[0], max_new_tokens=NEW)
    eng.run()
    assert inj.generated == again.generated


def test_bank_holds_one_backbone_copy():
    """Runners share the bank's backbone leaves; only the butterflies are
    per split."""
    _, tcfg = _cfgs()
    bank = TBank(tcfg, D_R, seed=0, device="cpu")
    runners = [bank.runner(s) for s in bank.candidates]
    for r in runners:
        assert r.params["stages"] is bank.params["stages"]
        assert r.params["embed"] is bank.params["embed"]
    ids = {id(t) for r in runners for t in tree_leaves(r.params)}
    assert len(ids) == len(tree_leaves(bank.params)) + 2 * len(runners)
