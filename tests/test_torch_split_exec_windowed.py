"""The port's split bank and serving engine on the windowed family against
the JAX bank: reduced gemma3 (4 layers, one global layer in two, window 8)
in f32, d_r=16, the int8 wire, splits 1 and 2.  A 13-token prompt decodes
12 new tokens, so the windowed layers' ring slots in the engine's pool wrap
past the window.  Greedy ids are identical to JAX's under cache handoff
(``submit_prefilled`` + ``run``) and under streamed decode (``edge_step`` /
``stream_step``), each package running its own edge -> wire -> cloud.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.runtime.split_exec import SplitModelBank as JBank
from repro_torch import bridge
from repro_torch.configs import get_config as tget_config
from repro_torch.runtime.split_exec import SplitModelBank as TBank

D_R = 16
SPLITS = (1, 2)
WINDOW = 8
PROMPT = np.random.default_rng(11).integers(0, 512, (1, 13)).astype(np.int32)
NEW = 12
MAX_LEN = PROMPT.shape[1] + NEW + 2


def _cfg(get_config):
    return dataclasses.replace(get_config("gemma3-12b").reduced(), num_layers=4,
                               global_every=2, sliding_window=WINDOW)


@pytest.fixture(scope="module")
def banks():
    """(JAX bank, port bank fed the JAX weights), int8 wire."""
    jb = JBank(_cfg(jget_config), D_R, wire_mode="int8", seed=0)
    to_np = lambda t: jax.tree.map(np.asarray, t)
    tb = TBank(_cfg(tget_config), D_R, wire_mode="int8", seed=0, device="cpu",
               params=bridge.to_torch(to_np(jb.params), device="cpu"),
               butterfly={s: bridge.to_torch(to_np(jb.butterfly_params(s)),
                                             device="cpu")
                          for s in SPLITS})
    return jb, tb


def _handoff(runner):
    payload, scales, c0 = runner.edge_half(runner.params, PROMPT)
    logits, c1 = runner.cloud_half(runner.params, payload, scales)
    eng = runner.make_engine(max_batch=2, max_len=MAX_LEN, seed=0)
    req = eng.submit_prefilled(PROMPT.shape[1], [c0, c1], logits[0],
                               max_new_tokens=NEW)
    eng.run()
    assert req.done and eng.num_active == 0
    return [int(t) for t in req.generated]


def _streamed(runner):
    params = runner.params
    payload, scales, c0 = runner.edge_half(params, PROMPT)
    logits, c1 = runner.cloud_half(params, payload, scales)
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
    return [int(t) for t in req.generated]


def test_windowed_config_wraps_its_rings():
    cfg = _cfg(tget_config)
    assert cfg.sliding_window == WINDOW < PROMPT.shape[1] + NEW
    assert cfg.global_every == 2 and cfg.num_layers == 4


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("transport", ["cache_handoff", "streamed"])
def test_windowed_split_serving_matches_jax(banks, transport, split):
    jb, tb = banks
    serve = _handoff if transport == "cache_handoff" else _streamed
    want = serve(jb.runner(split))
    assert len(want) == NEW
    assert serve(tb.runner(split)) == want
