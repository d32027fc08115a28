"""The port's ServingEngine against the JAX package's, with the JAX weights
carried across by the bridge: greedy tokens equal under the default
(single-model) prefill/decode, slots are reused, and temperature sampling
is deterministic under a seeded generator."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import model as JM
from repro.serving.engine import ServingEngine as JEngine
from repro_torch import bridge
from repro_torch.configs import get_config as tget_config
from repro_torch.models import model as TM
from repro_torch.serving.engine import ServingEngine as TEngine

PROMPTS = [np.random.default_rng(i).integers(0, 512, n).astype(np.int32)
           for i, n in enumerate((9, 14, 5))]


@pytest.fixture(scope="module")
def models():
    jc = dataclasses.replace(jget_config("qwen3-8b").reduced(), num_layers=4)
    tc = dataclasses.replace(tget_config("qwen3-8b").reduced(), num_layers=4)
    jbuilt, tbuilt = JM.build(jc), TM.build(tc)
    jparams, _ = JM.init_model(jax.random.key(0), jbuilt)
    tparams = bridge.to_torch(jax.tree.map(np.asarray, jparams), device="cpu")
    return jbuilt, jparams, tbuilt, tparams


def _serve(engine, prompts, new=(6, 3, 5)):
    """Two requests, drain, then a third into a freed slot."""
    reqs = [engine.submit(p, max_new_tokens=n) for p, n in zip(prompts[:2], new)]
    engine.run()
    reqs.append(engine.submit(prompts[2], max_new_tokens=new[2]))
    engine.run()
    return reqs


def test_greedy_tokens_match_jax(models):
    jbuilt, jparams, tbuilt, tparams = models
    jreqs = _serve(JEngine(jparams, jbuilt, max_batch=2, max_len=32), PROMPTS)
    teng = TEngine(tparams, tbuilt, max_batch=2, max_len=32, device="cpu")
    treqs = _serve(teng, PROMPTS)
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert all(r.done for r in treqs) and teng.num_active == 0
    assert [len(r.generated) for r in treqs] == [6, 3, 5]


def test_slots_are_reused_and_cleared(models):
    """A finished request frees its slot; the next one is written into it
    with the slot's old cache rows zeroed, so it decodes as in a fresh
    engine."""
    _, _, tbuilt, tparams = models
    eng = TEngine(tparams, tbuilt, max_batch=1, max_len=32, device="cpu")
    first = eng.submit(PROMPTS[1], max_new_tokens=4)
    assert eng.active[0] is first
    with pytest.raises(RuntimeError, match="full"):
        eng.submit(PROMPTS[0], max_new_tokens=2)
    eng.run()
    assert eng.active == [None]
    second = eng.submit(PROMPTS[2], max_new_tokens=5)
    assert eng.active[0] is second
    eng.run()
    fresh = TEngine(tparams, tbuilt, max_batch=1, max_len=32, device="cpu")
    alone = fresh.submit(PROMPTS[2], max_new_tokens=5)
    fresh.run()
    assert second.generated == alone.generated


def test_eos_and_length_stop(models):
    _, _, tbuilt, tparams = models
    eng = TEngine(tparams, tbuilt, max_batch=2, max_len=32, device="cpu")
    probe = eng.submit(PROMPTS[0], max_new_tokens=4)
    eng.run()
    eos = probe.generated[-1]
    stop = probe.generated.index(eos) + 1
    eng2 = TEngine(tparams, tbuilt, max_batch=2, max_len=32, device="cpu")
    req = eng2.submit(PROMPTS[0], max_new_tokens=4, eos_id=eos)
    eng2.run()
    assert req.done and req.generated == probe.generated[:stop]
    assert eng2.num_active == 0


def test_temperature_sampling_is_seeded(models):
    """Same seed, same tokens; the sampled row is a valid token id and the
    draw depends on the engine's generator."""
    _, _, tbuilt, tparams = models

    def sample(seed):
        eng = TEngine(tparams, tbuilt, max_batch=2, max_len=32, seed=seed,
                      device="cpu")
        reqs = [eng.submit(p, max_new_tokens=8, temperature=1.5)
                for p in PROMPTS[:2]]
        eng.run()
        return [r.generated for r in reqs]

    a, b = sample(0), sample(0)
    assert a == b
    assert all(0 <= t < tbuilt.cfg.vocab_size for g in a for t in g)
    assert any(sample(s) != a for s in (1, 2, 3))


def test_record_logits_matches_jax(models):
    jbuilt, jparams, tbuilt, tparams = models
    jeng = JEngine(jparams, jbuilt, max_batch=1, max_len=32)
    jr = jeng.submit(PROMPTS[0], max_new_tokens=3, record_logits=True)
    jeng.run()
    teng = TEngine(tparams, tbuilt, max_batch=1, max_len=32, device="cpu")
    tr = teng.submit(PROMPTS[0], max_new_tokens=3, record_logits=True)
    teng.run()
    assert len(tr.logits_history) == len(jr.logits_history) == 3
    for a, b in zip(tr.logits_history, jr.logits_history):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b).reshape(a.shape),
                                   rtol=0, atol=1e-4)
