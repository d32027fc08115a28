"""The two remaining dense configs, qwen3-14b (qk_norm, GQA 40/8) and
gemma-7b (GeGLU, MHA 16/16 at head_dim 256, tied embeddings), in the port
against the JAX package, in f32 on the CPU with the JAX weights carried
across by ``repro_torch.bridge``:

  * every config field and ``costs.param_count`` equal JAX's;
  * a reduced 4-layer model with a d_r = 16 butterfly after layer 2:
    ``forward_prefill`` logits within 1e-5, then, from caches padded by 4
    rows, greedy ``forward_decode`` tokens equal and their logits within
    1e-4 (as ``test_torch_model.py`` holds qwen3-8b);
  * split serving through ``SplitModelBank`` and ``ServingEngine`` (int8
    wire, cache handoff) decodes the JAX bank's greedy tokens.

``reduced()`` turns gemma-7b's 16/16 heads into 4/2, so a third variant
keeps ``num_kv_heads = num_heads`` on both sides: one query head a key
head, as the full model has.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import costs as jcosts
from repro.models import model as JM
from repro.runtime.split_exec import SplitModelBank as JBank
from repro_torch import bridge
from repro_torch.configs import get_config as tget_config
from repro_torch.core import costs as tcosts
from repro_torch.models import model as TM
from repro_torch.runtime.split_exec import SplitModelBank as TBank
from repro_torch.tree import tree_map

NAMES = ("qwen3-14b", "gemma-7b")
VARIANTS = [("qwen3-14b", False), ("gemma-7b", False), ("gemma-7b", True)]
IDS = ["qwen3-14b", "gemma-7b", "gemma-7b-mha"]
TOKS = np.random.default_rng(0).integers(0, 512, (2, 12)).astype(np.int32)
PROMPT = np.random.default_rng(7).integers(0, 512, (1, 13)).astype(np.int32)


def _cfgs(name, mha, butterfly=None):
    out = []
    for get in (jget_config, tget_config):
        c = dataclasses.replace(get(name).reduced(), num_layers=4)
        if mha:
            c = dataclasses.replace(c, num_kv_heads=c.num_heads)
        out.append(c.with_butterfly(*butterfly) if butterfly else c)
    return out


@pytest.mark.parametrize("name", NAMES)
def test_config_and_param_count_match_jax(name):
    jc, tc = jget_config(name), tget_config(name)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert dataclasses.asdict(tc.reduced()) == dataclasses.asdict(jc.reduced())
    assert tcosts.param_count(tc) == jcosts.param_count(jc)
    assert tcosts.param_count(tc.with_butterfly(5, 80)) == \
        jcosts.param_count(jc.with_butterfly(5, 80))


@pytest.mark.parametrize("name,mha", VARIANTS, ids=IDS)
def test_prefill_and_greedy_decode_match_jax(name, mha):
    jc, tc = _cfgs(name, mha, (2, 16))
    if mha:
        assert tc.q_per_kv == 1
    jbuilt, tbuilt = JM.build(jc), TM.build(tc)
    jparams, _ = JM.init_model(jax.random.key(0), jbuilt)
    tparams = bridge.to_torch(jax.tree.map(np.asarray, jparams), device="cpu")
    jl, jcache = JM.forward_prefill(jparams, jbuilt, {"tokens": jnp.asarray(TOKS)})
    tl, tcache = TM.forward_prefill(tparams, tbuilt,
                                    {"tokens": torch.from_numpy(TOKS)})
    assert tl.shape == (2, 1, tc.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-5)
    pad = lambda a: np.pad(np.asarray(a), [(0, 0), (0, 0), (0, 4), (0, 0), (0, 0)])
    jcache = jax.tree.map(lambda a: jnp.asarray(pad(a)), jcache)
    tcache = tree_map(lambda a: torch.from_numpy(pad(a.numpy())), tcache)
    jtok = np.asarray(jnp.argmax(jl[:, -1], axis=-1), np.int32)[:, None]
    ttok = tl[:, -1].argmax(-1, keepdim=True)
    for pos in range(12, 16):
        assert ttok.numpy().tolist() == jtok.tolist()
        jl, jcache = JM.forward_decode(jparams, jbuilt, jnp.asarray(jtok), jcache,
                                       pos)
        tl, tcache = TM.forward_decode(tparams, tbuilt, ttok, tcache, pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)
        jtok = np.asarray(jnp.argmax(jl[:, -1], axis=-1), np.int32)[:, None]
        ttok = tl[:, -1].argmax(-1, keepdim=True)


@pytest.mark.parametrize("name,mha", VARIANTS, ids=IDS)
def test_split_serving_matches_jax_bank(name, mha):
    """Edge half -> int8 wire -> cloud half, then the engine decodes 4
    greedy tokens from the handed-off caches, in both packages."""
    jcfg, tcfg = _cfgs(name, mha)
    split, new = 2, 4
    jb = JBank(jcfg, 16, wire_mode="int8", seed=0)
    to_np = lambda t: jax.tree.map(np.asarray, t)
    tb = TBank(tcfg, 16, wire_mode="int8", seed=0, device="cpu",
               params=bridge.to_torch(to_np(jb.params), device="cpu"),
               butterfly={split: bridge.to_torch(to_np(jb.butterfly_params(split)),
                                                 device="cpu")})
    generated = []
    for runner in (jb.runner(split), tb.runner(split)):
        payload, scales, c0 = runner.edge_half(runner.params, PROMPT)
        logits, c1 = runner.cloud_half(runner.params, payload, scales)
        eng = runner.make_engine(max_batch=2, max_len=24, seed=0)
        req = eng.submit_prefilled(PROMPT.shape[1], [c0, c1], logits[0],
                                   max_new_tokens=new)
        eng.run()
        assert req.done and len(req.generated) == new
        generated.append(req.generated)
    assert generated[1] == generated[0]
