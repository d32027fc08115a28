"""The port's two-pod decode pipeline (``repro_torch/serving/pipeline.py``)
and its two kernels' plain versions, against the JAX package on the CPU.

  * (a) ``ops.butterfly_restore_norm`` and ``ops.rmsnorm`` (the plain
    versions a CPU tensor takes) against JAX's ``ops`` wrappers, which run
    the Pallas kernels in interpret mode here, and against the pure-jnp
    oracles, on the same numpy inputs: f32 within rtol/atol 1e-5 (the f32
    restore product and the mean of squares sum in another order), bf16
    within one bf16 ulp (rtol 2**-7, atol 1e-3: both round one f32 result);
  * (b) the port's pipeline in f32: pipelined == serial and
    ``use_kernel=True`` == plain, bit for bit, for the int8 and int4 wires;
  * (c) JAX's ``make_decode_pipeline`` on a two-host-device mesh against
    the port's: in ``test_torch_pipeline_jax.py`` (qwen3, windowed gemma3)
    and ``test_torch_pipeline_jax_families.py`` (MoE, recurrent);
  * (d) what the port refuses: a model axis without its ranks, an
    encoder-decoder (JAX asserts it out of scope), fewer than two tokens, a
    pipelined run with one microbatch;
  * (e) what it now runs: ``overlap_psum`` (the same ids), and a model axis
    of 2 over two spawned CPU ranks (the same ids as degree 1; JAX's
    (pod=2, model=4) parity is in ``test_torch_model_parallel_jax.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops, ref as jref
from repro.serving.pipeline import wire_stats as jwire_stats
from repro_torch.configs import get_config as tget_config
from repro_torch.kernels import butterfly_kernel, ops, rmsnorm as rmsnorm_kernel
from repro_torch.models import model as TM
from repro_torch.models import parallel
from repro_torch.models import transformer as tfm
from repro_torch.runtime.split_exec import SplitModelBank
from repro_torch.serving import pipeline as spl

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2 ** -7, atol=1e-3)}


def _close(t: torch.Tensor, j, dtype: str):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               **TOL[dtype])


def _pair(a: np.ndarray, dtype: str):
    jd, td = DTYPES[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


# ----------------------------------------------------------------------- (a)
# rows <= 8 (JAX's fast path), ragged (padded to JAX's block) and tall
# (several Pallas blocks)
@pytest.mark.parametrize("T", [1, 4, 37, 300])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_restore_norm_matches_jax(T, dtype):
    d, d_r = 128, 16
    rng = np.random.default_rng(T)
    codes = rng.integers(-127, 128, (T, d_r)).astype(np.int8)
    scales = rng.uniform(0.01, 0.1, (T, 1)).astype(np.float32)
    wj, wt = _pair((rng.standard_normal((d_r, d)) / 4).astype(np.float32), dtype)
    nj, nt = _pair((0.1 * rng.standard_normal(d)).astype(np.float32), dtype)
    jd, td = DTYPES[dtype]
    x, h = ops.butterfly_restore_norm(torch.from_numpy(codes),
                                      torch.from_numpy(scales), wt, nt,
                                      eps=1e-6, out_dtype=td)
    assert x.dtype == h.dtype == td and x.shape == h.shape == (T, d)
    for xj, hj in (jops.butterfly_restore_norm(jnp.asarray(codes),
                                               jnp.asarray(scales), wj, nj,
                                               eps=1e-6, out_dtype=jd,
                                               block_t=256),
                   jref.butterfly_restore_norm_ref(jnp.asarray(codes),
                                                   jnp.asarray(scales), wj, nj,
                                                   1e-6, jd)):
        _close(x, xj, dtype)
        _close(h, hj, dtype)
    # h is the norm of the rounded x, as the fused kernel's is
    assert torch.equal(h, ops.rmsnorm(x, nt, eps=1e-6))


@pytest.mark.parametrize("T", [1, 8, 37, 300])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_jax(T, dtype):
    d = 96
    rng = np.random.default_rng(T + 1)
    xj, xt = _pair(rng.standard_normal((T, d)).astype(np.float32), dtype)
    wj, wt = _pair((0.1 * rng.standard_normal(d)).astype(np.float32), dtype)
    out = ops.rmsnorm(xt.reshape(T, 1, d), wt, eps=1e-5)
    assert out.dtype == DTYPES[dtype][1] and out.shape == (T, 1, d)
    for want in (jops.rmsnorm(xj, wj, eps=1e-5), jops.rmsnorm_ref(xj, wj, 1e-5),
                 jref.rms_norm_ref(xj, wj, 1e-5)):
        _close(out.reshape(T, d), want, dtype)
    assert torch.equal(ops.rmsnorm_ref(xt, wt, 1e-5), out.reshape(T, d))


def test_cpu_tensors_take_the_plain_norms():
    """A CPU tensor never reaches the new kernels: their launch counters
    stay put, and the launch wrappers refuse CPU tensors."""
    before = (butterfly_kernel.dequant_restore_norm.launches,
              rmsnorm_kernel.rmsnorm.launches)
    codes = torch.zeros((4, 16), dtype=torch.int8)
    scales = torch.ones((4, 1))
    w, nw = torch.zeros((16, 32)), torch.zeros(32)
    x, _ = ops.butterfly_restore_norm(codes, scales, w, nw)
    ops.rmsnorm(x, nw)
    assert (butterfly_kernel.dequant_restore_norm.launches,
            rmsnorm_kernel.rmsnorm.launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        butterfly_kernel.dequant_restore_norm(codes, scales, w, nw)
    with pytest.raises(ValueError, match="CUDA"):
        rmsnorm_kernel.rmsnorm(x, nw)


def test_first_layer_norm1_matches_jax():
    """The norm1 weight the fused restore reads, from a layer-range slice of
    the backbone, against JAX's on the same (bridged) weights."""
    from repro.configs import get_config as jget_config
    from repro.models import model as JM, transformer as jtfm
    from repro_torch import bridge
    jcfg = dataclasses.replace(jget_config("qwen3-8b").reduced(), num_layers=4)
    built = JM.build(jcfg)
    params, _ = JM.init_model(jax.random.key(0), built)
    # norm weights start at zero: give every layer's norm1 its own values,
    # so picking the wrong layer shows
    params = jax.tree.map(np.array, params)
    for u, unit in enumerate(params["stages"][0][0]):
        unit["norm1"] = np.arange(unit["norm1"].size, dtype=np.float32).reshape(
            unit["norm1"].shape) + 1000 * u
    tparams = bridge.to_torch(params, device="cpu")
    params = jax.tree.map(jnp.asarray, params)
    jsegs = list(built.stages[0])
    tsegs = list(TM.build(dataclasses.replace(tget_config("qwen3-8b").reduced(),
                                              num_layers=4)).stages[0])
    for lo in range(4):
        want = np.asarray(jtfm.first_layer_norm1(jsegs, params["stages"][0], lo))
        got = tfm.first_layer_norm1(tsegs, tparams["stages"][0], lo)
        np.testing.assert_array_equal(got.numpy(), want)
        for split in range(lo + 1, 4):
            js, jp = jtfm.slice_stage_params(jsegs, params["stages"][0], lo, split)
            ts, tp = tfm.slice_stage_params(tsegs, tparams["stages"][0], lo, split)
            np.testing.assert_array_equal(tfm.first_layer_norm1(ts, tp).numpy(),
                                          np.asarray(jtfm.first_layer_norm1(js, jp)))
    with pytest.raises(ValueError):
        tfm.first_layer_norm1(tsegs, tparams["stages"][0], 4)


@pytest.mark.parametrize("bits", [8, 4])
def test_wire_stats_match_jax(bits):
    from repro.configs import get_config as jget_config
    jcfg = jget_config("qwen3-8b").with_butterfly(4, 64)
    tcfg = tget_config("qwen3-8b").with_butterfly(4, 64)
    for mb, seq in ((4, 1), (4, 128), (3, 7)):
        assert spl.wire_stats(tcfg, mb, seq, bits) == jwire_stats(jcfg, mb, seq, bits)


# ----------------------------------------------------------------------- (b)
MMB, MB, S, T = 2, 2, 8, 4


def _bank(wire_mode="int8", **kw):
    cfg = tget_config("qwen3-8b").reduced()
    cfg = dataclasses.replace(cfg, num_layers=3, **kw)
    return SplitModelBank(cfg, 32, wire_mode=wire_mode, seed=0, device="cpu")


def _tokens(cfg):
    return np.random.default_rng(1).integers(0, cfg.vocab_size, (MMB * MB, S))


@pytest.mark.parametrize("wire_mode", ["int8", "int4"])
def test_pipelined_equals_serial_and_kernel_equals_plain(wire_mode):
    """f32 on the CPU: all four (schedule, kernel) settings give the same
    greedy ids, bit for bit; the first column is the prefill's greedy token
    from the bank's edge and cloud halves; each setting is one compile-cache
    key, counted as the JAX bank counts it."""
    bank = _bank(wire_mode)
    runner = bank.runner(2)
    toks = _tokens(bank.base_cfg)
    ids = {}
    for pipelined in (True, False):
        for use_kernel in (False, True):
            timings = {}
            run = runner.decode_pipeline(None, MMB, S, MB, T,
                                         pipelined=pipelined,
                                         use_kernel=use_kernel)
            ids[pipelined, use_kernel] = run(toks, timings)
            assert timings["ticks"] == MMB * (T - 1)
            assert timings["prefill_ms"] > 0 and timings["decode_ms"] > 0
    assert (bank.cache_hits, bank.cache_misses) == (0, 4)
    runner.decode_pipeline(None, MMB, S, MB, T)(toks)
    assert (bank.cache_hits, bank.cache_misses) == (1, 4)
    first = ids[True, False]
    assert first.dtype == torch.int32 and first.shape == (MMB * MB, T)
    for v in ids.values():
        assert torch.equal(v, first)
    for k in range(MMB):
        mb_toks = toks[k * MB:(k + 1) * MB]
        payload, scales, _ = runner.edge_half(runner.params, mb_toks)
        logits, _ = runner.cloud_half(runner.params, payload, scales)
        assert torch.equal(logits.argmax(-1).int(), first[k * MB:(k + 1) * MB, 0])


def test_grow_cache_pads_to_the_template():
    cfg = dataclasses.replace(tget_config("qwen3-8b").reduced(), num_layers=2)
    segs = list(TM.build(cfg).stages[0])
    small = tfm.init_stage_cache(segs, cfg, 2, 5, torch.float32, "cpu")
    small = [[{"kv": {n: torch.ones_like(a) for n, a in u["kv"].items()}}
              for u in seg] for seg in small]
    tmpl = tfm.init_stage_cache(segs, cfg, 2, 9, torch.float32, "meta")
    grown = spl._grow_cache(small, tmpl)
    k = grown[0][0]["kv"]["k"]
    assert k.shape == tmpl[0][0]["kv"]["k"].shape
    assert bool((k[:, :, :5] == 1).all()) and bool((k[:, :, 5:] == 0).all())


# ----------------------------------------------------------------------- (d)
def _encdec_built():
    return TM.build(tget_config("whisper-base").reduced().with_butterfly(1, 32))


REFUSALS = {
    # two model ranks a pod, and no torch.distributed world to hold them
    "model axis": (ValueError, dict(pods=(("cpu", "cpu"), ("cpu", "cpu")))),
    "three pods": (NotImplementedError, dict(pods=("cpu",) * 3)),
    "enc-dec": (NotImplementedError, dict(built=_encdec_built)),
    "one token": (ValueError, dict(new_tokens=1)),
    "pipelined, one microbatch": (ValueError, dict(num_microbatches=1)),
    "raw wire": (ValueError, dict(wire_mode="raw")),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_pipeline_refuses(case):
    err, kw = REFUSALS[case]
    cfg = tget_config("qwen3-8b").reduced().with_butterfly(1, 32)
    args = dict(built=TM.build(cfg), pods=("cpu", "cpu"), num_microbatches=2,
                prompt_len=S, microbatch=MB, new_tokens=T)
    args.update(kw)
    if callable(args["built"]):
        args["built"] = args["built"]()
    with pytest.raises(err):
        spl.make_decode_pipeline(**args)
    # the serial schedule takes a single microbatch
    if case == "pipelined, one microbatch":
        spl.make_decode_pipeline(**dict(args, pipelined=False))


def test_runner_refuses_unquantized_wire():
    runner = _bank("reduced").runner(1)
    with pytest.raises(ValueError):
        runner.decode_pipeline(None, MMB, S, MB, T)


# ----------------------------------------------------------------------- (e)
def test_overlap_psum_changes_no_id():
    """Deferring each MLP psum into the next layer adds the same values in
    the same order: the ids equal the undeferred run's, bit for bit."""
    runner = _bank().runner(2)
    toks = _tokens(runner.bank.base_cfg)
    ids = [runner.decode_pipeline(None, MMB, S, MB, T, use_kernel=True,
                                  overlap_psum=ov)(toks) for ov in (False, True)]
    assert torch.equal(ids[0], ids[1])


def _two_rank_ids(rank, device, pods):
    runner = _bank(num_heads=4, num_kv_heads=2).runner(2)
    toks = _tokens(runner.bank.base_cfg)
    return [runner.decode_pipeline(pods, MMB, S, MB, T, use_kernel=True,
                                   overlap_psum=ov)(toks)
            for ov in (False, True)]


def test_model_axis_pipeline_on_two_ranks():
    """(pod=2, model=2) over two spawned CPU ranks (gloo): each rank holds
    half the heads, d_ff columns and kv heads of both pods, and every rank
    decodes the degree-1 ids, with ``overlap_psum`` off and on."""
    want = _two_rank_ids(0, "cpu", ("cpu", "cpu"))[0]
    got = parallel.spawn(_two_rank_ids, 2, ((("cpu", "cpu"), ("cpu", "cpu")),))
    for ids in got:
        for overlapped in ids:
            assert torch.equal(overlapped, want), (overlapped, want)
