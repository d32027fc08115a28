"""The port on the card: each kernel against its plain PyTorch version on
the same inputs, the split path launching both butterfly kernels, the
windowed model's kernel prefill launching the flash kernel, the two-pod
decode pipeline on two streams of one card, and the runtime simulator's
numerics on the card.

These tests import no JAX, so a GPU machine with PyTorch alone runs them,
without the JAX package's conftest:

    PYTHONPATH=src python3 -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Elsewhere they skip.  Tolerances: codes differ by at most 1 on at most
0.1% of entries (rounded up to a whole entry), because the kernel's f32
sums run in another order than the plain product's; scales within rtol
1e-5; the restore within one bf16 ulp (rtol 2**-7, atol 1e-3), or rtol
1e-5 (atol 1e-6) in f32 up to d_r = 64; a wider f32 restore, and its plain
version, within the f32 summation bound of an f64 product.  Flash attention
within rtol/atol 2e-5 in f32 (f32 sums in another order) and one bf16 ulp
(rtol 2**-7, atol 1e-3) in bf16: both compute in f32 and round once.
The fused restore+norm kernel's x equals the restore kernel's and its h the
RMSNorm kernel's on that x, bit for bit (one shared row routine); x against
the plain restore as above (in f32 both within the summation bound of an
f64 product), h and the RMSNorm kernel against the plain norm
of the same x within rtol 1e-5 (atol 1e-6) in f32 (the mean of squares sums
in another order) and one bf16 ulp in bf16.  The bincount kernel's codes
and scales equal reduce_quant's bit for bit and its counts the histogram of
those codes exactly.
"""
import dataclasses
import math
import os

import numpy as np
import pytest
import torch

from repro_torch.kernels import butterfly_kernel, flash_attention as fa, ops, ref
from repro_torch.kernels import rmsnorm as rmsnorm_kernel

pytestmark = pytest.mark.cuda

# cuBLAS is deterministic across streams only with a fixed workspace; it
# reads this when its first handle is made, after this module is imported
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    # the plain versions' f32 products in full f32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(T, d, d_r, dtype, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((T, d)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((d, d_r)) * 0.05).astype(np.float32))
    return x.to(dtype), w.to(dtype)


# every compiled variant: reduce_quant's channel widths 32..1024 (CJ = 1..32)
# with 1-row blocks up to 1,024 rows and 16-row blocks above (d_r <= 64);
# dequant_restore past 48 KB of shared memory at d_r = 1024
@pytest.mark.parametrize("T", [1, 4, 8, 37, 512, 1025])
@pytest.mark.parametrize("d,d_r,dtype", [(4096, 64, torch.bfloat16),
                                         (256, 16, torch.float32),
                                         (200, 48, torch.bfloat16),
                                         (512, 128, torch.float32),
                                         (512, 128, torch.bfloat16),
                                         (384, 256, torch.bfloat16),
                                         (384, 512, torch.float32),
                                         (256, 1024, torch.float32),
                                         (256, 1024, torch.bfloat16)])
def test_kernels_match_plain(cuda, T, d, d_r, dtype):
    x, w = (t.to(cuda) for t in _inputs(T, d, d_r, dtype, seed=T))
    n0 = butterfly_kernel.reduce_quant.launches
    codes, scales = ops.butterfly_reduce_quant(x, w)
    assert butterfly_kernel.reduce_quant.launches == n0 + 1
    codes_p, scales_p = ref.butterfly_reduce_quant_ref(x, w)
    diff = (codes.int() - codes_p.int()).abs()
    assert int(diff.max()) <= 1
    assert int((diff > 0).sum()) <= math.ceil(1e-3 * diff.numel())
    torch.testing.assert_close(scales, scales_p, rtol=1e-5, atol=0)
    wr = w.t().contiguous()
    n0 = butterfly_kernel.dequant_restore.launches
    out = ops.butterfly_dequant_restore(codes_p, scales_p, wr, out_dtype=dtype)
    assert butterfly_kernel.dequant_restore.launches == n0 + 1
    out_p = ref.butterfly_dequant_restore_ref(codes_p, scales_p, wr, dtype)
    if dtype == torch.float32 and d_r > 64:
        # 128-1024 f32 products per output: the kernel and cuBLAS sum them
        # in different orders, so each is held to the f32 summation bound
        # against an f64 product, |err| <= n*u*sum|a_k b_k| (n = d_r,
        # u = 2**-24), on the same f32 dequantized inputs
        r64 = (codes_p.float() * scales_p).double()
        exact = r64 @ wr.double()
        bound = 1.01 * d_r * 2 ** -24 * (r64.abs() @ wr.double().abs())
        for o in (out, out_p):
            assert bool(((o.double() - exact).abs() <= bound).all())
        return
    tol = dict(rtol=2 ** -7, atol=1e-3) if dtype == torch.bfloat16 else \
        dict(rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(out, out_p, **tol)


# the bincount variant of every compiled reduce_quant variant (each channel
# width in f32 and bf16, 1-row and 16-row blocks), at both widths of the
# code alphabet: codes and scales bit for bit reduce_quant's, counts exactly
# the plain histogram of those codes, and within 2 per differing code of the
# whole plain version's (its codes may differ by 1 on 0.1% of entries)
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("T", [1, 4, 37, 512, 1025])
@pytest.mark.parametrize("d,d_r,dtype", [(256, 16, torch.float32),
                                         (256, 16, torch.bfloat16),
                                         (4096, 64, torch.bfloat16),
                                         (3840, 60, torch.float32),
                                         (512, 128, torch.float32),
                                         (512, 128, torch.bfloat16),
                                         (384, 256, torch.float32),
                                         (384, 256, torch.bfloat16),
                                         (384, 512, torch.float32),
                                         (384, 512, torch.bfloat16),
                                         (256, 1024, torch.float32),
                                         (256, 1024, torch.bfloat16)])
def test_bincount_kernel_matches_reduce_quant_and_plain(cuda, d, d_r, dtype, T,
                                                        bits):
    x, w = (t.to(cuda) for t in _inputs(T, d, d_r, dtype, seed=T + bits))
    n0 = butterfly_kernel.reduce_quant_bincount.launches
    codes, scales, counts = ops.butterfly_reduce_quant_bincount(x, w, bits=bits)
    assert butterfly_kernel.reduce_quant_bincount.launches == n0 + 1
    codes_q, scales_q = ops.butterfly_reduce_quant(x, w, bits=bits)
    assert torch.equal(codes, codes_q) and torch.equal(scales, scales_q)
    assert counts.dtype == torch.int32 and counts.shape == (d_r, 1 << bits)
    assert torch.equal(counts, ref.symbol_counts(codes, bits))
    assert int(counts.sum()) == T * d_r
    codes_p, _, counts_p = ref.butterfly_reduce_quant_bincount_ref(x, w, bits)
    n_diff = int((codes != codes_p).sum())
    assert int((counts - counts_p).abs().sum()) <= 2 * n_diff


def test_kernel_wrappers_refuse_bad_input(cuda):
    x, w = (t.to(cuda) for t in _inputs(8, 64, 16, torch.float32, seed=0))
    with pytest.raises(TypeError):
        butterfly_kernel.reduce_quant(x, w.to(torch.bfloat16))
    with pytest.raises(ValueError):
        butterfly_kernel.reduce_quant(x.t(), w)                  # not contiguous
    with pytest.raises(ValueError):
        butterfly_kernel.reduce_quant(x, torch.zeros((64, 1025), device=cuda))
    codes, scales = butterfly_kernel.reduce_quant(x, w)
    with pytest.raises(TypeError):                               # out != w dtype
        butterfly_kernel.dequant_restore(codes, scales, w.t().contiguous(),
                                         torch.bfloat16)
    with pytest.raises(ValueError):                              # wider than int8
        ops.butterfly_reduce_quant(x, w, bits=16)
    with pytest.raises(ValueError):
        ops.butterfly_reduce_quant_bincount(x, w, bits=16)
    with pytest.raises(TypeError):
        butterfly_kernel.reduce_quant_bincount(x, w.to(torch.bfloat16))


def _restore_inputs(T, d, d_r, dtype, seed):
    rng = np.random.default_rng(seed)
    codes = torch.from_numpy(rng.integers(-127, 128, (T, d_r)).astype(np.int8))
    scales = torch.from_numpy(rng.uniform(0.01, 0.1, (T, 1)).astype(np.float32))
    wr = torch.from_numpy((rng.standard_normal((d_r, d)) / math.sqrt(d_r))
                          .astype(np.float32)).to(dtype)
    nw = torch.from_numpy((0.1 * rng.standard_normal(d)).astype(np.float32)).to(dtype)
    return codes, scales, wr, nw


def _near_restore(out, codes, scales, wr, dtype):
    """The restore against its plain version: within one bf16 ulp in bf16;
    in f32 each of the two within the f32 summation bound of an f64
    product, |err| <= n*u*sum|a_k b_k| (n = d_r, u = 2**-24): the inputs'
    codes span [-127, 127], so a sum can cancel to near zero, where a
    relative tolerance says nothing."""
    d_r = codes.shape[1]
    plain = ref.butterfly_dequant_restore_ref(codes, scales, wr, dtype)
    if dtype == torch.float32:
        r64 = (codes.float() * scales).double()
        exact = r64 @ wr.double()
        bound = 1.01 * d_r * 2 ** -24 * (r64.abs() @ wr.double().abs())
        for o in (out, plain):
            assert bool(((o.double() - exact).abs() <= bound).all())
        return
    torch.testing.assert_close(out, plain, rtol=2 ** -7, atol=1e-3)


def _norm_tol(dtype):
    return dict(rtol=2 ** -7, atol=1e-3) if dtype == torch.bfloat16 else \
        dict(rtol=1e-5, atol=1e-6)


# d_r 16-1024 (shared memory past 48 KB at 1024), d 4096 and 3840 (the two
# models) and ragged widths, 1 to 1,025 rows (one or many 16-row blocks)
@pytest.mark.parametrize("T", [1, 4, 16, 37, 512, 1025])
@pytest.mark.parametrize("d,d_r,dtype", [(4096, 64, torch.bfloat16),
                                         (3840, 60, torch.bfloat16),
                                         (4096, 64, torch.float32),
                                         (256, 16, torch.float32),
                                         (200, 48, torch.bfloat16),
                                         (384, 1024, torch.float32),
                                         (256, 1024, torch.bfloat16)])
def test_restore_norm_matches_plain_and_its_parts(cuda, T, d, d_r, dtype):
    codes, scales, wr, nw = (t.to(cuda) for t in _restore_inputs(T, d, d_r,
                                                                  dtype, seed=T))
    n0 = butterfly_kernel.dequant_restore_norm.launches
    x, h = ops.butterfly_restore_norm(codes, scales, wr, nw, eps=1e-6,
                                      out_dtype=dtype)
    assert butterfly_kernel.dequant_restore_norm.launches == n0 + 1
    assert x.dtype == h.dtype == dtype and x.shape == h.shape == (T, d)
    assert torch.equal(x, ops.butterfly_dequant_restore(codes, scales, wr,
                                                        out_dtype=dtype))
    n0 = rmsnorm_kernel.rmsnorm.launches
    assert torch.equal(h, ops.rmsnorm(x, nw, eps=1e-6))
    assert rmsnorm_kernel.rmsnorm.launches == n0 + 1
    _near_restore(x, codes, scales, wr, dtype)
    torch.testing.assert_close(h, ref.rms_norm_ref(x, nw, 1e-6), **_norm_tol(dtype))


@pytest.mark.parametrize("T", [1, 4, 9, 512, 4096])
@pytest.mark.parametrize("d,dtype", [(4096, torch.bfloat16), (3840, torch.bfloat16),
                                     (4096, torch.float32), (33, torch.float32),
                                     (1000, torch.bfloat16)])
def test_rmsnorm_matches_plain(cuda, T, d, dtype):
    rng = np.random.default_rng(T + d)
    x = torch.from_numpy(rng.standard_normal((T, d)).astype(np.float32)).to(cuda, dtype)
    w = torch.from_numpy((0.1 * rng.standard_normal(d)).astype(np.float32)).to(cuda, dtype)
    n0 = rmsnorm_kernel.rmsnorm.launches
    out = ops.rmsnorm(x.reshape(T, 1, d), w, eps=1e-5)
    assert rmsnorm_kernel.rmsnorm.launches == n0 + 1
    assert out.dtype == dtype and out.shape == (T, 1, d)
    torch.testing.assert_close(out.reshape(T, d), ref.rms_norm_ref(x, w, 1e-5),
                               **_norm_tol(dtype))


def test_norm_wrappers_refuse_bad_input(cuda):
    codes, scales, wr, nw = (t.to(cuda) for t in _restore_inputs(
        8, 64, 16, torch.float32, seed=0))
    with pytest.raises(TypeError):                               # norm_w dtype
        butterfly_kernel.dequant_restore_norm(codes, scales, wr,
                                              nw.to(torch.bfloat16))
    with pytest.raises(TypeError):                               # out != w dtype
        butterfly_kernel.dequant_restore_norm(codes, scales, wr, nw,
                                              out_dtype=torch.bfloat16)
    with pytest.raises(ValueError):                              # norm_w width
        butterfly_kernel.dequant_restore_norm(codes, scales, wr, nw[:32])
    with pytest.raises(ValueError, match="CUDA"):
        butterfly_kernel.dequant_restore_norm(codes.cpu(), scales, wr, nw)
    x = torch.zeros((8, 64), device=cuda)
    with pytest.raises(TypeError):
        rmsnorm_kernel.rmsnorm(x, nw.to(torch.bfloat16))
    with pytest.raises(TypeError):
        rmsnorm_kernel.rmsnorm(x.to(torch.float16), nw)
    with pytest.raises(ValueError):
        rmsnorm_kernel.rmsnorm(x.t(), nw)                         # not contiguous
    with pytest.raises(ValueError, match="CUDA"):
        rmsnorm_kernel.rmsnorm(x.cpu(), nw.cpu())


def test_split_path_launches_both_kernels(cuda):
    """The reduced config in bf16 on the card: edge -> wire -> cloud and one
    engine decode step go through both kernels, and the cloud logits stay
    near the reference forward (whose wire rounds x @ w_reduce to bf16)."""
    from repro_torch.configs import get_config
    from repro_torch.runtime.split_exec import SplitModelBank
    cfg = dataclasses.replace(get_config("qwen3-8b").reduced(), num_layers=4,
                              dtype="bfloat16")
    bank = SplitModelBank(cfg, 16, seed=0, device=cuda)
    r = bank.runner(2)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 21))
    n = (butterfly_kernel.reduce_quant.launches,
         butterfly_kernel.dequant_restore.launches)
    payload, scales, c0 = r.edge_half(r.params, toks)
    logits, c1 = r.cloud_half(r.params, payload.cpu(), scales.cpu())
    eng = r.make_engine(max_batch=2, max_len=32)
    req = eng.submit_prefilled(21, [c0, c1], logits[0], max_new_tokens=3)
    eng.run()
    assert req.done and len(req.generated) == 3
    assert butterfly_kernel.reduce_quant.launches >= n[0] + 3
    assert butterfly_kernel.dequant_restore.launches >= n[1] + 3
    ref_logits, _ = r.reference_prefill(toks)
    delta = float((logits - ref_logits[:, -1]).abs().max())
    assert delta <= 0.05 * float(ref_logits.abs().max())


# B, S, T, N, K: aligned, ragged S < T, one query, more queries than keys
# (rows that see no key under a causal mask), wide GQA groups
FLASH_SHAPES = [(2, 128, 128, 4, 2), (1, 37, 53, 4, 2), (1, 1, 77, 8, 2),
                (1, 130, 65, 2, 2), (2, 200, 200, 8, 1)]


@pytest.mark.parametrize("mask", ["causal", "window", "full", "full+window"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", fa.HEAD_DIMS)
def test_flash_attention_matches_plain(cuda, hd, dtype, mask):
    causal = mask in ("causal", "window")
    window = 16 if "window" in mask else None
    tol = dict(rtol=2e-5, atol=2e-5) if dtype == torch.float32 else \
        dict(rtol=2 ** -7, atol=1e-3)
    rng = np.random.default_rng(hd)
    for B, S, T, N, K in FLASH_SHAPES:
        q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                   .to(device=cuda, dtype=dtype)
                   for shape in ((B, S, N, hd), (B, T, K, hd), (B, T, K, hd)))
        n0 = fa.flash_attention.launches
        out = ops.flash_attention(q, k, v, causal=causal, window=window)
        assert fa.flash_attention.launches == n0 + 1
        want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
        assert out.dtype == dtype and out.shape == (B, S, N, hd)
        torch.testing.assert_close(out, want, **tol)
    torch.cuda.synchronize()


def test_flash_wrapper_refuses_bad_input(cuda):
    q = torch.zeros((1, 8, 4, 64), device=cuda)
    k = torch.zeros((1, 8, 2, 64), device=cuda)
    with pytest.raises(TypeError):
        fa.flash_attention(q, k.to(torch.bfloat16), k)
    with pytest.raises(ValueError):                              # hd 48
        fa.flash_attention(q[..., :48].contiguous(), k[..., :48].contiguous(),
                           k[..., :48].contiguous())
    with pytest.raises(ValueError):                              # N % K
        fa.flash_attention(q[:, :, :3].contiguous(), k, k)
    with pytest.raises(ValueError):
        fa.flash_attention(q.transpose(1, 2), k, k)              # not contiguous
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, k, window=0)


def test_windowed_model_kernel_prefill_and_ring_decode(cuda):
    """Reduced gemma3 (4 layers, window 64, d_r=16 butterfly after layer 2)
    in f32 on the card: a 60-token kernel prefill launches the flash kernel
    once a layer and stays near the plain prefill, and 16 teacher-forced
    decode steps past the window through the ring caches stay near the
    plain run's."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    cfg = dataclasses.replace(get_config("gemma3-12b").reduced(), num_layers=4,
                              sliding_window=64, global_every=2).with_butterfly(2, 16)
    built = M.build(cfg)
    params = M.init_model(torch.Generator(device=cuda).manual_seed(0), built,
                          device=cuda)
    S, steps = 60, 16
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, S))).to(cuda)
    n = (fa.flash_attention.launches, butterfly_kernel.reduce_quant.launches)
    logits, caches = M.forward_prefill(params, built, {"tokens": toks},
                                       use_kernel=True)
    assert fa.flash_attention.launches == n[0] + cfg.num_layers
    assert butterfly_kernel.reduce_quant.launches == n[1] + 1
    ref_logits, ref_caches = M.forward_prefill(params, built, {"tokens": toks})
    assert fa.flash_attention.launches == n[0] + cfg.num_layers

    def near(a, b):
        assert bool(torch.isfinite(a).all())
        assert float((a - b).abs().max()) <= 0.05 * float(b.abs().max())

    near(logits, ref_logits)
    caches = M.pad_decode_caches(built, caches, S + steps)
    ref_caches = M.pad_decode_caches(built, ref_caches, S + steps)
    tok = ref_logits[:, -1].argmax(-1, keepdim=True)
    for pos in range(S, S + steps):
        logits, caches = M.forward_decode(params, built, tok, caches, pos,
                                          use_kernel=True)
        ref_logits, ref_caches = M.forward_decode(params, built, tok,
                                                  ref_caches, pos)
        near(logits, ref_logits)
        tok = ref_logits[:, -1].argmax(-1, keepdim=True)
    assert butterfly_kernel.reduce_quant.launches == n[1] + 1 + steps


def test_two_stream_pipeline_matches_serial(cuda):
    """Reduced qwen3 (3 layers, bf16, d_r=32 after layer 2) with both pods
    on the card, each on its own stream: the pipelined and serial
    schedules give the same greedy ids, bit for bit, for the int8 and int4
    wires with the kernels and for the plain int8 wire.  A kernel run
    launches reduce_quant and restore_norm once per prefill microbatch and
    once per decode tick (Mmb + Mmb*(T-1)), dequant_restore and flash
    never; a plain run launches none of them."""
    from repro_torch.configs import get_config
    from repro_torch.runtime.split_exec import SplitModelBank
    cfg = dataclasses.replace(get_config("qwen3-8b").reduced(), num_layers=3,
                              dtype="bfloat16")
    bank8 = SplitModelBank(cfg, 32, seed=0, device=cuda)
    bank4 = SplitModelBank(cfg, 32, wire_mode="int4", device=cuda,
                           params=bank8.params,
                           butterfly={2: bank8.butterfly_params(2)})
    Mmb, mb, S, T = 3, 4, 16, 6
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (Mmb * mb, S))).to(cuda)

    def counts():
        return (butterfly_kernel.reduce_quant.launches,
                butterfly_kernel.dequant_restore_norm.launches,
                butterfly_kernel.dequant_restore.launches,
                fa.flash_attention.launches)

    for bank, use_kernel in ((bank8, True), (bank4, True), (bank8, False)):
        ids = []
        for pipelined in (True, False):
            run = bank.runner(2).decode_pipeline(None, Mmb, S, mb, T,
                                                 pipelined=pipelined,
                                                 use_kernel=use_kernel)
            n0 = counts()
            ids.append(run(toks))
            torch.cuda.synchronize()
            n = Mmb * T if use_kernel else 0
            assert tuple(b - a for a, b in zip(n0, counts())) == (n, n, 0, 0)
        assert ids[0].shape == (Mmb * mb, T) and ids[0].device.type == "cuda"
        assert torch.equal(ids[0], ids[1]), (bank.wire_mode, use_kernel)


def test_simulation_entropy_wire_serves_the_int8_ids(cuda):
    """The runtime simulator with numerics on the card (reduced qwen3, 4
    layers): the entropy wire is numerically the int8 wire, so each request
    gets the same greedy ids on every transport, through both butterfly
    kernels; the entropy run's uplink bytes are the coded ones."""
    from repro_torch.configs import get_config
    from repro_torch.runtime.simulator import SimConfig, Simulation
    cfg = dataclasses.replace(get_config("qwen3-8b").reduced(), num_layers=4)
    ids = {}
    for transport in ("cache_handoff", "streamed", "progressive"):
        for wire in ("int8", "entropy"):
            n0 = (butterfly_kernel.reduce_quant.launches,
                  butterfly_kernel.dequant_restore.launches)
            sim = Simulation(SimConfig(cfg=cfg, wire_mode=wire,
                                       transport=transport, num_requests=4,
                                       seed=0, device="cuda"))
            tel = sim.run()
            assert butterfly_kernel.reduce_quant.launches > n0[0]
            assert butterfly_kernel.dequant_restore.launches > n0[1]
            ids[wire] = [list(r.engine_req.generated) for r in sim.requests]
            assert all(len(g) == 4 for g in ids[wire])
            coded = [t.coded_bytes for t in tel.traces]
            assert all(c > 0 for c in coded) == (wire == "entropy")
        assert ids["entropy"] == ids["int8"], transport
