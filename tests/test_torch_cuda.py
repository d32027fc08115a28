"""The port on the card: each kernel against its plain PyTorch version on
the same inputs, the split path launching both butterfly kernels, the
windowed model's kernel prefill launching the flash kernel, the two-pod
decode pipeline on two streams of one card, the runtime simulator's
numerics on the card, training on the card against the CPU, the MoE
layer's routing and whisper's kernel prefill on the card against the CPU,
the two-pod prefill pipeline on two streams against one, the dry
run's counts on the card against those on meta tensors, and the model axis:
two ranks sharing the card over gloo, their all_reduce and the reduced
families at (pod=2, model=2) against the CPU; the MoE layer's
automatic branch at (data=2, model=2) over four ranks on the card against
the CPU; the fake backend's 512-rank world and its c10d ops on meta
tensors under the card machine's PyTorch; and decode over
sequence-sharded caches over four ranks on the card against the CPU.

These tests import no JAX, so a GPU machine with PyTorch alone runs them,
without the JAX package's conftest:

    PYTHONPATH=src python3 -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Elsewhere they skip.  Tolerances: codes differ by at most 1 on at most
0.1% of entries (rounded up to a whole entry), because the kernel's f32
sums run in another order than the plain product's; scales within rtol
1e-5; the restore within one bf16 ulp (rtol 2**-7, atol 1e-3), or rtol
1e-5 (atol 1e-6) in f32 up to d_r = 64; a wider f32 restore, and its plain
version, within the f32 summation bound of an f64 product.  Flash attention
within rtol/atol 2e-5 in f32 (f32 sums in another order) and, in bf16, within
|out - o| <= 2**-7 |o| + 2**-7 sum_t w_t |v_t - o| of the f32 plain result
o and its softmax weights w, row by row: the tensor-core kernel rounds its
weights P to bf16 (see _flash_bf16_close).
The fused restore+norm kernel's x equals the restore kernel's and its h the
RMSNorm kernel's on that x, bit for bit (one shared row routine); x against
the plain restore as above (in f32 both within the summation bound of an
f64 product), h and the RMSNorm kernel against the plain norm
of the same x within rtol 1e-5 (atol 1e-6) in f32 (the mean of squares sums
in another order) and one bf16 ulp in bf16.  The bincount kernel's codes
and scales equal reduce_quant's bit for bit and its counts the histogram of
those codes exactly.  MoE routing on the card equals the CPU's (expert
ids, capacity slots) in f32 without TF32; outputs and logits, f32 sums in
another order, within rtol/atol 1e-4.
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


# every compiled variant: reduce_quant's channel widths 32..1024 in f32
# (CUDA cores) and bf16 (tensor cores), bf16 row tiles of 16 up to 1,024
# rows and of 64 above (d_r <= 128), split-K on (d > one chunk; up to 64
# slices below 16 rows, at most 8 from 16 rows on) and off (d=64 in bf16
# and d=128 at d_r <= 64 in f32 are one chunk), bf16 x rows whose width is
# not a whole number of 16-byte pieces (d=100, 1001: element loads);
# dequant_restore past 48 KB of shared memory at d_r = 1024, its bf16 row
# tiles of 16, 32, 64 and 128 on both sides of each switch (128/129,
# 256/257, 512/513 rows at d = 3840-4096: see
# test_restore_plan_switches_where_tested), w_restore loaded once for a
# block's walk (one or two k chunks, d_r <= 128) or streamed through the
# ring (256-1024), the codes copied 16 bytes at a time (d_r a multiple of
# 16), 4 (gemma3's d_r = 60, zeros up to k = 64) or one (d_r = 33), and
# widths whose rows are not whole 16-byte pieces; and the dense configs'
# wires: qwen3-14b's d=5120, d_r=80 (padded to 128 channels) and gemma-7b's
# d=3072, d_r=48 (padded to 64)
@pytest.mark.parametrize("T", [1, 4, 8, 16, 32, 33, 37, 128, 129, 256, 257,
                               512, 513, 1024, 1025, 4096])
@pytest.mark.parametrize("d,d_r,dtype", [(4096, 64, torch.bfloat16),
                                         (3840, 60, torch.bfloat16),
                                         (5120, 80, torch.bfloat16),
                                         (3072, 48, torch.bfloat16),
                                         (256, 16, torch.float32),
                                         (200, 48, torch.bfloat16),
                                         (512, 128, torch.float32),
                                         (512, 128, torch.bfloat16),
                                         (384, 256, torch.bfloat16),
                                         (384, 512, torch.float32),
                                         (256, 1024, torch.float32),
                                         (256, 1024, torch.bfloat16),
                                         (64, 64, torch.bfloat16),
                                         (128, 32, torch.float32),
                                         (100, 16, torch.bfloat16),
                                         (1001, 48, torch.bfloat16),
                                         (1001, 33, torch.bfloat16)])
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
# width in f32 and bf16, both bf16 row tiles, split-K on and off), at both
# widths of the code alphabet: codes and scales bit for bit reduce_quant's,
# counts exactly the plain histogram of those codes, and within 2 per
# differing code of the whole plain version's (its codes may differ by 1 on
# 0.1% of entries)
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("T", [1, 4, 16, 32, 33, 37, 512, 1024, 1025])
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
                                         (256, 1024, torch.bfloat16),
                                         (64, 64, torch.bfloat16)])
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


def test_restore_plan_switches_where_tested(cuda):
    """bf16 dequant_restore's row tiles switch where the tests put rows on
    both sides (test_kernels_match_plain, test_restore_norm_matches_plain_
    and_its_parts): 16 rows up to 128, 32 up to 256, 64 up to 512, 128
    beyond, at both models' widths; d_r = 1024 keeps 16-row tiles."""
    want = {1: 16, 128: 16, 129: 32, 256: 32, 257: 64, 512: 64, 513: 128,
            4096: 128}
    for d, d_r in ((4096, 64), (3840, 60)):
        got = {T: butterfly_kernel.restore_plan(T, d, d_r)["rows"] for T in want}
        assert got == want, (d, d_r, got)
    assert butterfly_kernel.restore_plan(4096, 256, 1024)["rows"] == 16


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
# models: every block of a cluster's eight 512-column slabs busy, the last
# half idle), 5000 (two slabs for some blocks), ragged widths and every width
# of the rmsnorm test (16-byte rows take the norm routine's vector branch, d
# 33 and 1001 its scalar one; at small d most blocks restore nothing), 1 to
# 4,096 rows (one or many 16-row tiles, a ragged last tile; a cluster owns
# one tile up to one wave of clusters and more beyond, see below), and
# both sides of each switch of dequant_restore's bf16 row tiles, so x equals
# its output whatever tile shape computed that output
@pytest.mark.parametrize("T", [1, 4, 16, 17, 37, 128, 129, 240, 241, 256, 257,
                               512, 513, 1025, 4096])
@pytest.mark.parametrize("d,d_r,dtype", [(4096, 64, torch.bfloat16),
                                         (3840, 60, torch.bfloat16),
                                         (4096, 64, torch.float32),
                                         (256, 16, torch.float32),
                                         (200, 48, torch.bfloat16),
                                         (384, 1024, torch.float32),
                                         (256, 1024, torch.bfloat16),
                                         # the other widths of the rmsnorm test
                                         (33, 16, torch.float32),
                                         (1000, 48, torch.bfloat16),
                                         (1001, 16, torch.bfloat16),
                                         (5000, 64, torch.bfloat16),
                                         # codes read a byte at a time
                                         (4096, 33, torch.bfloat16)])
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


def test_restore_norm_cluster_tiles_on_both_sides_of_one_wave(cuda):
    """A restore_norm cluster owns one 16-row tile while the clusters fit
    one wave of the card and several beyond: both sides of that switch (and
    a ragged count well past it), at d_r 64 and 1024 (shared memory past
    48 KB), keep x equal to dequant_restore's and h to rmsnorm's."""
    for d_r, dtype in ((64, torch.bfloat16), (1024, torch.float32)):
        wave = butterfly_kernel.restore_norm_wave(d_r, dtype)
        assert wave >= 1
        for T in (16 * wave, 16 * wave + 1, 48 * wave + 5):
            codes, scales, wr, nw = (t.to(cuda) for t in _restore_inputs(
                T, 512, d_r, dtype, seed=T))
            x, h = ops.butterfly_restore_norm(codes, scales, wr, nw, eps=1e-6,
                                              out_dtype=dtype)
            assert torch.equal(x, ops.butterfly_dequant_restore(
                codes, scales, wr, out_dtype=dtype))
            assert torch.equal(h, ops.rmsnorm(x, nw, eps=1e-6))
            _near_restore(x, codes, scales, wr, dtype)


# the wire kernels' blocks share data within a launch (reduce_quant's
# split-K partials and tickets, restore_norm's x across a cluster, and the
# restore tiles' w_restore kept in shared memory across tiles): any missing
# fence, stale read or reused ticket shows as a call that differs
@pytest.mark.parametrize("T", [1, 4, 128, 4096])
def test_wire_kernels_repeat_bit_for_bit(cuda, T):
    x, w = (t.to(cuda) for t in _inputs(T, 4096, 64, torch.bfloat16, seed=T))
    codes, scales, wr, nw = (t.to(cuda) for t in _restore_inputs(
        T, 4096, 64, torch.bfloat16, seed=T))

    def calls():
        return (ops.butterfly_reduce_quant(x, w),
                ops.butterfly_restore_norm(codes, scales, wr, nw, eps=1e-6,
                                           out_dtype=torch.bfloat16),
                (ops.butterfly_dequant_restore(codes, scales, wr,
                                               out_dtype=torch.bfloat16),))

    first = calls()
    for _ in range(19):
        for a, b in zip(first, calls()):
            assert all(torch.equal(u, v) for u, v in zip(a, b))


def test_wire_kernels_on_two_streams_match_serial(cuda):
    """reduce_quant, restore_norm and dequant_restore, 10 calls each on
    each of two streams at once (their launches interleave on the card),
    give what serial calls on the default stream give, bit for bit: the
    two streams' split-K tickets never meet."""
    shapes = (1, 4, 128)
    xs = [tuple(t.to(cuda) for t in _inputs(T, 4096, 64, torch.bfloat16, seed=T))
          for T in shapes]
    rs = [tuple(t.to(cuda) for t in _restore_inputs(T, 4096, 64, torch.bfloat16,
                                                     seed=T))
          for T in shapes]

    def calls():
        out = []
        for (x, w), (codes, scales, wr, nw) in zip(xs, rs):
            out.append(ops.butterfly_reduce_quant(x, w))
            out.append(ops.butterfly_restore_norm(codes, scales, wr, nw, eps=1e-6,
                                                  out_dtype=torch.bfloat16))
            out.append((ops.butterfly_dequant_restore(codes, scales, wr,
                                                      out_dtype=torch.bfloat16),))
        return out

    want = calls()
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    got = [[], []]
    for _ in range(10):
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                got[i].append(calls())
    torch.cuda.synchronize()
    for per_stream in got:
        for outs in per_stream:
            for a, b in zip(want, outs):
                assert all(torch.equal(u, v) for u, v in zip(a, b))


@pytest.mark.parametrize("T", [1, 2, 3, 4, 9, 512, 4096])
@pytest.mark.parametrize("d,dtype", [(4096, torch.bfloat16), (3840, torch.bfloat16),
                                     (4096, torch.float32), (33, torch.float32),
                                     (1000, torch.bfloat16), (1001, torch.bfloat16)])
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


def _flash_bf16_close(out, q, k, v, causal, window):
    """bf16 flash against the f32 plain result o: |out - o| <= 2**-7 |o| +
    2**-7 sum_t w_t |v_t - o| elementwise, w the plain softmax weights of
    the row.  The kernel rounds each weight to bf16 (unit roundoff u =
    2**-8) and divides by the sum of the rounded weights, which moves the
    output by at most 2u sum_t w_t |v_t - o|; rounding the output adds
    u |o|.  ``ref.flash_attention_bf16_bound`` states the derivation."""
    o, bound = ref.flash_attention_bf16_bound(q, k, v, causal=causal, window=window)
    excess = (out.float() - o).abs() / bound
    assert bool((excess <= 1).all()), float(excess.max())


def _flash_case(cuda, B, S, T, N, K, hd, dtype, causal, window, rng):
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .to(device=cuda, dtype=dtype)
               for shape in ((B, S, N, hd), (B, T, K, hd), (B, T, K, hd)))
    n0 = fa.flash_attention.launches
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert fa.flash_attention.launches == n0 + 1
    assert out.dtype == dtype and out.shape == (B, S, N, hd)
    if dtype == torch.float32:
        want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
        torch.testing.assert_close(out, want, rtol=2e-5, atol=2e-5)
    else:
        _flash_bf16_close(out, q, k, v, causal, window)


@pytest.mark.parametrize("mask", ["causal", "window", "full", "full+window"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", fa.HEAD_DIMS)
def test_flash_attention_matches_plain(cuda, hd, dtype, mask):
    causal = mask in ("causal", "window")
    window = 16 if "window" in mask else None
    rng = np.random.default_rng(hd)
    for B, S, T, N, K in FLASH_SHAPES:
        _flash_case(cuda, B, S, T, N, K, hd, dtype, causal, window, rng)
    torch.cuda.synchronize()


# the main paths' shapes (chip_smoke.py's FLASH_PATH: gemma3-12b's global
# and windowed layers on 2,048- and 100-token prompts, qwen3-8b on 128,
# gemma-7b's MHA (one query head a key head) on 2,048 and 100, qwen3-14b's
# five query heads a key head on 128), and B*N = 512 blocks a query tile,
# several waves over 132 SMs
@pytest.mark.parametrize("B,S,N,K,hd,window", [(1, 2048, 16, 8, 256, None),
                                               (1, 2048, 16, 8, 256, 1024),
                                               (1, 100, 16, 8, 256, None),
                                               (1, 128, 32, 8, 128, None),
                                               (1, 2048, 16, 16, 256, None),
                                               (1, 100, 16, 16, 256, None),
                                               (1, 128, 40, 8, 128, None),
                                               (16, 130, 32, 8, 128, 64),
                                               (8, 200, 64, 8, 64, None)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_path_shapes_and_waves(cuda, B, S, N, K, hd, window, dtype):
    _flash_case(cuda, B, S, S, N, K, hd, dtype, True, window,
                np.random.default_rng(S + hd))
    torch.cuda.synchronize()


@pytest.mark.parametrize("hd", fa.HEAD_DIMS)
def test_flash_bf16_runs_on_the_tensor_cores(cuda, hd):
    """A bf16 call launches the tensor-core kernel (wgmma, TMA) and an f32
    call the CUDA-core one, each once, by the profiler's kernel names."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    names = {}
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.randn((1, 64, 4, hd), device=cuda).to(dtype)
        k = torch.randn((1, 64, 2, hd), device=cuda).to(dtype)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fa.flash_attention(q, k, k)
            torch.cuda.synchronize()
        names[dtype] = [e.name for e in prof.events()
                        if e.device_type == DeviceType.CUDA and "flash_attention" in e.name]
    assert len(names[torch.bfloat16]) == 1 and \
        "flash_attention_tc_kernel" in names[torch.bfloat16][0]
    assert len(names[torch.float32]) == 1 and \
        "flash_attention_tc_kernel" not in names[torch.float32][0]


# the later families' flash shapes: whisper-base's encoder (1,500 frames,
# non-causal, 8 heads a key head each at hd 64) and its decoder on a
# 32-token prompt, pixtral-12b's 1,024 patches + 100 tokens (causal, G=4),
# and zamba2-7b's shared attention (32 heads, MHA, hd 112) on its 2,048- and
# 100-token prompts
@pytest.mark.parametrize("B,S,N,K,hd,causal", [(1, 1500, 8, 8, 64, False),
                                               (1, 32, 8, 8, 64, True),
                                               (1, 1124, 32, 8, 128, True),
                                               (1, 2048, 32, 32, 112, True),
                                               (1, 100, 32, 32, 112, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_new_family_shapes(cuda, B, S, N, K, hd, causal, dtype):
    _flash_case(cuda, B, S, S, N, K, hd, dtype, causal, None,
                np.random.default_rng(S + hd))
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


def test_mha_model_kernel_prefill_and_decode(cuda):
    """Reduced gemma-7b with its MHA kept (4 query heads, 4 key heads; f32,
    d_r=16 butterfly after layer 2) on the card: a 40-token kernel prefill
    launches the flash kernel once a layer and stays near the plain
    prefill, and 8 greedy decode steps stay near the plain run's."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    base = get_config("gemma-7b").reduced()
    cfg = dataclasses.replace(base, num_layers=4, num_kv_heads=base.num_heads
                              ).with_butterfly(2, 16)
    built = M.build(cfg)
    params = M.init_model(torch.Generator(device=cuda).manual_seed(0), built,
                          device=cuda)
    S, steps = 40, 8
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, S))).to(cuda)
    n = fa.flash_attention.launches
    logits, caches = M.forward_prefill(params, built, {"tokens": toks},
                                       use_kernel=True)
    assert fa.flash_attention.launches == n + cfg.num_layers
    ref_logits, ref_caches = M.forward_prefill(params, built, {"tokens": toks})

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


@pytest.mark.parametrize("split", [3, 7, 13, 16])
def test_resnet_split_on_the_card_matches_cpu(cuda, split):
    """Full-width ResNet-50 in f32 (no TF32) on two 64x64 images, split at
    the paper's Fig. 7 points with their least d_r: on the card the
    in-graph forward and edge_cloud_split agree within 1e-4; the card's
    codes equal the port's CPU run's (at most 1 apart on at most 0.1% of
    entries), scales within rtol 1e-5 and an atol of 1e-5 of the largest
    scale, and the card's cloud half on the CPU's wire gives the CPU's
    logits within 1e-4.  No kernel launches: the ResNet wire quantizes in
    plain PyTorch, as the JAX package's does."""
    from repro_torch.configs.resnet50 import PAPER_MIN_DR, resnet50
    from repro_torch.models import resnet as R
    from repro_torch.tree import tree_map
    d_r = PAPER_MIN_DR[split]
    cfg = dataclasses.replace(resnet50(), image_size=64).with_butterfly(split, d_r)
    params = R.init_resnet(torch.Generator(device=cuda).manual_seed(0), cfg,
                           device=cuda)
    images = torch.from_numpy(np.random.default_rng(split).standard_normal(
        (2, 64, 64, 3)).astype(np.float32))
    before = dict(_launch_counts())
    logits, wire = R.edge_cloud_split(params, images.to(cuda), cfg)
    ingraph = R.forward_resnet(params, images.to(cuda), cfg)
    assert _launch_counts() == before
    torch.testing.assert_close(ingraph, logits, rtol=1e-4, atol=1e-4)
    sp = cfg.block_spatial()[split - 1]
    assert wire["codes"].dtype == torch.int8
    assert tuple(wire["codes"].shape) == (2, sp, sp, d_r)
    cpu_params = tree_map(lambda t: t.cpu(), params)
    cpu_wire = R.edge_half(cpu_params, images, cfg)
    diff = (wire["codes"].cpu().int() - cpu_wire["codes"].int()).abs()
    assert int(diff.max()) <= 1
    assert int((diff > 0).sum()) <= math.ceil(1e-3 * diff.numel())
    torch.testing.assert_close(wire["scales"].cpu(), cpu_wire["scales"],
                               rtol=1e-5,
                               atol=1e-5 * float(cpu_wire["scales"].abs().max()))
    card = R.cloud_half(params, {k: v.to(cuda) for k, v in cpu_wire.items()},
                        cfg, torch.float32)
    torch.testing.assert_close(card.cpu(), R.cloud_half(
        cpu_params, cpu_wire, cfg, torch.float32), rtol=1e-4, atol=1e-4)


def _launch_counts():
    return {fn.__name__: fn.launches for fn in (
        butterfly_kernel.reduce_quant, butterfly_kernel.dequant_restore,
        butterfly_kernel.dequant_restore_norm,
        butterfly_kernel.reduce_quant_bincount, fa.flash_attention,
        rmsnorm_kernel.rmsnorm)}


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


@pytest.mark.parametrize("wire_mode", ["raw", "reduced", "int8", "int4", "entropy"])
def test_two_stream_split_pipeline_matches_serial(cuda, wire_mode):
    """The prefill pipeline (``make_split_pipeline``) on reduced qwen3 (3
    layers, bf16, d_r=32 after layer 2) with both pods on the card, each on
    its own stream: its logits equal a serial run on one stream, bit for
    bit; Mmb wires and Mmb logit rows cross; no kernel launches, as in the
    reference."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serving.pipeline import make_split_pipeline
    cfg = dataclasses.replace(get_config("qwen3-8b").reduced(), num_layers=3,
                              dtype="bfloat16").with_butterfly(2, 32)
    built = M.build(cfg)
    params = M.init_model(torch.Generator(device=cuda).manual_seed(0), built,
                          device=cuda)
    Mmb, mb, S = 3, 4, 16
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (Mmb * mb, S))).to(cuda)
    kernels = (butterfly_kernel.reduce_quant, butterfly_kernel.dequant_restore,
               butterfly_kernel.dequant_restore_norm, fa.flash_attention,
               rmsnorm_kernel.rmsnorm)
    n0 = [k.launches for k in kernels]
    out, crossings = [], []
    for pipelined in (True, False):
        fn = make_split_pipeline(built, (cuda, cuda), Mmb, S, mb, wire_mode,
                                 pipelined=pipelined)
        out.append(fn(params, toks, crossings))
    torch.cuda.synchronize()
    assert [k.launches for k in kernels] == n0
    assert out[0].shape == (Mmb * mb, cfg.vocab_size) and out[0].is_cuda
    assert torch.isfinite(out[0]).all() and torch.equal(out[0], out[1])
    assert sorted(c[0] for c in crossings) == \
        ["cloud->edge"] * 2 * Mmb + ["edge->cloud"] * 2 * Mmb


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["qwen3-8b", "gemma3-12b", "qwen3-moe-235b-a22b",
                                  "whisper-base", "zamba2-7b", "xlstm-125m"])
def test_dry_run_counts_on_the_card_equal_meta(cuda, arch, kind):
    """The dry run's FLOPs, bytes and argument, output and peak live bytes
    of a reduced step (butterfly after layer 1, 2 x 32 tokens) counted on
    the card equal those counted on meta tensors."""
    from repro_torch.configs import InputShape, get_config
    from repro_torch.launch import dryrun
    from repro_torch.models import model as M
    cfg = get_config(arch).reduced()
    if arch == "qwen3-moe-235b-a22b":
        cfg = dataclasses.replace(cfg, num_layers=3)
    built = M.build(cfg.with_butterfly(1, 16))
    shape = InputShape("t", 32, 2, kind)
    runs = []
    for device in ("meta", "cuda"):
        counter, memory = dryrun.count_step(built, shape, device)
        runs.append((counter.flops, counter.bytes, memory))
    assert runs[0] == runs[1]


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


def _train_on(step, params, batches):
    from repro_torch.training import adamw_init
    opt = adamw_init(params)
    out = []
    for batch in batches:
        params, opt, loss, gnorm = step(params, opt, batch)
        out += [float(loss), float(gnorm)]
    return out


def test_lm_training_on_the_card_matches_cpu(cuda):
    """The reduced f32 qwen3 (vocab 64) with a d_r=16 butterfly after layer
    1 and the rate term takes 5 steps from one init on the card and on the
    CPU: losses and grad norms within rtol 1e-3 (chip_smoke.py's TRAIN_RTOL:
    sums in another order flip a few wire codes), no kernel launched, the
    params left on the card in f32."""
    from repro_torch.configs import get_config
    from repro_torch.data import lm_batches
    from repro_torch.models import model as M
    from repro_torch.training import (AdamWConfig, cosine_schedule,
                                      make_train_step)
    from repro_torch.tree import tree_leaves, tree_map
    cfg = dataclasses.replace(get_config("qwen3-8b").reduced(), vocab_size=64)
    built = M.build(cfg.with_butterfly(1, 16, rate_weight=0.01))
    train = make_train_step(built, AdamWConfig(lr=cosine_schedule(1e-3, 2, 5)))

    def step(params, opt, batch):
        params, opt, m = train(params, opt, batch)
        return params, opt, m["loss"], m["grad_norm"]

    stream = lm_batches(64, 64, 4, seed=1)
    batches = [{k: torch.from_numpy(v) for k, v in next(stream).items()}
               for _ in range(5)]
    cpu = M.init_model(torch.Generator().manual_seed(0), built, device="cpu")
    card = tree_map(lambda t: t.to(cuda), cpu)
    before = _launch_counts()
    got = _train_on(step, card, [tree_map(lambda t: t.to(cuda), b) for b in batches])
    assert _launch_counts() == before
    want = _train_on(step, cpu, batches)
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert all(t.is_cuda and t.dtype == torch.float32 for t in tree_leaves(card))


def test_resnet_training_on_the_card_matches_cpu(cuda):
    """The reduced ResNet with a d_r=2 butterfly after RB1 takes 3 steps of
    the training example's step on the card and on the CPU (f32 without
    TF32): losses and grad norms within rtol 1e-3; no kernel launched."""
    from repro_torch.configs.resnet50 import resnet50
    from repro_torch.data import ImageTaskConfig, image_batches
    from repro_torch.examples.train_resnet_butterfly import make_resnet_step
    from repro_torch.models import resnet as R
    from repro_torch.training import AdamWConfig, constant_schedule
    from repro_torch.tree import tree_map
    cfg = resnet50().reduced().with_butterfly(1, 2)
    train = make_resnet_step(cfg, AdamWConfig(lr=constant_schedule(1e-3),
                                              weight_decay=1e-4))
    step = lambda p, o, b: train(p, o, *b)
    stream = image_batches(8, ImageTaskConfig(num_classes=cfg.num_classes,
                                              image_size=cfg.image_size))
    batches = [tuple(torch.from_numpy(a) for a in next(stream)) for _ in range(3)]
    cpu = R.init_resnet(torch.Generator().manual_seed(0), cfg, device="cpu")
    card = tree_map(lambda t: t.to(cuda), cpu)
    before = _launch_counts()
    got = _train_on(step, card, [tuple(a.to(cuda) for a in b) for b in batches])
    assert _launch_counts() == before
    np.testing.assert_allclose(got, _train_on(step, cpu, batches), rtol=1e-3)


@pytest.mark.parametrize("bits", [8, 4])
def test_wire_gradients_on_the_card_match_cpu(cuda, bits):
    """fake_quant's gradient is the upstream gradient on the card too, and
    its forward within rtol 1e-6 of the CPU's (the card divides by qmax, a
    host scalar, as a product with its reciprocal, so a scale may differ in
    its last bit); rate_bits's value within rtol 1e-5 and its grads within
    1e-5 of their largest, card against CPU."""
    from repro_torch.core.quantization import fake_quant
    from repro_torch.core.wire_codec import rate_bits
    rng = np.random.default_rng(bits)
    r = torch.from_numpy(rng.standard_normal((4, 9, 16)).astype(np.float32))
    logits = torch.from_numpy(rng.standard_normal((16, 2 ** bits)).astype(np.float32))
    up = torch.from_numpy(rng.standard_normal((4, 9, 16)).astype(np.float32))
    grads = []
    for dev in ("cpu", cuda):
        x = r.to(dev, copy=True).requires_grad_()
        y = fake_quant(x, bits)
        y.backward(up.to(dev))
        assert torch.equal(x.grad.cpu(), up)
        grads.append(y.detach().cpu())
        x = r.to(dev, copy=True).requires_grad_()
        lg = logits.to(dev, copy=True).requires_grad_()
        v = rate_bits(x, bits, lg)
        v.backward()
        grads += [v.detach().cpu(), x.grad.cpu(), lg.grad.cpu()]
    torch.testing.assert_close(grads[4], grads[0], rtol=1e-6, atol=0)
    torch.testing.assert_close(grads[5], grads[1], rtol=1e-5, atol=0)
    for a, b in ((grads[6], grads[2]), (grads[7], grads[3])):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * float(b.abs().max()))


def test_checkpoint_round_trips_from_the_card(cuda, tmp_path):
    """bf16 params and f32 moments saved from the card come back onto the
    card exactly, in their dtypes."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.training import init_train_state
    from repro_torch.training.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.tree import tree_leaves
    cfg = dataclasses.replace(get_config("qwen3-8b").reduced(), dtype="bfloat16")
    built = M.build(cfg.with_butterfly(1, 16))
    params, opt, _ = init_train_state(
        torch.Generator(device=cuda).manual_seed(0), built, device=cuda)
    opt["mu"]["embed"].add_(0.5)
    path = save_checkpoint(str(tmp_path / "ckpt"), params, opt, step=4)
    template = M.init_model(torch.Generator(device=cuda).manual_seed(1), built,
                            device=cuda)
    back, back_opt, meta = restore_checkpoint(path, template, opt)
    assert meta == {"step": 4}
    for a, b in zip(tree_leaves((params, opt)), tree_leaves((back, back_opt))):
        assert b.is_cuda and b.dtype == a.dtype and torch.equal(a, b)


@pytest.mark.parametrize("d,E,k,shared", [(256, 4, 2, 0), (4096, 128, 8, 0),
                                          (5120, 128, 1, 64)])
def test_moe_dispatch_on_the_card_matches_cpu(cuda, d, E, k, shared):
    """The MoE layer in f32 on the card and on the CPU from one init: the
    reduced qwen3-moe layer, and the routers of qwen3-moe-235b-a22b (d 4096,
    128 experts, top 8) and llama4-maverick (d 5120, 128, top 1, a shared
    expert) at their published widths with 64-wide experts, on 128 tokens
    at the default capacity (the wide routers drop choices): expert ids, capacity
    slots and buffer rows equal, outputs and aux losses within 1e-4."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.tree import tree_map
    base = get_config("qwen3-moe-235b-a22b").reduced()
    cfg = dataclasses.replace(base, d_model=d, moe=dataclasses.replace(
        base.moe, num_experts=E, top_k=k, d_ff_expert=64, shared_expert_ff=shared))
    params = moe.init_moe(torch.Generator().manual_seed(0), cfg, torch.float32, "cpu")
    card = tree_map(lambda t: t.to(cuda), params)
    x = torch.from_numpy(np.random.default_rng(d).standard_normal(
        (2, 64, d)).astype(np.float32))
    cap = moe._capacity(128, cfg.moe)
    routes = [moe.route(xx.reshape(128, d), p["router"], cfg.moe, cap)
              for xx, p in ((x, params), (x.to(cuda), card))]
    for a, b in zip(routes[0][3:], routes[1][3:]):
        assert torch.equal(a, b.cpu())
    assert (int((routes[0][4] >= cap).sum()) > 0) == (E == 128)
    out, aux = moe.apply_moe(params, x, cfg=cfg, act=cfg.act)
    out_c, aux_c = moe.apply_moe(card, x.to(cuda), cfg=cfg, act=cfg.act)
    torch.testing.assert_close(out_c.cpu(), out, rtol=1e-4, atol=1e-4)
    for key in aux:
        torch.testing.assert_close(aux_c[key].cpu(), aux[key], rtol=1e-4, atol=0)


def test_whisper_kernel_prefill_on_the_card_matches_cpu(cuda):
    """Reduced whisper (2 + 2 layers, 16 frames, f32 without TF32) from one
    init: the card's kernel prefill launches flash once an encoder layer
    (non-causal) and once a decoder layer, and its logits and caches, then
    8 greedy decode steps through the cross_kv cache, stay within 1e-4 of
    the CPU's (its flash is the plain version)."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.tree import tree_leaves, tree_map
    cfg = get_config("whisper-base").reduced()
    built = M.build(cfg)
    params = M.init_model(torch.Generator().manual_seed(0), built, device="cpu")
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 20))),
             "frames": torch.from_numpy(rng.standard_normal(
                 (1, cfg.encoder_frames, cfg.d_model)).astype(np.float32))}
    card = tree_map(lambda t: t.to(cuda), params)
    n = fa.flash_attention.launches
    logits_c, caches_c = M.forward_prefill(
        card, built, {k: v.to(cuda) for k, v in batch.items()}, use_kernel=True)
    assert fa.flash_attention.launches == n + cfg.encoder_layers + cfg.num_layers
    logits, caches = M.forward_prefill(params, built, batch, use_kernel=True)
    torch.testing.assert_close(logits_c.cpu(), logits, rtol=1e-4, atol=1e-4)
    for a, b in zip(tree_leaves(caches_c), tree_leaves(caches)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)
    caches_c = M.pad_decode_caches(built, caches_c, 28)
    caches = M.pad_decode_caches(built, caches, 28)
    tok = logits[:, -1].argmax(-1, keepdim=True)
    for pos in range(20, 28):
        logits_c, caches_c = M.forward_decode(card, built, tok.to(cuda), caches_c, pos)
        logits, caches = M.forward_decode(params, built, tok, caches, pos)
        torch.testing.assert_close(logits_c.cpu(), logits, rtol=1e-4, atol=1e-4)
        tok = logits[:, -1].argmax(-1, keepdim=True)
        assert int(logits_c[:, -1].argmax()) == int(tok)


@pytest.mark.parametrize("arch", ["zamba2-7b", "xlstm-125m"])
def test_recurrent_model_on_the_card_matches_cpu(cuda, arch):
    """Reduced zamba2 and xLSTM (f32 without TF32) with a butterfly after
    layer 1, from one init: the card's kernel prefill (flash in zamba2's
    shared layer, the fused wire kernels), then 8 greedy decode steps, stay
    within 1e-4 of the CPU's, logits and recurrent states; the card's
    pipelined and serial two-pod decode agree on ids and states, bit for
    bit."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.runtime.split_exec import SplitModelBank
    from repro_torch.tree import tree_leaves, tree_map
    cfg = dataclasses.replace(get_config(arch).reduced(), num_layers=4)
    built = M.build(cfg.with_butterfly(1, 16))
    params = M.init_model(torch.Generator().manual_seed(0), built, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16)))
    card = tree_map(lambda t: t.to(cuda), params)
    n = fa.flash_attention.launches
    logits_c, caches_c = M.forward_prefill(card, built, {"tokens": toks.to(cuda)},
                                           use_kernel=True)
    assert fa.flash_attention.launches == n + (2 if arch == "zamba2-7b" else 0)
    logits, caches = M.forward_prefill(params, built, {"tokens": toks}, use_kernel=True)
    torch.testing.assert_close(logits_c.cpu(), logits, rtol=1e-4, atol=1e-4)
    caches_c = M.pad_decode_caches(built, caches_c, 24)
    caches = M.pad_decode_caches(built, caches, 24)
    tok = logits[:, -1].argmax(-1, keepdim=True)
    for pos in range(16, 24):
        logits_c, caches_c = M.forward_decode(card, built, tok.to(cuda), caches_c,
                                              pos, use_kernel=True)
        logits, caches = M.forward_decode(params, built, tok, caches, pos,
                                          use_kernel=True)
        torch.testing.assert_close(logits_c.cpu(), logits, rtol=1e-4, atol=1e-4)
        tok = logits[:, -1].argmax(-1, keepdim=True)
    for a, b in zip(tree_leaves(caches_c), tree_leaves(caches)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)

    bank = SplitModelBank(cfg, 16, seed=0, device=cuda)
    out = []
    for pipelined in (True, False):
        states = {}
        ids = bank.runner(1).decode_pipeline(None, 2, 16, 2, 4, pipelined=pipelined,
                                             use_kernel=True)(toks.repeat(2, 1), None,
                                                              states)
        out.append((ids, tree_leaves(states)))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


def _gloo_rank(rank, device):
    import torch.distributed as dist
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.full((4, 4096), float(rank + 1), dtype=dtype, device=device)
        dist.all_reduce(x)
        out[str(dtype)] = (x.device.type, x.dtype, float(x.float().min()),
                           float(x.float().max()))
    return out


def test_gloo_all_reduce_of_two_ranks_on_one_card(cuda):
    """Two spawned ranks share card 0 over gloo (``parallel.backend_for``:
    NCCL refuses two ranks on one device): their all_reduce of bf16 and f32
    CUDA tensors sums in place, on the card."""
    from repro_torch.models import parallel
    assert parallel.backend_for(["cuda:0", "cuda:0"]) == "gloo"
    for out in parallel.spawn(_gloo_rank, 2, devices="cuda:0"):
        assert out == {str(dt): ("cuda", dt, 3.0, 3.0)
                       for dt in (torch.bfloat16, torch.float32)}


def _gloo_gather_rank(rank, device):
    import torch.distributed as dist
    x = torch.full((2, 3), float(rank + 1), device=device)
    parts = [torch.empty_like(x) for _ in range(2)]
    dist.all_gather(parts, x)
    out = torch.empty((1, 3), device=device)
    dist.reduce_scatter(out, [torch.full((1, 3), float(rank + 1), device=device),
                              torch.full((1, 3), 10.0 * (rank + 1), device=device)])
    return torch.cat(parts).cpu(), out.cpu(), out.device.type


def test_gloo_gather_and_reduce_scatter_on_one_card(cuda):
    """gloo's all_gather and reduce_scatter of CUDA tensors, which the
    automatic regime's FSDP gather and its backward issue, run on the
    card: rank r gathers both ranks' blocks in rank order and receives the
    sum of block r."""
    from repro_torch.models import parallel
    for r, (gathered, reduced, where) in enumerate(
            parallel.spawn(_gloo_gather_rank, 2, devices="cuda:0")):
        assert where == "cuda"
        assert torch.equal(gathered, torch.tensor([[1.0] * 3] * 2 + [[2.0] * 3] * 2))
        assert torch.equal(reduced, torch.full((1, 3), 3.0 * (1 if r == 0 else 10)))


def _axis_family(kind):
    from repro_torch.configs import get_config
    if kind == "moe":
        cfg = get_config("qwen3-moe-235b-a22b").reduced()
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, num_experts=4, top_k=2))
    elif kind == "zamba2":
        cfg = dataclasses.replace(get_config("zamba2-7b").reduced(), num_layers=4)
    else:
        cfg = get_config("qwen3-8b").reduced()
    return dataclasses.replace(cfg, dtype="float32").with_butterfly(1, 16)


def _axis_rank(rank, device):
    """The reduced families at (pod=2, model=2) on the card and on the CPU,
    from one CPU init: split-pipeline logits, decode-pipeline ids (kernels)
    and the MoE routes, recorded by wrapping ``moe.route``."""
    from repro_torch.models import model as M
    from repro_torch.models import moe
    from repro_torch.serving.pipeline import make_decode_pipeline, make_split_pipeline
    from repro_torch.tree import tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    route, out = moe.route, {}
    for kind in ("dense", "moe", "zamba2"):
        built = M.build(_axis_family(kind))
        params = M.init_model(torch.Generator().manual_seed(0), built, device="cpu")
        toks = np.random.default_rng(1).integers(0, built.cfg.vocab_size, (4, 32))
        for dev in ("cpu", "cuda"):
            pods = ((str(device) if dev == "cuda" else "cpu",) * 2,) * 2
            p = params if dev == "cpu" else tree_map(lambda t: t.to(device), params)
            eids = []

            def recording(*a, **kw):
                res = route(*a, **kw)
                eids.append(res[3].cpu())
                return res
            moe.route = recording
            try:
                logits = make_split_pipeline(built, pods, 2, 32, 2)(p, toks).cpu()
                ids = make_decode_pipeline(built, pods, 2, 32, 2, 4,
                                           use_kernel=True)(p, toks).cpu()
            finally:
                moe.route = route
            out[kind, dev] = (logits, ids, eids)
    return out


def test_model_axis_on_the_card_matches_cpu(cuda):
    """Two ranks on card 0 (gloo) at (pod=2, model=2), f32 without TF32:
    dense qwen3, qwen3-moe (4 experts, top-2) and zamba2 (its shared block
    sharded) give the CPU's split-pipeline logits within rtol 1e-4 (atol
    1e-5), its decode-pipeline ids (the wire kernels on the card) and its
    expert ids for every MoE choice; both ranks agree."""
    from repro_torch.models import parallel
    ranks = parallel.spawn(_axis_rank, 2, devices="cuda:0")
    for out in ranks:
        for kind in ("dense", "moe", "zamba2"):
            (lc, ic, ec), (lg, ig, eg) = out[kind, "cpu"], out[kind, "cuda"]
            torch.testing.assert_close(lg, lc, rtol=1e-4, atol=1e-5)
            assert torch.equal(ig, ic), kind
            assert len(ec) == len(eg) and all(torch.equal(a, b)
                                              for a, b in zip(ec, eg)), kind
            assert (kind == "moe") == bool(ec)
            assert torch.equal(lg, ranks[0][kind, "cuda"][0])


def _automatic_rank(rank, device):
    """The MoE layer's automatic branch at (data=2, model=2), reduced
    qwen3-moe in f32 (4 experts, top-2, the default capacity factor 1.25),
    on the card and on the CPU from one CPU init: the train path (4, 32)
    with its FSDP d_ff gather, and the decode broadcast (8, 1)."""
    from repro_torch.data import shard_batch
    from repro_torch.models import moe, parallel
    from repro_torch.tree import tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(_axis_family("moe"), num_heads=8, num_kv_heads=4)
    grid = parallel.RankGrid((2, 2), ("data", "model"))
    pctx = parallel.make_context(grid)
    params = moe.init_moe(torch.Generator().manual_seed(0), cfg, torch.float32, "cpu")
    specs = {"model": {"wg": 0, "wu": 0, "wd": 0},
             "data": {"wg": 2, "wu": 2, "wd": 1}}
    rng = np.random.default_rng(1)
    xs = {"train": rng.standard_normal((4, 32, cfg.d_model)).astype(np.float32),
          "decode": rng.standard_normal((8, 1, cfg.d_model)).astype(np.float32)}
    route, out = moe.route, {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda t: t.to(device if dev == "cuda" else "cpu"),
                     parallel.shard_grid(params, specs, grid))
        for name, x in xs.items():
            eids = []

            def recording(*a, **kw):
                res = route(*a, **kw)
                eids.append(res[3].cpu())
                return res
            moe.route = recording
            try:
                xb = shard_batch({"x": x}, pctx, device=device if dev == "cuda"
                                 else "cpu")["x"]
                o, aux = moe.apply_moe(p, xb, cfg=cfg, act="silu", pctx=pctx)
            finally:
                moe.route = route
            out[name, dev] = (o.cpu(), torch.stack([aux["load_balance"],
                                                    aux["router_z"]]).cpu(), eids,
                              o.device.type)
    return out


def test_moe_automatic_branch_on_the_card_matches_cpu(cuda):
    """Four ranks on card 0 (gloo) at (data=2, model=2), f32 without TF32:
    the automatic branch's outputs (the FSDP d_ff all-gather on the train
    path, the token all-gather and the sums over model and data in the
    decode broadcast) on the card within rtol 1e-4 (atol 1e-5) of the CPU's,
    its aux losses within rtol 1e-4 and every expert id equal; a data
    block's two model ranks agree bit for bit."""
    from repro_torch.models import parallel
    ranks = parallel.spawn(_automatic_rank, 4, devices="cuda:0")
    for r, out in enumerate(ranks):
        for name in ("train", "decode"):
            (oc, ac, ec, _), (og, ag, eg, where) = out[name, "cpu"], out[name, "cuda"]
            assert where == "cuda"
            torch.testing.assert_close(og, oc, rtol=1e-4, atol=1e-5)
            torch.testing.assert_close(ag, ac, rtol=1e-4, atol=0)
            assert len(ec) == len(eg) == 1 and torch.equal(ec[0], eg[0]), name
            mate = ranks[r ^ 1][name, "cuda"][0]
            assert torch.equal(og, mate), name


def test_fake_world_counts_c10d_on_meta(cuda):
    """The dry run's premise on the card's PyTorch: the ``"fake"`` backend
    starts a 512-rank world, builds the grid's groups, runs all_reduce,
    all_gather and reduce_scatter on meta tensors as dispatched ``c10d``
    ops the cost counter counts by their output bytes, and a reduced
    model's grid trace matches between two fake worlds in a row."""
    import torch.distributed as dist
    from repro_torch.configs import InputShape, get_config
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import model as M
    from repro_torch.models import parallel
    grid = make_production_mesh(multi_pod=True)
    with parallel.fake_world(grid, 5):
        pctx = parallel.make_context(grid)
        x = torch.empty((4, 8), device="meta")
        with roofline.CostCounter() as counter:
            parallel.model_psum(x, pctx)
            parallel.all_gather(x, 0, pctx.group)
            parallel.psum_scatter(torch.empty((32, 8), device="meta"), 0, 1,
                                  16, pctx.group)
        assert counter.collectives["all-reduce"] == 4 * 8 * 4 + 32 * 8 * 4
        assert counter.collectives["all-gather"] == 16 * 4 * 8 * 4
    assert not dist.is_initialized()
    built = M.build(dataclasses.replace(get_config("qwen3-8b").reduced(),
                                        num_kv_heads=1))
    shape = InputShape("d", 32, 64, "decode")
    runs = []
    for _ in range(2):
        with parallel.fake_world(grid, 0):
            counter, memory = dryrun.count_step(built, shape, grid=grid)
        runs.append((counter.flops, counter.bytes, dict(counter.collectives),
                     memory))
    assert runs[0] == runs[1] and runs[0][2]["all-reduce"] > 0


def _seq_rank(rank, device):
    """Reduced f32 configs at (data=2, model=2), from one CPU init, on the
    card and on the CPU: a prefill of 20 tokens into sequence-sharded
    caches and 3 greedy decode steps at capacity 32, the caches on
    "model" (a batch of 4) and on ("data", "model") (a batch of 1)."""
    from repro_torch.configs import get_config
    from repro_torch.data import shard_batch
    from repro_torch.models import model as M
    from repro_torch.models import parallel
    from repro_torch.tree import tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    grid = parallel.RankGrid((2, 2), ("data", "model"))
    base = parallel.make_context(grid)
    out = {}
    for name, (arch, over) in SEQ_CASES.items():
        cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                                  **over)
        built = M.build(cfg)
        params = M.init_model(torch.Generator().manual_seed(0), built, device="cpu")
        mine = parallel.shard_grid(params, M.param_specs(built, grid), grid)
        rng = np.random.default_rng(2)
        for B, axis in ((4, "model"), (1, ("data", "model"))):
            batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, 20))}
            if cfg.is_encdec:
                batch["frames"] = rng.standard_normal(
                    (B, cfg.encoder_frames, cfg.d_model)).astype(np.float32)
            pctx = base.for_batch(B).for_cache(axis)
            for dev in ("cpu", "cuda"):
                d = device if dev == "cuda" else "cpu"
                p = tree_map(lambda t: t.to(d), mine)
                b = shard_batch(batch, pctx, device=d)
                logits, caches = M.forward_prefill(p, built, b, pctx,
                                                   use_kernel=True)
                caches = M.pad_decode_caches(built, caches, 32, pctx)
                tok, steps = logits[:, -1].argmax(-1, keepdim=True), [logits]
                for i in range(3):
                    lg, caches = M.forward_decode(p, built, tok, caches, 20 + i,
                                                  pctx, use_kernel=True)
                    tok = lg[:, -1].argmax(-1, keepdim=True)
                    steps.append(lg)
                out[name, B, dev] = ([s.cpu() for s in steps], tok.cpu(),
                                     logits.device.type)
    return out


SEQ_CASES = {"kv replicated": ("qwen3-8b", {"num_kv_heads": 1}),
             "attention replicated": ("qwen3-8b", {"num_heads": 3,
                                                   "num_kv_heads": 1}),
             "ring": ("gemma3-12b", {"sliding_window": 16}),
             "whisper": ("whisper-base", {})}


def test_seq_sharded_decode_on_the_card_matches_cpu(cuda):
    """Four ranks on card 0 (gloo): decode over sequence-sharded caches
    with kv replicated, the attention replicated, a windowed ring and
    whisper's cross attention, each prefill and step's logits on the card
    within rtol 1e-4 (atol 1e-5) of the CPU's in f32 without TF32, the
    greedy ids equal."""
    from repro_torch.models import parallel
    ranks = parallel.spawn(_seq_rank, 4, devices="cuda:0")
    for out in ranks:
        for name in SEQ_CASES:
            for B in (4, 1):
                (sc, tc, _), (sg, tg, where) = out[name, B, "cpu"], out[name, B, "cuda"]
                assert where == "cuda"
                for g, c in zip(sg, sc):
                    torch.testing.assert_close(g, c, rtol=1e-4, atol=1e-5)
                assert torch.equal(tg, tc), (name, B)
