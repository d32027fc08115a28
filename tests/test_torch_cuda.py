"""The port on the card: each kernel against its plain PyTorch version on
the same inputs, the split path launching both butterfly kernels, and the
windowed model's kernel prefill launching the flash kernel.

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
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import butterfly_kernel, flash_attention as fa, ops, ref

pytestmark = pytest.mark.cuda


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
