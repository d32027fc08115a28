"""The port's flash attention against the JAX package's, on the same numpy
inputs.

On a CPU tensor ``repro_torch.kernels.ops.flash_attention`` runs its plain
version (``kernels/ref.flash_attention_ref``); it is held against the JAX
Pallas kernel in interpret mode on the cases of ``tests/test_kernels.py``
(``ATTN_CASES``), at head dims 128 and 256, and on a causal call with more
queries than keys (rows that see no key average v), within rtol/atol 2e-5
in f32 and 2e-2 in bf16.  The Pallas kernel needs its blocks to divide S
and T, so ragged shapes are held against the JAX reference instead.  The
model's ``use_kernel=True`` forward matches JAX's.  Kernel-vs-plain cases
on the card are in ``test_torch_cuda.py``.

The bf16 kernel on the card runs on the tensor cores and rounds its
softmax weights to bf16; ``_emulate_tensor_core_kernel`` repeats its
numerics here, so the bf16 tolerance the card tests use
(``kernels/ref.flash_attention_bf16_bound``: ``|Δ| <= 2**-7 |o| + 2**-7
sum_t w_t |v_t - o|`` per row, against the f32 reference o and its softmax
weights w) is held on the CPU, with a margin of two, at gemma3-12b's head
dim and prompt length, against both the port's and the JAX reference; and
the same bound rejects the emulation with a planted defect.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels import ops as jops, ref as jref
from repro.models import model as JM
from repro_torch import bridge
from repro_torch.configs import get_config as tget_config
from repro_torch.kernels import flash_attention as fa, ops, ref
from repro_torch.models import model as TM

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}

CASES = [
    # B, Sq, Skv, N, K, hd, causal, window  (tests/test_kernels.py ATTN_CASES)
    (2, 128, 128, 4, 2, 64, True, None),
    (2, 128, 128, 4, 2, 64, True, 32),
    (1, 128, 128, 8, 8, 32, False, None),
    (2, 64, 128, 4, 4, 64, True, None),       # continuation (q aligned to end)
    (1, 1, 128, 4, 2, 64, True, None),        # decode-like
    # the head dims of qwen3 and gemma3
    (1, 128, 128, 4, 2, 128, True, 64),
    (1, 64, 128, 2, 1, 256, True, None),
    # more queries than keys: the first 64 rows see no key
    (1, 128, 64, 4, 2, 64, True, None),
]


def _qkv(B, S, T, N, K, hd, dtype, seed=3):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(shape).astype(np.float32)
              for shape in ((B, S, N, hd), (B, T, K, hd), (B, T, K, hd))]
    jd, td, _ = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jd) for a in arrays],
            [torch.from_numpy(a).to(td) for a in arrays])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,S,T,N,K,hd,causal,window", CASES)
def test_flash_attention_matches_jax_kernel(B, S, T, N, K, hd, causal, window,
                                            dtype):
    (qj, kj, vj), (qt, kt, vt) = _qkv(B, S, T, N, K, hd, dtype)
    n0 = fa.flash_attention.launches
    got = ops.flash_attention(qt, kt, vt, causal=causal, window=window)
    assert fa.flash_attention.launches == n0         # CPU: the plain version
    want = jops.flash_attention(qj, kj, vj, causal=causal, window=window,
                                block_q=min(64, S), block_k=64)
    tol = DTYPES[dtype][2]
    assert got.dtype == DTYPES[dtype][1] and got.shape == (B, S, N, hd)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("S,T,causal,window", [(37, 53, True, 16),
                                               (53, 37, True, None),
                                               (45, 45, False, 7)])
def test_flash_attention_ragged_matches_jax_reference(S, T, causal, window):
    (qj, kj, vj), (qt, kt, vt) = _qkv(2, S, T, 4, 2, 64, "float32", seed=5)
    got = ops.flash_attention(qt, kt, vt, causal=causal, window=window)
    want = jref.flash_attention_ref(qj, kj, vj, causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_flash_attention_refuses_bad_input():
    (_, _, _), (q, k, v) = _qkv(1, 8, 8, 2, 1, 64, "float32")
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, v, window=0)
    with pytest.raises(ValueError):                   # the kernel: CUDA only
        fa.flash_attention(q, k, v)


def _qwen_models():
    jc = jget_config("qwen3-8b").reduced()
    tc = tget_config("qwen3-8b").reduced()
    jbuilt, tbuilt = JM.build(jc), TM.build(tc)
    jparams, _ = JM.init_model(jax.random.key(0), jbuilt)
    tparams = bridge.to_torch(jax.tree.map(np.asarray, jparams), device="cpu")
    return jbuilt, jparams, tbuilt, tparams


def test_forward_train_use_kernel_matches_jax():
    """As tests/test_kernels.py holds JAX's use_kernel forward to its plain
    one: the port's use_kernel forward against JAX's, and against its own
    plain forward."""
    jbuilt, jparams, tbuilt, tparams = _qwen_models()
    toks = np.random.default_rng(1).integers(0, tbuilt.cfg.vocab_size,
                                             (2, 64)).astype(np.int32)
    jl, _ = JM.forward_train(jparams, jbuilt, {"tokens": jnp.asarray(toks)},
                             use_kernel=True)
    tl, _ = TM.forward_train(tparams, tbuilt, {"tokens": torch.from_numpy(toks)},
                             use_kernel=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-5)
    plain, _ = TM.forward_train(tparams, tbuilt,
                                {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), plain.numpy(), rtol=2e-4, atol=2e-4)



def _emulate_tensor_core_kernel(q, k, v, causal, window, bk, fault=None):
    """The bf16 tensor-core kernel's numerics in plain PyTorch: f32 scores of
    the bf16 inputs in the log2 domain; per tile of ``bk`` keys the running
    max m, then P = exp2(s - m) rounded to bf16, the denominator summed from
    the rounded P and ``acc = alpha * acc + P @ v`` in f32; the output is
    ``acc / max(l, 1e-30)`` rounded to bf16.  It walks every key tile: a
    tile the kernel skips holds only masked keys, whose weights vanish
    (alpha = 0) once a visible key is seen.

    ``fault`` plants a defect the bound must catch: "skip_tile" has each row
    of the later half drop the first key tile it sees, "scale" makes the
    scores 3% too large."""
    B, S, N, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, S, K, N // K, hd)
    scale = math.log2(math.e) / math.sqrt(hd) * (1.03 if fault == "scale" else 1)
    s = torch.einsum("bskgh,btkh->bkgst", qg, k.float()) * scale
    qpos = torch.arange(S)[:, None] + (T - S)
    kpos = torch.arange(T)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    if fault == "skip_tile":
        first = (qpos - window + 1).clamp(min=0) if window else 0 * qpos
        first = first // bk * bk
        mask &= ~((torch.arange(S)[:, None] >= S // 2) & (kpos >= first)
                  & (kpos < first + bk))
    s = s.masked_fill(~mask, -1e30)
    m = torch.full(s.shape[:-1], -1e30)
    l = torch.zeros(s.shape[:-1])
    acc = torch.zeros(s.shape[:-1] + (hd,))
    vf = v.float()
    for k0 in range(0, T, bk):
        st = s[..., k0:k0 + bk]
        m_new = torch.maximum(m, st.amax(dim=-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(st - m_new[..., None]).to(torch.bfloat16).float()
        l = alpha * l + p.sum(dim=-1)
        acc = alpha[..., None] * acc + torch.einsum(
            "bkgst,btkh->bkgsh", p, vf[:, k0:k0 + bk])
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, N, hd).to(torch.bfloat16)


_BOUNDS = {}


def _bound(S, T, window):
    """Inputs at gemma3-12b's head dim (seeded by S and T), the f32
    reference o, its bf16 bound (``ref.flash_attention_bf16_bound``) and
    the JAX reference's f32 result; computed once a shape."""
    if (S, T, window) not in _BOUNDS:
        (qj, kj, vj), qkv = _qkv(1, S, T, 2, 1, 256, "bfloat16", seed=S + T)
        o, bound = ref.flash_attention_bf16_bound(*qkv, causal=True, window=window)
        o_jax = torch.from_numpy(np.array(jref.flash_attention_ref(
            *(a.astype(jnp.float32) for a in (qj, kj, vj)), causal=True,
            window=window)))
        _BOUNDS[S, T, window] = qkv, o, bound, o_jax
    return _BOUNDS[S, T, window]


# gemma3-12b's head dim and a 2,048-token prompt (global and its 1,024
# window), and more queries than keys (rows that see no key), at both key
# tile widths the kernel uses (64 at hd 256, 128 below)
@pytest.mark.parametrize("bk", [64, 128])
@pytest.mark.parametrize("S,T,window", [(2048, 2048, None), (2048, 2048, 1024),
                                        (256, 192, None)])
def test_tensor_core_numerics_within_half_the_bf16_bound(S, T, window, bk):
    (q, k, v), o, bound, o_jax = _bound(S, T, window)
    got = _emulate_tensor_core_kernel(q, k, v, True, window, bk).float()
    assert float(((got - o).abs() / bound).max()) <= 0.5
    assert float(((got - o_jax).abs() / bound).max()) <= 0.5
    if S == T:
        # row 0 sees key 0 alone: its weight rounds to exactly 1
        assert torch.equal(got[:, 0], v[:, 0].float().repeat_interleave(2, dim=1))


@pytest.mark.parametrize("fault", ["skip_tile", "scale"])
@pytest.mark.parametrize("window", [None, 1024])
def test_bf16_bound_rejects_planted_faults(window, fault):
    """The bound is tight enough to see each planted defect at the
    2,048-token shapes, on the later half of the rows alone (each sees
    1,024 keys or more, where |o| is smallest beside the spread of v)."""
    (q, k, v), o, bound, _ = _bound(2048, 2048, window)
    got = _emulate_tensor_core_kernel(q, k, v, True, window, 64, fault).float()
    assert float(((got - o).abs() / bound)[:, 1024:].max()) > 1
