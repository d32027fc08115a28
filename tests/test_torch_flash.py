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
"""
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
from repro_torch.kernels import flash_attention as fa, ops
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

