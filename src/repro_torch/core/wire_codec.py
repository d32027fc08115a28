"""Entropy codec for the butterfly wire: rANS over learned per-channel priors
(port of ``repro/core/wire_codec.py``; its encoder's bytes are identical).

The butterfly's absmax quantizer emits int8/int4 codes whose distribution is
far from uniform — especially once the rate term (``rate_bits``) has pushed
the reduce projection toward low-entropy codes.  This module turns that slack
into wire bytes: a vectorized interleaved-rANS coder (one lane per reduced
channel, numpy state vector, one Python step per token row) codes the symbol
tensor against a per-channel categorical prior.  The coder is *exact*: for
any prior with every symbol representable (``quantize_freqs`` guarantees
freq >= 1), encode -> decode round-trips bitwise, even when the prior badly
mismatches the data — a bad prior only costs bytes, never correctness.

Layout of an encoded payload::

    [T: uint32 LE]                         row count (leading dims flattened)
    [d_r x uint64 LE]                      final rANS lane states
    [uint32 LE ...]                        renormalization words

Interleave order: the decoder consumes words (row ascending, lane ascending);
the encoder walks rows in reverse, appends each step's lane-ascending word
chunk, and reverses the chunk list at flush — the classic interleaved-rANS
stream reversal, vectorized across lanes.

Per-row *decode* streaming keeps fixed-rate int8 rows: the ~12-byte state
flush dwarfs a d_r-symbol row, so entropy coding only pays on prefill-sized
payloads (see DESIGN.md section 18).

Everything here is host-side numpy, except ``rate_bits``: the
differentiable rate term of the training loss, in PyTorch.
"""
from __future__ import annotations

import dataclasses
import struct
from typing import Optional, Tuple

import numpy as np

# rANS parameters: 12-bit quantized probabilities, 64-bit lane state,
# 32-bit renormalization words.  With freq <= PROB_TOTAL the single-word
# renorm per symbol is guaranteed (state stays below 2**63).
SCALE_BITS = 12
PROB_TOTAL = 1 << SCALE_BITS
RANS_L = 1 << 31
_WORD = 0xFFFFFFFF

# Fixed per-payload overhead: uint32 row count + one uint64 state per lane.
HEADER_BYTES = 4
STATE_BYTES = 8

# Deployment-default coded rate for *predicted* sizes (planner scoring and
# timing-only runs, where no codes exist to encode): a trained prior lands
# around 3.5 bits/symbol on the bench workload (see the `wire` scenario in
# BENCH_runtime.json).  Kept as an exact rational so predicted byte counts
# are integer-deterministic.  Runs with real numerics charge the actual
# coded size instead.
NOMINAL_BITS_NUM = 7
NOMINAL_BITS_DEN = 2


def predicted_code_bytes(n_symbols: int) -> int:
    """ceil(n * 3.5 bits / 8) — the planner's data-free code-byte estimate."""
    return (n_symbols * NOMINAL_BITS_NUM + 8 * NOMINAL_BITS_DEN - 1) \
        // (8 * NOMINAL_BITS_DEN)


def alphabet_size(bits: int) -> int:
    return 1 << bits


def codes_to_symbols(codes, bits: int) -> np.ndarray:
    """Signed quantizer codes [-qmax-1, qmax] -> symbols [0, 2**bits)."""
    qmax = 2 ** (bits - 1) - 1
    sym = np.asarray(codes, dtype=np.int64) + qmax + 1
    if sym.min(initial=0) < 0 or sym.max(initial=0) >= alphabet_size(bits):
        raise ValueError(f"codes out of range for {bits}-bit alphabet")
    return sym


def symbols_to_codes(symbols, bits: int) -> np.ndarray:
    qmax = 2 ** (bits - 1) - 1
    codes = np.asarray(symbols, dtype=np.int64) - qmax - 1
    dtype = np.int8 if bits <= 8 else np.int16
    return codes.astype(dtype)


def quantize_freqs(probs: np.ndarray) -> np.ndarray:
    """(d_r, K) probabilities -> integer freqs, each >= 1, rows sum to
    PROB_TOTAL.  Deterministic: remainder goes to the largest fractional
    parts, ties broken by channel index."""
    p = np.asarray(probs, dtype=np.float64)
    if p.ndim == 1:
        p = p[None]
    d_r, K = p.shape
    if K > PROB_TOTAL:
        raise ValueError(f"alphabet {K} exceeds PROB_TOTAL {PROB_TOTAL}")
    p = np.maximum(p, 0.0)
    row = p.sum(axis=1, keepdims=True)
    p = np.where(row > 0, p / np.maximum(row, 1e-300), 1.0 / K)
    spread = float(PROB_TOTAL - K)
    scaled = p * spread
    f = np.floor(scaled).astype(np.int64) + 1
    short = PROB_TOTAL - f.sum(axis=1)                    # (d_r,) >= 0
    frac = scaled - np.floor(scaled)
    order = np.argsort(-frac, axis=1, kind="stable")      # deterministic ties
    for c in range(d_r):
        n = int(short[c])
        if n:
            f[c, order[c, :n]] += 1
    assert (f >= 1).all() and (f.sum(axis=1) == PROB_TOTAL).all()
    return f


@dataclasses.dataclass(frozen=True)
class WirePrior:
    """Quantized per-channel categorical prior over the code alphabet."""
    bits: int
    freqs: np.ndarray        # (d_r, K) int64, rows sum to PROB_TOTAL
    cumex: np.ndarray        # (d_r, K) exclusive cumulative freqs

    @property
    def d_r(self) -> int:
        return self.freqs.shape[0]

    @classmethod
    def from_probs(cls, probs: np.ndarray, bits: int) -> "WirePrior":
        f = quantize_freqs(probs)
        if f.shape[1] != alphabet_size(bits):
            raise ValueError(f"prior width {f.shape[1]} != 2**{bits}")
        cumex = np.concatenate(
            [np.zeros((f.shape[0], 1), np.int64), np.cumsum(f, axis=1)[:, :-1]],
            axis=1)
        return cls(bits=bits, freqs=f, cumex=cumex)

    @classmethod
    def from_counts(cls, counts: np.ndarray, bits: int,
                    alpha: float = 0.5) -> "WirePrior":
        """Empirical prior from per-channel symbol histograms (the fused
        quantize+bincount kernel's output), Laplace-smoothed."""
        c = np.asarray(counts, dtype=np.float64)
        return cls.from_probs(c + alpha, bits)

    @classmethod
    def default(cls, d_r: int, bits: int, rho: float = 0.8) -> "WirePrior":
        """Deployment default when no trained prior is shipped: a two-sided
        geometric centered on the zero code (absmax-quantized activations
        concentrate there), identical for every channel."""
        K = alphabet_size(bits)
        center = 1 << (bits - 1)
        k = np.arange(K, dtype=np.float64)
        p = rho ** np.abs(k - center)
        return cls.from_probs(np.tile(p[None], (d_r, 1)), bits)


def payload_overhead_bytes(d_r: int) -> int:
    return HEADER_BYTES + STATE_BYTES * d_r


def encode(codes, prior: WirePrior) -> bytes:
    """codes: (..., d_r) signed quantizer codes -> rANS payload bytes."""
    sym = codes_to_symbols(codes, prior.bits)
    d_r = prior.d_r
    if sym.shape[-1] != d_r:
        raise ValueError(f"codes last dim {sym.shape[-1]} != prior d_r {d_r}")
    s = sym.reshape(-1, d_r)
    T = s.shape[0]
    freqs = prior.freqs.astype(np.uint64)
    cumex = prior.cumex.astype(np.uint64)
    lane = np.arange(d_r)
    x = np.full(d_r, RANS_L, dtype=np.uint64)
    x_max_base = np.uint64((RANS_L >> SCALE_BITS) << 32)
    chunks = []
    for t in range(T - 1, -1, -1):
        st = s[t]
        f = freqs[lane, st]
        mask = x >= x_max_base * f
        if mask.any():
            chunks.append((x[mask] & np.uint64(_WORD)).astype(np.uint32))
            x[mask] >>= np.uint64(32)
        x = ((x // f) << np.uint64(SCALE_BITS)) + (x % f) + cumex[lane, st]
    words = (np.concatenate(chunks[::-1]) if chunks
             else np.zeros(0, np.uint32))
    return (struct.pack("<I", T)
            + x.astype("<u8").tobytes()
            + words.astype("<u4").tobytes())


def decode(data: bytes, prior: WirePrior, shape: Tuple[int, ...]) -> np.ndarray:
    """Inverse of :func:`encode`; ``shape`` is the code tensor shape
    (..., d_r).  Raises ValueError on a truncated/corrupt stream or a
    prior that differs from the encoder's."""
    d_r = prior.d_r
    if shape[-1] != d_r:
        raise ValueError(f"shape last dim {shape[-1]} != prior d_r {d_r}")
    n = int(np.prod(shape[:-1], dtype=np.int64)) if len(shape) > 1 else 1
    (T,) = struct.unpack_from("<I", data, 0)
    if T != n:
        raise ValueError(f"payload rows {T} != requested shape rows {n}")
    off = HEADER_BYTES
    x = np.frombuffer(data, dtype="<u8", count=d_r, offset=off
                      ).astype(np.uint64).copy()
    off += STATE_BYTES * d_r
    words = np.frombuffer(data, dtype="<u4", offset=off).astype(np.uint32)
    freqs = prior.freqs.astype(np.uint64)
    cumex = prior.cumex          # int64, for the searchsorted
    cumex_u = cumex.astype(np.uint64)
    lane = np.arange(d_r)
    out = np.empty((T, d_r), dtype=np.int64)
    pos = 0
    mask_slot = np.uint64(PROB_TOTAL - 1)
    for t in range(T):
        slot = (x & mask_slot).astype(np.int64)
        sym = np.sum(cumex <= slot[:, None], axis=1) - 1
        out[t] = sym
        f = freqs[lane, sym]
        x = f * (x >> np.uint64(SCALE_BITS)) \
            + slot.astype(np.uint64) - cumex_u[lane, sym]
        need = x < RANS_L
        k = int(need.sum())
        if k:
            if pos + k > words.size:
                raise ValueError("truncated rANS stream")
            x[need] = (x[need] << np.uint64(32)) | words[pos:pos + k]
            pos += k
    if pos != words.size or not (x == RANS_L).all():
        raise ValueError("corrupt rANS stream or mismatched encode/decode prior")
    return symbols_to_codes(out, prior.bits).reshape(shape)


def coded_nbytes(codes, prior: Optional[WirePrior] = None) -> int:
    """Actual payload size for a code tensor (runs the real encoder)."""
    arr = np.asarray(codes)
    if prior is None:
        prior = WirePrior.default(arr.shape[-1], 8)
    return len(encode(arr, prior))


def channel_counts(codes, bits: int) -> np.ndarray:
    """(..., d_r) codes -> (d_r, 2**bits) per-channel symbol histogram.
    Host-side oracle for the fused kernel's bincount output."""
    sym = codes_to_symbols(codes, bits).reshape(-1, codes.shape[-1])
    K = alphabet_size(bits)
    d_r = sym.shape[1]
    counts = np.zeros((d_r, K), dtype=np.int64)
    for c in range(d_r):
        counts[c] = np.bincount(sym[:, c], minlength=K)
    return counts


def estimate_coded_bytes(counts, prior: WirePrior) -> int:
    """Predicted payload size from per-channel symbol counts (the fused
    kernel's output) under ``prior`` — cross-entropy ideal length plus the
    fixed rANS overhead.  Tracks the true encoder closely (rANS is within a
    fraction of a percent of the ideal)."""
    c = np.asarray(counts, dtype=np.float64)
    bits_per = SCALE_BITS - np.log2(prior.freqs.astype(np.float64))
    total_bits = float((c * bits_per).sum())
    return int(np.ceil(total_bits / 8.0)) + payload_overhead_bytes(prior.d_r)


def expected_bits_per_symbol(counts, prior: WirePrior) -> float:
    """Mean cross-entropy code length (bits/symbol) of ``counts`` under
    ``prior`` — the quantity the planner's entropy branch approximates."""
    c = np.asarray(counts, dtype=np.float64)
    n = c.sum()
    if n <= 0:
        return 0.0
    bits_per = SCALE_BITS - np.log2(prior.freqs.astype(np.float64))
    return float((c * bits_per).sum() / n)


# ---------------------------------------------------------------------------
# differentiable rate term (training hook)
# ---------------------------------------------------------------------------


def rate_bits(r, bits: int = 8, prior_logits=None):
    """Expected code length (bits/symbol) of the butterfly's reduced
    activations ``r`` (..., d_r) under a per-channel categorical prior —
    differentiable in both ``r`` and ``prior_logits``.

    Mirrors the quantizer's scaling (per-row absmax -> continuous symbol
    position), then linearly interpolates the prior pmf between the two
    neighbouring symbols, so gradients flow into the reduce projection
    (sharper, lower-entropy code distributions) and into the prior.  With
    ``prior_logits=None`` a fixed two-sided geometric prior is used, which
    penalizes code magnitude — the BottleNet-style rate pressure.

    The clips are ``minimum(maximum(x, lo), hi)`` on tensor bounds, as
    ``jnp.clip`` computes them: at a bound the gradient splits 0.5/0.5
    (``torch.clamp`` would pass all of it), and a row whose positive absmax
    divides to ``qmax`` lands on the top symbol exactly.
    """
    import torch

    K = alphabet_size(bits)
    qmax = 2 ** (bits - 1) - 1
    d_r = r.shape[-1]
    bound = lambda v: torch.full((), v, dtype=r.dtype, device=r.device)
    absmax = r.abs().amax(dim=-1, keepdim=True)
    # a true division, as JAX's: CUDA divides by a host scalar through its
    # reciprocal, and a scale one bit off moves the row's absmax entry across
    # the interpolation's kink at a whole symbol, where the gradient jumps
    scale = torch.maximum(absmax, bound(1e-8)) / bound(qmax)
    s = torch.minimum(torch.maximum(r / scale + (qmax + 1), bound(0.0)),
                      bound(K - 1.0))                      # continuous symbol
    if prior_logits is None:
        center = 1 << (bits - 1)
        k = torch.arange(K, dtype=torch.float32, device=r.device)
        logp = (k - center).abs() * float(np.log(np.float32(0.8)))
        logp = logp - torch.log(logp.exp().sum())
        logp = logp[None].expand(d_r, K)
    else:
        logp = torch.log_softmax(prior_logits.float(), dim=-1)
    p = logp.exp()                                         # (d_r, K)
    lo = torch.clamp(torch.floor(s), 0, K - 2).long()
    frac = s - lo.to(s.dtype)
    flat = lo.reshape(-1, d_r)
    ch = torch.arange(d_r, device=r.device)[None, :]
    p_lo = p[ch, flat].reshape(lo.shape)
    p_hi = p[ch, flat + 1].reshape(lo.shape)
    p_s = p_lo * (1.0 - frac) + p_hi * frac
    return (-torch.log2(p_s + 1e-12)).mean()


# ---------------------------------------------------------------------------
# progressive bitplane schedule
# ---------------------------------------------------------------------------

# High-order bitplanes shipped in the coarse chunk (out of ``bits`` planes).
COARSE_BITS = 4


def coarse_codes(codes, coarse_bits: int = COARSE_BITS, bits: int = 8):
    """Keep the top ``coarse_bits`` bitplanes of each signed code (the chunk
    the cloud prefills on before refinement lands).  Arithmetic shift keeps
    the sign plane; refinement restores the exact code."""
    shift = bits - coarse_bits
    arr = np.asarray(codes)
    return ((arr.astype(np.int64) >> shift) << shift).astype(arr.dtype)


def split_coarse_refine(code_bytes: int, scale_bytes: int,
                        coarse_bits: int = COARSE_BITS,
                        bits: int = 8) -> Tuple[int, int]:
    """Split a coded payload of ``code_bytes`` (+ ``scale_bytes`` of raw
    scales) into (coarse, refine) transfer sizes.  The coarse chunk carries
    the top bitplanes *and* the scales (the cloud can't dequantize without
    them); refinement carries the remaining planes plus a second stream
    header.  coarse + refine >= code_bytes + scale_bytes, never less — the
    split costs a header, it doesn't invent compression."""
    coarse_code = (code_bytes * coarse_bits + bits - 1) // bits
    coarse = coarse_code + scale_bytes
    refine = (code_bytes - coarse_code) + HEADER_BYTES
    return coarse, refine
