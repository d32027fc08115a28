// The one RMSNorm row routine of the port's kernels, shared by
// csrc/butterfly.cu (butterfly_dequant_restore_norm) and csrc/rmsnorm.cu
// (rmsnorm), with the f32 conversions both use.  Because both kernels
// normalise a row with these same instructions in the same order, rmsnorm(x)
// equals the h of butterfly_dequant_restore_norm for the same x, bit for bit
// (both wrappers hand the kernels 16-byte aligned tensors, so a given d
// always takes the same branch below).
//
// kernels/build.py hashes every .cuh of csrc/ into each library's key, so a
// change here rebuilds both libraries.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace row_norm {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void from_f32(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* dst) {
  *dst = __float2bfloat16_rn(v);
}

// The VE = 16 / sizeof(T) values of one 16-byte piece, as f32 (exact).
__device__ __forceinline__ void unpack(uint4 u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x); f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z); f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(uint4 u, float (&f)[8]) {
  const unsigned int w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ uint4 pack(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}
__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  unsigned int w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 b = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    w[i] = *reinterpret_cast<unsigned int*>(&b);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The sum of squares of one 16-byte piece: its values in order, with fmaf.
template <typename T>
__device__ __forceinline__ float piece_sumsq(uint4 u, T) {
  float f[16 / sizeof(T)];
  unpack(u, f);
  float p = f[0] * f[0];
#pragma unroll
  for (int e = 1; e < 16 / (int)sizeof(T); ++e) p = fmaf(f[e], f[e], p);
  return p;
}

// 16-byte pieces of x (and as many of w) a lane holds in registers: 16 x 8
// bf16 covers d = 4096 (64 registers each); a longer row (f32 past 2048)
// re-reads its later pieces.
constexpr int kHeld = 16;

// One warp normalises one row of d values (the model's RMSNorm with the
// zero-centred weight, repro/models/common.py:rms_norm):
//   h = x * (1 / sqrt(sum(x^2) / d + eps)) * (1 + w)
// in f32, rounded once to T.
//
// Vector branch (d a multiple of VE = 16 / sizeof(T) and x, w, h 16-byte
// aligned): the row is cut into chunks of 32 * VE values; lane l owns the
// VE contiguous values at 32 * VE * c + VE * l of every chunk c, loads
// them in 16-byte pieces, all of them issued before the first FMA, and
// keeps the first kHeld in registers, so the row is read once.  With
// PREFETCH_W the matching pieces of w are loaded and held beside them, so
// w's latency overlaps x's (64 more registers at d = 4096); without, w is
// read as h is written.  Neither choice changes an instruction of the sums.
// Summation order: each piece's sum of squares (its values in order, with
// fmaf; the pieces' sums are independent, so their latencies overlap), then
// lane l adds its pieces' sums in chunk order; then a butterfly of xor
// shuffles (16, 8, 4, 2, 1) adds the 32 partial sums.
// IEEE addition commutes, so every lane ends with the same total.
// Scalar branch (any other d or alignment): lane l sums x[l], x[l + 32],
// ... in that order with fmaf, then the same butterfly, then re-reads.
// The inverse root is a correctly rounded sqrtf and an IEEE divide (never
// rsqrtf, which is approximate; the library is built without
// --use_fast_math).  `x` is a plain pointer, not __restrict__: the fused
// kernel reads back the row it has just written, so the read must not
// take the non-coherent read-only path.
template <typename T, bool PREFETCH_W = true>
__device__ __forceinline__ void warp_row_norm(const T* x, const T* __restrict__ w,
                                              T* h, int d, float eps) {
  constexpr int VE = 16 / sizeof(T);
  const int lane = threadIdx.x & 31;
  const bool vec = d % VE == 0 && ((reinterpret_cast<uintptr_t>(x) |
                                    reinterpret_cast<uintptr_t>(w) |
                                    reinterpret_cast<uintptr_t>(h)) & 15) == 0;
  float s = 0.f;
  if (vec) {
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    const uint4* wv = reinterpret_cast<const uint4*>(w);
    const int n = d / VE;                       // 16-byte pieces in the row
    uint4 held[kHeld], wheld[kHeld];
#pragma unroll
    for (int c = 0; c < kHeld; ++c)
      if (c * 32 + lane < n) held[c] = xv[c * 32 + lane];
    if (PREFETCH_W) {
#pragma unroll
      for (int c = 0; c < kHeld; ++c)
        if (c * 32 + lane < n) wheld[c] = wv[c * 32 + lane];
    }
#pragma unroll
    for (int c = 0; c < kHeld; ++c)
      if (c * 32 + lane < n) s += piece_sumsq(held[c], T());
    for (int i = kHeld * 32 + lane; i < n; i += 32) s += piece_sumsq(xv[i], T());
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    const float inv = 1.f / sqrtf(s / (float)d + eps);
    uint4* hv = reinterpret_cast<uint4*>(h);
#pragma unroll
    for (int c = 0; c < kHeld; ++c) {
      const int i = c * 32 + lane;
      if (i < n) {
        float f[VE], g[VE];
        unpack(held[c], f);
        unpack(PREFETCH_W ? wheld[c] : wv[i], g);
#pragma unroll
        for (int e = 0; e < VE; ++e) f[e] = f[e] * inv * (1.f + g[e]);
        hv[i] = pack(f);
      }
    }
    for (int i = kHeld * 32 + lane; i < n; i += 32) {
      float f[VE], g[VE];
      unpack(xv[i], f);
      unpack(wv[i], g);
#pragma unroll
      for (int e = 0; e < VE; ++e) f[e] = f[e] * inv * (1.f + g[e]);
      hv[i] = pack(f);
    }
    return;
  }
  for (int i = lane; i < d; i += 32) {
    const float v = to_f32(x[i]);
    s = fmaf(v, v, s);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  const float inv = 1.f / sqrtf(s / (float)d + eps);
  for (int i = lane; i < d; i += 32)
    from_f32(to_f32(x[i]) * inv * (1.f + to_f32(w[i])), &h[i]);
}

}  // namespace row_norm
