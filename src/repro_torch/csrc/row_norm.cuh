// The one RMSNorm row routine of the port's kernels, shared by
// csrc/butterfly.cu (butterfly_dequant_restore_norm) and csrc/rmsnorm.cu
// (rmsnorm), with the f32 conversions both use.  Because both kernels
// normalise a row with these same instructions in the same order, rmsnorm(x)
// equals the h of butterfly_dequant_restore_norm for the same x, bit for bit.
//
// kernels/build.py hashes every .cuh of csrc/ into each library's key, so a
// change here rebuilds both libraries.
#pragma once

#include <cuda_bf16.h>

namespace row_norm {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void from_f32(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* dst) {
  *dst = __float2bfloat16_rn(v);
}

// One warp normalises one row of d values (the model's RMSNorm with the
// zero-centred weight, repro/models/common.py:rms_norm):
//   h = x * (1 / sqrt(sum(x^2) / d + eps)) * (1 + w)
// in f32, rounded once to T.  Lane l sums the squares of x[l], x[l + 32],
// ... in that order with explicit fmaf, then a butterfly of shuffles adds
// the 32 partial sums; IEEE addition commutes, so every lane ends with the
// same total.  The inverse root is a correctly rounded sqrtf and an IEEE
// divide (never rsqrtf, which is approximate; the library is built without
// --use_fast_math).  `x` is a plain pointer, not __restrict__: the fused
// kernel reads back the row it has just written, so the read must not take
// the non-coherent read-only path.
template <typename T>
__device__ __forceinline__ void warp_row_norm(const T* x, const T* __restrict__ w,
                                              T* h, int d, float eps) {
  const int lane = threadIdx.x & 31;
  float s = 0.f;
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
