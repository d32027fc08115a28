// Hopper (sm_90a) kernels for the butterfly wire: the fused reduce+quantize
// on the edge (and its variant that also counts the codes' symbols), the
// fused dequantize+restore on the cloud, and the fused
// dequantize+restore+RMSNorm that feeds the first cloud layer.
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes.  Never
// build with --use_fast_math: it turns the IEEE divide `r / scale` into an
// approximate one, and the codes must round exactly as the reference does.
//
// Every kernel launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
//
// ---------------------------------------------------------------------------
// butterfly_reduce_quant
//   replaces src/repro/kernels/butterfly_kernel.py:_reduce_quant_kernel
//   (butterfly_reduce_quant_kernel, pl.pallas_call at :47).
//   r = x @ w_reduce (f32 accumulation); per row absmax over the d_r channels;
//   scale = max(absmax, 1e-8) / qmax; codes = clip(rint(r / scale), -qmax-1, qmax).
//
//   Bound on the card: memory.  It must read x once (T*d*bytes(x)) plus
//   w_reduce (d*d_r*bytes, 512 KB at d=4096, d_r=64 in bf16) and write
//   T*d_r int8 codes and T f32 scales; at d_r=64 it does 128 multiply-adds
//   per bf16 element of x, far below the card's ratio of compute to bytes.
//
//   Design: one block owns RQ rows (16, or 1 when there are too few rows to
//   fill the card) and all d_r channels.  It walks d in chunks of KC,
//   staging the x tile (k-major, so one 16-byte load gives a lane four rows)
//   and the w_reduce chunk (channels padded with zeros to whole warps) in
//   shared memory as f32, converting bf16 with __bfloat162float.  The eight
//   warps split each chunk's k range; a lane holds CJ channels of RQ rows in
//   f32 registers.  The eight partial sums are then added in a fixed warp
//   order, so the result does not depend on scheduling.  One warp owns a
//   row's epilogue: a warp-shuffle max gives the absmax, and the arithmetic
//   is IEEE: fmaxf, a true divide for the scale and for r / scale, rintf
//   (round half to even; roundf would round half away from zero) and a
//   clamp.  Rows past T load as zero and are never stored: the ragged edge
//   is masked here, so every row count goes through the kernel unpadded.
// ---------------------------------------------------------------------------
// butterfly_reduce_quant_bincount
//   replaces src/repro/kernels/butterfly_kernel.py:_reduce_quant_bincount_kernel
//   (butterfly_reduce_quant_bincount_kernel, pl.pallas_call at :104).
//   butterfly_reduce_quant, plus counts[c][code + qmax + 1] += 1 for every
//   code it emits: the per-channel symbol histogram (d_r x 2**bits int32)
//   that the entropy wire's prior and size estimate read.
//
//   Bound on the card: memory, as butterfly_reduce_quant; the histogram adds
//   d_r * 2**bits * 4 bytes (64 KB at d_r=64, 8 bits) to write.
//
//   Design: the same kernel with kCount set at compile time, so the codes
//   and scales come out of the same instructions, bit for bit.  Where the
//   epilogue stores a code (rows < T, channels < d_r) it adds one to the
//   code's bin with a global atomicAdd; integer adds give the same counts
//   in any order.  Rows past T are never counted, so the TPU wrapper's
//   correction for its zero pad rows has no counterpart.  The TPU kernel
//   carries the histogram in VMEM across its sequential grid; here blocks
//   run in parallel, and the bins near code 0 take most of the atomics.  A
//   histogram in shared memory per block, flushed once, is later work.
// ---------------------------------------------------------------------------
// butterfly_dequant_restore
//   replaces src/repro/kernels/butterfly_kernel.py:_dequant_restore_kernel
//   (butterfly_dequant_restore_kernel, pl.pallas_call at :197).
//   out = (codes * scale) @ w_restore, f32 accumulation, cast to the dtype of
//   w_restore (f32 or bf16; the wrapper refuses any other output dtype).
//
//   Bound on the card: memory, chiefly writing T*d*bytes(out); it reads
//   T*d_r int8 codes, T f32 scales and w_restore (d_r*d*bytes).
//
//   Design: one block owns RD rows x a slab of DD output columns, one column
//   per thread.  It stages codes*scale as f32 in shared memory, k-major so
//   one 16-byte load gives a thread four rows (multiply first, then
//   accumulate, as the TPU kernel does).  Each thread reads its own
//   w_restore column element once per channel straight into a register and
//   uses it for all RD rows: no other thread needs that element, so a
//   shared-memory copy would buy nothing.  bf16 output rounds with
//   __float2bfloat16_rn.  Rows past T and columns past d are masked.
// ---------------------------------------------------------------------------
// butterfly_dequant_restore_norm
//   replaces src/repro/kernels/butterfly_kernel.py:_dequant_restore_norm_kernel
//   (butterfly_dequant_restore_norm_kernel, pl.pallas_call at :158).
//   x = ((codes * scale) @ w_restore) rounded to the dtype of w_restore, then
//   h = rms_norm(x) of the ROUNDED x in f32: x * (1/sqrt(mean(x^2) + eps)) *
//   (1 + norm_w), rounded once.  Returns both: x is the residual stream, h
//   the first cloud layer's norm1 output.
//
//   Bound on the card: memory.  It reads what dequant_restore reads plus
//   norm_w (d*bytes) and writes two (T, d) outputs instead of one.
//
//   Design: the norm needs whole rows, so one block owns RD rows and ALL d
//   columns: it walks the column slabs of DD that dequant_restore spreads
//   over blocks, with the same helpers (stage_dequant, restore_column), so x
//   equals dequant_restore's output bit for bit.  Once every column of x is
//   written, __syncthreads() makes the block's stores visible to the block
//   and each warp normalises one row at a time with row_norm.cuh's
//   warp_row_norm, re-reading the rounded x from L1/L2 (2 bytes an element
//   at bf16; shared memory would need 16 KB a row in f32).  rmsnorm uses the
//   same routine, so its output equals h bit for bit.  Few rows fill few of
//   the 132 SMs (a 4-row decode tick runs one block): a simple kernel first.
// ---------------------------------------------------------------------------
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "row_norm.cuh"

namespace {

using row_norm::from_f32;
using row_norm::to_f32;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDr = 1024;      // the wrappers require d_r <= 1024
constexpr int kStageFloats = 8192;                // w chunk / partials (32 KB)
constexpr int RD = 16;            // rows per dequant_restore block
constexpr int DD = kThreads;      // output columns per dequant_restore block

// 16 raw bytes of w (4 f32 or 8 bf16) stored to shared memory as f32
__device__ __forceinline__ void store_f32x(float* dst, uint4 v, float) {
  *reinterpret_cast<float4*>(dst) = make_float4(__uint_as_float(v.x), __uint_as_float(v.y),
                                                __uint_as_float(v.z), __uint_as_float(v.w));
}
__device__ __forceinline__ float2 bf16x2_to_f32(unsigned int u) {   // exact
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}
__device__ __forceinline__ void store_f32x(float* dst, uint4 v, __nv_bfloat16) {
  const float2 a = bf16x2_to_f32(v.x), b = bf16x2_to_f32(v.y);
  const float2 c = bf16x2_to_f32(v.z), e = bf16x2_to_f32(v.w);
  *reinterpret_cast<float4*>(dst) = make_float4(a.x, a.y, b.x, b.y);
  *reinterpret_cast<float4*>(dst + 4) = make_float4(c.x, c.y, e.x, e.y);
}

// Channel widths the reduce kernel computes: d_r rounded up to 32 * CJ with
// CJ a power of two.  w_reduce must arrive with exactly that many columns
// (the wrapper zero-pads it), so a chunk of it is one contiguous span.
__host__ __device__ constexpr int padded_width(int d_r) {
  return d_r <= 32 ? 32 : d_r <= 64 ? 64 : d_r <= 128 ? 128 : d_r <= 256 ? 256
       : d_r <= 512 ? 512 : 1024;
}

// RQ rows per block; CJ channels per lane (DRP = 32 * CJ).  RQ * CJ <= 32
// keeps the partial sums of all warps within kStageFloats.
// With kCount, counts (d_r x 2 * (qmax + 1) int32, zeroed by the caller)
// gains one in the bin of every code stored.
template <typename T, int RQ, int CJ, bool kCount>
__global__ void __launch_bounds__(kThreads)
reduce_quant_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    int8_t* __restrict__ codes, float* __restrict__ scales,
                    int* __restrict__ counts, int n_rows, int d, int d_r, int qmax) {
  constexpr int DRP = 32 * CJ;                      // w_reduce row stride
  constexpr int KC = kStageFloats / DRP < 128 ? kStageFloats / DRP : 128;
  constexpr int KW = KC / kWarps;                   // k per warp per chunk
  constexpr int VE = 16 / sizeof(T);                // w elements per 16 bytes
  constexpr int XPT = (RQ * KC + kThreads - 1) / kThreads;
  constexpr int WPT = KC * DRP / VE / kThreads;     // 16-byte w loads per thread
  static_assert(RQ * CJ <= 32 && KW >= 1 && WPT >= 1, "tile does not fit");
  __shared__ __align__(16) float xs[KC * RQ];       // x tile, k-major
  __shared__ __align__(16) float ws[kStageFloats];  // w chunk, then partials

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * RQ;
  float acc[RQ][CJ];
#pragma unroll
  for (int r = 0; r < RQ; ++r)
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc[r][j] = 0.f;

  // The next chunk's x and w are fetched into registers (raw, converted
  // only when stored) while the warps compute on the current one, so the
  // global-memory latency overlaps the arithmetic.  The w chunk (KC rows of
  // DRP) is contiguous and read 16 bytes at a time.
  T xr[XPT];
  uint4 wr[WPT];
  auto fetch = [&](int k0) {
    const int kn = min(KC, d - k0);
#pragma unroll
    for (int i = 0; i < XPT; ++i) {
      const int e = tid + i * kThreads, r = e / KC, k = e % KC, row = row0 + r;
      xr[i] = (e < RQ * KC && row < n_rows && k < kn) ? x[(size_t)row * d + k0 + k]
                                                       : static_cast<T>(0.f);
    }
    const uint4* wc = reinterpret_cast<const uint4*>(w + (size_t)k0 * DRP);
#pragma unroll
    for (int i = 0; i < WPT; ++i) {
      const int v = tid + i * kThreads;
      wr[i] = v * VE < kn * DRP ? wc[v] : make_uint4(0u, 0u, 0u, 0u);
    }
  };

  fetch(0);
  for (int k0 = 0; k0 < d; k0 += KC) {
#pragma unroll
    for (int i = 0; i < XPT; ++i) {
      const int e = tid + i * kThreads;
      if (e < RQ * KC) xs[(e % KC) * RQ + e / KC] = to_f32(xr[i]);
    }
#pragma unroll
    for (int i = 0; i < WPT; ++i) store_f32x(&ws[(tid + i * kThreads) * VE], wr[i], T());
    __syncthreads();
    if (k0 + KC < d) fetch(k0 + KC);
#pragma unroll
    for (int kk = 0; kk < KW; ++kk) {
      const int k = warp * KW + kk;
      float wv[CJ];
#pragma unroll
      for (int j = 0; j < CJ; ++j) wv[j] = ws[k * DRP + lane + 32 * j];
      if constexpr (RQ % 4 == 0) {
#pragma unroll
        for (int r = 0; r < RQ; r += 4) {
          const float4 xv = *reinterpret_cast<const float4*>(&xs[k * RQ + r]);
#pragma unroll
          for (int j = 0; j < CJ; ++j) {
            acc[r][j] = fmaf(xv.x, wv[j], acc[r][j]);
            acc[r + 1][j] = fmaf(xv.y, wv[j], acc[r + 1][j]);
            acc[r + 2][j] = fmaf(xv.z, wv[j], acc[r + 2][j]);
            acc[r + 3][j] = fmaf(xv.w, wv[j], acc[r + 3][j]);
          }
        }
      } else {
#pragma unroll
        for (int r = 0; r < RQ; ++r) {
          const float xv = xs[k * RQ + r];
#pragma unroll
          for (int j = 0; j < CJ; ++j) acc[r][j] = fmaf(xv, wv[j], acc[r][j]);
        }
      }
    }
    __syncthreads();
  }

  // partial sums of every warp, then a fixed-order sum per (row, channel)
  float* red = ws;
#pragma unroll
  for (int r = 0; r < RQ; ++r)
#pragma unroll
    for (int j = 0; j < CJ; ++j) red[(warp * RQ + r) * DRP + lane + 32 * j] = acc[r][j];
  __syncthreads();

  const float fq = (float)qmax;
  for (int r = warp; r < RQ; r += kWarps) {
    float v[CJ];
    float m = 0.f;
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      const int c = lane + 32 * j;
      float sum = 0.f;
#pragma unroll
      for (int q = 0; q < kWarps; ++q) sum += red[(q * RQ + r) * DRP + c];
      v[j] = sum;
      if (c < d_r) m = fmaxf(m, fabsf(sum));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    const int row = row0 + r;
    if (row < n_rows) {
      const float scale = fmaxf(m, 1e-8f) / fq;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int c = lane + 32 * j;
        if (c < d_r) {
          const float q = fminf(fmaxf(rintf(v[j] / scale), -fq - 1.f), fq);
          codes[(size_t)row * d_r + c] = (int8_t)q;
          if constexpr (kCount)
            atomicAdd(&counts[c * (2 * (qmax + 1)) + (int)q + qmax + 1], 1);
        }
      }
      if (lane == 0) scales[row] = scale;
    }
  }
}

template <typename T, int RQ, int CJ, bool kCount>
cudaError_t launch_reduce(const void* x, const void* w, void* codes, void* scales,
                          int* counts, int n_rows, int d, int d_r, int qmax,
                          cudaStream_t s) {
  const dim3 grid((n_rows + RQ - 1) / RQ);
  reduce_quant_kernel<T, RQ, CJ, kCount><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<int8_t*>(codes), static_cast<float*>(scales), counts, n_rows, d,
      d_r, qmax);
  return cudaGetLastError();
}

template <typename T, bool kCount>
cudaError_t dispatch_reduce(const void* x, const void* w, void* codes, void* scales,
                            int* counts, int n_rows, int d, int d_r, int qmax,
                            cudaStream_t s) {
  // 16-row blocks where they still fill the card's 132 SMs, else one row a block
  const bool tall = n_rows > 1024;
#define REDUCE(RQ, CJ) \
  launch_reduce<T, RQ, CJ, kCount>(x, w, codes, scales, counts, n_rows, d, d_r, qmax, s)
  if (d_r <= 32) return tall ? REDUCE(16, 1) : REDUCE(1, 1);
  if (d_r <= 64) return tall ? REDUCE(16, 2) : REDUCE(1, 2);
  if (d_r <= 128) return REDUCE(1, 4);
  if (d_r <= 256) return REDUCE(1, 8);
  if (d_r <= 512) return REDUCE(1, 16);
  return REDUCE(1, 32);
#undef REDUCE
}

template <bool kCount>
int reduce_entry(const void* x, const void* w, void* codes, void* scales, int* counts,
                 int n_rows, int d, int d_r, int qmax, int dtype, void* stream) {
  if (n_rows <= 0 || d <= 0 || d_r <= 0 || d_r > kMaxDr || qmax < 0 || qmax > 127)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_reduce<float, kCount>(x, w, codes, scales, counts, n_rows, d,
                                               d_r, qmax, s);
  if (dtype == 1)
    return (int)dispatch_reduce<__nv_bfloat16, kCount>(x, w, codes, scales, counts,
                                                       n_rows, d, d_r, qmax, s);
  return (int)cudaErrorInvalidValue;
}

// codes * scale of rows [row0, row0 + RD) as f32 in shared memory, k-major
// (rs[k * RD + r]); rows past n_rows are zeros
__device__ __forceinline__ void stage_dequant(const int8_t* __restrict__ codes,
                                              const float* __restrict__ scales,
                                              float* rs, int row0, int n_rows, int d_r) {
  for (int e = threadIdx.x; e < RD * d_r; e += kThreads) {
    const int r = e / d_r, k = e % d_r, row = row0 + r;
    rs[k * RD + r] = row < n_rows ? (float)codes[(size_t)row * d_r + k] * scales[row] : 0.f;
  }
}

// acc[r] = sum over k, in order, of rs[k][r] * w[k][col] (f32 fmaf): one
// output column of the block's RD rows
template <typename T>
__device__ __forceinline__ void restore_column(const float* rs, const T* __restrict__ w,
                                               int col, int d_r, int d, float (&acc)[RD]) {
#pragma unroll
  for (int r = 0; r < RD; ++r) acc[r] = 0.f;
#pragma unroll 8
  for (int k = 0; k < d_r; ++k) {
    const float wv = to_f32(w[(size_t)k * d + col]);
#pragma unroll
    for (int r = 0; r < RD; r += 4) {
      const float4 rv = *reinterpret_cast<const float4*>(&rs[k * RD + r]);
      acc[r] = fmaf(rv.x, wv, acc[r]);
      acc[r + 1] = fmaf(rv.y, wv, acc[r + 1]);
      acc[r + 2] = fmaf(rv.z, wv, acc[r + 2]);
      acc[r + 3] = fmaf(rv.w, wv, acc[r + 3]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dequant_restore_kernel(const int8_t* __restrict__ codes,
                       const float* __restrict__ scales,
                       const T* __restrict__ w, T* __restrict__ out,
                       int n_rows, int d_r, int d) {
  extern __shared__ __align__(16) float rs[];   // d_r x RD, codes * scale as f32
  const int row0 = blockIdx.x * RD;
  stage_dequant(codes, scales, rs, row0, n_rows, d_r);
  __syncthreads();

  const int col = blockIdx.y * DD + threadIdx.x;
  if (col >= d) return;
  float acc[RD];
  restore_column(rs, w, col, d_r, d, acc);
#pragma unroll
  for (int r = 0; r < RD; ++r) {
    const int row = row0 + r;
    if (row < n_rows) from_f32(acc[r], &out[(size_t)row * d + col]);
  }
}

// x is written and then read back by the same block, so it is a plain
// pointer (see row_norm.cuh)
template <typename T>
__global__ void __launch_bounds__(kThreads)
dequant_restore_norm_kernel(const int8_t* __restrict__ codes,
                            const float* __restrict__ scales,
                            const T* __restrict__ w, const T* __restrict__ norm_w,
                            T* x, T* __restrict__ h, int n_rows, int d_r, int d,
                            float eps) {
  extern __shared__ __align__(16) float rs[];   // d_r x RD, codes * scale as f32
  const int row0 = blockIdx.x * RD;
  stage_dequant(codes, scales, rs, row0, n_rows, d_r);
  __syncthreads();

  for (int col = threadIdx.x; col < d; col += DD) {
    float acc[RD];
    restore_column(rs, w, col, d_r, d, acc);
#pragma unroll
    for (int r = 0; r < RD; ++r) {
      const int row = row0 + r;
      if (row < n_rows) from_f32(acc[r], &x[(size_t)row * d + col]);
    }
  }
  __syncthreads();                  // every column of the block's rows is in x

  for (int r = threadIdx.x / 32; r < RD; r += kWarps) {
    const int row = row0 + r;
    if (row < n_rows)
      row_norm::warp_row_norm(x + (size_t)row * d, norm_w, h + (size_t)row * d, d, eps);
  }
}

template <typename T>
cudaError_t launch_restore(const int8_t* codes, const float* scales,
                           const void* w, void* out, int n_rows, int d_r,
                           int d, cudaStream_t stream) {
  const size_t smem = (size_t)RD * d_r * sizeof(float);
  auto kern = dequant_restore_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid((n_rows + RD - 1) / RD, (d + DD - 1) / DD);
  kern<<<grid, kThreads, smem, stream>>>(codes, scales,
                                         static_cast<const T*>(w),
                                         static_cast<T*>(out), n_rows, d_r, d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_restore_norm(const int8_t* codes, const float* scales,
                                const void* w, const void* norm_w, void* x, void* h,
                                int n_rows, int d_r, int d, float eps,
                                cudaStream_t stream) {
  const size_t smem = (size_t)RD * d_r * sizeof(float);
  auto kern = dequant_restore_norm_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((n_rows + RD - 1) / RD);
  kern<<<grid, kThreads, smem, stream>>>(codes, scales, static_cast<const T*>(w),
                                         static_cast<const T*>(norm_w),
                                         static_cast<T*>(x), static_cast<T*>(h),
                                         n_rows, d_r, d, eps);
  return cudaGetLastError();
}

}  // namespace

// dtype codes shared with kernels/butterfly_kernel.py: 0 = float32, 1 = bfloat16.

// The column count w_reduce must have for butterfly_reduce_quant.
extern "C" int butterfly_reduce_width(int d_r) { return padded_width(d_r); }

// w must hold butterfly_reduce_width(d_r) columns (zeros past d_r) and be
// 16-byte aligned.
extern "C" int butterfly_reduce_quant(const void* x, const void* w, void* codes,
                                      void* scales, int n_rows, int d, int d_r,
                                      int qmax, int dtype, void* stream) {
  return reduce_entry<false>(x, w, codes, scales, nullptr, n_rows, d, d_r, qmax, dtype,
                             stream);
}

// As butterfly_reduce_quant, and counts (d_r x 2 * (qmax + 1) int32, zeroed by
// the caller) gains each stored code's symbol code + qmax + 1.
extern "C" int butterfly_reduce_quant_bincount(const void* x, const void* w,
                                               void* codes, void* scales, void* counts,
                                               int n_rows, int d, int d_r, int qmax,
                                               int dtype, void* stream) {
  return reduce_entry<true>(x, w, codes, scales, static_cast<int*>(counts), n_rows, d,
                            d_r, qmax, dtype, stream);
}

// out has the dtype of w.
extern "C" int butterfly_dequant_restore(const void* codes, const void* scales,
                                         const void* w, void* out, int n_rows,
                                         int d_r, int d, int dtype, void* stream) {
  if (n_rows <= 0 || d <= 0 || d_r <= 0 || d_r > kMaxDr) return (int)cudaErrorInvalidValue;
  const int8_t* c = static_cast<const int8_t*>(codes);
  const float* sc = static_cast<const float*>(scales);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_restore<float>(c, sc, w, out, n_rows, d_r, d, s);
  if (dtype == 1) return (int)launch_restore<__nv_bfloat16>(c, sc, w, out, n_rows, d_r, d, s);
  return (int)cudaErrorInvalidValue;
}

// x and h have the dtype of w and norm_w (d values).
extern "C" int butterfly_dequant_restore_norm(const void* codes, const void* scales,
                                              const void* w, const void* norm_w,
                                              void* x, void* h, int n_rows, int d_r,
                                              int d, float eps, int dtype, void* stream) {
  if (n_rows <= 0 || d <= 0 || d_r <= 0 || d_r > kMaxDr) return (int)cudaErrorInvalidValue;
  const int8_t* c = static_cast<const int8_t*>(codes);
  const float* sc = static_cast<const float*>(scales);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_restore_norm<float>(c, sc, w, norm_w, x, h, n_rows, d_r, d, eps, s);
  if (dtype == 1)
    return (int)launch_restore_norm<__nv_bfloat16>(c, sc, w, norm_w, x, h, n_rows, d_r, d,
                                                   eps, s);
  return (int)cudaErrorInvalidValue;
}
