// Hopper (sm_90a) flash attention: blockwise online-softmax GQA attention
// with causal and sliding-window masks, queries aligned to the end of the
// key sequence.
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes.  The
// kernel launches on the caller's stream, allocates nothing, and the entry
// point returns cudaGetLastError() so the Python wrapper can raise on a
// refused launch.
//
// ---------------------------------------------------------------------------
// flash_attention
//   replaces src/repro/kernels/flash_attention.py:flash_attention_kernel
//   (the online-softmax _attn_kernel, pl.pallas_call at :99).
//   q (B,S,N,hd), k/v (B,T,K,hd), f32 or bf16, hd in {32, 64, 128, 256};
//   query head h reads kv head h / (N/K), with K/V never repeated.  Query
//   row i sits at absolute position qpos = i + T - S; key t is visible when
//   (not causal or t <= qpos) and (no window or t > qpos - window).  Scores
//   are q.k / sqrt(hd) in f32; a masked score is -1e30, as in the reference,
//   so a row that sees no key (a causal call with S > T) averages all T
//   values, exactly as the reference's softmax over -1e30 does.  The running
//   max, denominator and accumulator are f32; the denominator is floored at
//   1e-30; the output is cast to the input dtype.
//
//   Bound on the card: operations.  It must do 4*hd FLOPs (a multiply-add
//   is two) per visible (query head, key) pair, 2*hd for q.k and 2*hd for p.v;
//   at gemma3's S = 2048, hd = 256 that is 34 GFLOP per causal layer against
//   50 MB of q, k, v and output, about 680 FLOP a byte, above the card's
//   ratio of bf16 tensor-core FLOP/s to bytes/s (about 295).
//
//   Design, simple and exact first: one block of 256 threads owns one
//   (batch, query head) and a tile of BQ = 64 query rows, and walks the key
//   tiles (BK = 64 keys, 32 at hd >= 128) in order, so no state crosses
//   blocks.  Q, K and V tiles are staged in shared memory as f32 (bf16 is
//   widened exactly), rows padded by 4 floats so the strided float4 reads
//   of the score product hit distinct banks.  Scores: each thread computes
//   a 4-row x BK/16-key patch with float4 reads along hd.  Softmax: four
//   lanes own a row, share its max and sum by shuffles, and keep m and l in
//   registers.  P.V: the same four lanes own the row's hd/4 output columns
//   as f32 registers.  All arithmetic is on the CUDA cores in f32, so the
//   result holds to the f32 reference; it is far from the operations bound,
//   which only the tensor cores (wgmma, with TMA staging) can approach.
//   Key tiles wholly outside the causal/window band of every row of the
//   query tile are skipped: their scores would all be -1e30 and, for a row
//   that sees some key, contribute exactly zero.  A query tile that holds a
//   row seeing no key (causal, qpos < 0) walks every key tile, so that row
//   gets the reference's mean of v.  Ragged edges are masked here: query
//   rows past S are computed on zeros and never stored, and keys past T
//   score -inf (weight exactly 0, never counted), so any S and T work.
// ---------------------------------------------------------------------------
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int BQ = 64;                 // query rows per block
constexpr float kMasked = -1e30f;      // the reference's fill for a masked score
constexpr int kPad = 4;                // floats of padding per staged row

template <int HD>
struct Tiles {
  static constexpr int BK = HD >= 128 ? 32 : 64;   // keys per tile
  static constexpr int TK = BK / 16;               // keys per thread in the score patch
  static constexpr int LD = HD + kPad;             // row stride of the Q/K/V tiles
  static constexpr int PLD = BK + kPad;            // row stride of the score tile
  static constexpr int kFloats = BQ * LD + 2 * BK * LD + BQ * PLD;
  static constexpr size_t kSmem = (size_t)kFloats * sizeof(float);
  static_assert(HD % 16 == 0 && BK % 16 == 0 && kSmem <= 232448, "tile does not fit");
};

__device__ __forceinline__ float2 bf16x2_to_f32(unsigned int u) {   // exact
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

// 16 raw bytes (4 f32 or 8 bf16) stored to shared memory as f32
__device__ __forceinline__ void store_f32x(float* dst, uint4 v, float) {
  *reinterpret_cast<float4*>(dst) = make_float4(__uint_as_float(v.x), __uint_as_float(v.y),
                                                __uint_as_float(v.z), __uint_as_float(v.w));
}
__device__ __forceinline__ void store_f32x(float* dst, uint4 v, __nv_bfloat16) {
  const float2 a = bf16x2_to_f32(v.x), b = bf16x2_to_f32(v.y);
  const float2 c = bf16x2_to_f32(v.z), e = bf16x2_to_f32(v.w);
  *reinterpret_cast<float4*>(dst) = make_float4(a.x, a.y, b.x, b.y);
  *reinterpret_cast<float4*>(dst + 4) = make_float4(c.x, c.y, e.x, e.y);
}

__device__ __forceinline__ void store_out(float* dst, float4 v) {
  *reinterpret_cast<float4*>(dst) = v;
}
__device__ __forceinline__ void store_out(__nv_bfloat16* dst, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<unsigned int*>(&lo);
  u.y = *reinterpret_cast<unsigned int*>(&hi);
  *reinterpret_cast<uint2*>(dst) = u;
}

// Stage `rows` rows of HD elements (row r at src + r * stride) into dst as
// f32 with row stride LD; rows at or past `valid` are zero.
template <typename T, int HD, int LD>
__device__ __forceinline__ void stage_rows(float* dst, const T* __restrict__ src,
                                           size_t stride, int rows, int valid) {
  constexpr int VE = 16 / sizeof(T);          // elements per 16-byte load
  constexpr int VPR = HD / VE;                // loads per row
  for (int e = threadIdx.x; e < rows * VPR; e += kThreads) {
    const int r = e / VPR, c = (e % VPR) * VE;
    float* d = dst + r * LD + c;
    if (r < valid) {
      store_f32x(d, __ldg(reinterpret_cast<const uint4*>(src + (size_t)r * stride + c)), T());
    } else {
#pragma unroll
      for (int i = 0; i < VE; i += 4)
        *reinterpret_cast<float4*>(d + i) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       int S, int T_len, int N, int K, float scale, int causal,
                       int window) {
  using Tl = Tiles<HD>;
  constexpr int BK = Tl::BK, TK = Tl::TK, LD = Tl::LD, PLD = Tl::PLD;
  constexpr int NC = HD / 16;                 // float4 output chunks per thread
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                           // BQ x LD
  float* Ks = Qs + BQ * LD;                   // BK x LD
  float* Vs = Ks + BK * LD;                   // BK x LD
  float* Ps = Vs + BK * LD;                   // BQ x PLD: scores, then weights

  const int tid = threadIdx.x;
  // heaviest query tiles (the last ones, under a causal mask) start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int bh = blockIdx.y, b = bh / N, h = bh % N;
  const int kvh = h / (N / K);
  const int shift = T_len - S;                // qpos = row + shift

  const size_t q_stride = (size_t)N * HD, kv_stride = (size_t)K * HD;
  const T* qb = q + ((size_t)b * S * N + h) * HD;
  const T* kb = k + ((size_t)b * T_len * K + kvh) * HD;
  const T* vb = v + ((size_t)b * T_len * K + kvh) * HD;
  const int q_valid = min(BQ, S - q0);
  stage_rows<T, HD, LD>(Qs, qb + (size_t)q0 * q_stride, q_stride, BQ, q_valid);

  // the band of keys any row of this tile can see
  const int qlo = q0 + shift, qhi = q0 + q_valid - 1 + shift;
  int k_begin = 0, k_end = T_len;
  if (!(causal && qlo < 0)) {                 // every row sees at least one key
    if (window > 0) k_begin = max(0, qlo - window + 1) / BK * BK;
    if (causal) k_end = min(T_len, qhi + 1);
  }

  // score patch: rows tr + 16 i, keys tk + 16 j of the tile
  const int tr = tid / 16, tk = tid % 16;
  // softmax and P.V: four lanes per row, each owning hd/4 output columns
  const int row = tid / 4, cg = tid % 4;
  float m_run = kMasked, l_run = 0.f;
  float4 acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    const int k_valid = min(BK, T_len - k0);
    stage_rows<T, HD, LD>(Ks, kb + (size_t)k0 * kv_stride, kv_stride, BK, k_valid);
    stage_rows<T, HD, LD>(Vs, vb + (size_t)k0 * kv_stride, kv_stride, BK, k_valid);
    __syncthreads();

    float s[4][TK];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < TK; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[4], kv[TK];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&Qs[(tr + 16 * i) * LD + d]);
#pragma unroll
      for (int j = 0; j < TK; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&Ks[(tk + 16 * j) * LD + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < TK; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tr + 16 * i, qpos = q0 + r + shift;
#pragma unroll
      for (int j = 0; j < TK; ++j) {
        const int c = tk + 16 * j, kpos = k0 + c;
        float val = s[i][j] * scale;
        if ((causal && kpos > qpos) || (window > 0 && kpos <= qpos - window)) val = kMasked;
        if (c >= k_valid) val = -INFINITY;          // past T: no weight at all
        Ps[r * PLD + c] = val;
      }
    }
    __syncthreads();

    // online softmax of this row over the tile (four lanes, one row)
    float* prow = Ps + row * PLD;
    float mx = -INFINITY;
#pragma unroll
    for (int j = cg; j < BK; j += 4) mx = fmaxf(mx, prow[j]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run, mx);
    const float alpha = expf(m_run - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = cg; j < BK; j += 4) {
      const float p = expf(prow[j] - m_new);
      prow[j] = p;
      sum += p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l_run = alpha * l_run + sum;
    m_run = m_new;
    __syncwarp();                                   // the row's weights, from its four lanes

#pragma unroll
    for (int c = 0; c < NC; ++c) {
      acc[c].x *= alpha; acc[c].y *= alpha; acc[c].z *= alpha; acc[c].w *= alpha;
    }
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float p = prow[j];
      const float* vr = Vs + j * LD + 4 * cg;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 vv = *reinterpret_cast<const float4*>(vr + 16 * c);
        acc[c].x = fmaf(p, vv.x, acc[c].x);
        acc[c].y = fmaf(p, vv.y, acc[c].y);
        acc[c].z = fmaf(p, vv.z, acc[c].z);
        acc[c].w = fmaf(p, vv.w, acc[c].w);
      }
    }
    __syncthreads();                                // before the next tile overwrites K, V, P
  }

  if (row < q_valid) {
    const float inv = 1.f / fmaxf(l_run, 1e-30f);
    T* orow = out + ((size_t)b * S * N + (size_t)(q0 + row) * N + h) * HD + 4 * cg;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float4 o = make_float4(acc[c].x * inv, acc[c].y * inv, acc[c].z * inv,
                                   acc[c].w * inv);
      store_out(orow + 16 * c, o);
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B,
                   int S, int T_len, int N, int K, int causal, int window,
                   cudaStream_t stream) {
  constexpr size_t smem = Tiles<HD>::kSmem;
  auto kern = flash_attention_kernel<T, HD>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((S + BQ - 1) / BQ, B * N);
  const float scale = 1.0f / sqrtf((float)HD);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), S, T_len, N, K, scale, causal, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out, int B,
                     int S, int T_len, int N, int K, int hd, int causal, int window,
                     cudaStream_t s) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, out, B, S, T_len, N, K, causal, window, s);
    case 64: return launch<T, 64>(q, k, v, out, B, S, T_len, N, K, causal, window, s);
    case 128: return launch<T, 128>(q, k, v, out, B, S, T_len, N, K, causal, window, s);
    case 256: return launch<T, 256>(q, k, v, out, B, S, T_len, N, K, causal, window, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes shared with kernels/flash_attention.py: 0 = float32, 1 = bfloat16.
// q (B,S,N,hd), k/v (B,T,K,hd) and out (B,S,N,hd) are contiguous and
// 16-byte aligned; window 0 means no window, otherwise window >= 1.
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* out,
                               int B, int S, int T, int N, int K, int hd, int causal,
                               int window, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || N <= 0 || K <= 0 || N % K != 0 || window < 0 ||
      (long long)B * N > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float>(q, k, v, out, B, S, T, N, K, hd, causal, window, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(q, k, v, out, B, S, T, N, K, hd, causal, window, s);
  return (int)cudaErrorInvalidValue;
}
