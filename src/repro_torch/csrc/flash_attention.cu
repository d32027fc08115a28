// Hopper (sm_90a) flash attention: blockwise online-softmax GQA attention
// with causal and sliding-window masks, queries aligned to the end of the
// key sequence.
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes (no
// -lcuda: the one driver call, cuTensorMapEncodeTiled, is reached through
// cudaGetDriverEntryPoint).  The kernels launch on the caller's stream,
// allocate nothing, and the entry point returns cudaGetLastError() so the
// Python wrapper can raise on a refused launch.
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
//   values, exactly as the reference's softmax over -1e30 does; keys past T
//   get weight exactly 0.  The running max, denominator and accumulator are
//   f32; the denominator is floored at 1e-30; the output is cast to the
//   input dtype.  One C entry point dispatches on the dtype: f32 runs the
//   CUDA-core kernel, bf16 the tensor-core kernel, and neither falls back to
//   the other.
//
//   Bound on the card: operations.  It must do 4*hd FLOPs (a multiply-add
//   is two) per visible (query head, key) pair, 2*hd for q.k and 2*hd for p.v;
//   at gemma3's S = 2048, hd = 256 that is 34 GFLOP per causal layer against
//   50 MB of q, k, v and output, about 680 FLOP a byte, above the card's
//   ratio of bf16 tensor-core FLOP/s to bytes/s (about 295).
//
//   Both kernels keep one control flow: one block owns one (batch, query
//   head) and a tile of query rows, walks the key tiles in order (no state
//   crosses blocks), and the heaviest query tiles start first.  Key tiles
//   wholly outside the causal/window band of every row of the query tile
//   are skipped: their scores would all be -1e30 and, for a row that sees
//   some key, contribute exactly zero.  A query tile that holds a row seeing
//   no key (causal, qpos < 0) walks every key tile, so that row gets the
//   reference's mean of v.  Query rows past S are computed on zeros and
//   never stored, and keys past T score -inf, so any S and T work.
//
//   f32, on the CUDA cores (exact to the f32 reference): 256 threads own
//   BQ = 64 query rows and walk key tiles of BK = 64 keys (32 at hd >= 128).
//   Q, K and V tiles are staged in shared memory as f32, rows padded by 4
//   floats so the strided float4 reads of the score product hit distinct
//   banks.  Scores: each thread computes a 4-row x BK/16-key patch with
//   float4 reads along hd.  Softmax: four lanes own a row, share its max and
//   sum by shuffles, and keep m and l in registers.  P.V: the same four
//   lanes own the row's hd/4 output columns as f32 registers.
//
//   bf16, on the tensor cores (namespace tc): a block is three warpgroups
//   (384 threads) over 128 query rows: two consumer warpgroups of 64 rows
//   each (wgmma's M) and one producer warpgroup, of which one thread issues
//   every load.  setmaxnreg gives the consumers 232 registers and the
//   producer 40; the block asks for at least 120 KB of shared memory so one
//   block holds an SM and the registers it moves are its own.
//   * Loads by TMA (cp.async.bulk.tensor, rank-4 maps of (B, rows, heads,
//     hd), so one head's rows are strided by heads * hd) into swizzled
//     shared memory: 128B swizzle in column blocks of 64 hd (64B swizzle in
//     one block of 32 at hd = 32), each block rows x 128 bytes.  Q comes
//     once; K and V tiles of BK keys go through a ring of 2 stages, K and V
//     each with a "full" mbarrier (expect_tx: the tile's bytes) and an
//     "empty" mbarrier on which all 256 consumer threads arrive once the
//     wgmma that reads the tile has completed.  TMA zero-fills rows past S
//     and T.  BK = 128 keys at hd <= 128, 64 at hd = 256.  Shared memory, Q
//     + 2 stages x (K + V): hd 256: 64 + 2 x (32 + 32) = 192 KB; hd 128: 32
//     + 2 x (32 + 32) = 160 KB; hd 64: 16 + 2 x (16 + 16) = 80 KB; hd 32: 8
//     + 2 x (8 + 8) = 40 KB; plus 1 KB of alignment and the barriers.
//   * Turns: the two consumer warpgroups take turns at the tensor cores
//     (a pair of named barriers).  Turn i issues O += P_{i-1} V_{i-1} and
//     S_i = Q K_i^T back to back and hands the turn over; the warpgroup's
//     masks and softmax of S_i then run on the CUDA cores while the other
//     warpgroup's turn keeps the tensor cores busy.  K_i is released when
//     S_i is done, V_i a turn later, so K loads run ahead of V.
//   * S = Q K^T: wgmma m64nBKk16, bf16 in, f32 accumulate, A (Q) and B (K)
//     from shared memory, both K-major (hd contiguous); hd/16 steps, each
//     advancing the descriptors 32 bytes inside a swizzle row.
//   * Masks and online softmax on the accumulator fragment: a thread holds
//     two rows (r0, r0 + 8) and two keys of every 8, and derives both from
//     warp and lane; masks are computed only on a tile that crosses a mask
//     edge (or T) for some row of the warpgroup; scores are scaled into the
//     log2 domain (ex2 on the special-function unit); the row max is
//     reduced over the lane quad by shuffles; m and l are f32 registers, l
//     summed per lane and over the quad once at the end; O is rescaled only
//     when some row of the warp changed its max (alpha != 1).
//   * O += P V: P = exp(s - m) rounded to bf16 in registers, where the S
//     fragment is exactly wgmma's A fragment; V from shared memory as B,
//     MN-major (hd contiguous), with the transpose bit; the denominator sums
//     the same rounded P, so the weights stay a convex combination and a
//     row that sees one key returns that key's v exactly.
//   * Epilogue: acc / max(l, 1e-30) rounded to bf16, written swizzled into
//     the warpgroup's own Q rows (its last wgmma has completed), then one
//     TMA store a column block, which writes rows < S only.
// ---------------------------------------------------------------------------
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <chrono>
#include <type_traits>

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

// 16 raw bytes (4 f32 or 8 bf16) stored to shared memory as f32
__device__ __forceinline__ void store_f32x(float* dst, uint4 v, float) {
  *reinterpret_cast<float4*>(dst) = make_float4(__uint_as_float(v.x), __uint_as_float(v.y),
                                                __uint_as_float(v.z), __uint_as_float(v.w));
}

__device__ __forceinline__ void store_out(float* dst, float4 v) {
  *reinterpret_cast<float4*>(dst) = v;
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

// Calls f(std::integral_constant<int, HD>{}) at the head dim hd; the one
// switch over the head dims that both kernels and the map encoding share.
template <class F>
cudaError_t with_head_dim(int hd, F&& f) {
  switch (hd) {
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 128: return f(std::integral_constant<int, 128>{});
    case 256: return f(std::integral_constant<int, 256>{});
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel (namespace tc)
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kConsumers = 2;                    // warpgroups of 64 query rows
constexpr int kThreads = 128 * (kConsumers + 1);  // + one producer warpgroup
constexpr int BQ = 64 * kConsumers;              // query rows per block
constexpr int kStages = 2;                       // K/V ring depth
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
// Requested dynamic shared memory is at least this, so that one block holds
// an SM: setmaxnreg moves registers between the warpgroups of one block,
// and a second block could leave a consumer waiting for registers forever.
constexpr int kOneBlockSmem = 120 * 1024;
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Cfg {
  static constexpr int BK = HD == 256 ? 64 : 128;          // keys per tile
  static constexpr int CB = HD < 64 ? HD : 64;             // columns per swizzle block
  static constexpr int CBB = CB * 2;                       // its row: 64 or 128 bytes
  static constexpr int NCB = HD / CB;                      // column blocks
  static constexpr uint64_t kSwizzle = CBB == 128 ? 1 : 2;  // descriptor: 128B or 64B
  static constexpr int kQBytes = BQ * HD * 2;
  static constexpr int kKVBytes = BK * HD * 2;             // one K or one V tile
  static constexpr int kBarOffset = kQBytes + 2 * kStages * kKVBytes;
  static constexpr int kSmem = 1024 + kBarOffset + 8 * (1 + 4 * kStages);
  static constexpr int kLaunchSmem = kSmem > kOneBlockSmem ? kSmem : kOneBlockSmem;
  static_assert(kSmem <= 232448, "tiles do not fit in shared memory");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}
// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// One box of a rank-4 tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3) : "memory");
}
// One box from shared memory to the tensor; rows past the tensor are not written.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3) : "memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle mode (1 = 128B, 2 = 64B).
__device__ __forceinline__ uint64_t sdesc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                          uint64_t swizzle) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (swizzle << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Pin registers in program order around the asynchronous wgmma, so that the
// compiler neither reads an accumulator before wgmma_wait_all() nor moves a
// write of an operand past wgmma_fence().
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
}

// 2^x on the special-function unit (ftz: a result below 2^-126 is 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 b = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&b);
}

// The wgmma instructions this kernel issues, one overload per width N
// (64 x N f32 accumulator fragment d: N / 2 registers a thread).
// d (64 x 64 f32 fragment) += A (64 x 16, K-major in shared memory) * B
// (64 x 16, K-major in shared memory); scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 128 f32 fragment) += A (64 x 16, K-major in shared memory) * B
// (128 x 16, K-major in shared memory); scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 32 f32 fragment) += A (64 x 16 bf16 in registers) * B (16 x 32,
// MN-major in shared memory: the transpose bit is set)
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 64 f32 fragment) += A (64 x 16 bf16 in registers) * B (16 x 64,
// MN-major in shared memory: the transpose bit is set)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 128 f32 fragment) += A (64 x 16 bf16 in registers) * B (16 x 128,
// MN-major in shared memory: the transpose bit is set)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 256 f32 fragment) += A (64 x 16 bf16 in registers) * B (16 x 256,
// MN-major in shared memory: the transpose bit is set)
__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


// Swizzled byte offset of a linear offset inside a column block whose rows
// are CBB bytes: the 16-byte chunk index is xored with the row's low bits,
// as TMA lays a box out under CU_TENSOR_MAP_SWIZZLE_128B / _64B.
template <int CBB>
__device__ __forceinline__ uint32_t swizzle(uint32_t off) {
  constexpr uint32_t mask = CBB == 128 ? 7 : 3;
  return off ^ (((off >> 7) & mask) << 4);
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_tc_kernel(__grid_constant__ const CUtensorMap qmap,
                          __grid_constant__ const CUtensorMap kmap,
                          __grid_constant__ const CUtensorMap vmap,
                          __grid_constant__ const CUtensorMap omap,
                          int S, int T_len, int N, int K, float scale_log2, int causal,
                          int window) {
  using C = Cfg<HD>;
  constexpr int BK = C::BK, CB = C::CB, CBB = C::CBB, NCB = C::NCB;
  extern __shared__ uint8_t smem_raw[];
  // TMA's swizzle atoms (1 KB) need 1 KB alignment
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sQ = (raw + 1023) & ~1023u;               // NCB blocks of BQ x CBB
  const uint32_t sK = sQ + C::kQBytes;                      // kStages x NCB blocks of BK x CBB
  const uint32_t sV = sK + kStages * C::kKVBytes;
  // barriers, 8 bytes each: Q arrived; then per stage, K arrived, V
  // arrived, K released, V released
  const uint32_t bar_q = sQ + C::kBarOffset;
  const uint32_t bar_kfull = bar_q + 8, bar_vfull = bar_kfull + 8 * kStages;
  const uint32_t bar_kempty = bar_vfull + 8 * kStages, bar_vempty = bar_kempty + 8 * kStages;
  uint8_t* smem = smem_raw + (sQ - raw);

  // heaviest query tiles (the last ones, under a causal mask) start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int bh = blockIdx.y, b = bh / N, h = bh % N;
  const int kvh = h / (N / K);
  const int shift = T_len - S;                // qpos = row + shift
  const int q_valid = min(BQ, S - q0);
  // the band of keys any row of this tile can see
  const int qlo = q0 + shift, qhi = q0 + q_valid - 1 + shift;
  int k_begin = 0, k_end = T_len;
  if (!(causal && qlo < 0)) {                 // every row sees at least one key
    if (window > 0) k_begin = max(0, qlo - window + 1) / BK * BK;
    if (causal) k_end = min(T_len, qhi + 1);
  }
  const int n_tiles = (k_end - k_begin + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_kfull + 8 * s, 1);
      mbar_init(bar_vfull + 8 * s, 1);
      mbar_init(bar_kempty + 8 * s, 128 * kConsumers);
      mbar_init(bar_vempty + 8 * s, 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ---- producer warpgroup: one thread keeps the TMA loads in flight
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kProducerRegs));
    if (threadIdx.x == kConsumers * 128) {
      mbar_expect_tx(bar_q, C::kQBytes);
#pragma unroll
      for (int j = 0; j < NCB; ++j)
#pragma unroll
        for (int c = 0; c < kConsumers; ++c)
          tma_load(sQ + j * BQ * CBB + c * 64 * CBB, &qmap, bar_q, j * CB, h, q0 + 64 * c, b);
      // K_i is released once S_i is done, V_i once P_i V_i is, a turn
      // later, so K runs ahead of V
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages, parity = ((i / kStages) & 1) ^ 1;
        const int k0 = k_begin + i * BK;
        mbar_wait(bar_kempty + 8 * s, parity);
        mbar_expect_tx(bar_kfull + 8 * s, C::kKVBytes);
#pragma unroll
        for (int j = 0; j < NCB; ++j)
          tma_load(sK + s * C::kKVBytes + j * BK * CBB, &kmap, bar_kfull + 8 * s, j * CB,
                   kvh, k0, b);
        mbar_wait(bar_vempty + 8 * s, parity);
        mbar_expect_tx(bar_vfull + 8 * s, C::kKVBytes);
#pragma unroll
        for (int j = 0; j < NCB; ++j)
          tma_load(sV + s * C::kKVBytes + j * BK * CBB, &vmap, bar_vfull + 8 * s, j * CB,
                   kvh, k0, b);
      }
    }
  } else {
    // ---- consumer warpgroup wg: query rows q0 + 64 wg ... + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs));
    const int tid = threadIdx.x % 128, lane = tid % 32;
    const int r0 = 16 * (tid / 32) + lane / 4;    // the thread's rows: r0 and r0 + 8
    const int qwg = q0 + 64 * wg + shift;         // qpos of the warpgroup's first row
    const int qpos0 = qwg + r0, qpos1 = qpos0 + 8;
    const int kq = 2 * (lane % 4);                // the thread's first key of each 8
    const uint32_t sQw = sQ + wg * 64 * CBB;

    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    float sc[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
    uint32_t pk[BK / 16][4];
#pragma unroll
    for (int i = 0; i < BK / 16; ++i) pk[i][0] = pk[i][1] = pk[i][2] = pk[i][3] = 0u;
    float m0 = kMasked, m1 = kMasked, l0 = 0.f, l1 = 0.f;   // l: this lane's keys only

    // The two warpgroups take turns at the tensor cores (named barriers
    // 3 + wg): turn i issues P_{i-1} V_{i-1} and S_i = Q K_i^T back to back,
    // and the warpgroup's softmax of S_i then runs while the other
    // warpgroup's turn keeps the tensor cores busy.  Warpgroup 1 hands
    // warpgroup 0 the first turn.
    if (wg == 1) asm volatile("bar.arrive 3, 256;\n" ::: "memory");
    mbar_wait(bar_q, 0);
    for (int i = 0; i <= n_tiles; ++i) {
      const bool has_s = i < n_tiles, has_pv = i > 0;
      const int s = i % kStages, sp = (i + kStages - 1) % kStages;
      if (has_pv) mbar_wait(bar_vfull + 8 * sp, ((i - 1) / kStages) & 1);
      if (has_s) mbar_wait(bar_kfull + 8 * s, (i / kStages) & 1);
      asm volatile("bar.sync %0, 256;\n" :: "r"(3 + wg) : "memory");
      pin(o);
      pin(pk);
      pin(sc);
      wgmma_fence();
      if (has_pv) {
        // O += P V: P from registers (the S fragment is the A fragment), V
        // MN-major (hd contiguous), 16 keys a step
        const uint32_t sVs = sV + sp * C::kKVBytes;
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_rs(o, pk[kk], sdesc(sVs + kk * 16 * CBB, BK * CBB, 8 * CBB, C::kSwizzle));
      }
      if (has_s) {
        // S = Q K^T: both operands K-major (hd contiguous), 16 hd a step
        const uint32_t sKs = sK + s * C::kKVBytes;
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const int j = kk / (CB / 16);
          const uint32_t off = (kk % (CB / 16)) * 32;
          wgmma_ss(sc, sdesc(sQw + j * BQ * CBB + off, 16, 8 * CBB, C::kSwizzle),
                   sdesc(sKs + j * BK * CBB + off, 16, 8 * CBB, C::kSwizzle), kk > 0);
        }
      }
      wgmma_commit();
      asm volatile("bar.arrive %0, 256;\n" :: "r"(3 + (1 - wg)) : "memory");
      wgmma_wait_all();
      pin(o);
      pin(sc);
      if (has_pv) mbar_arrive(bar_vempty + 8 * sp);   // this thread is done with V_{i-1}
      if (!has_s) break;
      mbar_arrive(bar_kempty + 8 * s);                // and with K_i

      // masks on the fragment, only on a tile that crosses a mask edge for
      // some row of this warpgroup: sc[4c + e] is row r0 (e < 2) or r0 + 8,
      // key k0 + 8c + kq + (e & 1)
      const int k0 = k_begin + i * BK;
      const bool edge = k0 + BK > T_len || (causal && k0 + BK - 1 > qwg) ||
                        (window > 0 && k0 <= qwg + 63 - window);
      float mx0 = -INFINITY, mx1 = -INFINITY;
      if (edge) {
#pragma unroll
        for (int c = 0; c < BK / 8; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kpos = k0 + 8 * c + kq + (e & 1);
            const int qpos = e < 2 ? qpos0 : qpos1;
            float val = sc[4 * c + e] * scale_log2;
            if ((causal && kpos > qpos) || (window > 0 && kpos <= qpos - window)) val = kMasked;
            if (kpos >= T_len) val = -INFINITY;   // past T: no weight at all
            sc[4 * c + e] = val;
          }
      } else {
#pragma unroll
        for (int c = 0; c < BK / 2; ++c) sc[c] *= scale_log2;
      }
#pragma unroll
      for (int c = 0; c < BK / 8; ++c) {
        mx0 = fmaxf(mx0, fmaxf(sc[4 * c], sc[4 * c + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * c + 2], sc[4 * c + 3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float alpha0 = ex2(m0 - mn0), alpha1 = ex2(m1 - mn1);
      m0 = mn0;
      m1 = mn1;

      // P = exp(s - m) rounded to bf16; the denominator sums the rounded P,
      // so the weights stay a convex combination
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int e = 8 * kk + 2 * r;            // sc[e], sc[e + 1]: one row, two keys
          const float mn = (r & 1) ? mn1 : mn0;
          const __nv_bfloat162 p = __floats2bfloat162_rn(ex2(sc[e] - mn), ex2(sc[e + 1] - mn));
          const float2 pf = __bfloat1622float2(p);
          if (r & 1) sum1 += pf.x + pf.y; else sum0 += pf.x + pf.y;
          pk[kk][r] = *reinterpret_cast<const uint32_t*>(&p);
        }
      l0 = alpha0 * l0 + sum0;
      l1 = alpha1 * l1 + sum1;
      // rescale O, unless no row of the warp changed its max (alpha = 1)
      if (!__all_sync(0xffffffffu, alpha0 == 1.f && alpha1 == 1.f)) {
#pragma unroll
        for (int c = 0; c < HD / 8; ++c) {
          o[4 * c] *= alpha0;
          o[4 * c + 1] *= alpha0;
          o[4 * c + 2] *= alpha1;
          o[4 * c + 3] *= alpha1;
        }
      }
    }
    // warpgroup 0 takes warpgroup 1's last hand-over, so no arrival is left
    // on barrier 3
    if (wg == 0) asm volatile("bar.sync 3, 256;\n" ::: "memory");

    // epilogue: the quad's partial denominators, the division, bf16, then
    // the rows through this warpgroup's Q area (its reads are complete) to
    // a TMA store that writes rows < S only
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
    uint8_t* sOw = smem + wg * 64 * CBB;
#pragma unroll
    for (int c = 0; c < HD / 8; ++c) {
      const int col = 8 * c + kq, j = col / CB, cb = (col % CB) * 2;
      uint8_t* blk = sOw + j * BQ * CBB;
      *reinterpret_cast<uint32_t*>(blk + swizzle<CBB>(r0 * CBB + cb)) =
          pack_bf16(o[4 * c] * inv0, o[4 * c + 1] * inv0);
      *reinterpret_cast<uint32_t*>(blk + swizzle<CBB>((r0 + 8) * CBB + cb)) =
          pack_bf16(o[4 * c + 2] * inv1, o[4 * c + 3] * inv1);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
    if (tid == 0 && 64 * wg < q_valid) {
#pragma unroll
      for (int j = 0; j < NCB; ++j)
        tma_store(&omap, sQw + j * BQ * CBB, j * CB, h, q0 + 64 * wg, b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, a driver-API call, reached through the runtime so
// the library needs no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A rank-4 map of a contiguous bf16 (B, rows, heads, hd) tensor: dims
// innermost first, so one head's rows are strided by heads * hd; boxes of
// CB columns x 1 head x box_rows rows, swizzled as the wgmma descriptors
// expect.  Rows past `rows` read as zeros and are never written.
bool encode_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int B, int rows,
                int heads, int hd, int box_rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads, (cuuint64_t)rows,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2, (cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)rows * heads * hd * 2};
  const cuuint32_t box[4] = {(cuuint32_t)(hd < 64 ? hd : 64), 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
             box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             hd >= 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Maps {
  CUtensorMap q, k, v, o;
};

template <int HD>
bool encode_maps(Maps* m, const void* q, const void* k, const void* v, void* out, int B,
                 int S, int T_len, int N, int K) {
  EncodeTiled enc = encode_tiled();
  return enc != nullptr && encode_map(enc, &m->q, q, B, S, N, HD, 64) &&
         encode_map(enc, &m->k, k, B, T_len, K, HD, Cfg<HD>::BK) &&
         encode_map(enc, &m->v, v, B, T_len, K, HD, Cfg<HD>::BK) &&
         encode_map(enc, &m->o, out, B, S, N, HD, 64);
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B, int S,
                   int T_len, int N, int K, int causal, int window, cudaStream_t stream) {
  Maps m;
  if (!encode_maps<HD>(&m, q, k, v, out, B, S, T_len, N, K)) return cudaErrorInvalidValue;
  auto kern = flash_attention_tc_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Cfg<HD>::kLaunchSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, B * N);
  const float scale_log2 = kLog2e / sqrtf((float)HD);
  kern<<<grid, kThreads, Cfg<HD>::kLaunchSmem, stream>>>(m.q, m.k, m.v, m.o, S, T_len, N, K,
                                                          scale_log2, causal, window);
  return cudaGetLastError();
}

}  // namespace tc

bool valid_call(int B, int S, int T, int N, int K, int window) {
  return B > 0 && S > 0 && T > 0 && N > 0 && K > 0 && N % K == 0 && window >= 0 &&
         (long long)B * N <= 65535;
}

}  // namespace

// dtype codes shared with kernels/flash_attention.py: 0 = float32 (CUDA
// cores), 1 = bfloat16 (tensor cores).  q (B,S,N,hd), k/v (B,T,K,hd) and
// out (B,S,N,hd) are contiguous and 16-byte aligned; window 0 means no
// window, otherwise window >= 1.
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* out,
                               int B, int S, int T, int N, int K, int hd, int causal,
                               int window, int dtype, void* stream) {
  if (!valid_call(B, S, T, N, K, window)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)with_head_dim(hd, [&](auto h) {
      return launch<float, decltype(h)::value>(q, k, v, out, B, S, T, N, K, causal, window, s);
    });
  if (dtype == 1)
    return (int)with_head_dim(hd, [&](auto h) {
      return tc::launch<decltype(h)::value>(q, k, v, out, B, S, T, N, K, causal, window, s);
    });
  return (int)cudaErrorInvalidValue;
}

// Host nanoseconds of encoding a bf16 call's four tensor maps, summed over
// `reps` encodings, into *ns.  Nothing launches.
extern "C" int flash_attention_encode_ns(const void* q, const void* k, const void* v,
                                         void* out, int B, int S, int T, int N, int K,
                                         int hd, int reps, long long* ns) {
  if (!valid_call(B, S, T, N, K, 0)) return (int)cudaErrorInvalidValue;
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < reps; ++i) {
    const cudaError_t err = with_head_dim(hd, [&](auto h) {
      tc::Maps m;
      return tc::encode_maps<decltype(h)::value>(&m, q, k, v, out, B, S, T, N, K)
                 ? cudaSuccess
                 : cudaErrorInvalidValue;
    });
    if (err != cudaSuccess) return (int)err;
  }
  *ns = std::chrono::duration_cast<std::chrono::nanoseconds>(
            std::chrono::steady_clock::now() - t0).count();
  return 0;
}
