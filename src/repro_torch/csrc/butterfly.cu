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
//   per bf16 element of x: below the tensor cores' ratio of operations to
//   bytes (about 295 a byte), though above what f32 FMA on the CUDA cores
//   keeps up with.
//
//   Design: a block owns a tile of RQ rows and one k slice of d, so the
//   grid (tiles x splits) fills the card at every row count.  plan_reduce
//   picks the tile (bf16: 16 rows up to kShortRows = 1,024 rows, 64 above,
//   16 at d_r > 128; f32: 16 rows, fewer at d_r > 64) and then as many k
//   slices, each whole chunks of KC, as bring the grid to about two waves
//   of the 132 SMs (kTargetBlocks), but at most 8 once a tile is full
//   (kMaxCombine): at d=4096, d_r=64, T=1 runs 64 slices of one chunk of
//   64 k rows (8 KB of w_reduce each), T=128 8 tiles x 8 slices of 512 k rows,
//   T=4096 64 tiles x 5 slices of 832.  With one slice (d <= KC, or
//   >= kTargetBlocks tiles) a block quantizes its own sums.  Otherwise
//   each block stores its valid rows' f32 partials to scratch (tiles x
//   splits x RQ x DRP f32 from the wrapper: 256 KB at T=1 and T=128, 5 MB
//   at T=4096 for d_r=64) and takes a ticket (one uint32 a tile); the last
//   block of a tile sums the partials in slice order (combine_partials)
//   and quantizes.
//   No float atomics: codes are the same on every call and every stream.
//   The tickets return to zero, so the wrapper keeps one buffer per device
//   and stream.
//   bf16 (MmaBody): tensor cores, mma.sync.m16n8k16 (bf16 in, f32
//   accumulators: the products are exact, only the order of the f32 sums
//   moves).  cp.async brings x (RQ x KC) and w (KC x DRP) chunks, 16 bytes
//   a thread, into a ring of 3 stages (rows padded by 16 bytes, so ldmatrix
//   meets no bank conflict; KC = 64 up to DRP 256, 16384 / DRP above:
//   22-106 KB of shared memory, 54 KB at d_r=64 with 64-row tiles, 34 KB
//   with 16).  min(8, DRP/8) warps split the channels, each covering all
//   RQ rows, so no sum crosses warps; the sums then go through shared
//   memory (RQ x DRP f32) to the epilogue.  An x whose rows are not whole
//   16-byte pieces, or whose base is not 16-byte aligned, is loaded an
//   element at a time.
//   f32 (FmaBody): a CUDA-core walk over the slice (never TF32, which
//   would break the codes' tolerance): x k-major and w as f32 in shared
//   memory, eight warps splitting each chunk's k range, their partial sums
//   added in a fixed warp order.
//   Epilogue (quantize_rows): one warp a row; a warp-shuffle max gives the
//   absmax, and the arithmetic is IEEE: fmaxf, a true divide for the scale
//   and for r / scale, rintf (round half to even) and a clamp.  Rows past T
//   load as zero and are never stored: every row count goes through the
//   kernel unpadded.  The codes' width is a launch argument (code_bytes):
//   int8 at bits <= 8, int16 at 16 bits (qmax 32767, the same scale rule;
//   the reference's 16-bit wire, which its Pallas codec refuses and its
//   unfused codec quantizes).  The sums, the split-K combine and the
//   instantiations are the same for both; only the store differs.
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
//   Design: the same kernel and plan with kCount set at compile time, so
//   the codes and scales come out of the same instructions, bit for bit.  Where the
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
//   T*d_r int8 codes, T f32 scales and w_restore (d_r*d*bytes, 512 KB at
//   d=4096, d_r=64 in bf16).  At d_r=64 it does 128 multiply-adds per
//   output element: far below the tensor cores' ratio, far above what f32
//   FMA on the CUDA cores does at the byte bound.
//
//   bf16 design (RestoreTile, tensor cores): out = scale * sum_k code_k * w_k.
//   An int8 code is exact in bf16, so mma.sync.m16n8k16 (bf16 in, f32
//   accumulators) forms every product code * w exactly; the row's f32 scale
//   multiplies the f32 sum once, in the epilogue, and the result rounds once
//   to bf16 (__floats2bfloat162_rn).  The plain version multiplies first,
//   (code * scale) @ w: the two differ by f32 rounding, far inside one bf16
//   ulp.  Feeding code * scale rounded to bf16 into the MMA instead would
//   round the input to 8 bits.  A tile is BM rows x kRestoreBN = 64
//   columns, for a block of 4 warps.  cp.async brings the tile's codes (16
//   or 4 bytes at a time where d_r allows, else plain loads) and scales
//   with the w_restore slab in 16-byte pieces (k-chunks of 64 rows, all at
//   once up to 3 chunks, else a ring of 3 stages; rows padded by 16 bytes
//   so ldmatrix meets no bank conflict; d that is not a multiple of 8, or
//   an unaligned w, loads an element at a time), zeros past d_r up to kp =
//   d_r rounded up to 16 (gemma3's d_r = 60 needs no pad in the wrapper).
//   Each warp turns its rows' codes into bf16 A fragments as it reads them
//   from shared memory (an exact f32 magic-number conversion, no I2F).  The
//   epilogue writes the bf16 tile to shared memory (over the codes) and
//   stores it in 16-byte pieces.  A block walks row tiles of one column
//   slab: w_restore is loaded once for the walk (up to 3 chunks), and the
//   next tile's codes and scales arrive in a second buffer while the tile
//   before computes and stores.  plan_restore picks the tile: the tallest
//   of 16, 32, 64 and 128 rows that still gives kTargetBlocks tiles (and
//   whose codes fit 16 KB), so few rows spread over many narrow column
//   slabs (T=1 at d=4096: 64 blocks, each reading 8 KB of w_restore) and
//   many rows share each staged slab (T=4096: 128-row tiles, 4 a block, so
//   4 MB of w_restore pass through L2 where one 16-row tile a block read
//   128 MB).  At d=4096 or 3840, d_r=64 or 60: 16 rows up to T=128, 32 up
//   to 256, 64 up to 512, 128 above.  On the card (tune sweep at d=4096)
//   8 warps a block, 64-row tiles from T=1,024, or twice the blocks did no
//   better.  No float atomics and no split of k: every call gives the same
//   bits.
//   f32 design (CUDA cores; TF32 would break f32's rtol 1e-5): one block
//   owns RD rows x a slab of DD output columns, one column per thread.  It
//   stages codes*scale as f32 in shared memory, k-major so one 16-byte load
//   gives a thread four rows (multiply first, then accumulate, as the TPU
//   kernel does); each thread reads its own w_restore column element once
//   per channel straight into a register and uses it for all RD rows.
//   Rows past T and columns past d are masked.
//   int16 codes (the 16-bit wire, no counterpart among the TPU kernels: the
//   reference's fused codec takes bits <= 8, and its 16-bit wire runs
//   unfused, dequantize then matmul): an int16 code is not exact in bf16,
//   so the tensor-core tile cannot take it.  Both dtypes take the f32
//   design's walk (dequant_restore_walk_kernel), which reads the codes as
//   int16; in bf16 it reads w_restore as bf16, rounds each code * scale to
//   bf16 as it stages it (the reference's dequantize casts to the
//   activation dtype before the matmul), sums in f32 and rounds the sum
//   once.  A simple walk, not yet tuned.
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
//   Design: the norm needs whole rows, and one SM walking every column of
//   a 4-row tick left the card idle, so a thread-block cluster of kCluster
//   = 8 blocks (the portable size; __cluster_dims__) owns RD-row tiles:
//   each block restores its own slabs of DDN = 512 columns of each RD-row
//   tile with dequant_restore's routine for the dtype: in bf16 RestoreTile's
//   walk over the cluster's tiles (16 warps, each 16 rows x 32 columns; a
//   slab's w_restore, 64 KB at d_r=64, loaded once for the walk where it
//   fits the 2-stage ring, d_r <= 128), in f32 stage_dequant and
//   restore_column.
//   Every output element goes through the same m16n8k16 placement (rows
//   tiled by 16 and columns by 8 from 0 in both kernels), the same k steps
//   in the same order from a zero accumulator and the same epilogue, so x
//   equals dequant_restore's output bit for bit.  Then a cluster barrier (arrive
//   .release, wait .acquire, after a __threadfence) makes every block's x
//   stores visible across the cluster, and row r of the cluster's rows goes
//   to warp (r / 8) % 16 of block r % 8, which normalises it with
//   row_norm.cuh's warp_row_norm, reading the rounded x back through L2
//   with plain loads.  rmsnorm uses the same routine, so its output equals
//   h bit for bit.  A cluster owns one tile while the clusters fit one
//   wave of the card (as many as cudaOccupancyMaxActiveClusters gives: a
//   block of 512 threads of 128 registers holds an SM), and ceil(tiles /
//   wave) tiles beyond, so the grid stays one wave and its norm keeps more
//   warps busy.  A 4-row tick runs on 8 SMs; d that 8 * 512 does not
//   divide leaves columns of the last slab (and at small d whole blocks)
//   idle in the restore.
// ---------------------------------------------------------------------------
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "row_norm.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDr = 1024;      // the wrappers require d_r <= 1024
constexpr int kStageFloats = 8192;                // w chunk / partials (32 KB)
constexpr int RD = 16;            // rows per dequant_restore block
constexpr int DD = kThreads;      // output columns per dequant_restore block

// 16 raw bytes of f32 w stored to shared memory
__device__ __forceinline__ void store_f32x4(float* dst, uint4 v) {
  *reinterpret_cast<float4*>(dst) = make_float4(__uint_as_float(v.x), __uint_as_float(v.y),
                                                __uint_as_float(v.z), __uint_as_float(v.w));
}

// Channel widths the reduce kernel computes: d_r rounded up to 32 * CJ with
// CJ a power of two.  w_reduce must arrive with exactly that many columns
// (the wrapper zero-pads it), so a chunk of it is one contiguous span.
__host__ __device__ constexpr int padded_width(int d_r) {
  return d_r <= 32 ? 32 : d_r <= 64 ? 64 : d_r <= 128 ? 128 : d_r <= 256 ? 256
       : d_r <= 512 ? 512 : 1024;
}

// ---- reduce_quant: the launch plan ----------------------------------------
// A block owns a tile of RQ rows and one k slice of d; kernel arguments and
// the plan the host and the wrapper's scratch sizes share.
struct ReduceArgs {
  const void* x;
  const void* w;
  void* codes;              // int8, or int16 where code_bytes == 2
  float* scales;
  int* counts;              // kCount only
  float* partials;          // tiles x splits x RQ x DRP f32 (splits > 1)
  unsigned int* tickets;    // one a tile, zero between launches (splits > 1)
  int n_rows, d, d_r, qmax;
  int code_bytes;           // 1 (int8 codes, qmax <= 127) or 2 (int16, qmax 32767)
  int kslice;               // k rows a slice: a multiple of the body's KC
  int splits;               // k slices a tile (gridDim.y)
};

constexpr int kTargetBlocks = 2 * 132;  // two waves of the H100's SMs
constexpr int kShortRows = 1024;        // bf16 up to here: 16-row tiles
constexpr int kMaxCombine = 8;          // tiles' worth of partials a combine sums

// bf16 body: k rows a stage (w chunk of KC x DRP bf16, <= 32 KB)
__host__ __device__ constexpr int mma_kc(int drp) { return drp <= 256 ? 64 : 16384 / drp; }
// f32 body: RQ * CJ <= 32 (CJ = DRP / 32) and a w chunk of kStageFloats
__host__ __device__ constexpr int fma_rq(int drp) { return drp <= 64 ? 16 : 1024 / drp; }
__host__ __device__ constexpr int fma_kc(int drp) {
  return kStageFloats / drp < 128 ? kStageFloats / drp : 128;
}

struct ReducePlan {
  int rq, kc, drp, tiles, splits, kslice;
};

// Row tile: bf16 16 rows up to kShortRows and 64 above (16 at d_r > 128,
// where 64 rows would not fit the accumulators); f32 fma_rq.  Split-K: as
// many k slices (whole chunks of KC) as bring tiles x splits to about
// kTargetBlocks, but no more than leave the last block of a tile summing
// kMaxCombine full tiles of partials (splits x valid rows <= kMaxCombine x
// RQ: 8 slices once a tile is full, 128 at T=1, where each slice holds one
// row).  On the card (d=4096, d_r=64) fewer, longer slices won from 32 rows
// up: a block's fixed costs (its ticket, the fences) and the combine grew
// faster than the shorter walk saved.
ReducePlan plan_reduce(int n_rows, int d, int d_r, int dtype) {
  ReducePlan p;
  p.drp = padded_width(d_r);
  if (dtype == 1) {
    p.rq = (p.drp <= 128 && n_rows > kShortRows) ? 64 : 16;
    p.kc = mma_kc(p.drp);
  } else {
    p.rq = fma_rq(p.drp);
    p.kc = fma_kc(p.drp);
  }
  p.tiles = (n_rows + p.rq - 1) / p.rq;
  const int chunks = (d + p.kc - 1) / p.kc;
  int want = (kTargetBlocks + p.tiles - 1) / p.tiles;
  const int cap = kMaxCombine * p.rq / (n_rows < p.rq ? n_rows : p.rq);
  want = want > cap ? cap : want;
  want = want < 1 ? 1 : want > chunks ? chunks : want;
  const int per = (chunks + want - 1) / want;        // chunks a slice
  p.kslice = per * p.kc;
  p.splits = (chunks + per - 1) / per;
  return p;
}

// ---- reduce_quant: the f32 body (CUDA cores) -------------------------------
// The block's RQ x DRP sums over k in [kbeg, kend) of x @ w, f32 FMA, into
// shared memory (sums[r * DRP + c]); returns them after a __syncthreads().
template <int RQ, int CJ>
struct FmaBody {
  static constexpr int kBlock = kThreads;
  static constexpr int DRP = 32 * CJ;                      // w_reduce row stride
  static constexpr int KC = fma_kc(DRP);
  static constexpr int KW = KC / kWarps;                   // k per warp per chunk
  static constexpr int XPT = (RQ * KC + kThreads - 1) / kThreads;
  static constexpr int WPT = KC * DRP / 4 / kThreads;      // 16-byte w loads a thread
  static_assert(RQ * CJ <= 32 && KW >= 1 && WPT >= 1, "tile does not fit");
  static constexpr size_t kSmem = 0;                       // all static

  __device__ static float* run(const ReduceArgs& a, int row0, int kbeg, int kend) {
    __shared__ __align__(16) float xs[KC * RQ];            // x tile, k-major
    __shared__ __align__(16) float ws[kStageFloats];       // w chunk, then partials
    __shared__ __align__(16) float sums[RQ * DRP];
    const float* x = static_cast<const float*>(a.x);
    const float* w = static_cast<const float*>(a.w);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, d = a.d;
    float acc[RQ][CJ];
#pragma unroll
    for (int r = 0; r < RQ; ++r)
#pragma unroll
      for (int j = 0; j < CJ; ++j) acc[r][j] = 0.f;

    // The next chunk's x and w are fetched into registers while the warps
    // compute on the current one, so the global-memory latency overlaps the
    // arithmetic.  The w chunk (KC rows of DRP) is contiguous and read 16
    // bytes at a time.
    float xr[XPT];
    uint4 wr[WPT];
    auto fetch = [&](int k0) {
      const int kn = min(KC, kend - k0);
#pragma unroll
      for (int i = 0; i < XPT; ++i) {
        const int e = tid + i * kThreads, r = e / KC, k = e % KC, row = row0 + r;
        xr[i] = (e < RQ * KC && row < a.n_rows && k < kn) ? x[(size_t)row * d + k0 + k] : 0.f;
      }
      const uint4* wc = reinterpret_cast<const uint4*>(w + (size_t)k0 * DRP);
#pragma unroll
      for (int i = 0; i < WPT; ++i) {
        const int v = tid + i * kThreads;
        wr[i] = v * 4 < kn * DRP ? wc[v] : make_uint4(0u, 0u, 0u, 0u);
      }
    };

    fetch(kbeg);
    for (int k0 = kbeg; k0 < kend; k0 += KC) {
#pragma unroll
      for (int i = 0; i < XPT; ++i) {
        const int e = tid + i * kThreads;
        if (e < RQ * KC) xs[(e % KC) * RQ + e / KC] = xr[i];
      }
#pragma unroll
      for (int i = 0; i < WPT; ++i) store_f32x4(&ws[(tid + i * kThreads) * 4], wr[i]);
      __syncthreads();
      if (k0 + KC < kend) fetch(k0 + KC);
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
    for (int e = tid; e < RQ * DRP; e += kThreads) {
      const int r = e / DRP, c = e % DRP;
      float sum = 0.f;
#pragma unroll
      for (int q = 0; q < kWarps; ++q) sum += red[(q * RQ + r) * DRP + c];
      sums[e] = sum;
    }
    __syncthreads();
    return sums;
  }
};

// ---- reduce_quant: the bf16 body (tensor cores) ----------------------------
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared, asynchronously; bytes < 16 fills the rest with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p))
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(smem_addr(p)) : "memory");
}
// c += a (16 x 16 bf16, rows) * b (16 x 8 bf16, columns), f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
               "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
               : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// NW warps split the DRP channels (NT tiles of 8 each) and all cover the
// RQ rows (MT tiles of 16), so no sum crosses warps.  Stages of KC k rows:
// x (RQ x KC, rows padded by 8) and w (KC x DRP, rows padded by 8: the
// 16-byte rows ldmatrix reads of 8 consecutive rows fall in distinct banks).
template <int RQ, int DRP>
struct MmaBody {
  static constexpr int NW = DRP / 8 < kWarps ? DRP / 8 : kWarps;
  static constexpr int kBlock = 32 * NW;
  static constexpr int NT = DRP / 8 / NW;
  static constexpr int MT = RQ / 16;
  static constexpr int KC = mma_kc(DRP);
  static constexpr int XS = KC + 8, WS = DRP + 8;
  static constexpr int kStageElems = RQ * XS + KC * WS;
  static constexpr int kStages = 3;
  static constexpr size_t kStageBytes = (size_t)kStages * kStageElems * 2;
  static constexpr size_t kSmem = kStageBytes > (size_t)RQ * DRP * 4 ? kStageBytes
                                                                      : (size_t)RQ * DRP * 4;
  static_assert(MT * NT <= 16 && NT >= 1 && KC % 16 == 0, "tile does not fit");

  __device__ static void load(__nv_bfloat16* st, const ReduceArgs& a, int row0, int k0,
                              int kend, bool xvec) {
    const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.x);
    const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(a.w);
    __nv_bfloat16* xs = st;
    __nv_bfloat16* wsm = st + RQ * XS;
    constexpr int XP = KC / 8, WP = DRP / 8;             // 16-byte pieces a row
    for (int i = threadIdx.x; i < RQ * XP; i += kBlock) {
      const int r = i / XP, k = k0 + (i % XP) * 8, row = row0 + r;
      __nv_bfloat16* dst = xs + r * XS + (i % XP) * 8;
      if (xvec) {
        const bool ok = row < a.n_rows && k < kend;
        cp_async16(dst, ok ? x + (size_t)row * a.d + k : x, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = (row < a.n_rows && k + e < kend) ? x[(size_t)row * a.d + k + e]
                                                    : __float2bfloat16_rn(0.f);
      }
    }
    for (int i = threadIdx.x; i < KC * WP; i += kBlock) {
      const int kr = i / WP, k = k0 + kr;
      const bool ok = k < kend;
      cp_async16(wsm + kr * WS + (i % WP) * 8, ok ? w + (size_t)k * DRP + (i % WP) * 8 : w,
                 ok ? 16 : 0);
    }
  }

  __device__ static float* run(const ReduceArgs& a, int row0, int kbeg, int kend) {
    extern __shared__ __align__(128) unsigned char smem_raw[];
    __nv_bfloat16* stages = reinterpret_cast<__nv_bfloat16*>(smem_raw);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int n0 = warp * NT * 8;
    // 16-byte pieces of x need whole pieces inside each row and an aligned base
    const bool xvec = a.d % 8 == 0 && (reinterpret_cast<uintptr_t>(a.x) & 15) == 0;
    float acc[MT][NT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;

    const int nch = (kend - kbeg + KC - 1) / KC;
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < nch) load(stages + s * kStageElems, a, row0, kbeg + s * KC, kend, xvec);
      cp_async_commit();
    }
    for (int c = 0; c < nch; ++c) {
      cp_async_wait<kStages - 2>();                      // chunk c has landed
      __syncthreads();                                   // ... and chunk c-1 is consumed
      const int nx = c + kStages - 1;
      if (nx < nch) load(stages + (nx % kStages) * kStageElems, a, row0, kbeg + nx * KC,
                         kend, xvec);
      cp_async_commit();
      const __nv_bfloat16* xs = stages + (c % kStages) * kStageElems;
      const __nv_bfloat16* wsm = xs + RQ * XS;
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
        uint32_t af[MT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m)
          ldmatrix_x4(af[m], xs + (m * 16 + (lane & 15)) * XS + kk + (lane >> 4) * 8);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          uint32_t bf[2];
          ldmatrix_x2_trans(bf, wsm + (kk + (lane & 15)) * WS + n0 + n * 8);
#pragma unroll
          for (int m = 0; m < MT; ++m) mma_bf16(acc[m][n], af[m], bf);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();                                     // the stages are free

    float* sums = reinterpret_cast<float*>(smem_raw);
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int r = m * 16 + g, c = n0 + n * 8 + 2 * t;
        sums[r * DRP + c] = acc[m][n][0];
        sums[r * DRP + c + 1] = acc[m][n][1];
        sums[(r + 8) * DRP + c] = acc[m][n][2];
        sums[(r + 8) * DRP + c + 1] = acc[m][n][3];
      }
    __syncthreads();
    return sums;
  }
};

// ---- reduce_quant: split-K combine and the quantize epilogue ---------------
// With splits > 1 each block stores its rows' partial sums, then takes a
// ticket; the block that draws the last one sums the tile's partials in
// slice order and goes on to the epilogue; the others return.  Release:
// every thread fences its stores before the block's ticket; acquire: the
// last block fences after it and reads the partials through L2 (__ldcg),
// never the non-coherent path.  It resets the ticket for the next launch on
// the stream.  G threads share four adjacent sums (16-byte loads), each
// summing a fixed run of the slices in order, then an xor butterfly adds
// the G runs: a fixed order, so codes never depend on which block finished
// last.  A thread carries U such groups at once, so U loads a slice are in
// flight.
template <int RQ, int DRP>
__device__ bool combine_partials(const ReduceArgs& a, float* sums, int tile, int slice,
                                 int row0) {
  constexpr int U = 4;                         // float4 groups a thread carries at once
  __shared__ int last;
  const int nr = min(RQ, a.n_rows - row0);
  const int E4 = nr * DRP / 4;                 // the tile's valid sums, as float4 groups
  float4* sums4 = reinterpret_cast<float4*>(sums);
  float4* part = reinterpret_cast<float4*>(a.partials) + (size_t)tile * a.splits * RQ * DRP / 4;
  float4* mine = part + (size_t)slice * RQ * DRP / 4;
  for (int e = threadIdx.x; e < E4; e += blockDim.x) mine[e] = sums4[e];
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(&a.tickets[tile], 1u) == (unsigned int)(a.splits - 1);
  __syncthreads();
  if (!last) return false;
  __threadfence();
  int G = 1;
  while (G < 32 && 2 * G * E4 <= (int)blockDim.x && 2 * G <= a.splits) G *= 2;
  const int per = (a.splits + G - 1) / G;
  const int q0 = (threadIdx.x % G) * per, q1 = min(a.splits, q0 + per);
  const size_t stride = (size_t)RQ * DRP / 4;  // float4 groups a slice
  for (int base = 0; base < E4 * G; base += blockDim.x * U) {
    int e[U];
    float4 s[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      e[u] = (base + u * blockDim.x + threadIdx.x) / G;
      s[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll 4
    for (int q = q0; q < q1; ++q)
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (e[u] < E4) {
          const float4 v = __ldcg(part + q * stride + e[u]);
          s[u].x += v.x;
          s[u].y += v.y;
          s[u].z += v.z;
          s[u].w += v.w;
        }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      for (int o = G / 2; o > 0; o >>= 1) {
        s[u].x += __shfl_xor_sync(0xffffffffu, s[u].x, o);
        s[u].y += __shfl_xor_sync(0xffffffffu, s[u].y, o);
        s[u].z += __shfl_xor_sync(0xffffffffu, s[u].z, o);
        s[u].w += __shfl_xor_sync(0xffffffffu, s[u].w, o);
      }
      if (e[u] < E4 && threadIdx.x % G == 0) sums4[e[u]] = s[u];
    }
  }
  if (threadIdx.x == 0) a.tickets[tile] = 0u;
  __syncthreads();
  return true;
}

// One warp a row: a warp-shuffle max gives the absmax, and the arithmetic
// is IEEE: fmaxf, a true divide for the scale and for r / scale, rintf
// (round half to even; roundf would round half away from zero) and a clamp.
// Rows past n_rows are never stored.  The codes are int8 or int16 as
// code_bytes says, a launch argument: the int16 wire (qmax 32767) runs the
// same instantiations, and only this store differs.  With kCount (int8
// codes only), counts (d_r x 2 * (qmax + 1) int32, zeroed by the caller)
// gains one in the bin of every code stored.
template <int RQ, int DRP, bool kCount>
__device__ void quantize_rows(const ReduceArgs& a, const float* sums, int row0) {
  constexpr int CJ = DRP / 32;
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  const float fq = (float)a.qmax;
  for (int r = threadIdx.x >> 5; r < RQ; r += nw) {
    const int row = row0 + r;
    if (row >= a.n_rows) break;
    float v[CJ];
    float m = 0.f;
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      const int c = lane + 32 * j;
      v[j] = sums[r * DRP + c];
      if (c < a.d_r) m = fmaxf(m, fabsf(v[j]));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    const float scale = fmaxf(m, 1e-8f) / fq;
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      const int c = lane + 32 * j;
      if (c < a.d_r) {
        const float q = fminf(fmaxf(rintf(v[j] / scale), -fq - 1.f), fq);
        const size_t at = (size_t)row * a.d_r + c;
        if (a.code_bytes == 2) static_cast<int16_t*>(a.codes)[at] = (int16_t)q;
        else static_cast<int8_t*>(a.codes)[at] = (int8_t)q;
        if constexpr (kCount)
          atomicAdd(&a.counts[c * (2 * (a.qmax + 1)) + (int)q + a.qmax + 1], 1);
      }
    }
    if (lane == 0) a.scales[row] = scale;
  }
}

// grid (tiles, splits): block (tile, slice) sums rows [tile * RQ, + RQ) over
// k in [slice * kslice, + kslice), then, alone or as the tile's last block,
// quantizes them.
template <class Body, int RQ, int DRP, bool kCount>
__global__ void __launch_bounds__(Body::kBlock)
reduce_quant_kernel(ReduceArgs a) {
  const int tile = blockIdx.x, slice = blockIdx.y, row0 = tile * RQ;
  const int kbeg = slice * a.kslice, kend = min(kbeg + a.kslice, a.d);
  float* sums = Body::run(a, row0, kbeg, kend);
  if (a.splits > 1 && !combine_partials<RQ, DRP>(a, sums, tile, slice, row0)) return;
  quantize_rows<RQ, DRP, kCount>(a, sums, row0);
}

template <class Body, int RQ, int DRP, bool kCount>
cudaError_t launch_reduce(const ReduceArgs& a, const ReducePlan& p, cudaStream_t s) {
  auto kern = reduce_quant_kernel<Body, RQ, DRP, kCount>;
  if (Body::kSmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Body::kSmem);
    if (err != cudaSuccess) return err;
  }
  kern<<<dim3(p.tiles, p.splits), Body::kBlock, Body::kSmem, s>>>(a);
  return cudaGetLastError();
}

template <bool kCount>
cudaError_t dispatch_reduce(const ReduceArgs& a, const ReducePlan& p, int dtype,
                            cudaStream_t s) {
#define FMA(RQ, CJ) launch_reduce<FmaBody<RQ, CJ>, RQ, 32 * CJ, kCount>(a, p, s)
#define MMA(RQ, DRP) launch_reduce<MmaBody<RQ, DRP>, RQ, DRP, kCount>(a, p, s)
  if (dtype == 0) {
    switch (p.drp) {
      case 32: return FMA(16, 1);
      case 64: return FMA(16, 2);
      case 128: return FMA(8, 4);
      case 256: return FMA(4, 8);
      case 512: return FMA(2, 16);
      default: return FMA(1, 32);
    }
  }
  const bool tall = p.rq == 64;
  switch (p.drp) {
    case 32: return tall ? MMA(64, 32) : MMA(16, 32);
    case 64: return tall ? MMA(64, 64) : MMA(16, 64);
    case 128: return tall ? MMA(64, 128) : MMA(16, 128);
    case 256: return MMA(16, 256);
    case 512: return MMA(16, 512);
    default: return MMA(16, 1024);
  }
#undef FMA
#undef MMA
}

bool reduce_args_ok(int n_rows, int d, int d_r, int qmax, int code_bytes, int dtype) {
  const bool codes_ok = code_bytes == 1 ? qmax >= 0 && qmax <= 127
                        : code_bytes == 2 && qmax == 32767;
  return n_rows > 0 && d > 0 && d_r > 0 && d_r <= kMaxDr && codes_ok &&
         (dtype == 0 || dtype == 1);
}

template <bool kCount>
int reduce_entry(const void* x, const void* w, void* codes, void* scales, int* counts,
                 void* partials, void* tickets, int n_rows, int d, int d_r, int qmax,
                 int code_bytes, int dtype, void* stream) {
  if (!reduce_args_ok(n_rows, d, d_r, qmax, code_bytes, dtype) ||
      (kCount && code_bytes != 1))
    return (int)cudaErrorInvalidValue;
  const ReducePlan p = plan_reduce(n_rows, d, d_r, dtype);
  if (p.splits > 1 && (partials == nullptr || tickets == nullptr))
    return (int)cudaErrorInvalidValue;
  ReduceArgs a;
  a.x = x;
  a.w = w;
  a.codes = codes;
  a.scales = static_cast<float*>(scales);
  a.counts = counts;
  a.partials = static_cast<float*>(partials);
  a.tickets = static_cast<unsigned int*>(tickets);
  a.n_rows = n_rows;
  a.d = d;
  a.d_r = d_r;
  a.qmax = qmax;
  a.code_bytes = code_bytes;
  a.kslice = p.kslice;
  a.splits = p.splits;
  return (int)dispatch_reduce<kCount>(a, p, dtype, static_cast<cudaStream_t>(stream));
}

// ---- dequant_restore and restore_norm: the CUDA-core walk -------------------
// codes * scale of rows [row0, row0 + RD) as f32 in shared memory, k-major
// (rs[k * RD + r]); rows past n_rows are zeros.  C is int8 or int16; kRound
// rounds each product to bf16 first, as the reference's dequantize casts it
// to a bf16 activation before the restore (the int16 wire's order)
template <typename C, bool kRound = false>
__device__ __forceinline__ void stage_dequant(const C* __restrict__ codes,
                                              const float* __restrict__ scales,
                                              float* rs, int row0, int n_rows, int d_r) {
  for (int e = threadIdx.x; e < RD * d_r; e += blockDim.x) {
    const int r = e / d_r, k = e % d_r, row = row0 + r;
    float v = row < n_rows ? (float)codes[(size_t)row * d_r + k] * scales[row] : 0.f;
    if constexpr (kRound) v = __bfloat162float(__float2bfloat16_rn(v));
    rs[k * RD + r] = v;
  }
}

// acc[r] = sum over k, in order, of rs[k][r] * w[k][col] (f32 fmaf, w read
// as f32): one output column of the block's RD rows
template <typename W>
__device__ __forceinline__ void restore_column(const float* rs, const W* __restrict__ w,
                                               int col, int d_r, int d, float (&acc)[RD]) {
#pragma unroll
  for (int r = 0; r < RD; ++r) acc[r] = 0.f;
#pragma unroll 8
  for (int k = 0; k < d_r; ++k) {
    const float wv = row_norm::to_f32(w[(size_t)k * d + col]);
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

// The f32 restore of int8 or int16 codes (W = float), and the bf16 restore
// of int16 codes (W = bf16: each code * scale rounded to bf16, the f32 sums
// rounded once to bf16); int8 codes restore to bf16 on the tensor cores
template <typename C, typename W>
__global__ void __launch_bounds__(kThreads)
dequant_restore_walk_kernel(const C* __restrict__ codes,
                            const float* __restrict__ scales,
                            const W* __restrict__ w, W* __restrict__ out,
                            int n_rows, int d_r, int d) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* rs = reinterpret_cast<float*>(smem_raw);   // d_r x RD, codes * scale
  const int row0 = blockIdx.x * RD;
  stage_dequant<C, sizeof(W) == 2>(codes, scales, rs, row0, n_rows, d_r);
  __syncthreads();

  const int col = blockIdx.y * DD + threadIdx.x;
  if (col >= d) return;
  float acc[RD];
  restore_column(rs, w, col, d_r, d, acc);
#pragma unroll
  for (int r = 0; r < RD; ++r) {
    const int row = row0 + r;
    if (row < n_rows) row_norm::from_f32(acc[r], out + (size_t)row * d + col);
  }
}

// ---- dequant_restore and restore_norm: the bf16 tile (tensor cores) --------
struct RestoreArgs {
  const int8_t* codes;
  const float* scales;
  const void* w;            // (d_r, d) of the kernel's dtype
  void* out;                // (n_rows, d) of the kernel's dtype (restore_norm: x)
  int n_rows, d_r, d;
  int kp;                   // d_r rounded up to 16: the k the products run over
  int cbytes;               // codes copied 16 or 4 bytes at a time, or 1: plain loads
  bool vec;                 // w read and out written 16 bytes at a time
};

RestoreArgs restore_args(const void* codes, const void* scales, const void* w, void* out,
                         int n_rows, int d_r, int d) {
  RestoreArgs p;
  p.codes = static_cast<const int8_t*>(codes);
  p.scales = static_cast<const float*>(scales);
  p.w = w;
  p.out = out;
  p.n_rows = n_rows;
  p.d_r = d_r;
  p.d = d;
  p.kp = (d_r + 15) / 16 * 16;
  const uintptr_t ca = reinterpret_cast<uintptr_t>(codes);
  p.cbytes = d_r % 16 == 0 && (ca & 15) == 0 ? 16 : d_r % 4 == 0 && (ca & 3) == 0 ? 4 : 1;
  p.vec = d % 8 == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0 &&
          (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  return p;
}

// 4 bytes global -> shared, asynchronously; bytes < 4 fills the rest with zeros
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p))
               : "memory");
}

// Two int8 codes, the low and the high byte of v, as a bf16 pair (low
// element first), exactly: the byte c + 128 in the low mantissa bits of
// 2**23 is the f32 2**23 + 128 + c, and subtracting 2**23 + 128 is exact
__device__ __forceinline__ uint32_t codes_to_bf16x2(uint32_t v) {
  const uint32_t u = v ^ 0x8080u;
  const float lo = __uint_as_float(0x4B000000u | (u & 0xffu)) - 8388736.f;
  const float hi = __uint_as_float(0x4B000000u | ((u >> 8) & 0xffu)) - 8388736.f;
  const __nv_bfloat162 b = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&b);
}

// Tiles of BM x BN outputs, WM x WN warps, each MT x NT tiles of 16 x 8:
// out = bf16(scale * sum_k code_k * w_k) with every product on the tensor
// cores and the k steps of 16 in order from a zero accumulator, whatever
// the tile shape, so two tile shapes give the same bits for the same
// element.  Shared memory: two buffers, each of BM scales (f32) and a
// region that holds a tile's codes as copied (BM rows of kp int8, row
// stride kp + 16) and then its output tile (row stride BN + 8 bf16); and a
// ring of w chunks (KC k rows x BN columns, row stride BN + 8; a chunk of
// kp rows where kp < KC).  The codes and w arrive by cp.async together,
// so a block waits for memory once a tile; each warp then turns its rows'
// codes into its bf16 A fragments straight from the copy
// (codes_to_bf16x2).  The strides keep the rows of an ldmatrix, and the
// codes a warp reads, in distinct banks.
template <int BM, int BN, int WM, int WN, int KC, int kStages>
struct RestoreTile {
  using bf16 = __nv_bfloat16;
  static constexpr int kBlock = 32 * WM * WN;
  static constexpr int MT = BM / 16 / WM, NT = BN / 8 / WN;
  static constexpr int WS = BN + 8, OS = BN + 8;
  static_assert(MT >= 1 && NT >= 2 && NT % 2 == 0 && KC % 16 == 0, "tile does not fit");

  __host__ __device__ static int chunks(int kp) { return (kp + KC - 1) / KC; }
  __host__ __device__ static int stages(int kp) {
    return chunks(kp) < kStages ? chunks(kp) : kStages;
  }
  __host__ __device__ static int stage_elems(int kp) { return (kp < KC ? kp : KC) * WS; }
  __host__ __device__ static int region_bytes(int kp) {
    return BM * (kp + 16 > OS * 2 ? kp + 16 : OS * 2);
  }
  __host__ __device__ static size_t smem(int kp) {
    return 2 * ((size_t)BM * 4 + region_bytes(kp)) + (size_t)stages(kp) * stage_elems(kp) * 2;
  }

  // The codes of rows [row0, row0 + BM) into raw[r * (kp + 16) + k], zeros
  // past d_r and past n_rows: by cp.async where they come in 16- or 4-byte
  // pieces, else plain loads; their scales into sc by cp.async
  __device__ static void load_codes(const RestoreArgs& p, int8_t* raw, float* sc, int row0) {
    const int rs = p.kp + 16;
    if (p.cbytes > 1) {
      const int cb = p.cbytes, q = p.kp / cb;
      for (int i = threadIdx.x; i < BM * q; i += kBlock) {
        const int r = i / q, k = (i - r * q) * cb, row = row0 + r;
        const bool ok = row < p.n_rows && k < p.d_r;    // d_r % cb == 0: whole pieces
        const int8_t* src = ok ? p.codes + (size_t)row * p.d_r + k : p.codes;
        if (cb == 16) cp_async16(raw + r * rs + k, src, ok ? 16 : 0);
        else cp_async4(raw + r * rs + k, src, ok ? 4 : 0);
      }
    } else {
      for (int i = threadIdx.x; i < BM * p.kp; i += kBlock) {
        const int r = i / p.kp, k = i - r * p.kp, row = row0 + r;
        raw[r * rs + k] = row < p.n_rows && k < p.d_r ? p.codes[(size_t)row * p.d_r + k] : 0;
      }
    }
    for (int r = threadIdx.x; r < BM; r += kBlock) {
      const bool ok = row0 + r < p.n_rows;
      cp_async4(sc + r, ok ? p.scales + row0 + r : p.scales, ok ? 4 : 0);
    }
  }

  // w rows [k0, k0 + min(KC, kp - k0)) of columns [col0, col0 + BN) into
  // ws[kr * WS + c]: cp.async in 16-byte pieces, or an element at a time;
  // zeros past d_r and past d
  __device__ static void load_w(const RestoreArgs& p, bf16* ws, int k0, int col0) {
    constexpr int P = BN / 8;                        // 16-byte pieces a row
    const bf16* w = static_cast<const bf16*>(p.w);
    const int kn = min(KC, p.kp - k0);
    for (int i = threadIdx.x; i < kn * P; i += kBlock) {
      const int kr = i / P, c = (i % P) * 8, k = k0 + kr, col = col0 + c;
      bf16* dst = ws + kr * WS + c;
      if (p.vec) {
        const bool ok = k < p.d_r && col < p.d;     // d % 8 == 0: whole pieces
        cp_async16(dst, ok ? w + (size_t)k * p.d + col : w, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = (k < p.d_r && col + e < p.d) ? w[(size_t)k * p.d + col + e]
                                                 : __float2bfloat16_rn(0.f);
      }
    }
  }

  // acc += the products of the k steps [k0, k0 + kn) (kn <= KC); the A
  // fragment of m16n8k16 (rows g and g + 8, k 2t, 2t + 1 and 8 more) comes
  // from the copied codes, two codes a register
  __device__ static void mma_chunk(float (&acc)[MT][NT][4], const int8_t* raw, int rs,
                                   const bf16* ws, int k0, int kn, int m0, int n0) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      if (kk >= kn) break;
      uint32_t af[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const int8_t* c = raw + (m0 + m * 16 + g) * rs + k0 + kk + 2 * t;
        af[m][0] = codes_to_bf16x2(*reinterpret_cast<const uint16_t*>(c));
        af[m][1] = codes_to_bf16x2(*reinterpret_cast<const uint16_t*>(c + 8 * rs));
        af[m][2] = codes_to_bf16x2(*reinterpret_cast<const uint16_t*>(c + 8));
        af[m][3] = codes_to_bf16x2(*reinterpret_cast<const uint16_t*>(c + 8 * rs + 8));
      }
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, ws + (kk + (lane & 15)) * WS + n0 + (n + (lane >> 4)) * 8);
        const uint32_t b0[2] = {bf[0], bf[1]}, b1[2] = {bf[2], bf[3]};
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          mma_bf16(acc[m][n], af[m], b0);
          mma_bf16(acc[m][n + 1], af[m], b1);
        }
      }
    }
  }

  // The epilogue of the tile at (row0, col0): scale the f32 sums, round
  // once to bf16, write them through shared memory (o, over the tile's
  // codes) and store them in 16-byte pieces
  __device__ static void store_tile(const RestoreArgs& p, const float (&acc)[MT][NT][4],
                                    const float* sc, bf16* o, int m0, int n0, int row0,
                                    int col0) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int r = m0 + m * 16 + g, c = n0 + n * 8 + 2 * t;
        *reinterpret_cast<__nv_bfloat162*>(o + r * OS + c) =
            __floats2bfloat162_rn(acc[m][n][0] * sc[r], acc[m][n][1] * sc[r]);
        *reinterpret_cast<__nv_bfloat162*>(o + (r + 8) * OS + c) =
            __floats2bfloat162_rn(acc[m][n][2] * sc[r + 8], acc[m][n][3] * sc[r + 8]);
      }
    __syncthreads();
    constexpr int P = BN / 8;
    bf16* out = static_cast<bf16*>(p.out);
    for (int i = threadIdx.x; i < BM * P; i += kBlock) {
      const int r = i / P, c = (i % P) * 8, row = row0 + r, col = col0 + c;
      if (row >= p.n_rows || col >= p.d) continue;
      const bf16* src = o + r * OS + c;
      bf16* dst = out + (size_t)row * p.d + col;
      if (p.vec) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (col + e < p.d) dst[e] = src[e];
      }
    }
  }

  // The tiles at rows row0, row0 + stride, ... (ntiles of them) of the
  // column slab at col0.  Where all of w's chunks fit the ring, the slab's
  // w is loaded once for the walk and each tile's codes and scales arrive
  // (in the other of two buffers) while the tile before computes and
  // stores; otherwise each tile streams w through the ring.
  __device__ static void walk(const RestoreArgs& p, unsigned char* smem, int col0, int row0,
                              int stride, int ntiles) {
    const int rb = region_bytes(p.kp), rs = p.kp + 16, nch = chunks(p.kp);
    const int se = stage_elems(p.kp);
    bf16* ring = reinterpret_cast<bf16*>(smem + 2 * BM * 4 + 2 * rb);
    auto sc = [&](int i) { return reinterpret_cast<float*>(smem) + (i & 1) * BM; };
    auto raw = [&](int i) { return reinterpret_cast<int8_t*>(smem + 2 * BM * 4 + (i & 1) * rb); };
    const int warp = threadIdx.x >> 5;
    const int m0 = (warp / WN) * MT * 16, n0 = (warp % WN) * NT * 8;
    const bool resident = nch <= kStages;
    __syncthreads();                   // a walk before this one is stored
    if (resident) {
      for (int c = 0; c < nch; ++c) load_w(p, ring + c * se, c * KC, col0);
      load_codes(p, raw(0), sc(0), row0);
      cp_async_commit();
    }
    for (int i = 0; i < ntiles; ++i) {
      const int r0 = row0 + i * stride;
      float acc[MT][NT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
      __syncthreads();                 // tile i - 1 is stored: its buffer is free
      if (resident) {
        if (i + 1 < ntiles) load_codes(p, raw(i + 1), sc(i + 1), r0 + stride);
        cp_async_commit();
        cp_async_wait<1>();            // tile i's codes (and w) have landed
        __syncthreads();
        for (int c = 0; c < nch; ++c)
          mma_chunk(acc, raw(i), rs, ring + c * se, c * KC, min(KC, p.kp - c * KC), m0, n0);
      } else {                         // a ring of kStages chunks
        load_codes(p, raw(i), sc(i), r0);   // in the first chunk's group
#pragma unroll
        for (int s = 0; s < kStages - 1; ++s) {
          load_w(p, ring + s * se, s * KC, col0);
          cp_async_commit();
        }
        for (int c = 0; c < nch; ++c) {
          cp_async_wait<kStages - 2>();     // chunk c has landed
          __syncthreads();                  // ... and chunk c - 1 is consumed
          const int nx = c + kStages - 1;
          if (nx < nch) load_w(p, ring + (nx % kStages) * se, nx * KC, col0);
          cp_async_commit();
          mma_chunk(acc, raw(i), rs, ring + (c % kStages) * se, c * KC,
                    min(KC, p.kp - c * KC), m0, n0);
        }
        cp_async_wait<0>();
      }
      __syncthreads();                 // every warp has read tile i's codes
      store_tile(p, acc, sc(i), reinterpret_cast<bf16*>(raw(i)), m0, n0, r0, col0);
    }
  }
};

// dequant_restore's bf16 tiles: BM rows x kRestoreBN columns, 4 warps (as
// many along the rows as there are 16-row tiles, up to 4), w in k-chunks of
// 64 rows, a ring of 3.  A block walks `groups`-strided row tiles of one
// column slab; plan_restore picks BM and the groups from the shape.
constexpr int kRestoreBN = 64;
constexpr int kRestoreMaxCodes = 16384;   // BM * kp: a tile's codes, 16 KB
constexpr int kRestoreBlocks = 4 * 132;   // four blocks on each of the H100's SMs

template <int BM>
using RestoreMma = RestoreTile<BM, kRestoreBN, (BM / 16 < 4 ? BM / 16 : 4),
                               4 / (BM / 16 < 4 ? BM / 16 : 4), 64, 3>;

template <int BM>
__global__ void __launch_bounds__(RestoreMma<BM>::kBlock)
dequant_restore_mma_kernel(RestoreArgs p, int groups) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int tiles = (p.n_rows + BM - 1) / BM, g = blockIdx.x;
  RestoreMma<BM>::walk(p, smem_raw, blockIdx.y * kRestoreBN, g * BM, groups * BM,
                       (tiles - g + groups - 1) / groups);
}

struct RestorePlan {
  int bm, slabs, groups;
};

// Rows a tile: the tallest of 16, 32, 64 and 128 that still gives
// kTargetBlocks tiles of kRestoreBN columns and whose codes fit
// kRestoreMaxCodes: few rows spread over the column slabs, many rows share
// each staged slab of w_restore.  At d = 3840-4096 (60-64 slabs) and d_r <=
// 64: 16 rows up to T = 128, 32 up to 256, 64 up to 512 and 128 from 513
// rows.  Then the tiles of a slab split into as few equal groups as keep
// the blocks within kRestoreBlocks, each a block that walks its group: one
// tile a block up to T = 1,024 at d = 4096, 2 at 1,025, 4 at 4,096.
RestorePlan plan_restore(int n_rows, int d, int kp) {
  RestorePlan p;
  p.slabs = (d + kRestoreBN - 1) / kRestoreBN;
  p.bm = 16;
  for (int cand = 32; cand <= 128; cand *= 2)
    if (cand * kp <= kRestoreMaxCodes &&
        (long long)((n_rows + cand - 1) / cand) * p.slabs >= kTargetBlocks)
      p.bm = cand;
  const int tiles = (n_rows + p.bm - 1) / p.bm;
  const int want = kRestoreBlocks / p.slabs > 1 ? kRestoreBlocks / p.slabs : 1;
  const int per = (tiles + want - 1) / want;            // tiles a block walks
  p.groups = (tiles + per - 1) / per;
  return p;
}

size_t restore_mma_smem(int bm, int kp) {
  switch (bm) {
    case 16: return RestoreMma<16>::smem(kp);
    case 32: return RestoreMma<32>::smem(kp);
    case 64: return RestoreMma<64>::smem(kp);
    default: return RestoreMma<128>::smem(kp);
  }
}

template <int BM>
cudaError_t launch_restore_mma(const RestoreArgs& p, const RestorePlan& plan,
                               cudaStream_t s) {
  auto kern = dequant_restore_mma_kernel<BM>;
  const size_t smem = RestoreMma<BM>::smem(p.kp);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kern<<<dim3(plan.groups, plan.slabs), RestoreMma<BM>::kBlock, smem, s>>>(p, plan.groups);
  return cudaGetLastError();
}

template <typename C, typename W>
cudaError_t launch_restore_walk(const void* codes, const float* scales, const void* w,
                                void* out, int n_rows, int d_r, int d, cudaStream_t s) {
  auto kern = dequant_restore_walk_kernel<C, W>;
  const size_t smem = (size_t)RD * d_r * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((n_rows + RD - 1) / RD, (d + DD - 1) / DD);
  kern<<<grid, kThreads, smem, s>>>(static_cast<const C*>(codes), scales,
                                    static_cast<const W*>(w), static_cast<W*>(out),
                                    n_rows, d_r, d);
  return cudaGetLastError();
}

// int16 codes (code_bytes 2) take the walk in either dtype
cudaError_t launch_restore(const RestoreArgs& p, int dtype, int code_bytes, cudaStream_t s) {
  if (code_bytes == 2) {
    if (dtype == 1)
      return launch_restore_walk<int16_t, __nv_bfloat16>(p.codes, p.scales, p.w, p.out,
                                                         p.n_rows, p.d_r, p.d, s);
    return launch_restore_walk<int16_t, float>(p.codes, p.scales, p.w, p.out, p.n_rows,
                                               p.d_r, p.d, s);
  }
  if (dtype == 1) {
    const RestorePlan plan = plan_restore(p.n_rows, p.d, p.kp);
    switch (plan.bm) {
      case 16: return launch_restore_mma<16>(p, plan, s);
      case 32: return launch_restore_mma<32>(p, plan, s);
      case 64: return launch_restore_mma<64>(p, plan, s);
      default: return launch_restore_mma<128>(p, plan, s);
    }
  }
  return launch_restore_walk<int8_t, float>(p.codes, p.scales, p.w, p.out, p.n_rows,
                                            p.d_r, p.d, s);
}

// ---- restore_norm ----------------------------------------------------------
// A cluster of kCluster blocks owns `sub` tiles of RD rows: block `rank`
// restores the column slabs rank, rank + kCluster, ... of DDN columns, for
// each tile in turn (bf16: slab by slab, RestoreTile's walk over the
// tiles; f32: tile by tile, one column a thread).  After the cluster barrier every column of
// those rows is in x, and row r of the cluster's rows goes to warp
// (r / kCluster) % kNormWarps of block r % kCluster.  x is written by other
// SMs of the cluster and read back here, so it is a plain pointer (see
// row_norm.cuh), never read through the non-coherent path.  The norm reads
// w as it writes h (no PREFETCH_W): holding w too, as rmsnorm does, costs
// registers; the sums run in the same order either way.
constexpr int kCluster = 8;       // blocks a cluster: the portable maximum
constexpr int DDN = 512;          // columns (and threads) a restore_norm block
constexpr int kNormWarps = DDN / 32;

// one warp a 16-row x 32-column strip of the slab; w chunks of 64 k rows, a
// ring of 2 (a slab's whole w_restore stays put up to d_r = 128)
using NormRestore = RestoreTile<RD, DDN, 1, kNormWarps, 64, 2>;

template <typename T>
size_t restore_norm_smem(int d_r) {
  if (sizeof(T) == 2) return NormRestore::smem((d_r + 15) / 16 * 16);
  return (size_t)RD * d_r * sizeof(float);
}

template <typename T>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(DDN)
dequant_restore_norm_kernel(RestoreArgs p, const T* __restrict__ norm_w,
                            T* __restrict__ h, float eps, int sub) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int rank = blockIdx.x % kCluster, row0 = blockIdx.x / kCluster * RD * sub;
  const int n_rows = p.n_rows, d = p.d;
  T* x = static_cast<T*>(p.out);
  if constexpr (sizeof(T) == 2) {
    const int ntiles = min(sub, (n_rows - row0 + RD - 1) / RD);
    for (int col0 = rank * DDN; col0 < d; col0 += kCluster * DDN)
      NormRestore::walk(p, smem_raw, col0, row0, RD, ntiles);
  } else {
    float* rs = reinterpret_cast<float*>(smem_raw);   // d_r x RD, codes * scale
    const float* w = static_cast<const float*>(p.w);
    for (int t = 0; t < sub && row0 + t * RD < n_rows; ++t) {
      const int r0 = row0 + t * RD;
      if (t) __syncthreads();                     // the last tile's rs is read
      stage_dequant<int8_t>(p.codes, p.scales, rs, r0, n_rows, p.d_r);
      __syncthreads();
      for (int col = rank * DDN + threadIdx.x; col < d; col += kCluster * DDN) {
        float acc[RD];
        restore_column(rs, w, col, p.d_r, d, acc);
#pragma unroll
        for (int r = 0; r < RD; ++r) {
          const int row = r0 + r;
          if (row < n_rows) x[(size_t)row * d + col] = acc[r];
        }
      }
    }
  }
  // every block's x stores are visible to every thread of the cluster after
  // the barrier: each thread fences its own stores, the arrive releases and
  // the wait acquires
  __threadfence();
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");

  for (int r = rank + kCluster * (threadIdx.x / 32); r < RD * sub;
       r += kCluster * kNormWarps) {
    const int row = row0 + r;
    if (row < n_rows)
      row_norm::warp_row_norm<T, false>(x + (size_t)row * d, norm_w,
                                        h + (size_t)row * d, d, eps);
  }
}

// The clusters of restore_norm the current card holds at once
// (cudaOccupancyMaxActiveClusters), asked once a device and dtype for
// shared memory up to 48 KB and once past it (a block is held to one an SM
// by its registers either way); the answer sets only which rows a cluster
// owns, never a value computed.
template <typename T>
cudaError_t restore_norm_wave(size_t smem, int* wave) {
  static int cached[64][2];                      // [device][smem > 48 KB]
  auto kern = dequant_restore_norm_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int& slot = cached[dev & 63][smem > 48 * 1024];
  if (slot <= 0) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(kCluster);
    cfg.blockDim = dim3(DDN);
    cfg.dynamicSmemBytes = smem;
    err = cudaOccupancyMaxActiveClusters(&slot, kern, &cfg);
    if (err != cudaSuccess) return err;
    if (slot <= 0) return cudaErrorInvalidConfiguration;   // no cluster fits
  }
  *wave = slot;
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_restore_norm(const RestoreArgs& p, const void* norm_w, void* h,
                                float eps, cudaStream_t stream) {
  const size_t smem = restore_norm_smem<T>(p.d_r);
  auto kern = dequant_restore_norm_kernel<T>;
  // one RD-row tile a cluster while the clusters fit one wave of the card,
  // then as many tiles a cluster as keep it to one wave; __cluster_dims__
  // fixes the cluster shape, so a card that cannot place it refuses the
  // launch (and the occupancy query fails first)
  const int tiles = (p.n_rows + RD - 1) / RD;
  int wave = 0;
  const cudaError_t err = restore_norm_wave<T>(smem, &wave);
  if (err != cudaSuccess) return err;
  const int sub = (tiles + wave - 1) / wave;
  const dim3 grid((unsigned)kCluster * ((tiles + sub - 1) / sub));
  kern<<<grid, DDN, smem, stream>>>(p, static_cast<const T*>(norm_w), static_cast<T*>(h),
                                    eps, sub);
  return cudaGetLastError();
}

}  // namespace

// dtype codes shared with kernels/butterfly_kernel.py: 0 = float32, 1 = bfloat16.

// The column count w_reduce must have for butterfly_reduce_quant.
extern "C" int butterfly_reduce_width(int d_r) { return padded_width(d_r); }

// The scratch butterfly_reduce_quant(_bincount) needs at this shape:
// sizes[0] f32 partial sums (0 when the plan does not split k) and
// sizes[1] tickets (uint32, zero before the first launch; the kernel leaves
// them zero again, so a buffer serves every later launch on one stream).
extern "C" int butterfly_reduce_scratch(int n_rows, int d, int d_r, int dtype,
                                        long long* sizes) {
  if (!reduce_args_ok(n_rows, d, d_r, 0, 1, dtype)) return (int)cudaErrorInvalidValue;
  const ReducePlan p = plan_reduce(n_rows, d, d_r, dtype);
  sizes[0] = p.splits > 1 ? (long long)p.tiles * p.splits * p.rq * p.drp : 0;
  sizes[1] = p.splits > 1 ? p.tiles : 0;
  return 0;
}

// w must hold butterfly_reduce_width(d_r) columns (zeros past d_r) and be
// 16-byte aligned; partials and tickets as butterfly_reduce_scratch sizes
// them (may be null where it gives 0).  codes are int8 (code_bytes 1, qmax
// <= 127) or int16 (code_bytes 2, qmax 32767).
extern "C" int butterfly_reduce_quant(const void* x, const void* w, void* codes,
                                      void* scales, void* partials, void* tickets,
                                      int n_rows, int d, int d_r, int qmax,
                                      int code_bytes, int dtype, void* stream) {
  return reduce_entry<false>(x, w, codes, scales, nullptr, partials, tickets, n_rows, d,
                             d_r, qmax, code_bytes, dtype, stream);
}

// As butterfly_reduce_quant, and counts (d_r x 2 * (qmax + 1) int32, zeroed by
// the caller) gains each stored code's symbol code + qmax + 1.
extern "C" int butterfly_reduce_quant_bincount(const void* x, const void* w,
                                               void* codes, void* scales, void* counts,
                                               void* partials, void* tickets,
                                               int n_rows, int d, int d_r, int qmax,
                                               int dtype, void* stream) {
  return reduce_entry<true>(x, w, codes, scales, static_cast<int*>(counts), partials,
                            tickets, n_rows, d, d_r, qmax, 1, dtype, stream);
}

bool restore_args_ok(int n_rows, int d_r, int d, int dtype) {
  return n_rows > 0 && d > 0 && d_r > 0 && d_r <= kMaxDr && (dtype == 0 || dtype == 1);
}

// out has the dtype of w; codes are int8 (code_bytes 1) or int16 (2).
extern "C" int butterfly_dequant_restore(const void* codes, const void* scales,
                                         const void* w, void* out, int n_rows,
                                         int d_r, int d, int dtype, int code_bytes,
                                         void* stream) {
  if (!restore_args_ok(n_rows, d_r, d, dtype) || (code_bytes != 1 && code_bytes != 2))
    return (int)cudaErrorInvalidValue;
  return (int)launch_restore(restore_args(codes, scales, w, out, n_rows, d_r, d), dtype,
                             code_bytes, static_cast<cudaStream_t>(stream));
}

// How butterfly_dequant_restore launches at this shape with int8 codes:
// plan[0] rows a block, plan[1] blocks, plan[2] dynamic shared memory a
// block (bytes); plan[3] butterfly_dequant_restore_norm's dynamic shared
// memory a block.
extern "C" int butterfly_restore_plan(int n_rows, int d_r, int d, int dtype, int* plan) {
  if (!restore_args_ok(n_rows, d_r, d, dtype)) return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    const int kp = (d_r + 15) / 16 * 16;
    const RestorePlan rp = plan_restore(n_rows, d, kp);
    plan[0] = rp.bm;
    plan[1] = rp.groups * rp.slabs;
    plan[2] = (int)restore_mma_smem(rp.bm, kp);
    plan[3] = (int)restore_norm_smem<__nv_bfloat16>(d_r);
  } else {
    plan[0] = RD;
    plan[1] = (n_rows + RD - 1) / RD * ((d + DD - 1) / DD);
    plan[2] = RD * d_r * (int)sizeof(float);
    plan[3] = (int)restore_norm_smem<float>(d_r);
  }
  return 0;
}

// The restore_norm clusters the current card holds at once at this d_r
// (a cluster owns one 16-row tile up to 16 * wave rows, more beyond).
extern "C" int butterfly_restore_norm_wave(int d_r, int dtype, int* wave) {
  if (!restore_args_ok(1, d_r, 1, dtype)) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)restore_norm_wave<float>(restore_norm_smem<float>(d_r), wave);
  return (int)restore_norm_wave<__nv_bfloat16>(restore_norm_smem<__nv_bfloat16>(d_r), wave);
}

// x and h have the dtype of w and norm_w (d values).
extern "C" int butterfly_dequant_restore_norm(const void* codes, const void* scales,
                                              const void* w, const void* norm_w,
                                              void* x, void* h, int n_rows, int d_r,
                                              int d, float eps, int dtype, void* stream) {
  if (!restore_args_ok(n_rows, d_r, d, dtype)) return (int)cudaErrorInvalidValue;
  const RestoreArgs p = restore_args(codes, scales, w, x, n_rows, d_r, d);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_restore_norm<float>(p, norm_w, h, eps, s);
  return (int)launch_restore_norm<__nv_bfloat16>(p, norm_w, h, eps, s);
}
