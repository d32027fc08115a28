// Hopper (sm_90a) RMSNorm kernel.
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes.  Never
// build with --use_fast_math: the inverse root is sqrtf and an IEEE divide.
// It launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
//
// ---------------------------------------------------------------------------
// rmsnorm
//   replaces src/repro/kernels/rmsnorm.py:_rmsnorm_kernel (rmsnorm_kernel,
//   pl.pallas_call at :30).
//   out = x * (1 / sqrt(mean(x^2) + eps)) * (1 + w) in f32, cast back to the
//   dtype of x (f32 or bf16); w has d values of the same dtype.
//
//   Bound on the card: memory.  It must read x (T*d*bytes) and w once and
//   write T*d*bytes; it does about four f32 operations an element.
//
//   Design: one warp a row, four rows a 128-thread block, through
//   row_norm.cuh's warp_row_norm: the routine the fused dequant+restore+norm
//   kernel (csrc/butterfly.cu) runs on its rows, so the two agree bit for bit
//   on the same x.  A lane issues all of its 16-byte loads of the row before
//   the first FMA and keeps them in registers (d = 4096 bf16: 16 loads, 64
//   registers), so the row is read once and a few rows cost one memory
//   round trip, not a chain of them; four rows a block spread a 4-row call
//   over as many warps as rows, and a 4,096-row call over 1,024 blocks.
//   Rows past T are masked; any d goes through (a d that is not a multiple
//   of 16 bytes takes the routine's scalar branch).
// ---------------------------------------------------------------------------
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "row_norm.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* x, const T* __restrict__ w, T* __restrict__ out, int n_rows,
               int d, float eps) {
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  if (row < n_rows)
    row_norm::warp_row_norm(x + (size_t)row * d, w, out + (size_t)row * d, d, eps);
}

template <typename T>
cudaError_t launch_rmsnorm(const void* x, const void* w, void* out, int n_rows, int d,
                           float eps, cudaStream_t stream) {
  const dim3 grid((n_rows + kWarps - 1) / kWarps);
  rmsnorm_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out), n_rows,
      d, eps);
  return cudaGetLastError();
}

}  // namespace

// dtype codes shared with kernels/rmsnorm.py: 0 = float32, 1 = bfloat16.
extern "C" int rmsnorm(const void* x, const void* w, void* out, int n_rows, int d,
                       float eps, int dtype, void* stream) {
  if (n_rows <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_rmsnorm<float>(x, w, out, n_rows, d, eps, s);
  if (dtype == 1) return (int)launch_rmsnorm<__nv_bfloat16>(x, w, out, n_rows, d, eps, s);
  return (int)cudaErrorInvalidValue;
}
