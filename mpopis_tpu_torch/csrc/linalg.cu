// Small dense linear algebra of the AIS update path: a lower Cholesky factor
// and a forward substitution, each one thread block.
//
// Replaces the Pallas TPU kernels mpopis_tpu/kernels/linalg.py::_chol_kernel
// (launched at linalg.py:76 by _chol_pallas) and ::_fwd_solve_kernel
// (launched at :89 by _fwd_solve_pallas), which the JAX package runs behind
// MPOPIS_PALLAS_LINALG in place of its library Cholesky and triangular solve.
//
// Design
// - linalg_chol: one block of 1024 threads. The matrix is copied into shared
//   memory while it fits (n <= 240 in float, n <= 170 in double), else it is
//   factored in place in the output in global memory (the JAX switch admits
//   n <= 1024). Right-looking outer-product steps (block_linalg.cuh): n
//   sequential columns, each a scaled column and a trailing lower-triangle
//   update spread over the block. A matrix that is not positive definite
//   gives NaNs, not an error, like the TPU kernel.
// - linalg_fwd_solve: y = L^-1 b for b (nrhs, n), one block; y lives in shared
//   memory, L is read from global memory. Per column j the block first takes
//   y[:, j] / L[j, j], then subtracts L[i, j] times it from every later entry:
//   the TPU kernel's right-looking substitution, n sequential steps.
//
// What bounds them on an H100: latency. At n=100 the Cholesky is n^3/3 =
// 0.33 MFLOP and the solve 2 n^2 = 20 kFLOP, microseconds of work for one SM
// and nanoseconds against the card's peaks; each column costs three (two)
// block barriers and a shared-memory round trip, and that chain of n steps is
// the time. No library call and no tensor cores inside.
//
// Interface: plain C functions per dtype, loaded with ctypes. Each launches
// on the given stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include "block_linalg.cuh"

namespace {

constexpr int kCholThreads = 1024;
constexpr int kSolveThreads = 256;
constexpr size_t kMaxDynamicSmem = 227 * 1024 - 1024;  // below the 227 KB a block may have

template <typename T>
__global__ void __launch_bounds__(kCholThreads)
    chol_kernel(const T* __restrict__ a, T* __restrict__ l, int n, int in_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* w = in_smem ? reinterpret_cast<T*>(smem_raw) : l;
  for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x) w[idx] = a[idx];
  __syncthreads();
  mpopis::block_cholesky(w, n);
  if (in_smem) {
    for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x) l[idx] = w[idx];
  }
}

template <typename T>
__global__ void __launch_bounds__(kSolveThreads)
    fwd_solve_kernel(const T* __restrict__ l, const T* __restrict__ b, T* __restrict__ y_out,
                     int n, int nrhs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* y = reinterpret_cast<T*>(smem_raw);  // (nrhs, n)
  T* yj = y + nrhs * n;                   // (nrhs,)
  for (int idx = threadIdx.x; idx < nrhs * n; idx += blockDim.x) y[idx] = b[idx];
  for (int j = 0; j < n; ++j) {
    __syncthreads();
    if (threadIdx.x < nrhs) yj[threadIdx.x] = y[threadIdx.x * n + j] / l[j * n + j];
    __syncthreads();
    const int m = n - j;
    for (int idx = threadIdx.x; idx < nrhs * m; idx += blockDim.x) {
      const int r = idx / m;
      const int i = j + idx % m;
      y[r * n + i] = i == j ? yj[r] : y[r * n + i] - l[i * n + j] * yj[r];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < nrhs * n; idx += blockDim.x) y_out[idx] = y[idx];
}

template <typename T>
int chol_launch(const void* a, void* l, int n, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = static_cast<size_t>(n) * n * sizeof(T);
  const int in_smem = bytes <= kMaxDynamicSmem;
  const size_t smem = in_smem ? bytes : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        chol_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  chol_kernel<T><<<1, kCholThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<T*>(l), n, in_smem);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int fwd_solve_launch(const void* l, const void* b, void* y, int n, int nrhs, void* stream) {
  if (n < 1 || nrhs < 1 || nrhs > kSolveThreads) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(nrhs) * (n + 1) * sizeof(T);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  fwd_solve_kernel<T><<<1, kSolveThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(l), static_cast<const T*>(b), static_cast<T*>(y), n, nrhs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int linalg_max_solve_rhs() { return kSolveThreads; }

int linalg_chol_f32(const void* a, void* l, int n, void* stream) {
  return chol_launch<float>(a, l, n, stream);
}

int linalg_chol_f64(const void* a, void* l, int n, void* stream) {
  return chol_launch<double>(a, l, n, stream);
}

int linalg_fwd_solve_f32(const void* l, const void* b, void* y, int n, int nrhs, void* stream) {
  return fwd_solve_launch<float>(l, b, y, n, nrhs, stream);
}

int linalg_fwd_solve_f64(const void* l, const void* b, void* y, int n, int nrhs, void* stream) {
  return fwd_solve_launch<double>(l, b, y, n, nrhs, stream);
}

}  // extern "C"
