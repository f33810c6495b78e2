// Block-wide small linear algebra shared by csrc/linalg.cu and
// csrc/ais_update.cu: one thread block works on one matrix that lies in
// shared memory or, when it does not fit there, in global memory (the
// functions take a plain pointer and __syncthreads() orders both). Every
// function is called by all threads of the block and returns with the block
// synchronised.
//
// Sums are taken in a fixed order for a fixed launch shape (no atomics), so
// a double run repeats bit for bit.

#pragma once

#include <cuda_runtime.h>

namespace mpopis {

// Sum of one value per thread over the block. `red` is shared memory of at
// least 32 values. blockDim.x must be a multiple of 32.
template <typename T>
__device__ T block_sum(T v, T* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __syncthreads();  // every thread has read red[0] of the previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    v = lane < nw ? red[lane] : T(0);
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  return red[0];
}

// In-place lower Cholesky factor of the symmetric n x n row-major matrix `a`
// (only its lower triangle is read); on return `a` holds L with zeros above
// the diagonal. The right-looking outer-product form of the TPU kernels
// (mpopis_tpu/kernels/linalg.py::_chol_kernel, ais_update.py::_chol_inplace):
// column j is the pivot column times 1/sqrt(pivot), then the trailing lower
// triangle loses its outer product. A matrix that is not positive definite
// gives NaNs from the failing column on, as the TPU kernel does.
template <typename T>
__device__ void block_cholesky(T* a, int n) {
  for (int j = 0; j < n; ++j) {
    __syncthreads();  // the previous trailing update is complete
    const T inv = T(1) / sqrt(a[j * n + j]);
    __syncthreads();  // every thread has read the pivot before it changes
    for (int i = j + threadIdx.x; i < n; i += blockDim.x) a[i * n + j] *= inv;
    __syncthreads();
    const int m = n - j - 1;
    for (int idx = threadIdx.x; idx < m * m; idx += blockDim.x) {
      const int i = j + 1 + idx / m;
      const int k = j + 1 + idx % m;
      if (k <= i) a[i * n + k] -= a[i * n + j] * a[k * n + j];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x) {
    if (idx % n > idx / n) a[idx] = T(0);
  }
  __syncthreads();
}

// c = a @ b for n x n row-major matrices; c must not alias a or b.
template <typename T>
__device__ void block_matmul(const T* a, const T* b, T* c, int n) {
  for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x) {
    const int i = idx / n;
    const int j = idx % n;
    T acc = T(0);
    for (int k = 0; k < n; ++k) acc += a[i * n + k] * b[k * n + j];
    c[idx] = acc;
  }
  __syncthreads();
}

// sigma + (jitter + 100 eps mean(diag(sigma))) I, in place: the TPU kernels'
// _jitter_mat (mpopis_tpu/kernels/ais_update.py:114).
template <typename T>
__device__ void block_jitter(T* a, int n, double jitter, double eps, T* red) {
  T d = T(0);
  for (int i = threadIdx.x; i < n; i += blockDim.x) d += a[i * n + i];
  const T scale = block_sum(d, red) / T(n);
  const T add = T(jitter) + T(100.0 * eps) * scale;
  for (int i = threadIdx.x; i < n; i += blockDim.x) a[i * n + i] += add;
  __syncthreads();
}

}  // namespace mpopis
