// Small dense linear algebra of the AIS update path: a lower Cholesky factor
// and a forward substitution, each one thread block.
//
// Replaces the Pallas TPU kernels mpopis_tpu/kernels/linalg.py::_chol_kernel
// (launched at linalg.py:76 by _chol_pallas) and ::_fwd_solve_kernel
// (launched at :89 by _fwd_solve_pallas), which the JAX package runs behind
// MPOPIS_PALLAS_LINALG in place of its library Cholesky and triangular solve.
//
// What bounds them on an H100: latency, not the card's peaks. At n = 100 the
// Cholesky is n^3/3 = 0.33 MFLOP and the solve 2 n^2 = 20 kFLOP, microseconds
// of one SM and nanoseconds against the card; the time is the chain of
// dependent steps and the block barriers between them.
//
// Design
// - linalg_chol: the blocked factor of block_linalg.cuh (panels of 32
//   columns: one warp factors the diagonal block in registers, one thread per
//   row solves the panel, 3 x 3 register tiles update the trailing lower
//   triangle; three block barriers per panel, 12 at n = 100 where the old
//   column loop had 300). The lower triangle is staged into shared memory by
//   cp.async with rows an odd number of 16-byte units long (n = 100 floats
//   are 25 units as they are; 136 are padded to 140), so that rows are read
//   16 bytes at a time and a warp's reads down a column meet distinct banks,
//   while the padded rows fit (else unpadded; in all n <= 240 in float,
//   n <= 170 in double), else it is factored in place in the output in
//   global memory (the JAX switch admits n <= 1024). L is written through to
//   the output panel by panel, coalesced, so no copy-out pass follows. 384
//   threads: one round covers the first panel's SYRK tiles up to n = 113 and
//   its rows up to n = 416, and __launch_bounds__(384) leaves 168 registers a
//   thread for the diagonal block's 32-entry row and the panel's 32 values;
//   of 256, 384, 512 and 1024 threads, 384 was the fastest at n = 100 and
//   136 in a phase-timed build (scripts/linalg_phase_times.py).
// - linalg_fwd_solve: y = L^-1 b for b (nrhs, n), nrhs <= 16, one block of
//   32 max(nrhs, 4) threads and one warp per right-hand side. L is read once,
//   in bands of 32 rows in order, each band only the columns 0 .. j0+31 it
//   needs, streamed through two shared-memory stages by cp.async (16 bytes a
//   thread where the rows are 16-byte aligned), so band b+1 loads while band b
//   is solved. A stage holds at most 1 KB of each row (256 float / 128 double
//   columns); a longer band is taken in several chunks, as a double band at
//   n = 1024 (256 KB) would not fit the 227 KB a block may have. Per band the
//   warp of a right-hand side first subtracts L[band, 0:j0] y[0:j0] (lane i
//   row j0+i, the solved prefix of y in shared memory, in the reference's
//   order of columns), then solves the 32 x 32 diagonal block with lane i
//   holding y[j0+i] and the updates moving by shuffles. One block barrier per
//   chunk of a band (one per band up to n = 256 in float), none per column.
//   Stage rows are an odd number of 16-byte units long, so a warp's 16-byte
//   reads down a column take the minimum four wavefronts.
//
// Measured (f32, n = 100, nrhs = 2, chip_smoke.py phase 15; H100 80GB HBM3,
// 700 W): the Cholesky 0.0209-0.0213 ms device-only (30 calls in a CUDA
// graph) against cholesky_ex's 0.0416-0.0417 ms, and 0.025-0.030 ms back to
// back from Python (the column loop before it: 0.118-0.121 ms); its phases
// (scripts/linalg_phase_times.py) are ~2.5 us per diagonal block, ~1 us per
// panel solve and 1.5-3.3 us per trailing update. The forward solve
// 0.0076-0.0078 ms device-only against solve_triangular's 0.0331-0.0332 ms,
// 0.023-0.041 ms back to back (before: 0.039-0.046 ms), where the Python
// call, not the kernel, is the time.
//
// Interface: plain C functions per dtype, loaded with ctypes. Each launches
// on the given stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

#include "block_linalg.cuh"

namespace {

using mpopis::kFullMask;
using mpopis::kPanel;

constexpr int kCholThreads = 384;
constexpr int kMaxRhs = 16;            // one warp per right-hand side
constexpr int kSolveMinWarps = 4;      // warps that issue the copies at small nrhs
constexpr int kStageRowBytes = 1024;   // bytes of a band row one stage holds
constexpr size_t kMaxDynamicSmem = 227 * 1024 - 1024;  // below the 227 KB a block may have

template <typename T>
__device__ void cp_async_elem(T* dst, const T* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src),
               "n"(static_cast<int>(sizeof(T))));
}

__device__ void cp_async_16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

__device__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// ---------------------------------------------------------------------------
// Cholesky
// ---------------------------------------------------------------------------

bool chol_in_smem(int n, size_t elem) {
  return static_cast<size_t>(n) * n * elem <= kMaxDynamicSmem;
}

// An odd number of 16-byte units per row where that fits, else n.
int chol_lda(int n, size_t elem) {
  size_t units = (n * elem + 15) / 16;
  if (units % 2 == 0) ++units;
  const size_t lda = units * 16 / elem;
  return n * lda * elem <= kMaxDynamicSmem ? static_cast<int>(lda) : n;
}

// kSmem: the matrix is staged in shared memory (a compile-time choice, so the
// compiler addresses it as shared memory) and L is written through to `l`;
// else it is factored in place in `l`.
template <typename T, bool kSmem>
__global__ void __launch_bounds__(kCholThreads)
    chol_kernel(const T* __restrict__ a, T* __restrict__ l, int n, int lda, int vec) {
  constexpr int kW = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  T* w = kSmem ? reinterpret_cast<T*>(smem_raw) : l;
  for (int r = warp; r < n; r += nwarps) {  // the lower triangle, row by row
    if (kSmem && vec) {  // 16 bytes a copy, up to the group that holds column r
      for (int c = lane * kW; c <= r; c += 32 * kW) cp_async_16(w + r * lda + c, a + r * n + c);
    } else {
      for (int c = lane; c <= r; c += 32) {
        if (kSmem) {
          cp_async_elem(w + r * lda + c, a + r * n + c);
        } else {
          w[r * lda + c] = a[r * n + c];
        }
      }
    }
  }
  cp_async_commit();
  cp_async_wait_all();
  mpopis::block_cholesky(w, n, lda, kSmem ? l : nullptr);  // its first barrier orders the copy
}

template <typename T>
int chol_launch(const void* a, void* l, int n, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* at = static_cast<const T*>(a);
  T* lt = static_cast<T*>(l);
  if (!chol_in_smem(n, sizeof(T))) {
    chol_kernel<T, false><<<1, kCholThreads, 0, s>>>(at, lt, n, n, 0);
    return static_cast<int>(cudaGetLastError());
  }
  const int lda = chol_lda(n, sizeof(T));
  const int vec = (n * sizeof(T)) % 16 == 0 && (lda * sizeof(T)) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(a) % 16 == 0;
  const size_t smem = static_cast<size_t>(n) * lda * sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        chol_kernel<T, true>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  chol_kernel<T, true><<<1, kCholThreads, smem, s>>>(at, lt, n, lda, vec);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// forward solve
// ---------------------------------------------------------------------------

template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  using type = float4;
};
template <>
struct Vec16<double> {
  using type = double2;
};

// y minus the dot product of l and v, term by term in column order
__device__ inline float sub_dot(float y, float4 l, float4 v) {
  y -= l.x * v.x;
  y -= l.y * v.y;
  y -= l.z * v.z;
  y -= l.w * v.w;
  return y;
}

__device__ inline double sub_dot(double y, double2 l, double2 v) {
  y -= l.x * v.x;
  y -= l.y * v.y;
  return y;
}

__device__ inline void unpack(float4 v, float* out) {
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

__device__ inline void unpack(double2 v, double* out) {
  out[0] = v.x;
  out[1] = v.y;
}

// Shared-memory layout of the solve: two stages of 32 band rows `ld` apart,
// each holding `cols` columns, then y (nrhs rows `ldy` apart).
struct SolveLayout {
  int cols, ld, ldy;
  size_t bytes;
};

template <typename T>
__host__ __device__ SolveLayout solve_layout(int n, int nrhs) {
  constexpr int kW = 16 / sizeof(T);  // values in 16 bytes
  constexpr int kChunk = kStageRowBytes / sizeof(T);
  const int cols = n <= kChunk ? (n + kPanel - 1) / kPanel * kPanel : kChunk;
  int units = cols / kW + 1;  // an odd number of 16-byte units
  if (units % 2 == 0) ++units;
  SolveLayout s;
  s.cols = cols;
  s.ld = units * kW;
  s.ldy = (n + kW - 1) / kW * kW;
  s.bytes = (2 * static_cast<size_t>(kPanel) * s.ld + static_cast<size_t>(nrhs) * s.ldy) *
            sizeof(T);
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kMaxRhs * 32)
    fwd_solve_kernel(const T* __restrict__ l, const T* __restrict__ b, T* __restrict__ y_out,
                     int n, int nrhs, int vec) {
  using V = typename Vec16<T>::type;
  constexpr int kW = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const SolveLayout s = solve_layout<T>(n, nrhs);
  T* const stages = reinterpret_cast<T*>(smem_raw);
  T* const ys = stages + 2 * kPanel * s.ld;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nbands = (n + kPanel - 1) / kPanel;

  // the tile of band `band`, columns [ch cols, ...) of those it needs, into `dst`
  auto issue = [&](int band, int ch, T* dst) {
    const int j0 = band * kPanel;
    const int need = min(j0 + kPanel, n);
    const int c0 = ch * s.cols;
    const int ncol = min(c0 + s.cols, need) - c0;
    const int rows = min(kPanel, n - j0);
    if (vec) {  // ncol is a multiple of kW
      const int nv = ncol / kW;
      for (int idx = threadIdx.x; idx < rows * nv; idx += blockDim.x) {
        const int r = idx / nv;
        const int v = idx - r * nv;
        cp_async_16(dst + r * s.ld + v * kW, l + static_cast<size_t>(j0 + r) * n + c0 + v * kW);
      }
    } else {
      for (int idx = threadIdx.x; idx < rows * ncol; idx += blockDim.x) {
        const int r = idx / ncol;
        const int c = idx - r * ncol;
        cp_async_elem(dst + r * s.ld + c, l + static_cast<size_t>(j0 + r) * n + c0 + c);
      }
    }
    cp_async_commit();
  };

  issue(0, 0, stages);
  for (int idx = threadIdx.x; idx < nrhs * n; idx += blockDim.x) {
    const int r = idx / n;
    ys[r * s.ldy + (idx - r * n)] = b[idx];
  }
  T yi = T(0);  // lane i of warp r: y[r][j0 + i]
  int band = 0, ch = 0, stage = 0;
  while (band < nbands) {
    const int j0 = band * kPanel;
    const int nch = (min(j0 + kPanel, n) + s.cols - 1) / s.cols;
    cp_async_wait_all();
    __syncthreads();  // the tile is in; every warp is done with the other stage
    const int next_band = ch + 1 == nch ? band + 1 : band;
    const int next_ch = ch + 1 == nch ? 0 : ch + 1;
    if (next_band < nbands) issue(next_band, next_ch, stages + (stage ^ 1) * kPanel * s.ld);
    if (warp < nrhs) {
      const int c0 = ch * s.cols;
      const T* lrow = stages + stage * kPanel * s.ld + lane * s.ld;  // row j0 + lane from c0
      const T* yr = ys + warp * s.ldy;
      if (ch == 0) yi = yr[min(j0 + lane, n - 1)];
      const int c1 = min(c0 + s.cols, j0);
      for (int c = c0; c < c1; c += kW) {
        yi = sub_dot(yi, *reinterpret_cast<const V*>(lrow + (c - c0)),
                     *reinterpret_cast<const V*>(yr + c));
      }
      if (ch == nch - 1) {  // the diagonal block, columns j0 .. j0+31
        const T* d = lrow + (j0 - c0);
        T lr[kPanel];
#pragma unroll
        for (int q = 0; q < kPanel / kW; ++q) {
          unpack(*reinterpret_cast<const V*>(d + q * kW), lr + q * kW);
        }
        const T rinv = T(1) / d[lane];
#pragma unroll
        for (int c = 0; c < kPanel; ++c) {
          if (lane == c) yi *= rinv;
          const T yc = __shfl_sync(kFullMask, yi, c);
          if (lane > c) yi -= lr[c] * yc;
        }
        if (j0 + lane < n) {
          ys[warp * s.ldy + j0 + lane] = yi;
          y_out[static_cast<size_t>(warp) * n + j0 + lane] = yi;
        }
        __syncwarp();
      }
    }
    band = next_band;
    ch = next_ch;
    stage ^= 1;
  }
}

template <typename T>
long long solve_smem(int n, int nrhs) {
  if (n < 1 || nrhs < 1 || nrhs > kMaxRhs) return -1;
  const size_t bytes = solve_layout<T>(n, nrhs).bytes;
  return bytes <= kMaxDynamicSmem ? static_cast<long long>(bytes) : -1;
}

template <typename T>
int fwd_solve_launch(const void* l, const void* b, void* y, int n, int nrhs, void* stream) {
  const long long smem = solve_smem<T>(n, nrhs);
  if (smem < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fwd_solve_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int vec = reinterpret_cast<uintptr_t>(l) % 16 == 0 && (n * sizeof(T)) % 16 == 0;
  const int threads = 32 * (nrhs > kSolveMinWarps ? nrhs : kSolveMinWarps);
  fwd_solve_kernel<T><<<1, threads, static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(l), static_cast<const T*>(b), static_cast<T*>(y), n, nrhs, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int linalg_max_solve_rhs() { return kMaxRhs; }

// The row stride the Cholesky kernel factors with: each row padded to an odd
// number of 16-byte units where the padded matrix fits shared memory (100 at
// n = 100 float, 140 at 136, 102 at n = 100 double), else n.
int linalg_chol_lda(int n, int elem_bytes) {
  return chol_in_smem(n, elem_bytes) ? chol_lda(n, elem_bytes) : n;
}

// Shared memory of one forward solve, or -1 where the kernel does not take
// (n, nrhs).
long long linalg_fwd_solve_smem(int n, int nrhs, int elem_bytes) {
  return elem_bytes == 8 ? solve_smem<double>(n, nrhs) : solve_smem<float>(n, nrhs);
}

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
