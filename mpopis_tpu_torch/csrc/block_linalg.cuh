// Block-wide small linear algebra shared by csrc/linalg.cu and
// csrc/ais_update.cu: one thread block works on one matrix that lies in
// shared memory or, when it does not fit there, in global memory (the
// functions take a plain pointer and __syncthreads() orders both).
// csrc/spatial_dynamics.cuh factors each sample's mass matrix with one
// warp's chol_diag_block. Every
// function is called by all threads of the block and returns with the block
// synchronised; blockDim.x is a multiple of 32, at most 1024.
//
// Sums are taken in a fixed order for a fixed launch shape (no atomics), so
// a double run repeats bit for bit.
//
// block_cholesky replaces the column loop of the TPU kernels' right-looking
// factor (mpopis_tpu/kernels/linalg.py::_chol_kernel, and the factor inside
// ais_update.py's refit and CMA kernels). On the H100 that loop was bound by
// its chain of n columns, three block barriers each (300 at n = 100, with
// 1024 threads); the arithmetic (n^3/3 = 0.33 MFLOP at n = 100) is
// microseconds of one SM. The blocked form below takes panels of 32 columns,
// one warp's width, so the chain is n / 32 panels of about three barriers:
// - the 32 x 32 diagonal block is factored by one warp in registers, lane i
//   holding row i; pivots and columns move by __shfl_sync, with no barrier;
// - each row below it is solved against L11^T by one thread, the rows of L11
//   read 16 bytes at a time as broadcasts (every thread of a warp reads the
//   same words);
// - the trailing lower triangle loses L21 L21^T as a SYRK of 3 x 3 register
//   tiles, only the tiles on or below the diagonal, L21 read 16 bytes at a
//   time.
// What bounds it now is the chain of those phases: at n = 100 each takes
// 1-3 us of one warp's dependent instructions (the diagonal blocks ~2.5 us,
// their pivot, shuffle and rsqrt chain), not the barriers between them
// (scripts/linalg_phase_times.py; times in csrc/linalg.cu's header). Its
// arithmetic is not rehearsed on the host as the contact kernels' is: the
// diagonal block is lane shuffles, which a host build cannot run.

#pragma once

#include <cuda_runtime.h>

#include <math.h>

namespace mpopis {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kPanel = 32;  // panel width: one warp's lanes

// Sum of one value per thread over the block. `red` is shared memory of at
// least 32 values.
template <typename T>
__device__ T block_sum(T v, T* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFullMask, v, o);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __syncthreads();  // every thread has read red[0] of the previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    v = lane < nw ? red[lane] : T(0);
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFullMask, v, o);
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  return red[0];
}

// Row ti and column tj <= ti of the t-th tile of a lower triangle of tiles
// counted row by row (t = ti (ti + 1) / 2 + tj). Once per tile, not per
// element.
__device__ inline void lower_tile(int t, int& ti, int& tj) {
  int i = static_cast<int>((sqrtf(8.0f * static_cast<float>(t) + 1.0f) - 1.0f) * 0.5f);
  while (i * (i + 1) / 2 > t) --i;
  while ((i + 1) * (i + 2) / 2 <= t) ++i;
  ti = i;
  tj = t - i * (i + 1) / 2;
}

// The 16 bytes at p (16 / sizeof(T) values) into out: one vector load where
// kVec (p 16-byte aligned), else one load per value.
template <typename T, bool kVec>
__device__ inline void load16(const T* p, T* out) {
  if constexpr (kVec && sizeof(T) == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  } else if constexpr (kVec) {
    const double2 v = *reinterpret_cast<const double2*>(p);
    out[0] = v.x;
    out[1] = v.y;
  } else {
#pragma unroll
    for (int e = 0; e < static_cast<int>(16 / sizeof(T)); ++e) out[e] = p[e];
  }
}

template <typename T, bool kVec>
__device__ inline void store16(T* p, const T* v) {
  if constexpr (kVec && sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (kVec) {
    *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
  } else {
#pragma unroll
    for (int e = 0; e < static_cast<int>(16 / sizeof(T)); ++e) p[e] = v[e];
  }
}

// The columns of a diagonal block held one row per lane: column c is the
// pivot column times rsqrt(pivot), then the block's trailing part loses its
// outer product (the reference's order). The chain from one pivot to the
// next runs through column c + 1 alone, so that column is updated first and
// the next pivot's shuffle and rsqrt are issued before the other columns'
// updates, whose issue then hides their latency. kRagged: stop after column
// nb - 1 (a branch per column, which the full block does without).
template <typename T, bool kRagged>
__device__ inline void chol_diag_columns(T (&row)[kPanel], int nb, T& my_inv) {
  const int lane = threadIdx.x & 31;
  T s_next = rsqrt(__shfl_sync(kFullMask, row[0], 0));
#pragma unroll
  for (int c = 0; c < kPanel; ++c) {
    if (kRagged && c >= nb) break;
    const T s = s_next;
    row[c] *= s;
    if (lane == c) my_inv = s;
    if (c + 1 < kPanel) {
      row[c + 1] -= row[c] * __shfl_sync(kFullMask, row[c], c + 1);
      s_next = rsqrt(__shfl_sync(kFullMask, row[c + 1], c + 1));
#pragma unroll
      for (int k = c + 2; k < kPanel; ++k) row[k] -= row[c] * __shfl_sync(kFullMask, row[c], k);
    }
  }
}

// One warp: the lower Cholesky factor of the nb x nb (nb <= 32) diagonal
// block at (j0, j0) of `a`, written in place with zeros above its diagonal,
// and inv[c] = 1 / sqrt(pivot c). Lane i holds row i in registers; lanes at
// or past nb hold rows of the identity.
template <typename T>
__device__ void chol_diag_block(T* a, int lda, int j0, int nb, T* inv) {
  const int lane = threadIdx.x & 31;
  const bool live = lane < nb;
  T* arow = a + (j0 + (live ? lane : 0)) * lda + j0;
  T row[kPanel];
#pragma unroll
  for (int c = 0; c < kPanel; ++c) {
    row[c] = live ? (c <= lane ? arow[c] : T(0)) : T(c == lane ? 1 : 0);
  }
  T my_inv = T(0);
  if (nb == kPanel) {
    chol_diag_columns<T, false>(row, nb, my_inv);
  } else {
    chol_diag_columns<T, true>(row, nb, my_inv);
  }
  if (live) {
#pragma unroll
    for (int c = 0; c < kPanel; ++c) {
      if (c < nb) arow[c] = c <= lane ? row[c] : T(0);
    }
    inv[lane] = my_inv;
  }
}

// One thread: row r of the panel below the diagonal block at (j0, j0),
// L21[r] = A21[r] L11^-T left-looking: x[c] = (a[r][c] - x[0:c] . L11[c][0:c])
// inv[c], the rows of L11 read 16 bytes at a time as broadcasts (every thread
// of a warp reads the same words), two partial sums per dot product.
template <typename T, bool kVec>
__device__ void chol_panel_row(T* a, int lda, int j0, int r, const T* inv) {
  constexpr int kW = 16 / sizeof(T);
  T* ar = a + r * lda + j0;
  const T* l11 = a + j0 * lda + j0;
  T x[kPanel];
#pragma unroll
  for (int g = 0; g < kPanel / kW; ++g) load16<T, kVec>(ar + g * kW, x + g * kW);
#pragma unroll
  for (int c = 0; c < kPanel; ++c) {
    T s0 = x[c];
    T s1 = T(0);
#pragma unroll
    for (int g = 0; g * kW < c; ++g) {
      T lc[kW];
      load16<T, kVec>(l11 + c * lda + g * kW, lc);
#pragma unroll
      for (int e = 0; e < kW; ++e) {
        const int k = g * kW + e;
        if (k < c) {
          if (k & 1) {
            s1 -= x[k] * lc[e];
          } else {
            s0 -= x[k] * lc[e];
          }
        }
      }
    }
    x[c] = (s0 + s1) * inv[c];
  }
#pragma unroll
  for (int g = 0; g < kPanel / kW; ++g) store16<T, kVec>(ar + g * kW, x + g * kW);
}

// The block: the final columns j0 .. j0+31 of rows j0 .. n-1 of `a` into
// `out` (row stride n), a warp per row and a lane per column (coalesced), with
// zeros above the diagonal up to column n - 1 in rows j0 .. j0+31. The last
// warp takes the first row, as the SYRK's tiles fill the first warps.
template <typename T>
__device__ void chol_write_panel(const T* a, int lda, int n, int j0, T* out) {
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int r = j0 + nwarps - 1 - (threadIdx.x >> 5); r < n; r += nwarps) {
    const int c_end = r < j0 + kPanel ? n : j0 + kPanel;
    for (int c = j0 + lane; c < c_end; c += 32) out[r * n + c] = c <= r ? a[r * lda + c] : T(0);
  }
}

// One thread: the E x E tile (ti, tj), tj <= ti, of the trailing lower
// triangle that starts at row and column t0 loses its part of L21 L21^T, L21
// being columns j0..j0+31 of rows t0..n-1, read 16 bytes at a time. Rows past
// n are clamped for the reads and never written; entries above the diagonal
// are neither read nor written.
template <typename T, bool kVec, int E>
__device__ void chol_syrk_tile(T* a, int lda, int n, int j0, int t0, int ti, int tj) {
  constexpr int kW = 16 / sizeof(T);
  const int i0 = t0 + E * ti;
  const int k0 = t0 + E * tj;
  const T* u_row[E];
  const T* v_row[E];
  T acc[E][E];
#pragma unroll
  for (int p = 0; p < E; ++p) {
    u_row[p] = a + (i0 + p < n ? i0 + p : n - 1) * lda + j0;
    v_row[p] = a + (k0 + p < n ? k0 + p : n - 1) * lda + j0;
  }
#pragma unroll
  for (int p = 0; p < E; ++p) {
#pragma unroll
    for (int q = 0; q < E; ++q) {
      const int i = i0 + p;
      const int k = k0 + q;
      acc[p][q] = i < n && k <= i ? a[i * lda + k] : T(0);
    }
  }
#pragma unroll
  for (int g = 0; g < kPanel / kW; ++g) {
    T u[E][kW], v[E][kW];
#pragma unroll
    for (int p = 0; p < E; ++p) {
      load16<T, kVec>(u_row[p] + g * kW, u[p]);
      load16<T, kVec>(v_row[p] + g * kW, v[p]);
    }
#pragma unroll
    for (int e = 0; e < kW; ++e) {
#pragma unroll
      for (int p = 0; p < E; ++p) {
#pragma unroll
        for (int q = 0; q < E; ++q) acc[p][q] -= u[p][e] * v[q][e];
      }
    }
  }
#pragma unroll
  for (int p = 0; p < E; ++p) {
#pragma unroll
    for (int q = 0; q < E; ++q) {
      const int i = i0 + p;
      const int k = k0 + q;
      if (i < n && k <= i) a[i * lda + k] = acc[p][q];
    }
  }
}

// The trailing update of one panel over the block, in 3 x 3 tiles: the
// threads of a warp take neighbouring tiles of a tile row, so their column
// rows lie 3 rows apart, an odd number of odd-length rows, and their 16-byte
// reads meet distinct banks; with an even edge they would share banks (four
// ways at 4 x 4).
template <typename T, bool kVec>
__device__ void chol_syrk(T* a, int lda, int n, int j0, int t0) {
  constexpr int kEdge = 3;
  const int mt = (n - t0 + kEdge - 1) / kEdge;
  for (int t = threadIdx.x; t < mt * (mt + 1) / 2; t += blockDim.x) {
    int ti, tj;
    lower_tile(t, ti, tj);
    chol_syrk_tile<T, kVec, kEdge>(a, lda, n, j0, t0, ti, tj);
  }
}

template <typename T, bool kVec>
__device__ void block_cholesky_panels(T* a, int n, int lda, T* out) {
  __shared__ T inv[kPanel];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int j0 = 0; j0 < n; j0 += kPanel) {
    const int t0 = j0 + kPanel;
    if (warp == 0) chol_diag_block(a, lda, j0, n - j0 < kPanel ? n - j0 : kPanel, inv);
    __syncthreads();  // L11 and inv are visible
    if (t0 >= n) {
      if (out) chol_write_panel(a, lda, n, j0, out);
      break;
    }
    for (int r = t0 + threadIdx.x; r < n; r += blockDim.x) {
      chol_panel_row<T, kVec>(a, lda, j0, r, inv);
    }
    __syncthreads();  // L21 is visible
    if (out) chol_write_panel(a, lda, n, j0, out);
    chol_syrk<T, kVec>(a, lda, n, j0, t0);
    // zeros right of the diagonal block
    for (int r = j0 + nwarps - 1 - warp; r < t0; r += nwarps) {
      for (int c = t0 + lane; c < n; c += 32) a[r * lda + c] = T(0);
    }
    __syncthreads();  // the trailing matrix is updated
  }
  __syncthreads();  // the last panel's writes to `out` are done
}

// In-place lower Cholesky factor of the symmetric n x n matrix `a`, row-major
// with row stride lda >= n (only its lower triangle is read); on return `a`
// holds L with zeros above the diagonal, and so does `out` (row stride n)
// unless it is null: each panel's columns are stored there once they are
// final, in the phase after, so a caller that copies L out needs no pass of
// its own. Blocked by panels of 32 columns (header note): three block
// barriers per panel, one for the last, one on entry and one on exit (12 at
// n = 100). Rows that start 16-byte aligned (lda * sizeof(T) a multiple of
// 16) are read 16 bytes at a time; an odd number of 16-byte units per row
// also spreads a warp's reads down a column over all banks. A matrix that is
// not positive definite gives NaNs from the failing column on and finite
// values before it, as the TPU kernel does: the diagonal block carries a NaN
// pivot into every later column of its rows, the panel into its later
// columns, the SYRK into the whole trailing matrix.
template <typename T>
__device__ void block_cholesky(T* a, int n, int lda, T* out = nullptr) {
  __syncthreads();  // the caller's writes to `a` are complete
  if ((lda * sizeof(T)) % 16 == 0 && reinterpret_cast<size_t>(a) % 16 == 0) {
    block_cholesky_panels<T, true>(a, n, lda, out);
  } else {
    block_cholesky_panels<T, false>(a, n, lda, out);
  }
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
