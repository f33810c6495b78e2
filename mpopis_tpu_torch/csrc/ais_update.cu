// Fused AIS distribution updates: the elite / weighted covariance refit with
// shrinkage, jitter and Cholesky, and the CMA-ES tail.
//
// Replaces the Pallas TPU kernels of mpopis_tpu/kernels/ais_update.py, which
// the JAX package runs behind MPOPIS_FUSED_UPDATE=1:
// - _masked_refit_kernel (:192) and _weighted_refit_kernel (:219), both
//   launched at :265 by _refit_call: L = chol(jitter(estimate)) of the masked
//   elite columns of E (CEMPPI, five estimators) or of the probability-
//   weighted columns (muSigma-AIS, and PMC with its K/(K-1) correction). The
//   two share one call site and one finalize step, and here one kernel pair.
// - _cma_kernel (:329), launched at :471 by cma_update_chol: Sigma^-1/2 by 20
//   coupled Newton-Schulz steps, the evolution paths, the guarded step size,
//   h_sigma, the scalar rank-mu term over K, the symmetrization from the upper
//   triangle, jitter and sigma * chol.
//
// Design
// - Refit, launch 1 (refit_moments_kernel): A = Xl Xr^T and, for `lw`/`ss`,
//   B = (Xl o Xl)(Xr o Xr)^T over the K sample columns, with Xl = (E - mu) w
//   and Xr = (E - mu) w for the 0/1 elite mask, Xr = E - mu for the weighted
//   refit. The grid spreads 16 x 16 output tiles over the K splits of 512
//   samples; each block stages 32-sample chunks of its rows and columns in
//   shared memory, and writes its partial sums to its own slot of a scratch
//   buffer. The TPU kernel's 2048-column chunking and zero padding existed for
//   VMEM: here the last chunk is masked instead.
// - Refit, launch 2 (refit_finalize_kernel), one block: sums the partial slots
//   in split order (no atomics, so double repeats bit for bit), applies the
//   estimator in the TPU kernel's standardization-free form (_shrink_finalize,
//   :122), the jitter (_jitter_mat, :114) and the Cholesky (block_linalg.cuh).
//   A and B (2 n^2 + 2 n values) sit in shared memory while they fit (n = 100:
//   81 KB float, 162 KB double), else in global scratch.
// - CMA (cma_cluster_kernel): a cluster of 16 blocks of 416 threads (a
//   card that cannot schedule it fails the launch). Block r owns a band of rows of the
//   Newton-Schulz matrices y, z and t. Each of the 20 steps is two stages,
//   each ended by one cluster barrier: t = 1.5 I - 0.5 z y, then y t and t z
//   together (where the one-block kernel before ran three products behind
//   three barriers). A stage copies the whole right operand from L2 into
//   shared memory (each block writes its band's rows of the whole matrices
//   to global memory as it computes them) and multiplies its band in
//   register tiles of four rows of a column: a 16-byte broadcast load of
//   the left rows and one load of the right column for four multiply-adds,
//   where the one-output-per-thread products made two loads per
//   multiply-add. Each output's sum runs over q in ascending order, as
//   before. Block 0 then runs the tail and the Cholesky alone, at 416
//   threads (128 registers a thread where the one-block kernel had 64). n
//   that no cluster holds in shared memory (two ld x ld staging matrices and
//   five bands: n > 152 in float, n > 108 in double) run on one block of
//   1024 threads from global scratch (cma_block_kernel), one output entry
//   per thread and step. Full precision, no tensor cores.
//
// What bounds them on an H100: at the headline (n = 100, K = 8192) the
// refit's moments are 2 n^2 K = 164 MFLOP each (A, and B for lw/ss), ~2.4 us
// at the 67 TFLOP/s float peak, against 3.3 MB of E read (~1 us at 3.35 TB/s);
// the one-block finalize is a latency-bound chain on one SM, far from either
// peak. The CMA tail's 60 products (2 MFLOP each, 120 MFLOP) are ~1.8 us of
// the card's float peak but ~270 us of one SM's; on 16 SMs each of its 40
// dependent stages costs the copy of a whole operand (~1 us), a band
// product of ~25 dependent steps of loads and multiply-adds and a cluster
// barrier, ~4.5 us a stage in all at n = 100 (scripts/cma_phase_times.py).
// Their Cholesky is
// block_linalg.cuh's blocked factor (panels of
// 32 columns, three barriers each, where the column loop before it had three
// per column), which the finalize writes straight to L: the masked `ss`
// refit fell from 0.184-0.189 to 0.098 ms device-only (0.101-0.109 back to
// back), the weighted refit from 0.172-0.176 to 0.084 (0.087-0.090), the CMA
// tail from 2.520-2.526 to 2.371 (2.378-2.389) ms (f32, chip_smoke.py phase
// 15, the parent's kernels timed back to back in the same call; H100 80GB
// HBM3, 700 W). At 1024 threads a thread has 64 registers, and the factor's
// diagonal blocks spill: they take ~4.8 us there against ~2.5 us at 384
// threads (scripts/linalg_phase_times.py).
//
// Interface: plain C functions per dtype, loaded with ctypes. Each launches on
// the given stream, does not synchronise, and returns cudaGetLastError(); the
// caller allocates the scratch that *_scratch_elems asks for.

#include <cuda_runtime.h>

#include <algorithm>
#include <cfloat>
#include <cmath>

#include <cooperative_groups.h>

#include "block_linalg.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 16;       // output tile edge of the moments kernel
constexpr int kChunk = 32;      // samples staged in shared memory at a time
constexpr int kSplit = 512;     // samples per K split
constexpr int kThreads = 1024;  // one-block kernels
constexpr size_t kMaxDynamicSmem = 227 * 1024 - 1024;

enum Method { kMle = 0, kLw = 1, kSs = 2, kRblw = 3, kOas = 4, kWeighted = 5 };

int num_splits(int k) { return (k + kSplit - 1) / kSplit; }

__host__ __device__ constexpr double eps_of(float) { return FLT_EPSILON; }
__host__ __device__ constexpr double eps_of(double) { return DBL_EPSILON; }
__host__ __device__ constexpr double tiny_of(float) { return FLT_MIN; }
__host__ __device__ constexpr double tiny_of(double) { return DBL_MIN; }

// max and clip that keep a NaN, as jnp.maximum and jnp.clip do
template <typename T>
__device__ T max_nan(T a, T b) {
  return (a != a || a > b) ? a : b;
}

template <typename T>
__device__ T clip_nan(T x, T lo, T hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// ---------------------------------------------------------------------------
// refit
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kTile * kTile)
    refit_moments_kernel(const T* __restrict__ e, const T* __restrict__ w,
                         const T* __restrict__ mu, int n, int k, int masked, int need_b,
                         T* __restrict__ part) {
  __shared__ T xl[kTile][kChunk + 1];
  __shared__ T xr[kTile][kChunk + 1];
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  const int split = blockIdx.z;
  const int k_begin = split * kSplit;
  const int k_end = min(k, k_begin + kSplit);
  const int tx = threadIdx.x % kTile;
  const int ty = threadIdx.x / kTile;
  T acc_a = T(0);
  T acc_b = T(0);
  for (int k0 = k_begin; k0 < k_end; k0 += kChunk) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < kTile * kChunk; idx += blockDim.x) {
      const int r = idx / kChunk;
      const int c = idx % kChunk;
      const int kk = k0 + c;
      T vl = T(0);
      T vr = T(0);
      if (kk < k_end) {
        const T wk = w[kk];
        if (i0 + r < n) vl = (e[static_cast<size_t>(i0 + r) * k + kk] - mu[i0 + r]) * wk;
        if (j0 + r < n) {
          vr = e[static_cast<size_t>(j0 + r) * k + kk] - mu[j0 + r];
          if (masked) vr *= wk;
        }
      }
      xl[r][c] = vl;
      xr[r][c] = vr;
    }
    __syncthreads();
    for (int c = 0; c < kChunk; ++c) {
      const T a = xl[ty][c];
      const T b = xr[tx][c];
      acc_a += a * b;
      if (need_b) acc_b += (a * a) * (b * b);
    }
  }
  const int i = i0 + ty;
  const int j = j0 + tx;
  if (i < n && j < n) {
    const size_t nn = static_cast<size_t>(n) * n;
    part[(2 * split) * nn + i * n + j] = acc_a;
    if (need_b) part[(2 * split + 1) * nn + i * n + j] = acc_b;
  }
}

// sigma (in a) from the moment sums a, b over m samples: _shrink_finalize.
template <typename T>
__device__ void shrink_finalize(T* a, const T* b, T* vec, int n, double m, int method, T* red) {
  const int nn = n * n;
  const T tiny = T(tiny_of(T()));
  if (method == kMle) {
    for (int idx = threadIdx.x; idx < nn; idx += blockDim.x) a[idx] = a[idx] / T(m);
    __syncthreads();
    return;
  }
  if (method == kLw) {
    T num = T(0), num_d = T(0), den = T(0), den_d = T(0);
    for (int idx = threadIdx.x; idx < nn; idx += blockDim.x) {
      const T s = a[idx] / T(m);
      const T var_s = (b[idx] / T(m) - s * s) / T(m);
      num += var_s;
      den += s * s;
      if (idx / n == idx % n) {
        num_d += var_s;
        den_d += s * s;
      }
    }
    const T numv = mpopis::block_sum(num, red) - mpopis::block_sum(num_d, red);
    const T denv = mpopis::block_sum(den, red) - mpopis::block_sum(den_d, red);
    const T lam = clip_nan(numv / max_nan(denv, tiny), T(0), T(1));
    for (int idx = threadIdx.x; idx < nn; idx += blockDim.x) {
      const T s = a[idx] / T(m);
      a[idx] = (T(1) - lam) * s + lam * (idx / n == idx % n ? s : T(0));
    }
    __syncthreads();
    return;
  }
  if (method == kSs) {
    T* inv_sd = vec;      // (n,) 1 / sd, unbiased variances
    T* sd_mle = vec + n;  // (n,) MLE standard deviations
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const T d = a[i * n + i];
      inv_sd[i] = T(1) / sqrt(max_nan(d / T(m - 1.0), tiny));
      sd_mle[i] = sqrt(max_nan(d / T(m), tiny));
    }
    __syncthreads();
    const T c_r = T(m / (m - 1.0));
    const T c_var = T(m / ((m - 1.0) * (m - 1.0) * (m - 1.0)));
    T num = T(0), num_d = T(0), den = T(0), den_d = T(0);
    for (int idx = threadIdx.x; idx < nn; idx += blockDim.x) {
      const int i = idx / n;
      const int j = idx % n;
      const T wbar = a[idx] / T(m) * inv_sd[i] * inv_sd[j];
      const T r = c_r * wbar;
      const T sum_w2 = b[idx] * (inv_sd[i] * inv_sd[i]) * (inv_sd[j] * inv_sd[j]);
      const T var_r = c_var * (sum_w2 - T(m) * wbar * wbar);
      num += var_r;
      den += r * r;
      if (i == j) {
        num_d += var_r;
        den_d += r * r;
      }
    }
    const T numv = mpopis::block_sum(num, red) - mpopis::block_sum(num_d, red);
    const T denv = mpopis::block_sum(den, red) - mpopis::block_sum(den_d, red);
    const T lam = clip_nan(numv / max_nan(denv, tiny), T(0), T(1));
    for (int idx = threadIdx.x; idx < nn; idx += blockDim.x) {
      const int i = idx / n;
      const int j = idx % n;
      const T r = c_r * (a[idx] / T(m) * inv_sd[i] * inv_sd[j]);
      const T r_shrunk = i == j ? T(1) : (T(1) - lam) * r;
      a[idx] = r_shrunk * sd_mle[i] * sd_mle[j];
    }
    __syncthreads();
    return;
  }
  // rblw / oas: target tr(S)/p I
  T tr = T(0), tr2 = T(0);
  for (int idx = threadIdx.x; idx < nn; idx += blockDim.x) {
    const T s = a[idx] / T(m);
    tr2 += s * s;
    if (idx / n == idx % n) tr += s;
  }
  const T tr_s = mpopis::block_sum(tr, red);
  const T tr_s2 = mpopis::block_sum(tr2, red);
  const double p = n;
  T num, den;
  if (method == kRblw) {
    num = T((m - 2.0) / m) * tr_s2 + tr_s * tr_s;
    den = T(m + 2.0) * (tr_s2 - tr_s * tr_s / T(p));
  } else {
    num = T(1.0 - 2.0 / p) * tr_s2 + tr_s * tr_s;
    den = T(m + 1.0 - 2.0 / p) * (tr_s2 - tr_s * tr_s / T(p));
  }
  const T rho = clip_nan(num / max_nan(den, tiny), T(0), T(1));
  const T target = tr_s / T(p);
  for (int idx = threadIdx.x; idx < nn; idx += blockDim.x) {
    const T s = a[idx] / T(m);
    a[idx] = (T(1) - rho) * s + rho * (idx / n == idx % n ? target : T(0));
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    refit_finalize_kernel(const T* __restrict__ part, int splits, int n, double m, int method,
                          double jitter, int corrected, int in_smem, T* __restrict__ work,
                          T* __restrict__ l_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T red[32];
  const int nn = n * n;
  T* a = in_smem ? reinterpret_cast<T*>(smem_raw) : work;
  T* b = a + nn;
  T* vec = b + nn;
  const int need_b = method == kLw || method == kSs;
  for (int idx = threadIdx.x; idx < nn; idx += blockDim.x) {
    T sa = T(0), sb = T(0);
    for (int s = 0; s < splits; ++s) {
      sa += part[(2 * static_cast<size_t>(s)) * nn + idx];
      if (need_b) sb += part[(2 * static_cast<size_t>(s) + 1) * nn + idx];
    }
    a[idx] = sa;
    b[idx] = sb;
  }
  __syncthreads();
  if (method == kWeighted) {
    if (corrected) {
      const T c = T(m / (m - 1.0));
      for (int idx = threadIdx.x; idx < nn; idx += blockDim.x) a[idx] *= c;
    }
    __syncthreads();
  } else {
    shrink_finalize(a, b, vec, n, m, method, red);
  }
  mpopis::block_jitter(a, n, jitter, eps_of(T()), red);
  mpopis::block_cholesky(a, n, n, l_out);
}

size_t refit_work_elems(int n) { return 2 * static_cast<size_t>(n) * n + 2 * n; }

size_t refit_part_elems(int n, int k) {
  return 2 * static_cast<size_t>(num_splits(k)) * n * n;
}

template <typename T>
int refit_launch(const void* e, const void* w, const void* mu, int n, int k, int method,
                 double m, double jitter, int corrected, void* scratch, void* l, void* stream) {
  if (n < 1 || k < 1 || method < kMle || method > kWeighted)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  T* part = static_cast<T*>(scratch);
  T* work = part + refit_part_elems(n, k);
  const int splits = num_splits(k);
  const int tiles = (n + kTile - 1) / kTile;
  const int need_b = method == kLw || method == kSs;
  refit_moments_kernel<T><<<dim3(tiles, tiles, splits), kTile * kTile, 0, s>>>(
      static_cast<const T*>(e), static_cast<const T*>(w), static_cast<const T*>(mu), n, k,
      method != kWeighted, need_b, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t bytes = refit_work_elems(n) * sizeof(T);
  const int in_smem = bytes <= kMaxDynamicSmem;
  const size_t smem = in_smem ? bytes : 0;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(refit_finalize_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  refit_finalize_kernel<T><<<1, kThreads, smem, s>>>(part, splits, n, m, method, jitter,
                                                      corrected, in_smem, work,
                                                      static_cast<T*>(l));
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// CMA tail
// ---------------------------------------------------------------------------

// Phase stamps of the CMA tail (scripts/cma_phase_times.py): the script
// builds a copy with CMA_STAMP and CMA_STAMP_START defined, which charge the
// time since the previous stamp to a phase; otherwise a stamp is nothing.
enum CmaPhase { kCmaSetup, kCmaPull, kCmaStageT, kCmaStageYZ, kCmaScale, kCmaTail, kCmaSigma,
                kCmaFactor, kCmaWrite, kCmaPhases };
#ifndef CMA_STAMP
#define CMA_STAMP(phase) ((void)0)
#define CMA_STAMP_START() ((void)0)
#endif

struct CmaConsts {
  double c1, c_Sigma, c_mu, c_sigma, d_sigma, e_norm, mu_eff;
};

// The CMA tail after Newton-Schulz, on one block: the evolution paths, the
// guarded step size, h_sigma, the scalar rank-mu term over K, Sigma_new from
// the upper triangle, jitter and sigma * chol. `cdw` holds C dw and norm_c2
// ||C||^2; `w` is n x n scratch (row stride n).
template <typename T>
__device__ void cma_tail(const T* __restrict__ sigma_in, const T* __restrict__ dw,
                         const T* __restrict__ ps_in, const T* __restrict__ pS_in,
                         const T* __restrict__ svals, const T* __restrict__ ws, T sigma_s,
                         int n, int k, const CmaConsts& c, double it, double jitter, int guards,
                         int update_chol, const T* cdw, T norm_c2, T* p_sig, T* p_Sig, T* w,
                         T* red, T* __restrict__ chol_out, T* __restrict__ sigma_out,
                         T* __restrict__ ps_out, T* __restrict__ pS_out, T* __restrict__ sig_out) {
  const int nn = n * n;
  const T it_f = T(it);
  // evolution path p_sigma and the step size
  const T k_ps = T(sqrt(c.c_sigma * (2.0 - c.c_sigma) * c.mu_eff));
  T ps2 = T(0);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const T p = T(1.0 - c.c_sigma) * ps_in[i] + k_ps * cdw[i];
    p_sig[i] = p;
    ps2 += p * p;
  }
  const T norm_ps = sqrt(mpopis::block_sum(ps2, red));
  T step_exp = T(c.c_sigma / c.d_sigma) * (norm_ps / T(c.e_norm) - T(1));
  if (guards) step_exp = clip_nan(step_exp, T(-20), T(20));
  T sigma_new = sigma_s * exp(step_exp);
  if (guards) sigma_new = clip_nan(sigma_new, T(1e-10), T(1e10));

  // h_sigma with (1 - c_sigma)^(2 it) as exp(2 it log(1 - c_sigma)), and p_Sigma
  const T decay = exp(T(2) * it_f * T(log(1.0 - c.c_sigma)));
  const T denom = sqrt(T(1) - decay);
  const T h_sigma = norm_ps / denom < T((1.4 + 2.0 / (n + 1.0)) * c.e_norm) ? T(1) : T(0);
  const T k_pS = T(sqrt(c.c_Sigma * (2.0 - c.c_Sigma) * c.mu_eff));
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    p_Sig[i] = T(1.0 - c.c_Sigma) * pS_in[i] + h_sigma * k_pS * dw[i];

  // the scalar rank-mu term (the reference's quirk form) over the K samples
  T rm = T(0);
  for (int q = threadIdx.x; q < k; q += blockDim.x) {
    const T sv = svals[q];
    const T wq = ws[q];
    const T w0 = wq >= T(0) ? wq : it_f * wq / max_nan(norm_c2 * sv * sv, T(1e-30));
    rm += w0 * sv * sv;
  }
  const T rank_mu = mpopis::block_sum(rm, red);  // also orders p_Sig
  CMA_STAMP(kCmaTail);

  // Sigma_new from the upper triangle, symmetrized
  const T k_old = T(1.0 - c.c1 - c.c_mu);
  const T k_h = (T(1) - h_sigma) * T(c.c_Sigma) * T(2.0 - c.c_Sigma);
  for (int idx = threadIdx.x; idx < nn; idx += blockDim.x) {
    const int i = idx / n;
    const int j = idx % n;
    const int u = i <= j ? idx : j * n + i;  // the upper-triangle entry
    const int ui = i <= j ? i : j;
    const int uj = i <= j ? j : i;
    const T sg = sigma_in[u];
    const T v = k_old * sg + T(c.c1) * (p_Sig[ui] * p_Sig[uj] + k_h * sg) + T(c.c_mu) * rank_mu;
    sigma_out[idx] = v;
    w[idx] = v;
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    ps_out[i] = p_sig[i];
    pS_out[i] = p_Sig[i];
  }
  if (threadIdx.x == 0) *sig_out = sigma_new;
  __syncthreads();
  CMA_STAMP(kCmaSigma);
  if (update_chol) {
    mpopis::block_jitter(w, n, jitter, eps_of(T()), red);
    mpopis::block_cholesky(w, n, n);
  }
  CMA_STAMP(kCmaFactor);
  for (int idx = threadIdx.x; idx < nn; idx += blockDim.x)
    chol_out[idx] = update_chol ? sigma_new * w[idx] : T(0);
  CMA_STAMP(kCmaWrite);
}

// ---- the cluster kernel ----------------------------------------------------

constexpr int kCmaThreads = 416;  // a block of the cluster kernel: 13 warps
constexpr int kCmaCluster = 16;   // blocks of the cluster (non-portable size)

// The register tile of the band products: kTileRows rows of one column of
// the band a thread, the q loop unrolled kTileUnroll times.
constexpr int kTileRows = 4;
constexpr int kTileUnroll = 4;

// Row stride of the cluster kernel's matrices: n rounded up to 4 values, so
// that a row holds whole 4-wide groups and starts 16-byte aligned.
int cma_ld(int n) { return (n + 3) / 4 * 4; }

// Rows of each block's band (rounded up to 4 in its buffers), and the
// kernel's shared memory (elements): two ld x ld staging matrices, the bands
// of y (two), z (two) and t, then C dw, p_sigma, p_Sigma and the blocks'
// parts of ||C||^2.
int cma_band_rows(int n) { return (n + kCmaCluster - 1) / kCmaCluster; }
size_t cma_cluster_elems(int n) {
  const size_t ld = cma_ld(n);
  const size_t rbp = (cma_band_rows(n) + kTileRows - 1) / kTileRows * kTileRows;
  return 2 * ld * ld + 5 * rbp * ld + 3 * static_cast<size_t>(n) + kCmaCluster;
}

// out[r * ld] (r < rows) = sum over q of a[r * ld + q] b[q * ld]: kTileRows
// band rows of one output column, q in ascending order for each output (the
// one-output-per-thread products' order; the padding past n adds zeros at
// the end), a's rows read 16 bytes at a time (broadcasts: the threads of a
// warp share the rows), b's column a value a row (the warp's threads on
// consecutive columns). kT: t = 1.5 I - 0.5 (a . b), the entry r on the
// diagonal where diag + r == 0. The rows also go to gout, this block's rows
// of the whole matrix.
template <typename T, bool kT>
__device__ __forceinline__ void col_tile(const T* __restrict__ a, const T* __restrict__ b,
                                         T* out, T* __restrict__ gout, int ld, int rows,
                                         int diag) {
  T acc[kTileRows];
#pragma unroll
  for (int r = 0; r < kTileRows; ++r) acc[r] = T(0);
#pragma unroll kTileUnroll
  for (int q = 0; q < ld; q += 4) {
    T av[kTileRows][4];
#pragma unroll
    for (int r = 0; r < kTileRows; ++r) {
      mpopis::load16<T, true>(a + r * ld + q, av[r]);
      if constexpr (sizeof(T) == 8) mpopis::load16<T, true>(a + r * ld + q + 2, av[r] + 2);
    }
    T bv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) bv[e] = b[(q + e) * ld];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int r = 0; r < kTileRows; ++r) acc[r] += av[r][e] * bv[e];
    }
  }
#pragma unroll
  for (int r = 0; r < kTileRows; ++r) {
    if (kT) acc[r] = (diag + r == 0 ? T(1.5) : T(0)) - T(0.5) * acc[r];
    if (r < rows) {
      out[r * ld] = acc[r];
      gout[r * ld] = acc[r];
    }
  }
}

// The band product out = a . b for this block's rows: a band (rbp rows), b a
// staged ld x ld matrix, one thread a tile of kTileRows rows of a column; the rows go to the band `out` and to this block's rows of the
// whole matrix g.
template <typename T, bool kT>
__device__ __forceinline__ void band_item(int item, const T* a, const T* b, T* out, T* g,
                                          int ld, int rows, int row0) {
  const int grp = item / ld;
  const int j = item - grp * ld;
  const int r0 = kTileRows * grp;
  col_tile<T, kT>(a + r0 * ld, b + j, out + r0 * ld + j, g + (row0 + r0) * ld + j, ld,
                  rows - r0, row0 + r0 - j);
}

// dst (ld x ld, its rows past n zero) = the first n rows of the matrix g in
// global memory, which the cluster's blocks wrote band by band: read from
// L2 (ld.global.cg: never a stale L1 line), 16 bytes a load and
// kStageBatch loads in flight a thread.
constexpr int kStageBatch = 8;

template <typename T>
__device__ void stage_full(T* dst, const T* g, int n, int ld) {
  const int total = n * ld * static_cast<int>(sizeof(T)) / 16;
  const float4* src = reinterpret_cast<const float4*>(g);
  float4* to = reinterpret_cast<float4*>(dst);
  for (int base = threadIdx.x; base < total; base += kStageBatch * blockDim.x) {
    float4 v[kStageBatch];
#pragma unroll
    for (int b = 0; b < kStageBatch; ++b) {
      const int idx = base + b * blockDim.x;
      if (idx < total) v[b] = __ldcg(src + idx);
    }
#pragma unroll
    for (int b = 0; b < kStageBatch; ++b) {
      const int idx = base + b * blockDim.x;
      if (idx < total) to[idx] = v[b];
    }
  }
}

// The two halves of a cluster barrier: arrive (release) and wait (acquire).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// One launch of a cluster of csize blocks. Newton-Schulz on bands of rb rows:
// block r owns rows r rb .. r rb + rb - 1 of y, z and t, in its shared
// memory (the left operands) and in the whole matrices in global memory. A
// stage copies the whole right operand from L2 into shared memory and
// computes its band, a thread four rows of a column; a cluster barrier ends
// it: t = 1.5 I - 0.5 z y, then y t and t z together (two stages and two
// barriers a step, where the one-block kernel had three products behind
// three barriers). z, which the second stage needs whole, is copied while
// the first stage's barrier completes. Then each block forms its rows of C
// dw and its part of ||C||^2 in block 0's shared memory (distributed shared
// memory), and block 0 runs the tail and the factor (cma_tail) alone.
// The bands travel through L2 and not through distributed shared memory:
// a block copying a 100 x 100 float matrix from its 15 peers' shared memory
// took 2.5 us a copy, from L2 1.1 us (scripts/cma_phase_times.py, the stamps
// after each copy).
template <typename T>
__global__ void __launch_bounds__(kCmaThreads)
    cma_cluster_kernel(const T* __restrict__ sigma_in, const T* __restrict__ dw,
                       const T* __restrict__ ps_in, const T* __restrict__ pS_in,
                       const T* __restrict__ svals, const T* __restrict__ ws,
                       const T* __restrict__ sigma_s_in, int n, int k, CmaConsts c, double it,
                       double jitter, int guards, int ns_its, int update_chol, int rb, int ld,
                       T* __restrict__ work, T* __restrict__ chol_out, T* __restrict__ sigma_out,
                       T* __restrict__ ps_out, T* __restrict__ pS_out, T* __restrict__ sig_out) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int csize = static_cast<int>(cluster.num_blocks());
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T red[32];
  const int rbp = (rb + kTileRows - 1) / kTileRows * kTileRows;
  const int band = rbp * ld;
  T* s0 = reinterpret_cast<T*>(smem_raw);
  T* s1 = s0 + ld * ld;
  // the bands: y (two), z (two), t; y of step parity p at yb + p band, z
  // at zb + p band (pointers into shared memory, not an array of them, so
  // that the loads stay shared-memory loads)
  T* yb = s1 + ld * ld;
  T* zb = yb + 2 * band;
  T* tb = zb + 2 * band;
  T* cdw = tb + band;
  T* p_sig = cdw + n;
  T* p_Sig = p_sig + n;
  T* c2_part = p_Sig + n;
  // the whole matrices in global memory, each block writing its rows: y and
  // z twice (a block may still read one while the others write the next)
  const size_t full = static_cast<size_t>(n) * ld;
  T* gy = work;  // y of parity p at gy + p full
  T* gz = work + 2 * full;
  T* gt = work + 4 * full;
  const int row0 = rank * rb;
  const int rows = max(0, min(rb, n - row0));
  const int items = rbp / kTileRows * ld;  // a product's register tiles
  CMA_STAMP_START();

  // y = Sigma / s, z = I on this block's rows; zeros past n, and in the
  // staging matrices' rows past n (they meet the bands' zero columns)
  T d = T(0);
  for (int i = threadIdx.x; i < n; i += blockDim.x) d += sigma_in[i * n + i];
  const T s_tr = mpopis::block_sum(d, red);
  for (int idx = threadIdx.x; idx < 5 * band; idx += blockDim.x) {
    const int i = (idx % band) / ld;
    const int j = idx % ld;
    const bool live = i < rows && j < n;
    T v = T(0);
    if (idx < band) v = live ? sigma_in[(row0 + i) * n + j] / s_tr : T(0);
    if (idx >= 2 * band && idx < 3 * band) v = live && row0 + i == j ? T(1) : T(0);
    yb[idx] = v;
    if (i < rows && idx < band) gy[(row0 + i) * ld + j] = v;
    if (i < rows && idx >= 2 * band && idx < 3 * band) gz[(row0 + i) * ld + j] = v;
  }
  for (int idx = n * ld + threadIdx.x; idx < ld * ld; idx += blockDim.x) {
    s0[idx] = T(0);
    s1[idx] = T(0);
  }
  cluster.sync();  // every block's rows are written, and every block runs
  CMA_STAMP(kCmaSetup);
  int cur = 0;
  for (int step = 0; step < ns_its; ++step) {
    const int nxt = cur ^ 1;
    // t = 1.5 I - 0.5 z y on this block's rows
    stage_full(s0, gy + cur * full, n, ld);
    __syncthreads();
    CMA_STAMP(kCmaPull);
    for (int it_ = threadIdx.x; it_ < items; it_ += blockDim.x)
      band_item<T, true>(it_, zb + cur * band, s0, tb, gt, ld, rows, row0);
    cluster_arrive();  // this block's rows of t are written
    stage_full(s1, gz + cur * full, n, ld);  // z is final since the last barrier
    cluster_wait();  // t is complete
    CMA_STAMP(kCmaStageT);
    // y <- y t and z <- t z on this block's rows
    stage_full(s0, gt, n, ld);
    __syncthreads();
    CMA_STAMP(kCmaPull);
    for (int it_ = threadIdx.x; it_ < 2 * items; it_ += blockDim.x) {
      if (it_ < items) {
        band_item<T, false>(it_, yb + cur * band, s0, yb + nxt * band, gy + nxt * full, ld,
                            rows, row0);
      } else {
        band_item<T, false>(it_ - items, tb, s1, zb + nxt * band, gz + nxt * full, ld, rows,
                            row0);
      }
    }
    cluster.sync();  // y and z are complete
    CMA_STAMP(kCmaStageYZ);
    cur = nxt;
  }

  // C = z / sqrt(s): this block's rows of C dw and its part of ||C||^2, into block 0
  const T sqrt_s = sqrt(s_tr);
  T* zc = zb + cur * band;
  T c2 = T(0);
  for (int idx = threadIdx.x; idx < rows * n; idx += blockDim.x) {
    const int at = (idx / n) * ld + idx % n;
    const T cij = zc[at] / sqrt_s;
    zc[at] = cij;
    c2 += cij * cij;
  }
  c2 = mpopis::block_sum(c2, red);  // also orders the writes to zc
  T* cdw0 = cluster.map_shared_rank(cdw, 0);
  for (int i = threadIdx.x; i < rows; i += blockDim.x) {
    T c_dw = T(0);
    for (int j = 0; j < n; ++j) c_dw += zc[i * ld + j] * dw[j];
    cdw0[row0 + i] = c_dw;
  }
  if (threadIdx.x == 0) cluster.map_shared_rank(c2_part, 0)[rank] = c2;
  cluster.sync();  // block 0 holds C dw and the parts; no block reads another's memory after
  if (rank != 0) return;
  T norm_c2 = T(0);
  for (int r = 0; r < csize; ++r) norm_c2 += c2_part[r];
  CMA_STAMP(kCmaScale);
  cma_tail(sigma_in, dw, ps_in, pS_in, svals, ws, *sigma_s_in, n, k, c, it, jitter, guards,
           update_chol, cdw, norm_c2, p_sig, p_Sig, s0, red, chol_out, sigma_out, ps_out, pS_out,
           sig_out);
}

// The cluster size for n in T: kCmaCluster where the cluster's shared
// memory holds n, else 0 (the one-block kernel then runs from global
// memory). Decided from the size alone.
template <typename T>
int cma_cluster_size(int n) {
  return cma_cluster_elems(n) * sizeof(T) <= kMaxDynamicSmem ? kCmaCluster : 0;
}

// Lets the cluster kernel take all the shared memory a block can have and a
// cluster of 16 blocks; set once a process.
template <typename T>
cudaError_t cma_cluster_attributes() {
  static bool set = false;
  if (set) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      cma_cluster_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kMaxDynamicSmem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(cma_cluster_kernel<T>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) cudaGetLastError();  // returned here, not left for the next launch
  set = err == cudaSuccess;
  return err;
}

// ---- the one-block kernel, for n that no cluster holds ----------------------

// One block of kThreads runs everything: the four n x n Newton-Schulz
// matrices in global scratch, one output entry per thread and step.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    cma_block_kernel(const T* __restrict__ sigma_in, const T* __restrict__ dw,
                     const T* __restrict__ ps_in, const T* __restrict__ pS_in,
                     const T* __restrict__ svals, const T* __restrict__ ws,
                     const T* __restrict__ sigma_s_in, int n, int k, CmaConsts c, double it,
                     double jitter, int guards, int ns_its, int update_chol,
                     T* __restrict__ work, T* __restrict__ chol_out, T* __restrict__ sigma_out,
                     T* __restrict__ ps_out, T* __restrict__ pS_out, T* __restrict__ sig_out) {
  __shared__ T red[32];
  const int nn = n * n;
  T* y = work;
  T* z = y + nn;
  T* t = z + nn;
  T* w = t + nn;
  T* p_sig = w + nn;  // (n,)
  T* p_Sig = p_sig + n;  // (n,)
  T* cdw = p_Sig + n;    // (n,)
  CMA_STAMP_START();

  // C = Sigma^-1/2 by coupled Newton-Schulz: Y -> (Sigma/s)^1/2, Z -> (Sigma/s)^-1/2
  T d = T(0);
  for (int i = threadIdx.x; i < n; i += blockDim.x) d += sigma_in[i * n + i];
  const T s_tr = mpopis::block_sum(d, red);
  for (int idx = threadIdx.x; idx < nn; idx += blockDim.x) {
    y[idx] = sigma_in[idx] / s_tr;
    z[idx] = idx / n == idx % n ? T(1) : T(0);
  }
  __syncthreads();
  CMA_STAMP(kCmaSetup);
  for (int step = 0; step < ns_its; ++step) {
    for (int idx = threadIdx.x; idx < nn; idx += blockDim.x) {  // t = 1.5 I - 0.5 z y
      const int i = idx / n;
      const int j = idx % n;
      T acc = T(0);
      for (int q = 0; q < n; ++q) acc += z[i * n + q] * y[q * n + j];
      t[idx] = (i == j ? T(1.5) : T(0)) - T(0.5) * acc;
    }
    __syncthreads();
    CMA_STAMP(kCmaStageT);
    mpopis::block_matmul(y, t, w, n);  // y <- y t
    T* tmp = y;
    y = w;
    w = tmp;
    mpopis::block_matmul(t, z, w, n);  // z <- t z
    tmp = z;
    z = w;
    w = tmp;
    CMA_STAMP(kCmaStageYZ);
  }
  const T sqrt_s = sqrt(s_tr);
  T c2 = T(0);
  for (int idx = threadIdx.x; idx < nn; idx += blockDim.x) {
    const T cij = z[idx] / sqrt_s;
    z[idx] = cij;
    c2 += cij * cij;
  }
  const T norm_c2 = mpopis::block_sum(c2, red);  // also orders the writes to z
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    T c_dw = T(0);
    for (int j = 0; j < n; ++j) c_dw += z[i * n + j] * dw[j];
    cdw[i] = c_dw;
  }
  __syncthreads();
  CMA_STAMP(kCmaScale);
  cma_tail(sigma_in, dw, ps_in, pS_in, svals, ws, *sigma_s_in, n, k, c, it, jitter, guards,
           update_chol, cdw, norm_c2, p_sig, p_Sig, w, red, chol_out, sigma_out, ps_out, pS_out,
           sig_out);
}

// Global scratch (elements) of either kernel: the cluster kernel's five whole
// matrices (n x ld), or the one-block kernel's four (n x n) and three vectors.
size_t cma_work_elems(int n) {
  return std::max(5 * static_cast<size_t>(n) * cma_ld(n),
                  4 * static_cast<size_t>(n) * n + 3 * n);
}

template <typename T>
int cma_launch(const void* sigma, const void* dw, const void* ps, const void* pS,
               const void* svals, const void* ws, const void* sigma_s, int n, int k,
               const double* consts, double it, double jitter, int guards, int ns_its,
               int update_chol, void* scratch, void* chol, void* sigma_out, void* ps_out,
               void* pS_out, void* sig_out, void* stream) {
  if (n < 1 || k < 1 || ns_its < 0) return static_cast<int>(cudaErrorInvalidValue);
  const CmaConsts c{consts[0], consts[1], consts[2], consts[3], consts[4], consts[5], consts[6]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* a_sigma = static_cast<const T*>(sigma);
  const T* a_dw = static_cast<const T*>(dw);
  const T* a_ps = static_cast<const T*>(ps);
  const T* a_pS = static_cast<const T*>(pS);
  const T* a_sv = static_cast<const T*>(svals);
  const T* a_ws = static_cast<const T*>(ws);
  const T* a_sig = static_cast<const T*>(sigma_s);
  T* o_chol = static_cast<T*>(chol);
  T* o_sigma = static_cast<T*>(sigma_out);
  T* o_ps = static_cast<T*>(ps_out);
  T* o_pS = static_cast<T*>(pS_out);
  T* o_sig = static_cast<T*>(sig_out);
  if (cma_cluster_size<T>(n) == 0) {
    cma_block_kernel<T><<<1, kThreads, 0, s>>>(a_sigma, a_dw, a_ps, a_pS, a_sv, a_ws, a_sig, n,
                                               k, c, it, jitter, guards, ns_its, update_chol,
                                               static_cast<T*>(scratch), o_chol, o_sigma, o_ps,
                                               o_pS, o_sig);
    return static_cast<int>(cudaGetLastError());
  }
  const cudaError_t attr_err = cma_cluster_attributes<T>();
  if (attr_err != cudaSuccess) return static_cast<int>(attr_err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCmaCluster);
  cfg.blockDim = dim3(kCmaThreads);
  cfg.dynamicSmemBytes = cma_cluster_elems(n) * sizeof(T);
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCmaCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, cma_cluster_kernel<T>, a_sigma, a_dw, a_ps, a_pS, a_sv, a_ws, a_sig, n, k, c, it,
      jitter, guards, ns_its, update_chol, cma_band_rows(n), cma_ld(n),
      static_cast<T*>(scratch), o_chol, o_sigma,
      o_ps, o_pS, o_sig);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

extern "C" {

// Scratch (in elements of the dtype) the caller allocates for one call.
long long ais_refit_scratch_elems(int n, int k) {
  return static_cast<long long>(refit_part_elems(n, k) + refit_work_elems(n));
}

long long ais_cma_scratch_elems(int n) { return static_cast<long long>(cma_work_elems(n)); }

// The CMA kernel's cluster size for n (16 blocks), or 0 where it runs on one
// block from global memory.
int ais_cma_cluster_size(int n, int f64) {
  return f64 ? cma_cluster_size<double>(n) : cma_cluster_size<float>(n);
}

int ais_num_cma_consts() { return 7; }

// method: 0 mle, 1 lw, 2 ss, 3 rblw, 4 oas (masked refit); 5 the weighted refit
int ais_refit_chol_f32(const void* e, const void* w, const void* mu, int n, int k, int method,
                       double m, double jitter, int corrected, void* scratch, void* l,
                       void* stream) {
  return refit_launch<float>(e, w, mu, n, k, method, m, jitter, corrected, scratch, l, stream);
}

int ais_refit_chol_f64(const void* e, const void* w, const void* mu, int n, int k, int method,
                       double m, double jitter, int corrected, void* scratch, void* l,
                       void* stream) {
  return refit_launch<double>(e, w, mu, n, k, method, m, jitter, corrected, scratch, l, stream);
}

// consts: c1, c_Sigma, c_mu, c_sigma, d_sigma, e_norm, mu_eff
int ais_cma_update_f32(const void* sigma, const void* dw, const void* ps, const void* pS,
                       const void* svals, const void* ws, const void* sigma_s, int n, int k,
                       const double* consts, double it, double jitter, int guards, int ns_its,
                       int update_chol, void* scratch, void* chol, void* sigma_out,
                       void* ps_out, void* pS_out, void* sig_out, void* stream) {
  return cma_launch<float>(sigma, dw, ps, pS, svals, ws, sigma_s, n, k, consts, it, jitter,
                           guards, ns_its, update_chol, scratch, chol, sigma_out, ps_out,
                           pS_out, sig_out, stream);
}

int ais_cma_update_f64(const void* sigma, const void* dw, const void* ps, const void* pS,
                       const void* svals, const void* ws, const void* sigma_s, int n, int k,
                       const double* consts, double it, double jitter, int guards, int ns_its,
                       int update_chol, void* scratch, void* chol, void* sigma_out,
                       void* ps_out, void* pS_out, void* sig_out, void* stream) {
  return cma_launch<double>(sigma, dw, ps, pS, svals, ws, sigma_s, n, k, consts, it, jitter,
                            guards, ns_its, update_chol, scratch, chol, sigma_out, ps_out,
                            pS_out, sig_out, stream);
}

}  // extern "C"
