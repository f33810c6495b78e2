// The per-entry arithmetic of the covariance-refit kernel (csrc/ais_update.cu,
// refit_cluster_kernel): which columns count, how a block's columns are cut
// from them, the moment products of one register tile and one column in the
// kernel's order, the estimators' sums, scalars and entries, and the jitter.
// The kernel and the host check (tests/ais_host_check.cpp, built with g++)
// include it, so that its arithmetic is held against the plain version where
// there is no card.
//
// The estimators are the TPU kernel's standardization-free forms
// (mpopis_tpu/kernels/ais_update.py::_shrink_finalize, :122) written over the
// lower triangle: an off-diagonal sum over the whole matrix is twice the sum
// below the diagonal, so no diagonal is subtracted from a full sum.

#pragma once

#include <float.h>
#include <math.h>
#include <stddef.h>

#ifdef __CUDACC__
#define REFIT_HD __host__ __device__ __forceinline__
#else
#define REFIT_HD inline
#endif

namespace refit {

enum Method { kMle = 0, kLw = 1, kSs = 2, kRblw = 3, kOas = 4, kWeighted = 5 };

REFIT_HD float r_sqrt(float x) { return sqrtf(x); }
REFIT_HD double r_sqrt(double x) { return sqrt(x); }
REFIT_HD float r_fma(float a, float b, float c) { return fmaf(a, b, c); }
REFIT_HD double r_fma(double a, double b, double c) { return fma(a, b, c); }
REFIT_HD double eps_of(float) { return FLT_EPSILON; }
REFIT_HD double eps_of(double) { return DBL_EPSILON; }
REFIT_HD double tiny_of(float) { return FLT_MIN; }
REFIT_HD double tiny_of(double) { return DBL_MIN; }

// max and clip that keep a NaN, as jnp.maximum and jnp.clip do
template <typename T>
REFIT_HD T max_nan(T a, T b) {
  return (a != a || a > b) ? a : b;
}
template <typename T>
REFIT_HD T clip_nan(T x, T lo, T hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// A column counts where its mask entry or weight is not zero (a NaN counts).
template <typename T>
REFIT_HD bool counts(T w) {
  return w != T(0);
}

// The columns [lo, hi) of the `total` that count (in ascending order) that
// block `rank` of `blocks` takes: equal shares, the larger ones last.
REFIT_HD void share(int total, int rank, int blocks, int& lo, int& hi) {
  lo = static_cast<int>(static_cast<long long>(total) * rank / blocks);
  hi = static_cast<int>(static_cast<long long>(total) * (rank + 1) / blocks);
}

// Row ti and column tj <= ti of lower tile t, counted row by row
// (t = ti (ti + 1) / 2 + tj).
REFIT_HD void tile_of(int t, int& ti, int& tj) {
  int i = static_cast<int>((r_sqrt(8.0f * static_cast<float>(t) + 1.0f) - 1.0f) * 0.5f);
  while (i * (i + 1) / 2 > t) --i;
  while ((i + 1) * (i + 2) / 2 <= t) ++i;
  ti = i;
  tj = t - i * (i + 1) / 2;
}

REFIT_HD int tile_index(int ti, int tj) { return ti * (ti + 1) / 2 + tj; }

REFIT_HD bool needs_b(int method) { return method == kLw || method == kSs; }

// The moments' register tiles: E x E entries of the lower triangle a
// thread, 8 x 8 where only A is summed (mle, rblw, oas, weighted: 64
// multiply-adds for four 16-byte loads of a column), 4 x 4 where B is too
// (lw, ss: two tiles of accumulators). Value (p, q) of a tile is its
// p E + q; row i's diagonal entry is value diag_value(i, E) of tile
// diag_tile(i, E).
REFIT_HD int tile_edge(int method) { return needs_b(method) ? 4 : 8; }
REFIT_HD int num_tiles(int n, int e) {
  const int nt = (n + e - 1) / e;
  return nt * (nt + 1) / 2;
}
REFIT_HD int diag_tile(int i, int e) { return tile_index(i / e, i / e); }
REFIT_HD int diag_value(int i, int e) { return (i % e) * (e + 1); }

constexpr int kThreads = 384;  // a block of the kernel: 12 warps
constexpr int kMaxGroups = 8;

// Column groups: as many copies of the tiles as a block's threads hold, at
// most 8; copy g takes columns g, g + G, ... of each chunk into its own
// accumulators, which stay in registers over the chunks and are added up
// in group order at the end. 0 where the tiles outnumber the threads: a
// thread then takes tiles t, t + kThreads, ..., a chunk at a time, and adds
// each chunk's products to the block's partials.
REFIT_HD int tile_groups(int tiles) {
  const int g = kThreads / tiles;
  return g > kMaxGroups ? kMaxGroups : g;
}

// One column's share of a tile: a[p][q] += u[p] v[q] and, kB, b[p][q] +=
// u[p]^2 v[q]^2, u the tile's rows and v its columns of the staged column
// (masked: (E - mu) w for both; weighted: (E - mu) w for the rows, E - mu
// for the columns). A fused multiply-add each, as on the card.
template <typename T, int E, bool kB>
REFIT_HD void tile_column(const T (&u)[E], const T (&v)[E], T (&a)[E * E], T (&b)[E * E]) {
#pragma unroll
  for (int p = 0; p < E; ++p) {
#pragma unroll
    for (int q = 0; q < E; ++q) a[p * E + q] = r_fma(u[p], v[q], a[p * E + q]);
  }
  if (kB) {
    T u2[E], v2[E];
#pragma unroll
    for (int p = 0; p < E; ++p) {
      u2[p] = u[p] * u[p];
      v2[p] = v[p] * v[p];
    }
#pragma unroll
    for (int p = 0; p < E; ++p) {
#pragma unroll
      for (int q = 0; q < E; ++q) b[p * E + q] = r_fma(u2[p], v2[q], b[p * E + q]);
    }
  }
}

constexpr int kCluster = 16;  // blocks of the kernel's cluster (non-portable size)
constexpr int kCols = 32;     // columns a chunk holds (a lane each; fewer for large n)
constexpr size_t kMaxSmem = 227 * 1024 - 1024;  // dynamic shared memory a block may take

// The rows of a staged column that the tiles read: whole tiles of either
// edge, zero past n.
REFIT_HD int staged_rows(int n) { return 8 * ((n + 7) / 8); }

// Elements of one stage: `cols` columns of ldx values, then their weights,
// rounded up to 16 bytes.
REFIT_HD int stage_elems(int cols, int ldx, int elem) {
  const int al = 16 / elem;
  return (cols * ldx + cols + al - 1) / al * al;
}

// Where the kernel's arrays live, decided on the host from n, K and the
// dtype's size: offsets in elements of T from the dynamic shared memory,
// each 16-byte aligned, the int arrays (the ballots and this block's column
// list) after them at `ints` bytes. The staged chunks are two stages of
// `cols` columns of ldx values each and their weights; ldx is the staged rows
// plus 4, an odd number of 16-byte groups (float), so that a warp storing
// one row of 32 columns meets 8 banks, not 4. in_smem: each block's
// partial moments (A then B, the lower tiles of either edge) at `parts` and
// block 0's factor over the stages (its entries arrive after the last
// chunk), in shared memory; else the partials in global scratch and the
// factor in place in the output, with chunks of `cols` columns that fit.
struct RefitLayout {
  int n, k, ldx, lda, cols, in_smem;
  long long part;                // elements of one partial matrix: its tiles' entries
  long long parts, x, vec;       // offsets: partials, the stages, mu and the rows' values
  long long ints, words, idx_cap;  // bytes to the ints; ballot words; column list
  long long bytes;               // dynamic shared memory (0: no layout fits)
  long long scratch;             // elements of global scratch
};

template <typename T>
RefitLayout refit_layout(int n, int k) {
  RefitLayout L{};
  const long long al = 16 / sizeof(T);
  auto up = [al](long long v) { return (v + al - 1) / al * al; };
  L.n = n;
  L.k = k;
  L.ldx = staged_rows(n) + 4;
  const long long part4 = 16LL * num_tiles(n, 4), part8 = 64LL * num_tiles(n, 8);
  L.part = part4 > part8 ? part4 : part8;
  long long units = (static_cast<long long>(n) * sizeof(T) + 15) / 16;  // odd 16-byte units
  if (units % 2 == 0) ++units;
  L.lda = static_cast<int>(units * 16 / sizeof(T));
  L.words = (k + 31) / 32;
  L.idx_cap = (k + kCluster - 1) / kCluster;
  const long long ints = 4 * (L.words + L.idx_cap);
  const long long vec = up(3LL * n);  // mu, and ss's 1 / sd and MLE sd
  for (int cols = kCols; cols >= 4; cols /= 2) {
    const long long stages = 2LL * stage_elems(cols, L.ldx, static_cast<int>(sizeof(T)));
    const long long factor = up(static_cast<long long>(n) * L.lda);
    const long long in_smem =
        (2 * L.part + (stages > factor ? stages : factor) + vec) * sizeof(T) + ints;
    const long long in_global = (stages + vec) * sizeof(T) + ints;
    const bool smem = cols == kCols && in_smem <= static_cast<long long>(kMaxSmem);
    if (!smem && in_global > static_cast<long long>(kMaxSmem)) continue;
    L.cols = cols;
    L.in_smem = smem;
    L.parts = 0;
    L.x = smem ? 2 * L.part : 0;
    L.vec = L.x + (smem && factor > stages ? factor : stages);
    L.ints = (L.vec + vec) * static_cast<long long>(sizeof(T));
    L.bytes = smem ? in_smem : in_global;
    L.scratch = smem ? 0 : 2 * L.part * kCluster;
    break;
  }
  return L;
}

// The scalars of the estimate, taken once a call: the divisor m (the elite
// count; K for the weighted refit) and the factors in m that the
// estimators take in double, rounded to T; then the shrinkage weight (lw,
// ss: lambda; rblw, oas: rho) and rblw/oas's target tr(S) / p.
template <typename T>
struct Shrink {
  double m_d;
  T m, m1;     // m and m - 1
  T c_r;       // m / (m - 1): ss's correlation scale, the corrected weighted refit's
  T c_var;     // m / (m - 1)^3: ss's variance of the correlations
  T lam, target;
};

template <typename T>
REFIT_HD Shrink<T> shrink_consts(double m) {
  Shrink<T> sh;
  sh.m_d = m;
  sh.m = T(m);
  sh.m1 = T(m - 1.0);
  sh.c_r = T(m / (m - 1.0));
  sh.c_var = T(m / ((m - 1.0) * (m - 1.0) * (m - 1.0)));
  sh.lam = T(0);
  sh.target = T(0);
  return sh;
}

// ss's per-row values from the diagonal moment d = A_ii: 1 / sd of the
// unbiased variance, and the MLE sd.
template <typename T>
REFIT_HD void ss_row(T d, const Shrink<T>& sh, T& inv_sd, T& sd_mle) {
  const T tiny = T(tiny_of(T()));
  inv_sd = T(1) / r_sqrt(max_nan(d / sh.m1, tiny));
  sd_mle = r_sqrt(max_nan(d / sh.m, tiny));
}

// Entry (i, j), j <= i, of the moments a = A_ij, b = B_ij into the two sums
// the estimator's scalar needs: lw and ss the off-diagonal sums of the
// variance estimate and of the squared entry (twice the entries below the
// diagonal); rblw and oas tr(S^2) and tr(S). ss reads its rows' inv_sd.
template <typename T>
REFIT_HD void entry_sums(int method, int i, int j, T a, T b, const Shrink<T>& sh, T inv_i,
                         T inv_j, T& s0, T& s1) {
  if (method == kLw) {
    if (i == j) return;
    const T s = a / sh.m;
    const T var_s = (b / sh.m - s * s) / sh.m;
    s0 += T(2) * var_s;
    s1 += T(2) * (s * s);
  } else if (method == kSs) {
    if (i == j) return;
    const T wbar = a / sh.m * inv_i * inv_j;
    const T r = sh.c_r * wbar;
    const T sum_w2 = b * (inv_i * inv_i) * (inv_j * inv_j);
    const T var_r = sh.c_var * (sum_w2 - sh.m * wbar * wbar);
    s0 += T(2) * var_r;
    s1 += T(2) * (r * r);
  } else if (method == kRblw || method == kOas) {
    const T s = a / sh.m;
    s0 += (i == j ? T(1) : T(2)) * (s * s);
    if (i == j) s1 += s;
  }
}

// The shrinkage weight from the two sums over the whole matrix (n = p rows)
// into sh.
template <typename T>
REFIT_HD void shrink_scalar(int method, T s0, T s1, int n, Shrink<T>& sh) {
  const T tiny = T(tiny_of(T()));
  const double m = sh.m_d;
  if (method == kLw || method == kSs) {
    sh.lam = clip_nan(s0 / max_nan(s1, tiny), T(0), T(1));
  } else if (method == kRblw || method == kOas) {
    const double p = n;
    const T tr_s2 = s0, tr_s = s1;
    T num, den;
    if (method == kRblw) {
      num = T((m - 2.0) / m) * tr_s2 + tr_s * tr_s;
      den = T(m + 2.0) * (tr_s2 - tr_s * tr_s / T(p));
    } else {
      num = T(1.0 - 2.0 / p) * tr_s2 + tr_s * tr_s;
      den = T(m + 1.0 - 2.0 / p) * (tr_s2 - tr_s * tr_s / T(p));
    }
    sh.lam = clip_nan(num / max_nan(den, tiny), T(0), T(1));
    sh.target = tr_s / T(p);
  }
}

// Entry (i, j) of the estimate from the moment a = A_ij; ss reads its rows'
// inv_sd and sd_mle; `corrected` scales the weighted refit by m / (m - 1).
template <typename T>
REFIT_HD T estimate(int method, int i, int j, T a, const Shrink<T>& sh, T inv_i, T inv_j,
                    T sd_i, T sd_j, int corrected) {
  switch (method) {
    case kMle:
      return a / sh.m;
    case kLw: {
      const T s = a / sh.m;
      return (T(1) - sh.lam) * s + sh.lam * (i == j ? s : T(0));
    }
    case kSs: {
      const T r = sh.c_r * (a / sh.m * inv_i * inv_j);
      const T r_shrunk = i == j ? T(1) : (T(1) - sh.lam) * r;
      return r_shrunk * sd_i * sd_j;
    }
    case kRblw:
    case kOas: {
      const T s = a / sh.m;
      return (T(1) - sh.lam) * s + sh.lam * (i == j ? sh.target : T(0));
    }
    default:
      return corrected ? a * sh.c_r : a;
  }
}

// What the jitter adds to each diagonal entry: jitter + 100 eps mean(diag),
// the TPU kernels' _jitter_mat (mpopis_tpu/kernels/ais_update.py:114), from
// the sum of the estimate's diagonal.
template <typename T>
REFIT_HD T jitter_add(T diag_sum, int n, double jitter) {
  return T(jitter) + T(100.0 * eps_of(T())) * (diag_sum / T(n));
}

}  // namespace refit
