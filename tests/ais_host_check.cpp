// Host build of the covariance-refit kernel's arithmetic (mpopis_tpu_torch/
// csrc/refit_math.cuh), for tests/test_torch_ais_host_check.py: runs the
// kernel's steps on the CPU in its order (the columns that count and each
// block's share of them, the moments chunk by chunk in E x E tiles, the sums
// over the blocks in rank order, the estimator, the jitter), so that they are
// held against the plain PyTorch version where there is no card. The factor
// is the plain right-looking loop (chol_reference): the kernel's blocked
// factor is held on the card.
//
// Input file: int f64, n, K, method, corrected, layout_only; double m,
// jitter; then E ((n, K) doubles), the weights (K) and mu (n). Output: the
// kernel's layout for (n, K) in the dtype (in_smem, cols, bytes, scratch),
// then, unless layout_only, L one row a line.
#include <cstdio>
#include <cstdlib>
#include <vector>

#include "refit_math.cuh"

template <typename V>
static std::vector<V> read(FILE* f, size_t n) {
  std::vector<V> v(n);
  if (n && fread(v.data(), sizeof(V), n, f) != n) exit(3);
  return v;
}

// One block's partial moments over its columns [lo, hi) of the list, in the
// kernel's order: chunks of L.cols columns, E x E tiles, and either column
// groups accumulated over all chunks and added in group order at the end,
// or (more tiles than threads) each chunk's products added to the partial.
// Value v of tile t at v * tiles + t, as in the kernel.
template <typename T, int E, bool kB>
static void block_moments(const std::vector<T>& e, const std::vector<T>& w,
                          const std::vector<T>& mu, const std::vector<int>& cols_list, int lo,
                          int hi, const refit::RefitLayout& L, bool weighted, T* pa, T* pb) {
  constexpr int kV = E * E;
  const int n = L.n, k = L.k, ldx = L.ldx, count = hi - lo;
  const int tiles = refit::num_tiles(n, E), groups = refit::tile_groups(tiles);
  std::vector<T> xl(static_cast<size_t>(L.cols) * ldx), xr(xl.size());
  std::vector<T> acc_a(static_cast<size_t>(tiles) * (groups ? groups : 1) * kV, T(0));
  std::vector<T> acc_b(acc_a.size(), T(0));
  auto products = [&](int t, int c0, int c1, int step, T* a, T* b) {
    int ti, tj;
    refit::tile_of(t, ti, tj);
    for (int c = c0; c < c1; c += step) {
      T u[E], v[E];
      for (int p = 0; p < E; ++p) {
        u[p] = xl[c * ldx + E * ti + p];
        v[p] = xr[c * ldx + E * tj + p];
      }
      refit::tile_column<T, E, kB>(u, v, *reinterpret_cast<T(*)[kV]>(a),
                                   *reinterpret_cast<T(*)[kV]>(b));
    }
  };
  for (int c0 = 0; c0 < count; c0 += L.cols) {
    const int cc = count - c0 < L.cols ? count - c0 : L.cols;
    for (int c = 0; c < cc; ++c) {
      const int col = cols_list[lo + c0 + c];
      for (int i = 0; i < ldx; ++i) {
        T vr = T(0), vl = T(0);
        if (i < n) {
          vr = e[static_cast<size_t>(i) * k + col] - mu[i];
          vl = vr * w[col];
        }
        xl[c * ldx + i] = vl;
        xr[c * ldx + i] = weighted ? vr : vl;
      }
    }
    for (int t = 0; t < tiles; ++t) {
      if (groups) {
        for (int g = 0; g < groups; ++g) {
          const size_t at = (static_cast<size_t>(g) * tiles + t) * kV;
          products(t, g, cc, groups, &acc_a[at], &acc_b[at]);
        }
      } else {
        T a[kV] = {}, b[kV] = {};
        products(t, 0, cc, 1, a, b);
        for (int q = 0; q < kV; ++q) {
          pa[q * tiles + t] += a[q];
          pb[q * tiles + t] += b[q];
        }
      }
    }
  }
  for (int g = 0; g < groups; ++g) {
    for (int t = 0; t < tiles; ++t) {
      const size_t at = (static_cast<size_t>(g) * tiles + t) * kV;
      for (int q = 0; q < kV; ++q) {
        pa[q * tiles + t] = g == 0 ? acc_a[at + q] : pa[q * tiles + t] + acc_a[at + q];
        pb[q * tiles + t] = g == 0 ? acc_b[at + q] : pb[q * tiles + t] + acc_b[at + q];
      }
    }
  }
}

template <typename T>
static int run(FILE* f, int n, int k, int method, int corrected, int layout_only) {
  const refit::RefitLayout L = refit::refit_layout<T>(n, k);
  printf("%d %d %lld %lld\n", L.in_smem, L.cols, L.bytes, L.scratch);
  const std::vector<double> md = read<double>(f, 2);
  if (layout_only) return 0;
  const double m = md[0], jitter = md[1];
  const std::vector<double> ed = read<double>(f, static_cast<size_t>(n) * k);
  const std::vector<double> wd = read<double>(f, k), mud = read<double>(f, n);
  const std::vector<T> e(ed.begin(), ed.end()), w(wd.begin(), wd.end());
  const std::vector<T> mu(mud.begin(), mud.end());
  const int blocks = refit::kCluster;

  // 1-2. the columns that count, each block's share, its partial moments
  std::vector<int> cols_list;
  for (int c = 0; c < k; ++c)
    if (refit::counts(w[c])) cols_list.push_back(c);
  const int total = static_cast<int>(cols_list.size());
  std::vector<T> parts(static_cast<size_t>(blocks) * 2 * L.part, T(0));
  for (int r = 0; r < blocks; ++r) {
    int lo, hi;
    refit::share(total, r, blocks, lo, hi);
    T* pa = parts.data() + static_cast<size_t>(r) * 2 * L.part;
    if (refit::needs_b(method)) {
      block_moments<T, 4, true>(e, w, mu, cols_list, lo, hi, L, false, pa, pa + L.part);
    } else {
      block_moments<T, 8, false>(e, w, mu, cols_list, lo, hi, L, method == refit::kWeighted, pa,
                                 pa + L.part);
    }
  }

  // 3. the sums over the blocks in rank order: the diagonal, then each
  // block's slice of tiles into A and its part of the estimator's sums
  auto summed = [&](size_t q, bool second) {
    T s = T(0);
    for (int r = 0; r < blocks; ++r)
      s += parts[static_cast<size_t>(r) * 2 * L.part + (second ? L.part : 0) + q];
    return s;
  };
  refit::Shrink<T> sh = refit::shrink_consts<T>(m);
  const int edge = refit::tile_edge(method), vals = edge * edge;
  const int tiles = refit::num_tiles(n, edge);
  std::vector<T> d_a(n), inv_sd(n, T(0)), sd_mle(n, T(0));
  for (int i = 0; i < n; ++i) {
    d_a[i] = summed(static_cast<size_t>(refit::diag_value(i, edge)) * tiles +
                        refit::diag_tile(i, edge), false);
    if (method == refit::kSs) refit::ss_row(d_a[i], sh, inv_sd[i], sd_mle[i]);
  }
  std::vector<T> a(static_cast<size_t>(n) * n, T(0));
  T g0 = T(0), g1 = T(0);
  for (int r = 0; r < blocks; ++r) {
    const int t_lo = static_cast<int>(static_cast<long long>(tiles) * r / blocks);
    const int t_hi = static_cast<int>(static_cast<long long>(tiles) * (r + 1) / blocks);
    T s0 = T(0), s1 = T(0);
    for (int v = 0; v < vals; ++v) {
      for (int t = t_lo; t < t_hi; ++t) {
        int ti, tj;
        refit::tile_of(t, ti, tj);
        const int i = edge * ti + v / edge, j = edge * tj + v % edge;
        if (i >= n || j > i) continue;
        const size_t q = static_cast<size_t>(v) * tiles + t;
        const T av = summed(q, false), bv = summed(q, true);
        a[static_cast<size_t>(i) * n + j] = av;
        refit::entry_sums(method, i, j, av, bv, sh, inv_sd[i], inv_sd[j], s0, s1);
      }
    }
    g0 += s0;
    g1 += s1;
  }

  // 4. the estimate with its jitter, then the plain factor
  refit::shrink_scalar(method, g0, g1, n, sh);
  T diag = T(0);
  for (int i = 0; i < n; ++i)
    diag += refit::estimate(method, i, i, d_a[i], sh, inv_sd[i], inv_sd[i], sd_mle[i], sd_mle[i],
                            corrected);
  const T add = refit::jitter_add(diag, n, jitter);
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j <= i; ++j) {
      T& at = a[static_cast<size_t>(i) * n + j];
      at = refit::estimate(method, i, j, at, sh, inv_sd[i], inv_sd[j], sd_mle[i], sd_mle[j],
                           corrected) + (i == j ? add : T(0));
      a[static_cast<size_t>(j) * n + i] = at;
    }
  }
  std::vector<T> l(static_cast<size_t>(n) * n, T(0));
  auto at = [n](std::vector<T>& v, int i, int j) -> T& { return v[static_cast<size_t>(i) * n + j]; };
  for (int j = 0; j < n; ++j) {
    const T inv = T(1) / refit::r_sqrt(at(a, j, j));
    for (int i = j; i < n; ++i) at(l, i, j) = at(a, i, j) * inv;
    for (int i = j; i < n; ++i)
      for (int c = j; c < n; ++c) at(a, i, c) -= at(l, i, j) * at(l, c, j);
  }
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j < n; ++j) printf(j ? " %.17g" : "%.17g", static_cast<double>(at(l, i, j)));
    printf("\n");
  }
  return 0;
}

int main(int argc, char** argv) {
  if (argc != 2) return 2;
  FILE* f = fopen(argv[1], "rb");
  if (!f) return 2;
  const std::vector<int> h = read<int>(f, 6);
  const int rc = h[0] ? run<double>(f, h[1], h[2], h[3], h[4], h[5])
                      : run<float>(f, h[1], h[2], h[3], h[4], h[5]);
  fclose(f);
  return rc;
}
