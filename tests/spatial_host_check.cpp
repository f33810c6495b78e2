// Host build of the spatial kernel's device code (mpopis_tpu_torch/csrc/
// spatial_dynamics.cuh) for tests/test_torch_spatial_kernel.py: runs the
// kernel's per-sample loop on the CPU, so that its arithmetic is held against
// the plain PyTorch version where there is no card.
//
// Input file: int f64, n_int, n_double; the packed ints and doubles; int mode
// (0 rollout, 1 step), K, T, na; the states as doubles (one state for a
// rollout, K for a step) and the actions as doubles ((T, na, K) for a rollout,
// (K, na) for a step). Output: one line per sample, its cost (rollout) or its
// new state (step).
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <vector>

#define __device__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __constant__ static
inline float rsqrtf(float x) { return 1.0f / std::sqrt(x); }
inline double rsqrt(double x) { return 1.0 / std::sqrt(x); }

#include "spatial_dynamics.cuh"

using namespace spatial;

template <typename V>
static std::vector<V> read(FILE* f, int n) {
  std::vector<V> v(n);
  if (fread(v.data(), sizeof(V), n, f) != static_cast<size_t>(n)) exit(3);
  return v;
}

template <typename T>
static int run(FILE* f, int n_int, int n_double) {
  constexpr int N = 14, NQ = 15, NX = NQ + N + 1;
  const std::vector<int> ip = read<int>(f, n_int);
  const std::vector<double> dp = read<double>(f, n_double);
  const std::vector<int> hdr = read<int>(f, 4);
  const int mode = hdr[0], num_k = hdr[1], horizon = hdr[2], na = hdr[3];
  static Model<T> m;
  if (!make_model<T>(ip.data(), n_int, dp.data(), n_double, &m)) return 2;
  const std::vector<double> x0 = read<double>(f, mode == 0 ? NX : NX * num_k);
  const std::vector<double> ctrl = read<double>(f, (mode == 0 ? horizon : 1) * na * num_k);
  static Rows<T, N> rows;
  for (int k = 0; k < num_k; ++k) {
    T lam_full[kMaxRows], a[kMaxAct], q[NQ], qv[N];
    const double* xk = x0.data() + (mode == 0 ? 0 : k * NX);
    for (int i = 0; i < NQ; ++i) q[i] = T(xk[i]);
    for (int d = 0; d < N; ++d) qv[d] = T(xk[NQ + d]);
    T track = T(xk[NQ + N]), cost = T(0);
    for (int t = 0; t < horizon; ++t) {
      for (int i = 0; i < na; ++i)
        a[i] = T(mode == 0 ? ctrl[(t * na + i) * num_k + k] : ctrl[k * na + i]);
      const T snap = control_step<T, N, NQ>(m, q, qv, a, lam_full, rows);
      T rew = m.healthy + (snap - track) * m.fwd_inv_dt;
      for (int i = 0; i < na; ++i) rew = rew - m.ctrl_w * (a[i] * a[i]);
      cost = cost - rew;
      track = snap;
    }
    if (mode == 0) {
      printf("%.17g\n", static_cast<double>(cost));
    } else {
      for (int i = 0; i < NQ; ++i) printf("%.17g ", static_cast<double>(q[i]));
      for (int d = 0; d < N; ++d) printf("%.17g ", static_cast<double>(qv[d]));
      printf("%.17g\n", static_cast<double>(track));
    }
  }
  return 0;
}

int main(int argc, char** argv) {
  if (argc != 2) return 1;
  FILE* f = fopen(argv[1], "rb");
  if (!f) return 1;
  const std::vector<int> h = read<int>(f, 3);
  return h[0] ? run<double>(f, h[1], h[2]) : run<float>(f, h[1], h[2]);
}
