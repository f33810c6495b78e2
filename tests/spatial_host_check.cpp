// Host build of the spatial kernel's device code (mpopis_tpu_torch/csrc/
// spatial_dynamics.cuh) for tests/test_torch_spatial_kernel.py (Ant's build),
// tests/test_torch_pusher_kernel.py (the Pusher's),
// tests/test_torch_humanoid_kernel.py (the Humanoid's) and
// tests/test_torch_standup_models.py (the Standup's): runs the kernel's
// per-sample function on the CPU with one lane (W = 1, where the warp's lane
// primitives are identities), so that its arithmetic is held against the
// plain PyTorch version where there is no card. HOST_BUILDS picks the builds
// compiled in (1: Ant and the Pusher, the default; 2: the Humanoid; 4: the
// Standup), so that each test compiles only its own.
//
// Input file: int f64, n_int, n_double; the packed ints and doubles; int mode
// (0 rollout, 1 step), K, T, na; the states as doubles (one state for a
// rollout, K for a step) and the actions as doubles ((T, na, K) for a rollout,
// (K, na) for a step). The build follows the packed (n_dof, n_q) and feature
// mask, as the kernel's launch does. Output: one line per sample, its cost
// (rollout) or its new state (step).
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

#ifndef HOST_BUILDS
#define HOST_BUILDS 1
#endif

constexpr int kPusherFeatures = kEuler | kSlideJoints | kCondim1 | kCylinder | kPusher;
constexpr int kHumanoidFeatures = kSelfPairs | kSprings | kComX;
constexpr int kStandupFeatures = kSelfPairs | kSprings | kStandup;

template <typename V>
static std::vector<V> read(FILE* f, int n) {
  std::vector<V> v(n);
  if (fread(v.data(), sizeof(V), n, f) != static_cast<size_t>(n)) exit(3);
  return v;
}

template <typename T, int N, int NQ, int F>
static int run(FILE* f, const std::vector<int>& ip, const std::vector<double>& dp) {
  constexpr int NX = NQ + N + Carry<F>::n;
  constexpr int R = RowCap<F>::n;
  const std::vector<int> hdr = read<int>(f, 4);
  const int mode = hdr[0], num_k = hdr[1], horizon = hdr[2], na = hdr[3];
  static Model<T> m;
  if (!make_model<T>(ip.data(), static_cast<int>(ip.size()), dp.data(),
                     static_cast<int>(dp.size()), &m) || m.features != F)
    return 2;
  const std::vector<double> x0 = read<double>(f, mode == 0 ? NX : NX * num_k);
  const std::vector<double> ctrl = read<double>(f, (mode == 0 ? horizon : 1) * na * num_k);
  std::vector<T> xs(x0.begin(), x0.end()), cs(ctrl.begin(), ctrl.end());
  std::vector<T> costs(num_k), out(static_cast<size_t>(NX) * num_k);
  static Work<T, N, R, F> wk;  // the workspace of the sample's one lane
  for (int k = 0; k < num_k; ++k) {
    if (mode == 0) {  // the rollout entry's strides: controls (T, na, K)
      run_sample<T, N, NQ, F, R, 1>(m, k, xs.data(), 0, cs.data(),
                                    static_cast<long long>(na) * num_k, num_k, 1, horizon,
                                    costs.data(), static_cast<T*>(nullptr), wk);
      printf("%.17g\n", static_cast<double>(costs[k]));
    } else {  // the step entry's: states (K, NX), actions (K, na)
      run_sample<T, N, NQ, F, R, 1>(m, k, xs.data(), NX, cs.data(), 0, 1, na, 1,
                                    static_cast<T*>(nullptr), out.data(), wk);
      for (int i = 0; i < NX; ++i) printf("%.17g ", static_cast<double>(out[k * NX + i]));
      printf("\n");
    }
  }
  return 0;
}

template <typename T>
static int dispatch(FILE* f, int n_int, int n_double) {
  const std::vector<int> ip = read<int>(f, n_int);
  const std::vector<double> dp = read<double>(f, n_double);
  if (n_int < kIntHeader) return 2;
#if HOST_BUILDS & 1
  if (ip[0] == 14 && ip[1] == 15 && ip[12] == 0) return run<T, 14, 15, 0>(f, ip, dp);
  if (ip[0] == 11 && ip[1] == 11 && ip[12] == kPusherFeatures)
    return run<T, 11, 11, kPusherFeatures>(f, ip, dp);
#endif
#if HOST_BUILDS & 2
  if (ip[0] == 23 && ip[1] == 24 && ip[12] == kHumanoidFeatures)
    return run<T, 23, 24, kHumanoidFeatures>(f, ip, dp);
#endif
#if HOST_BUILDS & 4
  if (ip[0] == 23 && ip[1] == 24 && ip[12] == kStandupFeatures)
    return run<T, 23, 24, kStandupFeatures>(f, ip, dp);
#endif
  return 2;
}

int main(int argc, char** argv) {
  if (argc != 2) return 1;
  FILE* f = fopen(argv[1], "rb");
  if (!f) return 1;
  const std::vector<int> h = read<int>(f, 3);
  return h[0] ? dispatch<double>(f, h[1], h[2]) : dispatch<float>(f, h[1], h[2]);
}
