// Host build of the planar kernels' device code (mpopis_tpu_torch/csrc/
// planar_dynamics.cuh) at its four builds, for
// tests/test_torch_planar_kernel.py (HalfCheetah: 9 dofs, Euler; Walker2d: 9
// dofs, RK4; Hopper: 6 dofs, RK4) and tests/test_torch_swimmer_kernel.py (the
// Swimmer: 5 dofs, RK4, the fluid force on): runs the kernels' per-sample
// function on the CPU with one lane (W = 1, where the group's lane
// primitives are identities), so that its arithmetic is held against the
// plain PyTorch version where there is no card. The build follows the
// packed model's dofs and integrator, as the kernels' launches do, with the
// same row capacities.
//
// Input file: int f64, n_int, n_double; the packed ints and doubles; int mode
// (0 rollout, 1 step), K, T; the states as doubles (one state for a rollout,
// K for a step) and the actions as doubles ((T, na, K) for a rollout, (K, na)
// for a step). Output: one line per sample, its cost (rollout) or its new
// state (step).
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <vector>

#define __device__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __constant__ static

#include "planar_dynamics.cuh"

using namespace planar;

template <typename V>
static std::vector<V> read(FILE* f, int n) {
  std::vector<V> v(n);
  if (fread(v.data(), sizeof(V), n, f) != static_cast<size_t>(n)) exit(3);
  return v;
}

template <typename T, typename MT, int N, bool FLUID, bool EULER, int R>
static int run(FILE* f, const MT& m) {
  constexpr int NA = N - 3, NX = 2 * N;
  if (m.n_limits + 3 * m.n_contacts + m.n_pairs > R) return 2;
  const std::vector<int> hdr = read<int>(f, 3);
  const int mode = hdr[0], num_k = hdr[1], horizon = hdr[2];
  const std::vector<double> x0 = read<double>(f, mode == 0 ? NX : NX * num_k);
  const std::vector<double> ctrl = read<double>(f, (mode == 0 ? horizon : 1) * NA * num_k);
  std::vector<T> xs(x0.begin(), x0.end()), cs(ctrl.begin(), ctrl.end());
  std::vector<T> costs(num_k), out(static_cast<size_t>(NX) * num_k);
  static Work<T, N, R> wk;  // the workspace of the sample's one lane
  for (int k = 0; k < num_k; ++k) {
    if (mode == 0) {  // the rollout entry's strides: controls (T, NA, K)
      run_sample<T, N, FLUID, EULER, R, 1>(m, k, xs.data(), 0, cs.data(),
                                           static_cast<long long>(NA) * num_k, num_k, 1, horizon,
                                           costs.data(), static_cast<T*>(nullptr), wk);
      printf("%.17g\n", static_cast<double>(costs[k]));
    } else {  // the step entry's: states (K, NX), actions (K, NA)
      run_sample<T, N, FLUID, EULER, R, 1>(m, k, xs.data(), NX, cs.data(), 0, 1, NA, 1,
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
  int nd = 0;
  if (n_int >= kIntHeader && ip[0] == 5) {
    static FluidModel<T> m;
    if (!make_fluid_model<T>(ip.data(), n_int, dp.data(), n_double, &nd, &m) || !m.rk4) return 2;
    return run<T, FluidModel<T>, 5, true, false, kSwimmerRows>(f, m);
  }
  static Model<T> m;
  if (!make_model<T>(ip.data(), n_int, dp.data(), n_double, false, &nd, &m)) return 2;
  if (nd == 9 && !m.rk4) return run<T, Model<T>, 9, false, true, kCheetahRows>(f, m);
  if (nd == 9 && m.rk4) return run<T, Model<T>, 9, false, false, kWalkerRows>(f, m);
  if (nd == 6 && m.rk4) return run<T, Model<T>, 6, false, false, kHopperRows>(f, m);
  return 2;
}

int main(int argc, char** argv) {
  if (argc != 2) return 1;
  FILE* f = fopen(argv[1], "rb");
  if (!f) return 1;
  const std::vector<int> h = read<int>(f, 3);
  return h[0] ? dispatch<double>(f, h[1], h[2]) : dispatch<float>(f, h[1], h[2]);
}
