// Host build of the car rollout kernel's device code (mpopis_tpu_torch/csrc/
// car_dynamics.cuh), for tests/test_torch_car_host_check.py: runs each
// sample's action steps and joint reward on the CPU in the order the
// kernel's two warps run them, so that the substep's identities are held
// against the plain PyTorch version where there is no card.
//
// Input file: int f64, num_cars, M, K, T, n_sub; 27 doubles of physics
// constants (kernels/car_rollout.py::_kernel_params); the joint state
// (8 num_cars doubles), the track (3 M doubles: xs, ys, widths) and the
// controls ((T, 2 num_cars, K) doubles). Output: one line per sample, its
// cost, then each car's final x, y, sin psi, cos psi, vx, vy, psi_dot, delta.
#include <cstdio>
#include <cstdlib>
#include <vector>

#include "car_dynamics.cuh"

template <typename V>
static std::vector<V> read(FILE* f, size_t n) {
  std::vector<V> v(n);
  if (fread(v.data(), sizeof(V), n, f) != n) exit(3);
  return v;
}

template <typename T, int NC>
static int run(FILE* f, int m_track, int num_k, int horizon, int n_sub) {
  const std::vector<double> p = read<double>(f, car::kNumParams);
  const car::CarConsts<T> c = car::make_consts<T>(p.data(), n_sub);
  const std::vector<double> x0 = read<double>(f, 8 * NC);
  const std::vector<double> tr = read<double>(f, 3 * static_cast<size_t>(m_track));
  const std::vector<double> ctrl = read<double>(f, static_cast<size_t>(horizon) * 2 * NC * num_k);
  const std::vector<T> s0(x0.begin(), x0.end()), track(tr.begin(), tr.end());
  const std::vector<T> u(ctrl.begin(), ctrl.end());
  const T* txs = track.data();
  const T* tys = txs + m_track;
  const T* tws = tys + m_track;
  for (int k = 0; k < num_k; ++k) {
    car::Car<T> cars[NC];
    for (int ci = 0; ci < NC; ++ci) car::load_car(cars[ci], s0.data() + 8 * ci);
    T cost = T(0);
    for (int t = 0; t < horizon; ++t) {
      const T* ut = u.data() + static_cast<size_t>(t) * 2 * NC * num_k + k;
      for (int ci = 0; ci < NC; ++ci)
        car::begin_action(cars[ci], ut[(2 * ci) * num_k], ut[(2 * ci + 1) * num_k], c);
      car::advance_cars<T, NC>(cars, c);
      T s[NC][4];
      for (int ci = 0; ci < NC; ++ci) {
        s[ci][0] = cars[ci].x;
        s[ci][1] = cars[ci].y;
        s[ci][2] = cars[ci].vx;
        s[ci][3] = cars[ci].vy;
      }
      cost = cost - car::joint_reward<T, NC>(s, txs, tys, tws, m_track, c);
    }
    printf("%.17g", static_cast<double>(cost));
    for (int ci = 0; ci < NC; ++ci) {
      const car::Car<T>& a = cars[ci];
      for (const T v : {a.x, a.y, a.sin_p, a.cos_p, a.vx, a.vy, a.psid, a.delta})
        printf(" %.17g", static_cast<double>(v));
    }
    printf("\n");
  }
  return 0;
}

template <typename T>
static int dispatch(FILE* f, int num_cars, int m_track, int num_k, int horizon, int n_sub) {
  switch (num_cars) {
    case 1:
      return run<T, 1>(f, m_track, num_k, horizon, n_sub);
    case 2:
      return run<T, 2>(f, m_track, num_k, horizon, n_sub);
    case 3:
      return run<T, 3>(f, m_track, num_k, horizon, n_sub);
    case 4:
      return run<T, 4>(f, m_track, num_k, horizon, n_sub);
    default:
      return 2;
  }
}

int main(int argc, char** argv) {
  if (argc != 2) return 1;
  FILE* f = fopen(argv[1], "rb");
  if (!f) return 1;
  const std::vector<int> h = read<int>(f, 6);
  return h[0] ? dispatch<double>(f, h[1], h[2], h[3], h[4], h[5])
              : dispatch<float>(f, h[1], h[2], h[3], h[4], h[5]);
}
