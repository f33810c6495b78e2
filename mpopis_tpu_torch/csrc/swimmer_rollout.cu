// Swimmer-v4 rollout costs, a group of W lanes per sample, and the same
// control step applied to a batch of states.
//
// Replaces the Pallas TPU kernel mpopis_tpu/kernels/planar_step.py:228 (entry
// swimmer_rollout_costs_tak; `_swimmer_rollout_impl` :182, whose pallas_call
// it launches). For each of K candidate control sequences it integrates T
// control steps of 4 RK4 substeps of the analytic 5-dof chain
// (planar_dynamics.cuh, the planar contact kernel's device code, built at
// N = 5 with FLUID: the inertia-box fluid force joins the smooth force at
// every stage) and the 2-row joint-limit QP at its fixed (2, 3) iterations,
// and accumulates
//   cost = sum_t -((q0' - q0) / dt - 1e-4 * sum a^2),
// the action clamped to [-1, 1] for the torque and read as given by the
// reward.
//
// Design: as planar_rollout.cu, one build (5 dofs, RK4, the fluid force, a
// row capacity of 2) at W lanes a sample from scripts/planar_k_scan.py. Its
// forward pass is short and mostly serial (the frames of 3 bodies, 15 mass
// entries, the fluid force, a 5 x 5 factor and its solves; the limit QP only
// where a joint passes its limit), so the lanes serve mostly to put more
// warps on the card. The thread-per-sample kernel it replaces held M, L and
// the row arrays in local memory (6.1 KB of stack a thread in f32) at 128
// warps for K = 4096: its phase split (scripts/planar_phase_times.py; H100
// 80GB HBM3, 700 W) put 16-24% of a pass from reset in the factor and
// solves, 17% in the mass matrix and bias, 21% in the QP. What bounds it now
// is that serial pass: at W = 16 one sample alone takes 1.71 ms (K = 1,
// T = 25) and K = 4096 2.53 ms (scripts/planar_k_scan.py); from reset the
// frames, mass matrix, fluid force and factor are 69% of a pass, the QP 14%
// (41% from the limit start; scripts/planar_phase_times.py).
//
// The fluid coefficients come in the packed double array after the model,
// computed in double on the host (models/swimmer_device.py::FLUID), and ride
// in a FluidModel, so the contact kernels' Model is left as it was.
//
// Interface: plain C functions per dtype, loaded with ctypes
// (kernels/planar_step.py, the swimmer_* entries); the packed model is the
// planar kernel's (make_model in planar_dynamics.cuh) plus the 5 fluid
// coefficients. A launch does not synchronise and returns cudaGetLastError().

#include <cuda_runtime.h>

#include "planar_dynamics.cuh"

namespace {

using namespace planar;

constexpr int kSwimmerDof = 5;
#ifdef PLANAR_LANES  // scripts/planar_k_scan.py
constexpr int kSwimmerLanes = PLANAR_LANES;
#else
constexpr int kSwimmerLanes = 16;
#endif

template <typename T>
using Swimmer = Build<FluidModel<T>, T, kSwimmerDof, true, false, kSwimmerRows, kSwimmerLanes>;

template <typename T>
int launch(const int* ip, int n_int, const double* dp, int n_double, const void* x0,
           long long x_stride, const void* controls, long long c_t, long long c_i, long long c_k,
           int num_k, int horizon, void* costs, void* x_out, void* stream) {
  FluidModel<T> m;
  int nd = 0;
  if (num_k < 1 || horizon < 0 || !make_fluid_model(ip, n_int, dp, n_double, &nd, &m) ||
      !m.rk4 || m.n_limits + 3 * m.n_contacts + m.n_pairs > kSwimmerRows)
    return static_cast<int>(cudaErrorInvalidValue);
  return Swimmer<T>::launch(m, x0, x_stride, controls, c_t, c_i, c_k, num_k, horizon, costs,
                            x_out, stream);
}

// (T, 2, K) controls from one state (10,) -> costs (K,)
template <typename T>
int rollout(const int* ip, int n_int, const double* dp, int n_double, const void* state0,
            const void* controls, void* costs, int num_k, int horizon, void* stream) {
  constexpr int na = kSwimmerDof - 3;
  return launch<T>(ip, n_int, dp, n_double, state0, 0, controls,
                   static_cast<long long>(na) * num_k, num_k, 1, num_k, horizon, costs, nullptr,
                   stream);
}

// states (B, 10) and actions (B, 2) -> states (B, 10) after one control step
template <typename T>
int step(const int* ip, int n_int, const double* dp, int n_double, const void* x,
         const void* actions, void* out, int batch, void* stream) {
  constexpr int na = kSwimmerDof - 3;
  return launch<T>(ip, n_int, dp, n_double, x, 2LL * kSwimmerDof, actions, 0, 1, na, batch, 1,
                   nullptr, out, stream);
}

}  // namespace

extern "C" {

int swimmer_max_rows() { return kMaxRows; }

// (lanes a sample, warps a block) of the build in f32 or f64
int swimmer_launch_shape(int n_dof, int rk4, int f64, int* out) {
  if (n_dof != kSwimmerDof || !rk4) return static_cast<int>(cudaErrorInvalidValue);
  out[0] = kSwimmerLanes;
  out[1] = f64 ? Swimmer<double>::warps() : Swimmer<float>::warps();
  return out[1] > 0 ? 0 : static_cast<int>(cudaErrorInvalidConfiguration);
}

int swimmer_rollout_costs_f32(const int* ip, int n_int, const double* dp, int n_double,
                              const void* state0, const void* controls, void* costs, int num_k,
                              int horizon, void* stream) {
  return rollout<float>(ip, n_int, dp, n_double, state0, controls, costs, num_k, horizon,
                        stream);
}

int swimmer_rollout_costs_f64(const int* ip, int n_int, const double* dp, int n_double,
                              const void* state0, const void* controls, void* costs, int num_k,
                              int horizon, void* stream) {
  return rollout<double>(ip, n_int, dp, n_double, state0, controls, costs, num_k, horizon,
                         stream);
}

int swimmer_step_states_f32(const int* ip, int n_int, const double* dp, int n_double,
                            const void* x, const void* actions, void* out, int batch,
                            void* stream) {
  return step<float>(ip, n_int, dp, n_double, x, actions, out, batch, stream);
}

int swimmer_step_states_f64(const int* ip, int n_int, const double* dp, int n_double,
                            const void* x, const void* actions, void* out, int batch,
                            void* stream) {
  return step<double>(ip, n_int, dp, n_double, x, actions, out, batch, stream);
}

}  // extern "C"
