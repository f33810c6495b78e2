// Swimmer-v4 rollout costs, one thread per sample, and the same control step
// applied to a batch of states.
//
// Replaces the Pallas TPU kernel
// mpopis_tpu/kernels/planar_step.py::_swimmer_rollout_impl (launched at
// planar_step.py:228, entry swimmer_rollout_costs_tak). For each of K
// candidate control sequences it integrates T control steps of 4 RK4
// substeps of the analytic 5-dof chain (planar_dynamics.cuh, the planar
// contact kernel's device code, instantiated at N = 5 with FLUID: the
// inertia-box fluid force joins the smooth force at every stage) and the
// 2-row joint-limit QP at its fixed (2, 3) iterations, and accumulates
//   cost = sum_t -((q0' - q0) / dt - 1e-4 * sum a^2),
// the action clamped to [-1, 1] for the torque and read as given by the
// reward.
//
// Design: as planar_rollout.cu. q, qv and the 5 x 5 mass matrix and factor
// are registers; the 2 limit rows sit in the shared row arrays (local
// memory), and a sample whose limits are inactive skips its QP. The fluid
// coefficients come in the packed double array after the model, computed in
// double on the host (models/swimmer_device.py::FLUID), and ride in a
// FluidModel, so the contact kernels' Model is left as it was.
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

template <typename T>
__global__ void __launch_bounds__(kBlock)
swimmer_kernel(const T* __restrict__ x0, long long x_stride, const T* __restrict__ controls,
               long long c_t, long long c_i, long long c_k, int num_k, int horizon,
               T* __restrict__ costs, T* __restrict__ x_out, const FluidModel<T> m) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= num_k) return;
  Scratch<T, kSwimmerDof> sc;
  run_sample<T, kSwimmerDof, true>(m, k, x0, x_stride, controls, c_t, c_i, c_k, horizon, costs,
                                   x_out, sc);
}

template <typename T>
int launch(const int* ip, int n_int, const double* dp, int n_double, const void* x0,
           long long x_stride, const void* controls, long long c_t, long long c_i, long long c_k,
           int num_k, int horizon, void* costs, void* x_out, void* stream) {
  FluidModel<T> m;
  int nd = 0;
  if (num_k < 1 || horizon < 0 || !make_fluid_model(ip, n_int, dp, n_double, &nd, &m))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((num_k + kBlock - 1) / kBlock);
  swimmer_kernel<T><<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x0), x_stride, static_cast<const T*>(controls), c_t, c_i, c_k, num_k,
      horizon, static_cast<T*>(costs), static_cast<T*>(x_out), m);
  return static_cast<int>(cudaGetLastError());
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
