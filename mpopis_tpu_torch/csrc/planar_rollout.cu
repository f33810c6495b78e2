// Planar-contact MuJoCo rollout costs (HalfCheetah, Hopper, Walker2d), one
// thread per sample, and the same control step applied to a batch of states.
//
// Replaces the Pallas TPU kernel mpopis_tpu/kernels/planar_step.py::_make_kernel
// with _contact_advance (launched at planar_step.py:159). For each of K
// candidate control sequences it integrates T control steps of frame_skip
// physics substeps and accumulates cost = sum_t -(healthy + (q0' - q0) * inv_dt
// - ctrl_w * sum a^2). Each substep is one constrained forward pass per
// integrator stage (1 for euler_implicit, 4 for rk4):
//   frames -> analytic mass matrix and bias -> unrolled Cholesky ->
//   constraint rows (joint limits; three rows per plane-capsule contact, the
//   merged normal row at R/2; capsule-capsule pairs by Ericson's closest
//   points) -> box QP by the fixed-iteration active-set / CG / projected arc
//   search, warm-started from the previous substep's or stage's multipliers
//   (reset to 0 at every control step) -> accelerations.
// Euler-implicit solves the QP against the undamped M, then factors
// M + h*diag(damping) for the velocity update.
//
// Design
// - One thread per sample. q, qv, the mass matrix and its Cholesky factors are
//   register arrays: the dof count is a template parameter (6 for Hopper, 9
//   for HalfCheetah and Walker2d), so every dof loop unrolls. The model's
//   bodies are those hinges: body b owns dof b + 2 (checked by the wrapper),
//   so per-body arrays unroll too, and a row's body is found by an unrolled
//   select instead of a dynamic register index.
// - The model (bodies, contacts, limits, pairs, per-dof constants, solver
//   iteration counts, reward weights) is one POD struct passed by value, so
//   one kernel serves all three models. Every thread reads the same entry at
//   the same time (uniform branches, constant-bank broadcasts).
// - The per-row arrays (J up to 57 x 9, aref, R, the CG vectors, lambda) live
//   in local memory, i.e. L1/L2: ptxas reports 6.6 KB (float, 6 dofs) to
//   17 KB (double, 9 dofs) of stack a thread. Making this fast (rows spread
//   over a warp, J in shared memory) is later work.
// - A thread whose rows are all inactive skips its QP (lambda = 0 exactly, as
//   the plain version gets by iterating). The TPU kernel decides per K-block.
// - The maths (planar_dynamics.cuh, shared with the Swimmer's kernel in
//   swimmer_rollout.cu) is a transcription of the plain PyTorch version
//   (mpopis_tpu_torch/models/planar_contact.py). Derived constants (kb, the
//   impedance offsets, pos + anchor, h/6) are computed in double on the host
//   and rounded once, as the plain version does. The operation order still
//   differs (and nvcc contracts multiply-adds into FMAs; building with
//   -fmad=false moved no median on an H100), and the QP's discrete choices
//   (lam > 0, grad < 0, f_t < best_f) can turn rounding into a different
//   iterate near a contact switch, so the double instantiation is held to the
//   plain version by its median relative error (chip_smoke.py).
//
// What bounds it on an H100: latency. Each substep is a long dependent chain
// (~40 applications of J M^-1 J^T per QP, each ~2 x R x n FMAs plus two
// triangular solves), mostly through local memory. K = 2048 gives only 64
// warps: kBlock = 32 spreads them over 64 SMs rather than packing 2 warps on
// each of 32.
//
// Interface: plain C functions per dtype, loaded with ctypes. The model comes
// as a flat int array and a flat double array in the order of make_model
// in planar_dynamics.cuh (packed by mpopis_tpu_torch/kernels/planar_step.py). A launch does not
// synchronise and returns cudaGetLastError().

#include <cuda_runtime.h>

#include "planar_dynamics.cuh"

namespace {

using namespace planar;

// The one kernel behind both entries: thread k runs sample k (run_sample in
// planar_dynamics.cuh, with no fluid force).
template <typename T, int N>
__global__ void __launch_bounds__(kBlock)
planar_kernel(const T* __restrict__ x0, long long x_stride, const T* __restrict__ controls,
              long long c_t, long long c_i, long long c_k, int num_k, int horizon,
              T* __restrict__ costs, T* __restrict__ x_out, const Model<T> m) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= num_k) return;
  Scratch<T, N> sc;
  run_sample<T, N, false>(m, k, x0, x_stride, controls, c_t, c_i, c_k, horizon, costs, x_out, sc);
}

template <typename T>
int launch(const int* ip, int n_int, const double* dp, int n_double, const void* x0,
           long long x_stride, const void* controls, long long c_t, long long c_i, long long c_k,
           int num_k, int horizon, void* costs, void* x_out, void* stream) {
  Model<T> m;
  int nd = 0;
  if (num_k < 1 || horizon < 0 || !make_model(ip, n_int, dp, n_double, false, &nd, &m))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((num_k + kBlock - 1) / kBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* xs = static_cast<const T*>(x0);
  const T* ctrl = static_cast<const T*>(controls);
  T* c = static_cast<T*>(costs);
  T* xo = static_cast<T*>(x_out);
  if (nd == 6)
    planar_kernel<T, 6><<<grid, kBlock, 0, s>>>(xs, x_stride, ctrl, c_t, c_i, c_k, num_k,
                                                horizon, c, xo, m);
  else
    planar_kernel<T, 9><<<grid, kBlock, 0, s>>>(xs, x_stride, ctrl, c_t, c_i, c_k, num_k,
                                                horizon, c, xo, m);
  return static_cast<int>(cudaGetLastError());
}

// (T, na, K) controls from one state (2n,) -> costs (K,)
template <typename T>
int rollout(const int* ip, int n_int, const double* dp, int n_double, const void* state0,
            const void* controls, void* costs, int num_k, int horizon, void* stream) {
  const int na = n_int > 9 ? ip[9] : 0;
  return launch<T>(ip, n_int, dp, n_double, state0, 0, controls,
                   static_cast<long long>(na) * num_k, num_k, 1, num_k, horizon, costs,
                   nullptr, stream);
}

// states (B, 2n) and actions (B, na) -> states (B, 2n) after one control step
template <typename T>
int step(const int* ip, int n_int, const double* dp, int n_double, const void* x,
         const void* actions, void* out, int batch, void* stream) {
  const int nd = n_int > 0 ? ip[0] : 0;
  const int na = n_int > 9 ? ip[9] : 0;
  return launch<T>(ip, n_int, dp, n_double, x, 2LL * nd, actions, 0, 1, na, batch, 1,
                   nullptr, out, stream);
}

}  // namespace

extern "C" {

int planar_max_rows() { return kMaxRows; }

int planar_rollout_costs_f32(const int* ip, int n_int, const double* dp, int n_double,
                             const void* state0, const void* controls, void* costs, int num_k,
                             int horizon, void* stream) {
  return rollout<float>(ip, n_int, dp, n_double, state0, controls, costs, num_k, horizon,
                        stream);
}

int planar_rollout_costs_f64(const int* ip, int n_int, const double* dp, int n_double,
                             const void* state0, const void* controls, void* costs, int num_k,
                             int horizon, void* stream) {
  return rollout<double>(ip, n_int, dp, n_double, state0, controls, costs, num_k, horizon,
                         stream);
}

int planar_step_states_f32(const int* ip, int n_int, const double* dp, int n_double,
                           const void* x, const void* actions, void* out, int batch,
                           void* stream) {
  return step<float>(ip, n_int, dp, n_double, x, actions, out, batch, stream);
}

int planar_step_states_f64(const int* ip, int n_int, const double* dp, int n_double,
                           const void* x, const void* actions, void* out, int batch,
                           void* stream) {
  return step<double>(ip, n_int, dp, n_double, x, actions, out, batch, stream);
}

}  // extern "C"
