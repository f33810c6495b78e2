// Planar-contact MuJoCo rollout costs (HalfCheetah, Hopper, Walker2d), a
// group of W lanes per sample, and the same control step applied to a batch
// of states.
//
// Replaces the Pallas TPU kernel mpopis_tpu/kernels/planar_step.py:47
// `_make_kernel` with `_contact_advance` (:92; pallas_call :159, entry
// planar_rollout_costs_tak). For each of K candidate control sequences it
// integrates T control steps of frame_skip physics substeps and accumulates
// cost = sum_t -(healthy + (q0' - q0) * inv_dt - ctrl_w * sum a^2). Each
// substep is one constrained forward pass per integrator stage (1 for
// euler_implicit, 4 for rk4): frames -> analytic mass matrix and bias ->
// Cholesky -> constraint rows -> box QP warm-started from the previous
// substep's or stage's multipliers (reset to 0 at every control step) ->
// accelerations. Euler-implicit solves the QP against the undamped M, then
// factors M + h diag(damping) for the velocity update.
//
// Design (the device code is planar_dynamics.cuh, shared with the Swimmer's
// kernel in swimmer_rollout.cu)
// - Three builds, each with its integrator, dofs and row capacity fixed at
//   compile time: HalfCheetah (9 dofs, Euler, 54 rows), Walker2d (9, RK4,
//   48) and Hopper (6, RK4, 30, capsule pairs); the packed model picks one.
// - A group of W lanes per sample, W per build from scripts/planar_k_scan.py
//   (the time against K and W); the rows and the QP's iterates lie on the
//   lanes, the per-sample arrays (J, W = L^-1 J^T, the dense A, rhs, R,
//   lambda's warm starts, M and L, the frames) in the group's slice of
//   dynamic shared memory, the model in the block's. Blocks are the number
//   of warps (1 to 8) that keeps the most warps resident on an SM.
// - The thread-per-sample kernel this replaces kept every row array in
//   local memory (6.6 KB (f32, 6 dofs) to 17 KB (f64, 9 dofs) of stack a
//   thread) and swept every candidate row with two triangular solves in
//   each of the ~42 applications of J M^-1 J^T a forward pass: its phase
//   split (scripts/planar_phase_times.py, stamped at K = 2048 T = 15; H100
//   80GB HBM3, 700 W) put 62-91% of a pass in the QP (the operator 17-53%),
//   under 9% in the factor and solves, under 4% in the mass matrix and bias.
//   Its time did not grow from K = 132 to 4096: the slowest samples of a
//   warp (each with its own active rows and branches) set it.
//
// What bounds it on an H100 now: the schedulers' issue of each group's long
// chain of instructions. At W = 32 one HalfCheetah sample alone takes
// 0.96 ms (K = 1, T = 15), 1.7 ms at one warp a scheduler (K = 528), and
// past that the time grows with K (3.2 ms at 2048, 6.3 at 4096; Hopper 4.8
// and Walker2d 10.1 ms at 2048; scripts/planar_k_scan.py, f32 from reset;
// H100 80GB HBM3, 700 W); narrower groups pack samples whose rows and
// branches differ, and ran slower. Every forward pass from the main path's
// states takes the QP's dense path (at most 32 valid rows: its sums from
// shared memory, the arc search in one pass over A), and the QP takes 22-41%
// of a HalfCheetah pass, 42-49% of a Walker2d and 57-65% of a Hopper pass;
// the frames, mass matrix and factor take 49-68% of a HalfCheetah pass
// (scripts/planar_phase_times.py).
//
// Interface: plain C functions per dtype, loaded with ctypes. The model comes
// as a flat int array and a flat double array in the order of make_model in
// planar_dynamics.cuh (packed by mpopis_tpu_torch/kernels/planar_step.py). A
// launch does not synchronise and returns cudaGetLastError().

#include <cuda_runtime.h>

#include "planar_dynamics.cuh"

namespace {

using namespace planar;

// the lanes a sample of each build; PLANAR_LANES (scripts/planar_k_scan.py)
// gives every build that width
#ifdef PLANAR_LANES
constexpr int kCheetahLanes = PLANAR_LANES, kWalkerLanes = PLANAR_LANES,
              kHopperLanes = PLANAR_LANES;
#else
constexpr int kCheetahLanes = 32, kWalkerLanes = 32, kHopperLanes = 32;
#endif

template <typename T>
using Cheetah = Build<Model<T>, T, 9, false, true, kCheetahRows, kCheetahLanes>;
template <typename T>
using Walker = Build<Model<T>, T, 9, false, false, kWalkerRows, kWalkerLanes>;
template <typename T>
using Hopper = Build<Model<T>, T, 6, false, false, kHopperRows, kHopperLanes>;

template <typename T>
int launch(const int* ip, int n_int, const double* dp, int n_double, const void* x0,
           long long x_stride, const void* controls, long long c_t, long long c_i, long long c_k,
           int num_k, int horizon, void* costs, void* x_out, void* stream) {
  Model<T> m;
  int nd = 0;
  if (num_k < 1 || horizon < 0 || !make_model(ip, n_int, dp, n_double, false, &nd, &m))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nr = m.n_limits + 3 * m.n_contacts + m.n_pairs;
  if (nd == 9 && !m.rk4 && nr <= kCheetahRows)
    return Cheetah<T>::launch(m, x0, x_stride, controls, c_t, c_i, c_k, num_k, horizon, costs,
                              x_out, stream);
  if (nd == 9 && m.rk4 && nr <= kWalkerRows)
    return Walker<T>::launch(m, x0, x_stride, controls, c_t, c_i, c_k, num_k, horizon, costs,
                             x_out, stream);
  if (nd == 6 && m.rk4 && nr <= kHopperRows)
    return Hopper<T>::launch(m, x0, x_stride, controls, c_t, c_i, c_k, num_k, horizon, costs,
                             x_out, stream);
  return static_cast<int>(cudaErrorInvalidValue);  // no build takes this model
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

template <typename B>
int shape(int* out) {
  out[0] = B::kLanes;
  out[1] = B::warps();
  return out[1] > 0 ? 0 : static_cast<int>(cudaErrorInvalidConfiguration);
}

}  // namespace

extern "C" {

int planar_max_rows() { return kMaxRows; }

// (lanes a sample, warps a block) of the build for (n_dof, rk4) in f32 or f64
int planar_launch_shape(int n_dof, int rk4, int f64, int* out) {
  if (n_dof == 9 && !rk4) return f64 ? shape<Cheetah<double>>(out) : shape<Cheetah<float>>(out);
  if (n_dof == 9 && rk4) return f64 ? shape<Walker<double>>(out) : shape<Walker<float>>(out);
  if (n_dof == 6 && rk4) return f64 ? shape<Hopper<double>>(out) : shape<Hopper<float>>(out);
  return static_cast<int>(cudaErrorInvalidValue);
}

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
