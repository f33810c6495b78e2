// Spatial-contact MuJoCo rollout costs (Ant, Pusher, Humanoid,
// HumanoidStandup), one thread per sample, and the same control step applied
// to a batch of states.
//
// Replaces the Pallas TPU kernel mpopis_tpu/kernels/spatial_step.py::_make_kernel
// with _spatial_advance (launched at spatial_step.py:311, entry
// spatial_rollout_costs_tak) in its four builds: Ant's (the `locomotion`
// reward family with the `q0` track, RK4), the Pusher's (the `pusher`
// family, Euler-implicit, slide joints, condim-1 floor contacts and
// capsule-cylinder pairs), the Humanoid's (RK4, 109 capsule-capsule self
// pairs, joint springs, the `locomotion` family with the com-x track; 242
// rows) and the Standup's (the same with the `standup` family). For each of K
// candidate control sequences it integrates T control steps of frame_skip
// substeps and accumulates
//   cost = sum_t -reward_t
// with the family's reward (run_sample in spatial_dynamics.cuh), whose carry
// (Ant: the torso x of the last RK stage's positions; Pusher: the 9 stale
// xpos entries of the last substep's pre-integration positions; Humanoid:
// the mass-weighted com x of the last RK stage's positions; Standup: the sum
// of |cfrc_ext|^2 of the last RK stage's positions and lambda) crosses the
// control steps in the state's tail. Each RK stage or Euler substep is a full
// constrained forward pass (spatial_dynamics.cuh): frames, mass matrix and its
// Cholesky, bias, the valid constraint rows, the warm-started box QP (lambda
// chained through the stages and substeps, reset to 0 at every control step).
//
// Design
// - One thread per sample, as the planar kernel (planar_rollout.cu). The
//   alternative, a warp per sample with J in shared memory and the rows over
//   the lanes, spends shuffles on every J^T lambda; it is later work. For the
//   Humanoid's 242 rows x 23 dofs one thread keeps ~40 KB (f32) / ~80 KB
//   (f64) of rows and QP vectors in local memory, and the row capacity is a
//   template parameter (RowCap), so Ant and the Pusher keep their 128.
// - Only the rows valid at the current state enter the QP, compacted
//   (spatial_dynamics.cuh): the work follows the contacts that are live, and
//   a sample with none skips its QP.
// - q, qv and the per-dof vectors are register arrays (the dof count is a
//   template parameter: 14 for Ant, 11 for the Pusher, 23 for the two
//   humanoids); the compacted rows (up to 128 x 14 or 248 x 23), the
//   QP vectors, the frames and the mass matrix and its factor live in local
//   memory, i.e. L1/L2.
// - Blocks are as small as fill the card: 1 thread per block up to ~8 blocks
//   per SM, then wider, so that K = 1024 samples spread over all SMs with 8
//   independent warps on each instead of 32 packed lanes on 32 SMs.
// - What a build runs is fixed at compile time by its feature mask, so the
//   Ant build holds none of the Pusher's branches.
// - The model (spatial::Model, built on the host from the flat arrays the
//   wrapper packs, in double, rounded once) lives in device memory the
//   wrapper owns; every thread reads it at the same addresses.
//
// What bounds it on an H100: latency. A substep is a long dependent chain
// (4 stages x (frames, an n x n Cholesky, ~40 applications of J M^-1 J^T over
// the valid rows)), mostly through local memory, and K = 1024 gives one
// sample per thread with no more threads to hide it.
//
// Interface: plain C functions, loaded with ctypes (kernels/spatial_step.py).
// The wrapper packs the model as a flat int array and a flat double array
// (layout: make_model in spatial_dynamics.cuh), has spatial_pack_model turn them into the
// device struct's bytes and copies those to the card once. A launch does not
// synchronise and returns cudaGetLastError().

#include <cuda_runtime.h>

#include "spatial_dynamics.cuh"

namespace {

using namespace spatial;

// The one kernel behind both entries: thread k runs sample k (run_sample in
// spatial_dynamics.cuh) with the build's feature mask F and row capacity.
template <typename T, int N, int NQ, int F>
__global__ void __launch_bounds__(32)
spatial_kernel(const Model<T>* __restrict__ model, const T* __restrict__ x0, long long x_stride,
               const T* __restrict__ controls, long long c_t, long long c_i, long long c_k,
               int num_k, int horizon, T* __restrict__ costs, T* __restrict__ x_out) {
  constexpr int R = RowCap<F>::n;
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= num_k) return;
  Rows<T, N, R> rows;
  T lam_full[R];
  run_sample<T, N, NQ, F, R>(*model, k, x0, x_stride, controls, c_t, c_i, c_k, horizon, costs,
                             x_out, lam_full, rows);
}

// The builds: (n_dof, n_q, feature mask) of Ant, the Pusher, the Humanoid and
// the Standup
constexpr int kAntFeatures = 0;
constexpr int kPusherFeatures = kEuler | kSlideJoints | kCondim1 | kCylinder | kPusher;
constexpr int kHumanoidFeatures = kSelfPairs | kSprings | kComX;
constexpr int kStandupFeatures = kSelfPairs | kSprings | kStandup;

int carry_of(int features) {
  return (features & kPusher) ? Carry<kPusher>::n : Carry<0>::n;
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        count < 1)
      count = 132;
  }
  return count;
}

template <typename T>
int launch(const void* model, int n_dof, int n_q, int features, const void* x0,
           long long x_stride, const void* controls, long long c_t, long long c_i, long long c_k,
           int num_k, int horizon, void* costs, void* x_out, void* stream) {
  if (num_k < 1 || horizon < 0 || model == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  // 1 thread a block while that leaves at most ~8 blocks an SM, then wider
  int threads = 1;
  while (threads < 32 && static_cast<long long>(threads) * 8 * sm_count() < num_k) threads *= 2;
  const dim3 grid((num_k + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Model<T>* m = static_cast<const Model<T>*>(model);
  const T* xs = static_cast<const T*>(x0);
  const T* ctrl = static_cast<const T*>(controls);
  T* c = static_cast<T*>(costs);
  T* xo = static_cast<T*>(x_out);
  if (n_dof == 14 && n_q == 15 && features == kAntFeatures)
    spatial_kernel<T, 14, 15, kAntFeatures><<<grid, threads, 0, s>>>(
        m, xs, x_stride, ctrl, c_t, c_i, c_k, num_k, horizon, c, xo);
  else if (n_dof == 11 && n_q == 11 && features == kPusherFeatures)
    spatial_kernel<T, 11, 11, kPusherFeatures><<<grid, threads, 0, s>>>(
        m, xs, x_stride, ctrl, c_t, c_i, c_k, num_k, horizon, c, xo);
  else if (n_dof == 23 && n_q == 24 && features == kHumanoidFeatures)
    spatial_kernel<T, 23, 24, kHumanoidFeatures><<<grid, threads, 0, s>>>(
        m, xs, x_stride, ctrl, c_t, c_i, c_k, num_k, horizon, c, xo);
  else if (n_dof == 23 && n_q == 24 && features == kStandupFeatures)
    spatial_kernel<T, 23, 24, kStandupFeatures><<<grid, threads, 0, s>>>(
        m, xs, x_stride, ctrl, c_t, c_i, c_k, num_k, horizon, c, xo);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The interface constants the wrapper checks against its own.
void spatial_layout(int* out) {
  const int v[] = {kIntHeader,       kDoubleHeader,   kMaxBodies,        kMaxJoints,
                   kMaxContacts,     kMaxLimits,      kMaxAct,           kMaxPairs,
                   kMaxSelfPairs,    kMaxRows,        kMaxRowsWide,      kAntFeatures,
                   kPusherFeatures,  kHumanoidFeatures, kStandupFeatures};
  for (int i = 0; i < 15; ++i) out[i] = v[i];
}

int spatial_model_bytes(int f64) {
  return f64 ? static_cast<int>(sizeof(Model<double>)) : static_cast<int>(sizeof(Model<float>));
}

// The device struct's bytes from the packed arrays into `out` (host memory of
// out_bytes); 0, or cudaErrorInvalidValue if the arrays do not fit.
int spatial_pack_model(int f64, const int* ip, int n_int, const double* dp, int n_double,
                       void* out, int out_bytes) {
  if (out_bytes != spatial_model_bytes(f64)) return static_cast<int>(cudaErrorInvalidValue);
  const bool ok =
      f64 ? make_model<double>(ip, n_int, dp, n_double, static_cast<Model<double>*>(out))
          : make_model<float>(ip, n_int, dp, n_double, static_cast<Model<float>*>(out));
  return ok ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// (T, na, K) controls from one state (n_q + n_dof + carry,) -> costs (K,)
int spatial_rollout_costs_f32(const void* model, int n_dof, int n_q, int features, int na,
                              const void* state0, const void* controls, void* costs, int num_k,
                              int horizon, void* stream) {
  return launch<float>(model, n_dof, n_q, features, state0, 0, controls,
                       static_cast<long long>(na) * num_k, num_k, 1, num_k, horizon, costs,
                       nullptr, stream);
}

int spatial_rollout_costs_f64(const void* model, int n_dof, int n_q, int features, int na,
                              const void* state0, const void* controls, void* costs, int num_k,
                              int horizon, void* stream) {
  return launch<double>(model, n_dof, n_q, features, state0, 0, controls,
                        static_cast<long long>(na) * num_k, num_k, 1, num_k, horizon, costs,
                        nullptr, stream);
}

// states (B, n_q + n_dof + carry) and actions (B, na) -> states after one
// control step
int spatial_step_states_f32(const void* model, int n_dof, int n_q, int features, int na,
                            const void* x, const void* actions, void* out, int batch,
                            void* stream) {
  return launch<float>(model, n_dof, n_q, features, x, n_q + n_dof + carry_of(features), actions,
                       0, 1, na, batch, 1, nullptr, out, stream);
}

int spatial_step_states_f64(const void* model, int n_dof, int n_q, int features, int na,
                            const void* x, const void* actions, void* out, int batch,
                            void* stream) {
  return launch<double>(model, n_dof, n_q, features, x, n_q + n_dof + carry_of(features), actions,
                        0, 1, na, batch, 1, nullptr, out, stream);
}

}  // extern "C"
