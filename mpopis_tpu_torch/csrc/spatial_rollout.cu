// Spatial-contact MuJoCo rollout costs (Ant, Pusher, Humanoid,
// HumanoidStandup), one warp per sample, and the same control step applied
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
// - One warp per sample (spatial_dynamics.cuh spreads its work over the 32
//   lanes). On one thread per sample the kernel was a serial chain on one
//   live lane of each warp: the QP's 42 applications of J M^-1 J^T per
//   forward pass (each two dependent 23-step substitutions), the 242 row
//   tests and the mass matrix, with ~41 KB (f32) / ~82 KB (f64) of rows and
//   QP vectors in local memory per thread. scripts/spatial_phase_times.py
//   put 36-47% of its time in those applications and 7-15% in the rest of
//   the QP, 19-28% in the mass matrix and bias, 6-14% in the factor and
//   solves, 9-14% in the pair geometry (H100 80GB HBM3, 700 W).
// - A warp's per-sample arrays lie in its slice of dynamic shared memory
//   (spatial::Work): the valid rows' columns of W = L^-1 J^T, formed once
//   per forward pass by one lane per row against the factor, so that no
//   triangular solve is left in the QP's loop; their rhs, regularizer and
//   model row; lambda's warm starts; M and its factor; the frames and the
//   bodies' motion. Per-lane state (q, qv, the RK4 stages, the QP iterates
//   of the lane's rows) stays in registers. The row capacity is a template
//   parameter (RowCap), so Ant (128 x 14) and the Pusher (128 x 11) hold
//   only their own rows.
// - The QP's operands move through the warp's shared memory in 16-byte
//   reads. At most 32 valid rows (the common case: 92-97% of the Ant's
//   forward passes in the main path, median 2-3 rows) the QP applies the
//   dense A = W^T W + diag R, formed once per pass at a row stride of 32
//   words and 16 bytes (a quarter warp's rows on distinct banks): each lane
//   stores its entry of the vector once, and dots its row of A with it four
//   entries a step, A's row and the vector (a broadcast) each one 16-byte
//   load in f32. The arc search's six points share one pass over A. Every
//   row-order scalar is one store a lane and one broadcast load per four
//   lanes in place of a shuffle per lane. The QP's iterations are compiled
//   twice: one register a lane for each iterate on this dense path, a slot
//   per 32 rows beyond, where the QP applies W^T (W v) with a reduce-scatter
//   over the lanes. How the operands move changes no FMA or add, nor their
//   order: the results do not depend on it, bit for bit.
// - Blocks are the number of warps (1 to 8) that keeps the most warps
//   resident on an SM under the build's shared memory (30.6 KB a warp for
//   the humanoids in f32) and registers, the fewer on a tie; a warp past
//   num_k exits whole.
// - What a build runs is fixed at compile time by its feature mask, so the
//   Ant build holds none of the Pusher's branches.
// - The model (spatial::Model, built on the host from the flat arrays the
//   wrapper packs, in double, rounded once) lives in device memory the
//   wrapper owns; every thread reads it at the same addresses.
//
// What bounds it on an H100: the warp's chain of dependent steps, and the
// schedulers' issue once two warps share one. Every build keeps a block of
// one warp and the resident warps an SM its registers or shared memory
// allow (Ant 8, the Pusher 16 in f32, the humanoids 7), so K = 1024 is a
// single wave on Ant and a second, partial one on the humanoids
// (scripts/spatial_k_scan.py). Per forward pass on Ant the QP is 47-48%,
// the mass matrix and bias 21-23%, the frames (one lane) 11% and the factor
// and solves 8-9% (scripts/spatial_phase_times.py, the stamped kernel at K =
// 1024 from the grounded start and the main path's states; the stamps weigh
// most in the QP, which has the most of them).
//
#include <cuda_runtime.h>

#include "spatial_dynamics.cuh"

namespace {

using namespace spatial;

constexpr int kMaxWarps = 8;  // warps of a block at most

// The one kernel behind both entries: warp w of the block runs sample
// blockIdx.x * warps + w (run_sample in spatial_dynamics.cuh, W = 32) with
// the build's feature mask F and row capacity, its workspace the warp's
// slice of dynamic shared memory.
template <typename T, int N, int NQ, int F>
__global__ void __launch_bounds__(kMaxWarps * 32)
spatial_kernel(const Model<T>* __restrict__ model, const T* __restrict__ x0, long long x_stride,
               const T* __restrict__ controls, long long c_t, long long c_i, long long c_k,
               int num_k, int horizon, T* __restrict__ costs, T* __restrict__ x_out) {
  using Ws = Work<T, N, RowCap<F>::n, F>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int k = blockIdx.x * (blockDim.x >> 5) + warp;
  if (k >= num_k) return;  // the whole warp
  Ws& wk = reinterpret_cast<Ws*>(smem)[warp];
  run_sample<T, N, NQ, F, RowCap<F>::n, 32>(*model, k, x0, x_stride, controls, c_t, c_i, c_k,
                                            horizon, costs, x_out, wk);
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

// The warps of a block for this build: of 1 .. kMaxWarps (as many as fit
// in one block's shared memory), the count that keeps the most warps
// resident on an SM, the smaller on a tie (a finer last wave). Chosen once
// per build; the first call also lets the kernel take the dynamic shared
// memory it needs.
template <typename T, int N, int NQ, int F>
int block_warps() {
  static int warps = 0;
  if (warps == 0) {
    const auto kern = spatial_kernel<T, N, NQ, F>;
    constexpr int per_warp = static_cast<int>(sizeof(Work<T, N, RowCap<F>::n, F>));
    int dev = 0, smem_max = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
            cudaSuccess)
      return 0;
    const int fit = smem_max / per_warp < kMaxWarps ? smem_max / per_warp : kMaxWarps;
    if (fit < 1 || cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        fit * per_warp) != cudaSuccess)
      return 0;
    int best = 0, best_resident = 0;
    for (int w = 1; w <= fit; ++w) {
      int blocks = 0;
      if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, 32 * w, w * per_warp) !=
          cudaSuccess)
        return 0;
      if (blocks * w > best_resident) {
        best_resident = blocks * w;
        best = w;
      }
    }
    warps = best;
  }
  return warps;
}

template <typename T, int N, int NQ, int F>
int launch_build(const Model<T>* m, const T* xs, long long x_stride, const T* ctrl, long long c_t,
                 long long c_i, long long c_k, int num_k, int horizon, T* c, T* xo,
                 cudaStream_t s) {
  const int warps = block_warps<T, N, NQ, F>();
  if (warps < 1) {
    const cudaError_t e = cudaGetLastError();
    return static_cast<int>(e != cudaSuccess ? e : cudaErrorInvalidConfiguration);
  }
  const int per_warp = static_cast<int>(sizeof(Work<T, N, RowCap<F>::n, F>));
  const dim3 grid((num_k + warps - 1) / warps);
  spatial_kernel<T, N, NQ, F><<<grid, 32 * warps, warps * per_warp, s>>>(
      m, xs, x_stride, ctrl, c_t, c_i, c_k, num_k, horizon, c, xo);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* model, int n_dof, int n_q, int features, const void* x0,
           long long x_stride, const void* controls, long long c_t, long long c_i, long long c_k,
           int num_k, int horizon, void* costs, void* x_out, void* stream) {
  if (num_k < 1 || horizon < 0 || model == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Model<T>* m = static_cast<const Model<T>*>(model);
  const T* xs = static_cast<const T*>(x0);
  const T* ctrl = static_cast<const T*>(controls);
  T* c = static_cast<T*>(costs);
  T* xo = static_cast<T*>(x_out);
  if (n_dof == 14 && n_q == 15 && features == kAntFeatures)
    return launch_build<T, 14, 15, kAntFeatures>(m, xs, x_stride, ctrl, c_t, c_i, c_k, num_k,
                                                 horizon, c, xo, s);
  if (n_dof == 11 && n_q == 11 && features == kPusherFeatures)
    return launch_build<T, 11, 11, kPusherFeatures>(m, xs, x_stride, ctrl, c_t, c_i, c_k, num_k,
                                                    horizon, c, xo, s);
  if (n_dof == 23 && n_q == 24 && features == kHumanoidFeatures)
    return launch_build<T, 23, 24, kHumanoidFeatures>(m, xs, x_stride, ctrl, c_t, c_i, c_k,
                                                      num_k, horizon, c, xo, s);
  if (n_dof == 23 && n_q == 24 && features == kStandupFeatures)
    return launch_build<T, 23, 24, kStandupFeatures>(m, xs, x_stride, ctrl, c_t, c_i, c_k,
                                                     num_k, horizon, c, xo, s);
  return static_cast<int>(cudaErrorInvalidValue);
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
