// Fused car-racing rollout costs for 1..kMaxCars cars: per block, one warp
// integrates 32 samples and a second warp scores them one action step
// behind.
//
// Replaces the Pallas TPU kernel mpopis_tpu/kernels/car_rollout.py::_make_kernel
// (launched at car_rollout.py:334). For each of K candidate control sequences
// it integrates T action steps x n_sub semi-implicit Euler substeps of the
// brush-tire bicycle model per car, queries the subsampled track centerline
// after every action step, and accumulates cost = sum_t -reward(s_t), with the
// joint pairwise-distance and -11000 collision terms for several cars.
//
// What bounds it on an H100: one sample's dependent chain of T x n_sub
// substeps. The arithmetic of a call (K=8192, T=50: 4.1M substeps) is ~0.01
// ms of the card's float32 rate, but each sample's substeps are sequential,
// so the call lasts as long as one sample's chain at any K up to a warp per
// scheduler (K ~ 8k), and at K=150 (the CLI's default) it fills 5 of the
// 132 SMs. The thread-per-sample design before this one ran ~10
// transcendentals per substep on that chain (two atan2, a tan, an atan and a
// sqrt per tire, sincos of delta, and the heading wrap sincos -> atan2 ->
// sincos), and the 48-point track sweep and the reward (13% of a sample's
// time) after each action step: 0.665-0.677 ms at every K from 1 to 16384
// (scripts/car_phase_times.py; H100 80GB HBM3, 700 W).
//
// Design
// - The chain is shortened (csrc/car_dynamics.cuh): the slip angles from
//   their components (a quotient a tire), the loads and tire coefficients
//   cached per sign of vx, delta and the heading advanced as rotations, with
//   identities exact up to rounding, and the substep written without
//   branches but the sign's and the IEEE quotient's slow path. A substep's chain from (vx, vy, psi_dot) to the
//   next is a few multiply-adds, the quotient and the tire's polynomial; the
//   heading's sincos(psi_dot dt) and the position hang off it.
// - The reward is taken off the chain (warp specialization): warp 0 of a
//   block integrates its 32 samples and writes each action step's (x, y, vx,
//   vy) of every car into a ring of kSlots slots in shared memory; warp 1
//   sweeps the centerline (in shared memory, every lane on the same point:
//   broadcasts) and scores them, a slot behind. Named barriers hand a slot
//   over (FULL, integrator -> scorer) and back (EMPTY). Nothing the next
//   action step reads waits for the reward.
// - One block per 32 samples (64 threads): K=8192 is 256 blocks, about two a
//   SM, one warp a scheduler. At K=150 the 5 blocks take 5 SMs; the chain
//   cannot be split, so the call then takes the same time as at K=8192.
// - Controls are read in the (T, 2*num_cars, K) layout, coalesced, one action
//   step ahead of their use. Lanes past K compute on a clamped sample and
//   store nothing, so every barrier sees whole warps.
// - The float instantiation is the main path; long float horizons cross the
//   -1e6 off-track and -5000 sideslip steps on a few samples, so float32 is
//   held to the JAX kernel tests' rtol 2e-4 / atol 2e-3 at short horizons
//   and by its median relative error at the full one; float64 to 1e-9 of the
//   plain version, or sample by sample within 10x the plain version's own
//   spread under nudged inputs. Built without --use_fast_math.
// - 0.145-0.154 ms at K=1 to 8192 and 0.176 at 16384 (T=50, one car;
//   scripts/car_phase_times.py, H100 80GB HBM3, 700 W).

// Interface: a plain C function per dtype, loaded with ctypes. It launches on
// the given stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include "car_dynamics.cuh"

namespace {

using car::Car;
using car::CarConsts;
using car::kMaxCars;
using car::kNumParams;

constexpr int kSamples = 32;            // samples a block: one warp's lanes
constexpr int kThreads = 2 * kSamples;  // the integrating warp and the scoring warp
constexpr int kSlots = 4;               // action steps in flight between the two
constexpr int kBarFull = 1;             // named barriers kBarFull + slot: a slot is written
constexpr int kBarEmpty = kBarFull + kSlots;  // kBarEmpty + slot: a slot is read

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(kThreads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(kThreads) : "memory");
}

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
car_rollout_kernel(const T* __restrict__ state0, const T* __restrict__ track, int m_track,
                   const T* __restrict__ controls, T* __restrict__ costs, int num_k,
                   int horizon, const CarConsts<T> c) {
  // ring[slot][car][field][lane], field (x, y, vx, vy); then the centerline
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  T* s_track = ring + kSlots * NC * 4 * kSamples;
  const int lane = threadIdx.x & 31;
  const int k = min(blockIdx.x * kSamples + lane, num_k - 1);
  CAR_STAMP_START();

  if (threadIdx.x < kSamples) {  // the integrating warp
    Car<T> cars[NC];
#pragma unroll
    for (int ci = 0; ci < NC; ++ci) car::load_car(cars[ci], state0 + 8 * ci);
    const size_t stride = static_cast<size_t>(num_k);
    T steer[NC], pedal[NC];
#pragma unroll
    for (int ci = 0; ci < NC; ++ci) {
      steer[ci] = horizon > 0 ? controls[(2 * ci) * stride + k] : T(0);
      pedal[ci] = horizon > 0 ? controls[(2 * ci + 1) * stride + k] : T(0);
    }
    for (int t = 0; t < horizon; ++t) {
#pragma unroll
      for (int ci = 0; ci < NC; ++ci) car::begin_action(cars[ci], steer[ci], pedal[ci], c);
      if (t + 1 < horizon) {  // the next action step's controls, in flight meanwhile
        const T* ctrl = controls + static_cast<size_t>(t + 1) * (2 * NC) * stride + k;
#pragma unroll
        for (int ci = 0; ci < NC; ++ci) {
          steer[ci] = ctrl[(2 * ci) * stride];
          pedal[ci] = ctrl[(2 * ci + 1) * stride];
        }
      }
      car::advance_cars<T, NC>(cars, c);
      CAR_STAMP(kCarDynamics);
      const int slot = t % kSlots;
      if (t >= kSlots) bar_sync(kBarEmpty + slot);
      CAR_STAMP(kCarWait);
      T* out = ring + slot * NC * 4 * kSamples + lane;
#pragma unroll
      for (int ci = 0; ci < NC; ++ci) {
        out[(4 * ci + 0) * kSamples] = cars[ci].x;
        out[(4 * ci + 1) * kSamples] = cars[ci].y;
        out[(4 * ci + 2) * kSamples] = cars[ci].vx;
        out[(4 * ci + 3) * kSamples] = cars[ci].vy;
      }
      bar_arrive(kBarFull + slot);
    }
    return;
  }

  // the scoring warp
  for (int i = lane; i < 3 * m_track; i += kSamples) s_track[i] = track[i];
  __syncwarp();
  const T* txs = s_track;
  const T* tys = s_track + m_track;
  const T* tws = s_track + 2 * m_track;
  T cost = T(0);
  for (int t = 0; t < horizon; ++t) {
    const int slot = t % kSlots;
    bar_sync(kBarFull + slot);
    CAR_STAMP(kCarWait);
    const T* in = ring + slot * NC * 4 * kSamples + lane;
    T s[NC][4];
#pragma unroll
    for (int ci = 0; ci < NC; ++ci) {
#pragma unroll
      for (int f = 0; f < 4; ++f) s[ci][f] = in[(4 * ci + f) * kSamples];
    }
    if (t + kSlots < horizon) bar_arrive(kBarEmpty + slot);
    cost = cost - car::joint_reward<T, NC>(s, txs, tys, tws, m_track, c);
  }
  if (blockIdx.x * kSamples + lane < num_k) costs[k] = cost;
}

template <typename T, int NC>
cudaError_t launch_cars(dim3 grid, size_t smem, cudaStream_t s, const T* s0, const T* tr,
                        int m_track, const T* ctrl, T* out, int num_k, int horizon,
                        const CarConsts<T>& c) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        car_rollout_kernel<T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  car_rollout_kernel<T, NC><<<grid, kThreads, smem, s>>>(s0, tr, m_track, ctrl, out, num_k,
                                                         horizon, c);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* state0, const void* track, int m_track, const void* controls,
           void* costs, int num_k, int horizon, int num_cars, const double* params,
           int n_sub, void* stream) {
  if (num_k < 1 || horizon < 0 || m_track < 1 || num_cars < 1 || num_cars > kMaxCars)
    return static_cast<int>(cudaErrorInvalidValue);
  const CarConsts<T> c = car::make_consts<T>(params, n_sub);
  const dim3 grid((num_k + kSamples - 1) / kSamples);
  const size_t smem = (kSlots * num_cars * 4 * kSamples + 3 * static_cast<size_t>(m_track)) *
                      sizeof(T);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* s0 = static_cast<const T*>(state0);
  const T* tr = static_cast<const T*>(track);
  const T* ctrl = static_cast<const T*>(controls);
  T* out = static_cast<T*>(costs);
  cudaError_t err;
  switch (num_cars) {
    case 1:
      err = launch_cars<T, 1>(grid, smem, s, s0, tr, m_track, ctrl, out, num_k, horizon, c);
      break;
    case 2:
      err = launch_cars<T, 2>(grid, smem, s, s0, tr, m_track, ctrl, out, num_k, horizon, c);
      break;
    case 3:
      err = launch_cars<T, 3>(grid, smem, s, s0, tr, m_track, ctrl, out, num_k, horizon, c);
      break;
    default:
      err = launch_cars<T, 4>(grid, smem, s, s0, tr, m_track, ctrl, out, num_k, horizon, c);
      break;
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

int car_rollout_max_cars() { return kMaxCars; }
int car_rollout_num_params() { return kNumParams; }

int car_rollout_costs_f32(const void* state0, const void* track, int m_track,
                          const void* controls, void* costs, int num_k, int horizon,
                          int num_cars, const double* params, int n_sub, void* stream) {
  return launch<float>(state0, track, m_track, controls, costs, num_k, horizon, num_cars,
                       params, n_sub, stream);
}

int car_rollout_costs_f64(const void* state0, const void* track, int m_track,
                          const void* controls, void* costs, int num_k, int horizon,
                          int num_cars, const double* params, int n_sub, void* stream) {
  return launch<double>(state0, track, m_track, controls, costs, num_k, horizon, num_cars,
                        params, n_sub, stream);
}

}  // extern "C"
