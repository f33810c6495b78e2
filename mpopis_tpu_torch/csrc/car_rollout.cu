// Fused car-racing rollout costs for 1..kMaxCars cars, one thread per sample.
//
// Replaces the Pallas TPU kernel mpopis_tpu/kernels/car_rollout.py::_make_kernel
// (launched at car_rollout.py:334). For each of K candidate control sequences
// it integrates T action steps x n_sub semi-implicit Euler substeps of the
// brush-tire bicycle model per car, queries the subsampled track centerline
// after every action step, and accumulates cost = sum_t -reward(s_t), with the
// joint pairwise-distance and -11000 collision terms for several cars.
//
// Design
// - One thread per sample. Every car's state (x, y, psi, Vx, Vy, psi_dot,
//   delta) and the running cost stay in registers for the whole horizon
//   (the car count is a template parameter, so the state arrays unroll).
// - Controls are read in the (T, 2*num_cars, K) layout: for a fixed (t, a)
//   consecutive threads read consecutive addresses, so every load coalesces.
//   The ragged tail of K is masked; nothing is padded or copied.
// - The centerline (xs, ys, widths: 3*M values) is copied into shared memory
//   once per block. Every thread sweeps the same point m in lockstep, so each
//   read is a shared-memory broadcast.
// - Physics constants arrive as one by-value struct argument.
// - The maths is a direct transcription of the plain PyTorch version
//   (mpopis_tpu_torch/models/car_racing.py::step_car_state / car_reward):
//   native atan2/tan/atan for the slip angles and the tire threshold, sin/cos
//   of delta, and the heading wrapped by atan2(sin psi, cos psi) each substep.
//   The TPU kernel's slip-angle identities (_tire_fy_sc) and its sin/cos
//   heading rotation are NOT used. So the double instantiation agrees with the
//   plain version in float64 up to rounding (FMA contraction, library ulps),
//   amplified by the dynamics: chip_smoke.py pins it at rtol 1e-9. The float
//   instantiation is the main path; long float horizons cross the -1e6
//   off-track and -5000 sideslip steps on a few samples, so float32 is held to
//   the JAX kernel tests' rtol 2e-4 / atol 2e-3 at short horizons and by its
//   median relative error at the full one. Built without --use_fast_math.
//
// What bounds it on an H100: instruction latency of FP32 + SFU work. Each
// substep evaluates ~10 transcendentals (3 atan2, 2 tan, 2 atan, sin/cos of
// delta and psi) in a long dependent chain; per call at K=8192, H=50 that is
// 8192 x 500 substeps, while the control reads are only
// 8192 x 50 x 2 x 4 B = 3.3 MB. Known occupancy caveat: K=8192 at 64 threads
// per block is 128 blocks on 132 SMs, i.e. ~2 warps per SM, far too few to
// hide the chain's latency. kBlock = 64 at least covers the SMs; the real fix
// (more independent work per SM) is left to a later performance change.
//
// Interface: a plain C function per dtype, loaded with ctypes. It launches on
// the given stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kMaxCars = 4;
constexpr int kBlock = 64;
constexpr int kNumParams = 27;  // entries of the host's double parameter array

template <typename T>
struct CarConsts {
  T m, i_zz, h_cm, l_f, l_r, c_d0, c_d1, c_af, c_ar, mu_f, mu_r;
  T delta_max, delta_dot_max, fx_max, fx_min, lambda_brake, lambda_drive;
  T beta_limit, dt, ddt;
  T ll;                    // l_r + l_f
  T fz_f0, fz_r0;          // m*l_r*g, m*l_f*g
  T c_af2, c_af3, c_ar2, c_ar3;  // c_a^2, c_a^3 (computed in double on the host)
  int n_sub;
};

__device__ __forceinline__ float d_atan2(float y, float x) { return atan2f(y, x); }
__device__ __forceinline__ double d_atan2(double y, double x) { return atan2(y, x); }
__device__ __forceinline__ float d_atan(float x) { return atanf(x); }
__device__ __forceinline__ double d_atan(double x) { return atan(x); }
__device__ __forceinline__ float d_tan(float x) { return tanf(x); }
__device__ __forceinline__ double d_tan(double x) { return tan(x); }
__device__ __forceinline__ float d_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double d_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float d_abs(float x) { return fabsf(x); }
__device__ __forceinline__ double d_abs(double x) { return fabs(x); }
__device__ __forceinline__ void d_sincos(float x, float* s, float* c) { sincosf(x, s, c); }
__device__ __forceinline__ void d_sincos(double x, double* s, double* c) { sincos(x, s, c); }

template <typename T>
__device__ __forceinline__ T d_sign(T x) {
  return x > T(0) ? T(1) : (x < T(0) ? T(-1) : x);  // sign(0) = 0, NaN stays
}

// Brush tire lateral force (plain version: models/car_racing.py::_tire_fy).
template <typename T>
__device__ __forceinline__ T tire_fy(T alpha, T mu, T c_a, T c_a2, T c_a3, T fz, T fx) {
  const T mf = mu * fz;
  const T fy2 = mf * mf - fx * fx;
  const T fy_max = d_sqrt(fy2 < T(1e-8) ? T(1e-8) : fy2);
  const T ta = d_tan(alpha);
  const T cubic = -c_a * ta + (c_a2 / (T(3) * fy_max)) * d_abs(ta) * ta -
                  (c_a3 / (T(27) * (fy_max * fy_max))) * (ta * ta * ta);
  const T saturated = -fy_max * d_sign(alpha);
  return d_abs(alpha) < d_atan(T(3) * fy_max / c_a) ? cubic : saturated;
}

// One action step = n_sub substeps (plain version: step_car_state).
template <typename T>
__device__ __forceinline__ void advance_car(T& x, T& y, T& psi, T& vx, T& vy, T& psid,
                                            T& delta, T steer, T pedal,
                                            const CarConsts<T>& c) {
  const T target = steer * c.delta_max;
  const T commanded = d_abs(target - delta) / c.dt;
  const T ddelta =
      (commanded > c.delta_dot_max ? c.delta_dot_max : commanded) * d_sign(target - delta);
  const T lam = pedal <= T(0) ? c.lambda_brake : c.lambda_drive;
  const T accel = c.fx_max * (pedal < T(0) ? T(0) : pedal);
  const T brake_pedal = c.fx_min * (pedal > T(0) ? T(0) : pedal);

  for (int i = 0; i < c.n_sub; ++i) {
    delta = delta + ddelta * c.ddt;
    const T alpha_f = d_atan2(vy + c.l_f * psid, vx) - delta;
    const T alpha_r = d_atan2(vy - c.l_r * psid, vx);
    const T sgn_vx = d_sign(vx);
    const T fx_aero = (c.c_d0 + c.c_d1 * d_abs(vx)) * sgn_vx;
    const T fx = accel + brake_pedal * sgn_vx;
    const T fxf = lam * fx;
    const T fxr = (T(1) - lam) * fx;
    const T fzf = (c.fz_f0 - c.h_cm * fx) / c.ll;
    const T fzr = (c.fz_r0 + c.h_cm * fx) / c.ll;
    const T fyf = tire_fy(alpha_f, c.mu_f, c.c_af, c.c_af2, c.c_af3, fzf, fxf);
    const T fyr = tire_fy(alpha_r, c.mu_r, c.c_ar, c.c_ar2, c.c_ar3, fzr, fxr);
    T sin_d, cos_d;
    d_sincos(delta, &sin_d, &cos_d);
    const T psidd = (c.l_f * (fxf * sin_d + fyf * cos_d) - c.l_r * fyr) / c.i_zz;
    const T vy_dot = (fyf * cos_d + fxf * sin_d + fyr) / c.m - psid * vx;
    const T vx_dot = (fxf * cos_d - fyf * sin_d + fxr - fx_aero) / c.m + psid * vy;
    psid = psid + psidd * c.ddt;
    vx = vx + vx_dot * c.ddt;
    vy = vy + vy_dot * c.ddt;
    psi = psi + psid * c.ddt;
    T sin_p, cos_p;
    d_sincos(psi, &sin_p, &cos_p);
    psi = d_atan2(sin_p, cos_p);
    d_sincos(psi, &sin_p, &cos_p);
    x = x + (vx * cos_p - vy * sin_p) * c.ddt;
    y = y + (vx * sin_p + vy * cos_p) * c.ddt;
  }
}

// Per-car reward on the post-step state (plain version: car_reward), with
// the nearest-point query of models/track.py::distance_query.
template <typename T>
__device__ __forceinline__ T car_reward(T x, T y, T vx, T vy, const T* __restrict__ txs,
                                        const T* __restrict__ tys,
                                        const T* __restrict__ tws, int m_track,
                                        const CarConsts<T>& c) {
  // nearest centerline point: first index among equal minima
  T best = T(0);
  int bi = 0;
  for (int m = 0; m < m_track; ++m) {
    const T dx = txs[m] - x;
    const T dy = tys[m] - y;
    const T d2 = dx * dx + dy * dy;
    if (m == 0 || d2 < best) {
      best = d2;
      bi = m;
    }
  }
  const int im1 = (bi - 1 + m_track) % m_track;
  const int ip1 = (bi + 1) % m_track;
  const T ax = txs[im1] - x, ay = tys[im1] - y;
  const T bx = txs[ip1] - x, by = tys[ip1] - y;
  const T dist_m1 = d_sqrt(ax * ax + ay * ay);
  const T dist_p1 = d_sqrt(bx * bx + by * by);
  const int i2 = dist_m1 <= dist_p1 ? im1 : ip1;
  const T p1x = txs[bi], p1y = tys[bi];
  const T segx = txs[i2] - p1x, segy = tys[i2] - p1y;
  const T t = ((x - p1x) * segx + (y - p1y) * segy) / (segx * segx + segy * segy);
  const T ex = p1x + t * segx - x;
  const T ey = p1y + t * segy - y;
  const T dist = d_sqrt(ex * ex + ey * ey);

  const T beta = d_atan2(vy, vx);
  T rew = dist < tws[bi] ? T(0) : T(-1000000.0);
  rew = rew + (d_abs(beta) > c.beta_limit ? T(-5000.0) : T(0));
  rew = rew - dist;
  rew = rew + T(2) * d_sqrt(vx * vx + vy * vy);
  return rew;
}

template <typename T, int NC>
__global__ void __launch_bounds__(kBlock)
car_rollout_kernel(const T* __restrict__ state0, const T* __restrict__ track, int m_track,
                   const T* __restrict__ controls, T* __restrict__ costs, int num_k,
                   int horizon, const CarConsts<T> c) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_track = reinterpret_cast<T*>(smem_raw);
  for (int i = threadIdx.x; i < 3 * m_track; i += blockDim.x) s_track[i] = track[i];
  __syncthreads();

  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= num_k) return;
  const T* txs = s_track;
  const T* tys = s_track + m_track;
  const T* tws = s_track + 2 * m_track;

  T x[NC], y[NC], psi[NC], vx[NC], vy[NC], psid[NC], delta[NC];
#pragma unroll
  for (int ci = 0; ci < NC; ++ci) {
    x[ci] = state0[8 * ci + 0];
    y[ci] = state0[8 * ci + 1];
    psi[ci] = state0[8 * ci + 2];
    vx[ci] = state0[8 * ci + 3];
    vy[ci] = state0[8 * ci + 4];
    psid[ci] = state0[8 * ci + 5];
    delta[ci] = state0[8 * ci + 6];
  }

  const size_t stride = static_cast<size_t>(num_k);
  T cost = T(0);
  for (int t = 0; t < horizon; ++t) {
    const T* ctrl_t = controls + static_cast<size_t>(t) * (2 * NC) * stride + k;
#pragma unroll
    for (int ci = 0; ci < NC; ++ci) {
      const T steer = ctrl_t[(2 * ci) * stride];
      const T pedal = ctrl_t[(2 * ci + 1) * stride];
      advance_car(x[ci], y[ci], psi[ci], vx[ci], vy[ci], psid[ci], delta[ci], steer, pedal,
                  c);
    }
    T rew = T(0);
#pragma unroll
    for (int ci = 0; ci < NC; ++ci)
      rew = rew + car_reward(x[ci], y[ci], vx[ci], vy[ci], txs, tys, tws, m_track, c);
    // joint terms: pairwise distance and collision
#pragma unroll
    for (int i = 0; i < NC; ++i) {
#pragma unroll
      for (int j = i + 1; j < NC; ++j) {
        const T dx = x[i] - x[j];
        const T dy = y[i] - y[j];
        const T dd = d_sqrt(dx * dx + dy * dy + T(1e-30));
        rew = rew - dd;
        rew = rew - (dd <= T(4) ? T(11000.0) : T(0));
      }
    }
    cost = cost - rew;
  }
  costs[k] = cost;
}

template <typename T>
CarConsts<T> make_consts(const double* p, int n_sub) {
  CarConsts<T> c;
  T* fields[kNumParams] = {&c.m,     &c.i_zz,      &c.h_cm,          &c.l_f,
                           &c.l_r,   &c.c_d0,      &c.c_d1,          &c.c_af,
                           &c.c_ar,  &c.mu_f,      &c.mu_r,          &c.delta_max,
                           &c.delta_dot_max,       &c.fx_max,        &c.fx_min,
                           &c.lambda_brake,        &c.lambda_drive,  &c.beta_limit,
                           &c.dt,    &c.ddt,       &c.ll,            &c.fz_f0,
                           &c.fz_r0, &c.c_af2,     &c.c_af3,         &c.c_ar2,
                           &c.c_ar3};
  for (int i = 0; i < kNumParams; ++i) *fields[i] = static_cast<T>(p[i]);
  c.n_sub = n_sub;
  return c;
}

template <typename T>
int launch(const void* state0, const void* track, int m_track, const void* controls,
           void* costs, int num_k, int horizon, int num_cars, const double* params,
           int n_sub, void* stream) {
  if (num_k < 1 || horizon < 0 || m_track < 1 || num_cars < 1 || num_cars > kMaxCars)
    return static_cast<int>(cudaErrorInvalidValue);
  const CarConsts<T> c = make_consts<T>(params, n_sub);
  const dim3 grid((num_k + kBlock - 1) / kBlock);
  const size_t smem = 3 * static_cast<size_t>(m_track) * sizeof(T);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* s0 = static_cast<const T*>(state0);
  const T* tr = static_cast<const T*>(track);
  const T* ctrl = static_cast<const T*>(controls);
  T* out = static_cast<T*>(costs);
  switch (num_cars) {
    case 1:
      car_rollout_kernel<T, 1><<<grid, kBlock, smem, s>>>(s0, tr, m_track, ctrl, out, num_k,
                                                          horizon, c);
      break;
    case 2:
      car_rollout_kernel<T, 2><<<grid, kBlock, smem, s>>>(s0, tr, m_track, ctrl, out, num_k,
                                                          horizon, c);
      break;
    case 3:
      car_rollout_kernel<T, 3><<<grid, kBlock, smem, s>>>(s0, tr, m_track, ctrl, out, num_k,
                                                          horizon, c);
      break;
    default:
      car_rollout_kernel<T, 4><<<grid, kBlock, smem, s>>>(s0, tr, m_track, ctrl, out, num_k,
                                                          horizon, c);
      break;
  }
  return static_cast<int>(cudaGetLastError());
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
