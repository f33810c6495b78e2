// Per-sample device code of the car rollout kernel (csrc/car_rollout.cu): the
// brush-tire bicycle model's action step and the reward, written once for
// the card and for the host. tests/car_host_check.cpp builds it with g++ and
// holds it against the plain PyTorch version
// (mpopis_tpu_torch/models/car_racing.py::step_car_state / car_reward).
//
// Against the plain version the substep is rewritten with identities that
// are exact up to rounding, so that the chain from one substep's (vx, vy,
// psi_dot) to the next one's holds one divide and a few multiply-adds:
// - the slip angle alpha = atan2(Y, X) - delta enters the tire model only
//   through tan(alpha), sign(alpha) and |alpha| < atan(q). With
//   (s, c) = (Y cos d - X sin d, X cos d + Y sin d) = h (sin alpha, cos alpha),
//   h > 0, tan(alpha) = s / c, and |alpha| < atan(q) <=> c > 0 and |s / c| < q
//   (alpha lies in (-pi - delta_max, pi + delta_max], where cos alpha > 0
//   only on (-pi/2, pi/2)). sign(alpha) is sign(s), save past +-pi (see
//   slip_sign). (Y, X) = (0, 0), where atan2 gives 0, is taken as (0, 1);
//   an input of -0 is taken as +0;
// - the forces that depend only on sign(vx) and the pedal (the loads, the
//   friction circle's fy_max and the tire polynomial's coefficients) are
//   computed with the plain version's arithmetic in the first substep of an
//   action step, and again only where sign(vx) takes a value not seen in
//   the action step yet (a sample braking at rest flips it every substep:
//   the two signs' forces are both kept);
// - the selections (in range or saturated, the sign past +-pi) are selects,
//   so that a substep has no branch but the sign's and the IEEE quotient's
//   slow path;
// - delta advances by the constant delta_dot dt of the action step, so
//   (sin delta, cos delta) is rotated by (sin, cos) of that step;
// - the heading enters only through (sin psi, cos psi): the plain version's
//   wrap atan2(sin psi, cos psi) feeds nothing else. It is carried as that
//   pair, rotated each substep by sincos(psi_dot dt) and renormalized once
//   per action step;
// - the divisions by m and I_zz are products with their reciprocals.
// No polynomial stands in for a library function, and nothing is built with
// --use_fast_math.

#pragma once

#include <math.h>

#ifdef __CUDACC__
#define CAR_HD __host__ __device__ __forceinline__
#else
#define CAR_HD inline
#endif

// Phase stamps (scripts/car_phase_times.py): the script builds a copy with
// CAR_STAMP and CAR_STAMP_START defined, which charge the time since the
// previous stamp to a phase; otherwise a stamp is nothing.
enum CarPhase { kCarDynamics, kCarSweep, kCarReward, kCarWait, kCarPhases };
#ifndef CAR_STAMP
#define CAR_STAMP(phase) ((void)0)
#define CAR_STAMP_START() ((void)0)
#endif

namespace car {

constexpr int kMaxCars = 4;
constexpr int kNumParams = 27;  // entries of the host's double parameter array

template <typename T>
struct CarConsts {
  T m, i_zz, h_cm, l_f, l_r, c_d0, c_d1, c_af, c_ar, mu_f, mu_r;
  T delta_max, delta_dot_max, fx_max, fx_min, lambda_brake, lambda_drive;
  T beta_limit, dt, ddt;
  T ll;                          // l_r + l_f
  T fz_f0, fz_r0;                // m*l_r*g, m*l_f*g
  T c_af2, c_af3, c_ar2, c_ar3;  // c_a^2, c_a^3 (computed in double on the host)
  T inv_m, inv_i_zz;             // 1/m, 1/I_zz (in double on the host)
  int n_sub;
};

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
  c.inv_m = static_cast<T>(1.0 / p[0]);
  c.inv_i_zz = static_cast<T>(1.0 / p[1]);
  c.n_sub = n_sub;
  return c;
}

CAR_HD float c_sqrt(float x) { return sqrtf(x); }
CAR_HD double c_sqrt(double x) { return sqrt(x); }
CAR_HD float c_abs(float x) { return fabsf(x); }
CAR_HD double c_abs(double x) { return fabs(x); }
CAR_HD float c_atan2(float y, float x) { return atan2f(y, x); }
CAR_HD double c_atan2(double y, double x) { return atan2(y, x); }
CAR_HD void c_sincos(float x, float* s, float* c) {
#ifdef __CUDA_ARCH__
  sincosf(x, s, c);
#else
  *s = sinf(x);
  *c = cosf(x);
#endif
}
CAR_HD void c_sincos(double x, double* s, double* c) {
#ifdef __CUDA_ARCH__
  sincos(x, s, c);
#else
  *s = sin(x);
  *c = cos(x);
#endif
}

template <typename T>
CAR_HD T c_sign(T x) {
  return x > T(0) ? T(1) : (x < T(0) ? T(-1) : x);  // sign(0) = 0, NaN stays
}

// The forces of an action step at one sign of vx: the axles' drive and
// brake forces, the friction circles' fy_max, and the tire polynomials'
// coefficients k1 = c_a^2 / (3 fy_max), k2 = c_a^3 / (27 fy_max^2) and
// bounds q = 3 fy_max / c_a. sgn = 2: not set.
template <typename T>
struct SignForces {
  T sgn, fxf, fxr, fym_f, fym_r, k1_f, k2_f, k1_r, k2_r, q_f, q_r;
};

// One car: the state the substeps carry, the action step's constants, and
// its forces at the current sign of vx and at the last other one (a sample
// braking at rest flips sign(vx) every substep).
template <typename T>
struct Car {
  T x, y, vx, vy, psid, delta;
  T sin_p, cos_p;  // heading
  // action step
  T lam, accel, brake_pedal;
  T e, sin_e, cos_e;  // delta's advance in one substep, and its rotation
  T sin_d, cos_d;  // delta of the next substep
  SignForces<T> f, f_other;
};

// The forces at sign(vx) = s, with the plain version's arithmetic
// (models/car_racing.py::step_car_state and _tire_fy).
template <typename T>
CAR_HD SignForces<T> sign_forces(const Car<T>& car, T s, const CarConsts<T>& c) {
  SignForces<T> f;
  const T fx = car.accel + car.brake_pedal * s;
  f.sgn = s;
  f.fxf = car.lam * fx;
  f.fxr = (T(1) - car.lam) * fx;
  const T fzf = (c.fz_f0 - c.h_cm * fx) / c.ll;
  const T fzr = (c.fz_r0 + c.h_cm * fx) / c.ll;
  const T mf = c.mu_f * fzf, mr = c.mu_r * fzr;
  const T f2 = mf * mf - f.fxf * f.fxf, r2 = mr * mr - f.fxr * f.fxr;
  f.fym_f = c_sqrt(f2 < T(1e-8) ? T(1e-8) : f2);
  f.fym_r = c_sqrt(r2 < T(1e-8) ? T(1e-8) : r2);
  f.k1_f = c.c_af2 / (T(3) * f.fym_f);
  f.k2_f = c.c_af3 / (T(27) * (f.fym_f * f.fym_f));
  f.k1_r = c.c_ar2 / (T(3) * f.fym_r);
  f.k2_r = c.c_ar3 / (T(27) * (f.fym_r * f.fym_r));
  f.q_f = T(3) * f.fym_f / c.c_af;
  f.q_r = T(3) * f.fym_r / c.c_ar;
  return f;
}

// car.f at the sign s of vx: the other sign's forces if they are cached,
// else computed (the current ones kept as the other).
template <typename T>
CAR_HD void set_sign(Car<T>& car, T s, const CarConsts<T>& c) {
  const SignForces<T> cur = car.f;
  if (car.f_other.sgn == s) {
    car.f = car.f_other;
  } else {
    car.f = sign_forces(car, s, c);
  }
  car.f_other = cur;
}

template <typename T>
CAR_HD void load_car(Car<T>& car, const T* s) {
  car.x = s[0];
  car.y = s[1];
  c_sincos(s[2], &car.sin_p, &car.cos_p);
  car.vx = s[3];
  car.vy = s[4];
  car.psid = s[5];
  car.delta = s[6];
}

// The action step's constants, and (sin, cos) of delta after the first
// substep.
template <typename T>
CAR_HD void begin_action(Car<T>& car, T steer, T pedal, const CarConsts<T>& c) {
  const T target = steer * c.delta_max;
  const T commanded = c_abs(target - car.delta) / c.dt;
  const T ddelta = (commanded > c.delta_dot_max ? c.delta_dot_max : commanded) *
                   c_sign(target - car.delta);
  car.lam = pedal <= T(0) ? c.lambda_brake : c.lambda_drive;
  car.accel = c.fx_max * (pedal < T(0) ? T(0) : pedal);
  car.brake_pedal = c.fx_min * (pedal > T(0) ? T(0) : pedal);
  car.e = ddelta * c.ddt;
  c_sincos(car.e, &car.sin_e, &car.cos_e);
  car.delta = car.delta + car.e;  // the first substep's delta
  c_sincos(car.delta, &car.sin_d, &car.cos_d);
  car.f.sgn = T(2);  // not set: the first substep sets them
  car.f_other.sgn = T(2);
}

// sign(alpha) of alpha = atan2(y, x) - delta from its scaled components
// (s, cs): sign(s), save where alpha passes +-pi (x < 0 only). alpha > pi
// <=> x < 0, y >= 0 and s < 0; alpha < -pi <=> x < 0, y < 0 and s > 0; alpha
// = +-pi (s = 0, cs < 0) takes the sign of y, as atan2 puts theta in (-pi,
// pi]. Selects, not branches (the tests are on bools, not short-circuit).
template <typename T>
CAR_HD T slip_sign(T s, T cs, T y, T x) {
  const bool at_pi = (cs < T(0)) & (s == T(0));
  const bool above_pi = (x < T(0)) & (y >= T(0)) & (s < T(0));
  const bool below_pi = (x < T(0)) & (y < T(0)) & (s > T(0));
  T sgn = at_pi ? (y >= T(0) ? T(1) : T(-1)) : c_sign(s);
  sgn = above_pi ? T(1) : sgn;
  return below_pi ? T(-1) : sgn;
}

// The brush tire's lateral force from the slip angle's components (s, cs)
// (plain version: _tire_fy). k1 = c_a^2 / (3 fy_max), k2 = c_a^3 /
// (27 fy_max^2), q = 3 fy_max / c_a.
template <typename T>
CAR_HD T tire_fy_sc(T s, T cs, T y, T x, T c_a, T k1, T k2, T q, T fy_max) {
  const T ta = s / cs;
  const T ata = c_abs(ta);
  const T cubic = -c_a * ta + k1 * ata * ta - k2 * (ta * ta * ta);
  const T saturated = -fy_max * slip_sign(s, cs, y, x);
  return (cs > T(0)) & (ata < q) ? cubic : saturated;
}

// One substep of one car (plain version: one pass of step_car_state's loop),
// its forces set for sign(vx).
template <typename T>
CAR_HD void substep(Car<T>& car, const CarConsts<T>& c) {
  const T vx = car.vx, vy = car.vy, psid = car.psid;
  const T sd = car.sin_d, cd = car.cos_d;
  const T y_f = vy + c.l_f * psid;
  const T y_r = vy - c.l_r * psid;
  // atan2(0, 0) = 0: the direction (0, 1)
  const T x_f = y_f == T(0) && vx == T(0) ? T(1) : vx;
  const T x_r = y_r == T(0) && vx == T(0) ? T(1) : vx;
  const T s_f = y_f * cd - x_f * sd;
  const T cs_f = x_f * cd + y_f * sd;
  const SignForces<T>& f = car.f;
  const T fyf = tire_fy_sc(s_f, cs_f, y_f, x_f, c.c_af, f.k1_f, f.k2_f, f.q_f, f.fym_f);
  const T fyr = tire_fy_sc(y_r, x_r, y_r, x_r, c.c_ar, f.k1_r, f.k2_r, f.q_r, f.fym_r);
  const T fx_aero = (c.c_d0 + c.c_d1 * c_abs(vx)) * f.sgn;
  const T psidd = (c.l_f * (f.fxf * sd + fyf * cd) - c.l_r * fyr) * c.inv_i_zz;
  const T vy_dot = (fyf * cd + f.fxf * sd + fyr) * c.inv_m - psid * vx;
  const T vx_dot = (f.fxf * cd - fyf * sd + f.fxr - fx_aero) * c.inv_m + psid * vy;
  car.psid = psid + psidd * c.ddt;
  car.vx = vx + vx_dot * c.ddt;
  car.vy = vy + vy_dot * c.ddt;
  T sq, cq;
  c_sincos(car.psid * c.ddt, &sq, &cq);
  const T sp = car.sin_p * cq + car.cos_p * sq;
  const T cp = car.cos_p * cq - car.sin_p * sq;
  car.sin_p = sp;
  car.cos_p = cp;
  car.x = car.x + (car.vx * cp - car.vy * sp) * c.ddt;
  car.y = car.y + (car.vx * sp + car.vy * cp) * c.ddt;
  // delta of the next substep
  car.sin_d = sd * car.cos_e + cd * car.sin_e;
  car.cos_d = cd * car.cos_e - sd * car.sin_e;
}

// One action step of NC cars: n_sub substeps, the cars' independent chains
// side by side. The forces are set again in a substep where some car's
// sign(vx) is not the one they were set for.
template <typename T, int NC>
CAR_HD void advance_cars(Car<T> (&cars)[NC], const CarConsts<T>& c) {
  for (int i = 0; i < c.n_sub; ++i) {
    bool stale = false;
#pragma unroll
    for (int ci = 0; ci < NC; ++ci) stale |= c_sign(cars[ci].vx) != cars[ci].f.sgn;
    if (stale) {
#pragma unroll
      for (int ci = 0; ci < NC; ++ci) {
        const T s = c_sign(cars[ci].vx);
        if (s != cars[ci].f.sgn) set_sign(cars[ci], s, c);
      }
    }
#pragma unroll
    for (int ci = 0; ci < NC; ++ci) {
      if (i > 0) cars[ci].delta = cars[ci].delta + cars[ci].e;
      substep(cars[ci], c);
    }
  }
#pragma unroll
  for (int ci = 0; ci < NC; ++ci) {  // renormalize the heading's rotation
    const T r = T(1) / c_sqrt(cars[ci].sin_p * cars[ci].sin_p + cars[ci].cos_p * cars[ci].cos_p);
    cars[ci].sin_p *= r;
    cars[ci].cos_p *= r;
  }
}

// Per-car reward on the post-step state (plain version: car_reward), with
// the nearest-point query of models/track.py::distance_query over the M
// centerline points (xs, ys, widths): the first index among equal minima.
template <typename T>
CAR_HD T car_reward(T x, T y, T vx, T vy, const T* txs, const T* tys, const T* tws,
                    int m_track, const CarConsts<T>& c) {
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
  CAR_STAMP(kCarSweep);
  const int im1 = (bi - 1 + m_track) % m_track;
  const int ip1 = (bi + 1) % m_track;
  const T ax = txs[im1] - x, ay = tys[im1] - y;
  const T bx = txs[ip1] - x, by = tys[ip1] - y;
  const T dist_m1 = c_sqrt(ax * ax + ay * ay);
  const T dist_p1 = c_sqrt(bx * bx + by * by);
  const int i2 = dist_m1 <= dist_p1 ? im1 : ip1;
  const T p1x = txs[bi], p1y = tys[bi];
  const T segx = txs[i2] - p1x, segy = tys[i2] - p1y;
  const T t = ((x - p1x) * segx + (y - p1y) * segy) / (segx * segx + segy * segy);
  const T ex = p1x + t * segx - x;
  const T ey = p1y + t * segy - y;
  const T dist = c_sqrt(ex * ex + ey * ey);

  const T beta = c_atan2(vy, vx);
  T rew = dist < tws[bi] ? T(0) : T(-1000000.0);
  rew = rew + (c_abs(beta) > c.beta_limit ? T(-5000.0) : T(0));
  rew = rew - dist;
  rew = rew + T(2) * c_sqrt(vx * vx + vy * vy);
  return rew;
}

// The joint reward of NC cars after an action step: each car's reward, then
// the pairwise distance and the -11000 collision term of every pair (plain
// version: kernels/car_rollout.py::car_rollout_costs_tak_reference).
// State s[ci] = (x, y, vx, vy).
template <typename T, int NC>
CAR_HD T joint_reward(const T (&s)[NC][4], const T* txs, const T* tys, const T* tws,
                      int m_track, const CarConsts<T>& c) {
  T rew = T(0);
#pragma unroll
  for (int ci = 0; ci < NC; ++ci)
    rew = rew + car_reward(s[ci][0], s[ci][1], s[ci][2], s[ci][3], txs, tys, tws, m_track, c);
#pragma unroll
  for (int i = 0; i < NC; ++i) {
#pragma unroll
    for (int j = i + 1; j < NC; ++j) {
      const T dx = s[i][0] - s[j][0];
      const T dy = s[i][1] - s[j][1];
      const T dd = c_sqrt(dx * dx + dy * dy + T(1e-30));
      rew = rew - dd;
      rew = rew - (dd <= T(4) ? T(11000.0) : T(0));
    }
  }
  CAR_STAMP(kCarReward);
  return rew;
}

}  // namespace car
