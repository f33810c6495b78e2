// Planar contact dynamics of one sample, run by the W lanes of a group, for
// the rollout kernels in planar_rollout.cu (HalfCheetah, Hopper, Walker2d:
// TPU kernel 2, mpopis_tpu/kernels/planar_step.py:47 `_make_kernel` with
// `_contact_advance` :92, pallas_call :159) and swimmer_rollout.cu (the
// Swimmer: TPU kernel 3, `_swimmer_rollout_impl` :182, pallas_call :228):
// frames, the analytic mass matrix and bias, the constraint rows (joint
// limits; three rows per plane-capsule contact, the merged normal row at
// R/2; capsule-capsule pairs by Ericson's closest points), the warm-started
// box QP (fixed-iteration active set / CG / projected arc search), the
// Euler-implicit and RK4 substeps, the control step with its locomotion
// reward, the launch of a build, and the host-side reader of the packed
// model.
//
// The arithmetic of the plain PyTorch version
// (mpopis_tpu_torch/models/planar_contact.py). The dof count N is a template
// parameter (5 for the Swimmer, 6 for Hopper, 9 for HalfCheetah and
// Walker2d), so every dof loop unrolls; body b owns hinge dof b + 2. So are
// the integrator (EULER), FLUID (the Swimmer's inertia-box fluid force,
// models/swimmer_device.py::fluid_force, in the smooth force at every
// stage), the row capacity R and the group's width W: a build is one
// model's code alone.
//
// The lanes of one sample (lanes.cuh: an aligned slice of W = 4, 8, 16 or
// 32 lanes of a warp on the card; one lane in the host build of
// tests/planar_host_check.cpp, W = 1, where every lane primitive is the
// identity) share a workspace (Work) in shared memory:
// - every lane carries the state and the actions in registers and computes
//   the same integration and reward;
// - the first lane walks the body chain (the frames) and factors M (at most
//   9 dofs: a chain of square roots that lanes would not shorten);
// - the lanes take the mass matrix's lower-triangle entries and the bias
//   entries, each summed over the bodies in the plain version's order;
// - lane l tests candidate rows l, l + W, ... of each kind and forms the
//   valid ones (J and W = L^-1 J^T, so that no triangular solve is left in
//   the QP), compacted in the model's order by a ballot and popcount;
// - the QP's rows and iterates lie on the lanes, its scalars summed in the
//   plain version's row order with the same bits on every lane, and J^T
//   lambda dof by dof in row order. Up to kDense = 32 valid rows (the dense
//   path, each iterate one register a lane at W = 32) it applies the dense
//   A = W^T W + diag R, formed once a forward pass: each lane stores its
//   entry of the vector once and dots its row of A with the stored vector
//   four entries a load; each lane stores its terms of a sum and every lane
//   adds them up from broadcast loads (one barrier a step, no shuffle); the
//   arc search's six points share one pass over A. Beyond that an
//   application is W^T (W v) and a sum takes a shuffle a row.
// There are no atomics: a sample's result does not depend on scheduling.
// The double instantiation agrees with the plain version to rounding, not
// bit for bit (nvcc contracts multiply-adds into FMAs; the operator is
// W^T W, not J (L L^T)^-1 J^T): near a contact switch the QP turns rounding
// into other iterates, so the contact cases are held by the nudge rule
// (chip_smoke.py, tests/test_torch_cuda.py).
//
// What bounds the kernels on an H100, and what their forward passes spend
// their time on, is in the headers of planar_rollout.cu and
// swimmer_rollout.cu; the thread-per-sample design this replaced kept every
// row array in local memory and spent 62-91% of a contact pass in a QP that
// swept every candidate row (scripts/planar_phase_times.py).
//
// The header compiles as host C++ too (tests/planar_host_check.cpp defines
// the CUDA keywords away), so its arithmetic is checked where there is no
// card.
#pragma once

#include "lanes.cuh"

namespace planar {

using mpopis::Lanes;
using mpopis::lane_value;
using mpopis::popc;

constexpr int kMaxBodies = 7;
constexpr int kMaxDof = kMaxBodies + 2;
constexpr int kMaxContacts = 16;
constexpr int kMaxLimits = 6;
constexpr int kMaxPairs = 3;
constexpr int kMaxRows = kMaxLimits + 3 * kMaxContacts + kMaxPairs;
// the builds' row capacities: the model's own rows (HalfCheetah 6 limits and
// 16 contacts, Walker2d 6 and 14, Hopper 3, 8 and 3 capsule pairs, the
// Swimmer 2 limits)
constexpr int kCheetahRows = 54, kWalkerRows = 48, kHopperRows = 30, kSwimmerRows = 2;
constexpr int kDense = 32;  // valid rows up to which the QP applies a dense A
constexpr int kLadder = 6;  // the arc search's points
// The dense path's vectors (Work::vec): the arc search's points masked to
// the active rows (the first also every other vector A is applied to), the
// rows' terms of f_b = rhs . p(t) and those of f_a = p(t) . A p(t), the
// last also those of the other row-order sums (kSumLg .. kSumDenom). Two
// consecutive steps of the QP use distinct vectors, so a lane may store the
// next one's while another still reads the last one's; one barrier a step.
constexpr int kVecPoint = 0, kVecFb = kLadder, kVecFa = 2 * kLadder, kVecs = 3 * kLadder;
constexpr int kSumLg = kVecFa, kSumRl = kVecFa + 1, kSumRs = kVecFa + 2, kSumDenom = kVecFa + 3;
constexpr int kIntHeader = 10;
constexpr int kDoubleHeader = 9;

// The phases of a forward pass that scripts/planar_phase_times.py times: a
// stamp charges the time since the previous one (or since the sample's
// start) to its phase. The script builds a copy with PLANAR_STAMP and
// PLANAR_STAMP_START defined, and PLANAR_ROWS, which counts each forward
// pass by its valid rows; otherwise each is nothing.
enum Phase {
  kPhFrames, kPhMass, kPhFluid, kPhFactor, kPhRows, kPhApply, kPhQp, kPhIntegrate, kPhases
};
#ifndef PLANAR_STAMP
#define PLANAR_STAMP(phase) ((void)0)
#define PLANAR_STAMP_START() ((void)0)
#endif
#ifndef PLANAR_ROWS
#define PLANAR_ROWS(nv) ((void)0)
#endif

template <typename T>
struct Imp {  // solimp impedance and solref stiffness/damping of one row kind
  T d0e, dspan, width, kc, bc;
};

template <typename T>
struct Body {
  T pax, paz;  // pos + anchor (parent frame)
  T ax, az;    // hinge anchor (own frame)
  T sign, comx, comz, mass, iyy;
  int parent;
  unsigned chain;  // bit e set: body e is on this body's root-ward chain
};

template <typename T>
struct Limit {
  T lo, hi, invweight;
  Imp<T> imp;
  int dof;
};

template <typename T>
struct Contact {
  T lx, lz, radius, mu, margin, bw, rfac;
  Imp<T> imp;
  int body;
};

template <typename T>
struct Pair {
  T a1x, a1z, b1x, b1z, r1, a2x, a2z, b2x, b2z, r2, margin, bw;
  Imp<T> imp;
  int body1, body2;
  unsigned plus, minus;  // hinges of body2's chain only (+), of body1's only (-)
};

template <typename T>
struct Model {
  Body<T> body[kMaxBodies];
  Contact<T> con[kMaxContacts];
  Limit<T> lim[kMaxLimits];
  Pair<T> pair[kMaxPairs];
  T damping[kMaxDof], armature[kMaxDof], stiffness[kMaxDof], h_damping[kMaxDof];
  T gear[kMaxDof];
  T root_x, root_z, gravity, h, h_half, h_sixth, healthy, ctrl_w, inv_dt;
  int n_contacts, n_limits, n_pairs, rk4, frame_skip, outer, cg;
};

// A model with the fluid coefficients, which only FLUID code reads (through
// the Model<T>& it is passed as): viscous force, quadratic drag along and
// across the link axis, viscous and quadratic torque. A struct of its own,
// so that the contact kernels' Model keeps its size.
template <typename T>
struct FluidModel : Model<T> {
  T visc_f, c_par, c_perp, visc_t, c_rot;
};

__device__ __forceinline__ float d_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double d_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float d_abs(float x) { return fabsf(x); }
__device__ __forceinline__ double d_abs(double x) { return fabs(x); }
__device__ __forceinline__ void d_sincos(float x, float* s, float* c) { sincosf(x, s, c); }
__device__ __forceinline__ void d_sincos(double x, double* s, double* c) { sincos(x, s, c); }

// torch.clamp semantics: NaN passes through
template <typename T>
__device__ __forceinline__ T clip(T x, T lo, T hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

template <typename T>
__device__ __forceinline__ T impedance(T pos, const Imp<T>& im) {
  const T x = clip(d_abs(pos) / im.width, T(0), T(1));
  const T y = x < T(0.5) ? T(2) * x * x : T(1) - T(2) * ((T(1) - x) * (T(1) - x));
  return im.d0e + im.dspan * y;
}

// v[i] with i known only at run time, without indexing the register array
template <typename T, int N>
__device__ __forceinline__ T pick(const T (&v)[N], int i) {
  T out = T(0);
#pragma unroll
  for (int d = 0; d < N; ++d) out = d == i ? v[d] : out;
  return out;
}

template <typename T, int N>
__device__ __forceinline__ T dot_row(const T (&j)[N], const T (&v)[N]) {
  T s = T(0);
#pragma unroll
  for (int d = 0; d < N; ++d) s = s + j[d] * v[d];
  return s;
}

// Row i and column j <= i of entry e of a lower triangle counted row by row
// (e = i (i + 1) / 2 + j)
__device__ __forceinline__ void tri_index(int e, int& i, int& j) {
  i = 0;
  while ((i + 1) * (i + 2) / 2 <= e) ++i;
  j = e - i * (i + 1) / 2;
}

// The world frames of the bodies: origin, angle, hinge anchor, cos and sin
template <typename T, int N>
struct Frames {
  static constexpr int NB = N - 2;
  T ox[NB], oz[NB], th[NB], awx[NB], awz[NB], c[NB], s[NB];
};

template <typename T, int N>
__device__ __forceinline__ void compute_frames(const Model<T>& m, const T (&q)[N],
                                               Frames<T, N>& f) {
#pragma unroll
  for (int b = 0; b < N - 2; ++b) {
    const Body<T>& bd = m.body[b];
    const bool off = !(bd.ax == T(0) && bd.az == T(0));
    if (bd.parent < 0) {
      const T bx = q[0] + m.root_x, bz = q[1] + m.root_z;
      f.th[b] = bd.sign * q[b + 2];
      if (!off) {
        f.ox[b] = bx;
        f.oz[b] = bz;
        f.awx[b] = bx;
        f.awz[b] = bz;
      } else {
        T s, c;
        d_sincos(f.th[b], &s, &c);
        f.awx[b] = bx + bd.ax;
        f.awz[b] = bz + bd.az;
        f.ox[b] = f.awx[b] - (c * bd.ax + s * bd.az);
        f.oz[b] = f.awz[b] - (-s * bd.ax + c * bd.az);
      }
    } else {
      const int p = bd.parent;
      const T pox = f.ox[p], poz = f.oz[p], cp = f.c[p], sp = f.s[p];
      f.th[b] = f.th[p] + bd.sign * q[b + 2];
      f.awx[b] = pox + cp * bd.pax + sp * bd.paz;
      f.awz[b] = poz - sp * bd.pax + cp * bd.paz;
      if (!off) {
        f.ox[b] = f.awx[b];
        f.oz[b] = f.awz[b];
      } else {
        T s, c;
        d_sincos(f.th[b], &s, &c);
        f.ox[b] = f.awx[b] - (c * bd.ax + s * bd.az);
        f.oz[b] = f.awz[b] - (-s * bd.ax + c * bd.az);
      }
    }
    d_sincos(f.th[b], &f.s[b], &f.c[b]);
  }
}

// One sample's workspace: its group's slice of dynamic shared memory on the
// card, one static instance in the host build. R is the build's row
// capacity. The rows valid at this state are compacted in the model's row
// order: row i keeps its Jacobian J[i], its column w[i] of W = L^-1 J^T,
// rhs = aref - J a_smooth, its regularizer and idx, its row of the model
// (where its lambda warm start lies in lam_full); the row stride S is odd,
// so that the lanes' rows meet distinct banks.
// With at most D valid rows the QP applies the dense A = W^T W + diag R,
// formed once a forward pass. A's rows lie DS entries apart, whole 16-byte
// pieces: at D = 32 that is 4 words more than a multiple of 32 (36 f32, 34
// f64), so that the 8 lanes of a quarter warp read their rows' 16-byte
// pieces from distinct banks. Once A is formed, w is dead on that path, and
// its room holds the dense path's vectors of DV entries (vec): the vectors A
// is applied to and the lanes' terms of the row-order sums, which every lane
// reads back as broadcasts. Beyond D rows vbuf holds the vector an
// application multiplies, u the W^T-side sums.
template <typename T, int N, int R>
struct alignas(16) Work {
  static constexpr int S = N | 1;
  static constexpr int D = R < kDense ? R : kDense;
  static constexpr int DV = (D + 3) / 4 * 4;
  static constexpr int DS = DV + 16 / static_cast<int>(sizeof(T));
  static_assert(D < kDense || DS * sizeof(T) / 4 % 32 == 4,
                "a quarter warp's rows of A on distinct banks");
  T A[D][DS];
  union {
    T w[R][S];
    T vec[kVecs][DV];
  };
  T J[R][S];
  T rhs[R], reg[R], lam_full[R], vbuf[R];
  int idx[R];
  T M[N][N];  // the mass matrix's lower triangle
  T L[N][N];  // its factor, or that of M + h diag(damping)
  T inv[N];   // 1 / L[i][i]
  T bias[N], u[N], qfrc[N];
  Frames<T, N> f;
};

// The frames of q into wk.f, by the first lane; the other lanes wait.
template <typename T, int N, int R, int W>
__device__ __forceinline__ void frames(const Model<T>& m, const T (&q)[N], Work<T, N, R>& wk) {
  Lanes<W>::sync();  // every lane is done with the previous forward pass
  if (Lanes<W>::lane() == 0) compute_frames(m, q, wk.f);
  Lanes<W>::sync();
}

// Column i of the com Jacobian of a body (chain mask `chain`, com (px, pz)):
// its x and z rows and its angular row.
template <typename T, int N>
__device__ __forceinline__ void com_column(const Model<T>& m, const Frames<T, N>& f,
                                          unsigned chain, int i, T px, T pz, T& jx, T& jz,
                                          T& w) {
  if (i < 2) {
    jx = i == 0 ? T(1) : T(0);
    jz = i == 1 ? T(1) : T(0);
    w = T(0);
    return;
  }
  const int e = i - 2;
  const bool on = (chain >> e) & 1u;
  const T se = m.body[e].sign;
  jx = on ? se * (pz - f.awz[e]) : T(0);
  jz = on ? (-se) * (px - f.awx[e]) : T(0);
  w = on ? se : T(0);
}

// Mass matrix (lower triangle, into wk.M) and bias (wk.bias), each summed
// over the bodies in the plain version's order: armature, then per body
// m (Jx Jx^T + Jz Jz^T) and I w w^T. Every lane propagates the bodies'
// velocities and accelerations at q''=0 down the chain and forms their coms
// and forces; lane l then takes the entries l, l + W, ... of the lower
// triangle (45 at 9 dofs) and the bias entries l, l + W, ...
template <typename T, int N, int R, int W>
__device__ void mass_and_bias(const Model<T>& m, const T (&qv)[N], Work<T, N, R>& wk) {
  constexpr int NB = N - 2;
  const Frames<T, N>& f = wk.f;
  T omega[NB], vax[NB], vaz[NB], aax[NB], aaz[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const Body<T>& bd = m.body[b];
    if (bd.parent < 0) {
      omega[b] = bd.sign * qv[b + 2];
      vax[b] = qv[0];
      vaz[b] = qv[1];
      aax[b] = T(0);
      aaz[b] = T(0);
    } else {
      T po = T(0), pvx = T(0), pvz = T(0), pax = T(0), paz = T(0);
#pragma unroll
      for (int p = 0; p < b; ++p) {
        if (p == bd.parent) {
          po = omega[p];
          pvx = vax[p];
          pvz = vaz[p];
          pax = aax[p];
          paz = aaz[p];
        }
      }
      const int p = bd.parent;
      omega[b] = po + bd.sign * qv[b + 2];
      const T dx = f.awx[b] - f.awx[p], dz = f.awz[b] - f.awz[p];
      vax[b] = pvx + po * dz;
      vaz[b] = pvz - po * dx;
      const T vdx = vax[b] - pvx, vdz = vaz[b] - pvz;
      aax[b] = pax + po * vdz;
      aaz[b] = paz - po * vdx;
    }
  }
  T px[NB], pz[NB], fx[NB], fz[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const Body<T>& bd = m.body[b];
    px[b] = f.ox[b] + f.c[b] * bd.comx + f.s[b] * bd.comz;
    pz[b] = f.oz[b] - f.s[b] * bd.comx + f.c[b] * bd.comz;
    const T rx = px[b] - f.awx[b], rz = pz[b] - f.awz[b];
    const T vpx = vax[b] + omega[b] * rz;
    const T vpz = vaz[b] - omega[b] * rx;
    const T apx = aax[b] + omega[b] * (vpz - vaz[b]);
    const T apz = aaz[b] - omega[b] * (vpx - vax[b]);
    fx[b] = bd.mass * apx;
    fz[b] = bd.mass * (apz + m.gravity);
  }
  constexpr int kEntries = N * (N + 1) / 2;
  const int lane = Lanes<W>::lane();
  for (int e = lane; e < kEntries; e += W) {
    int i, j;
    tri_index(e, i, j);
    T acc = i == j ? m.armature[i] : T(0);
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const Body<T>& bd = m.body[b];
      T jxi, jzi, wi, jxj, jzj, wj;
      com_column(m, f, bd.chain, i, px[b], pz[b], jxi, jzi, wi);
      com_column(m, f, bd.chain, j, px[b], pz[b], jxj, jzj, wj);
      acc = acc + bd.mass * (jxi * jxj + jzi * jzj);
      acc = acc + bd.iyy * wi * wj;
    }
    wk.M[i][j] = acc;
  }
  for (int d = lane; d < N; d += W) {
    T acc = T(0);
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      T jx, jz, w;
      com_column(m, f, m.body[b].chain, d, px[b], pz[b], jx, jz, w);
      acc = acc + (jx * fx[b] + jz * fz[b]);
    }
    wk.bias[d] = acc;
  }
  Lanes<W>::sync();
}

// The inertia-box fluid force of each link pulled back through its com
// Jacobian, added to out; in z-convention (theta_z = -theta, w_z = -w), as
// the plain version's fluid_force. Every lane computes it.
template <typename T, int N>
__device__ __forceinline__ void add_fluid_force(const FluidModel<T>& m, const T (&qv)[N],
                                                const Frames<T, N>& f, T (&out)[N]) {
  constexpr int NB = N - 2;
  T omega[NB], vax[NB], vaz[NB], fq[N];
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const Body<T>& bd = m.body[b];
    if (bd.parent < 0) {
      omega[b] = bd.sign * qv[b + 2];
      vax[b] = qv[0];
      vaz[b] = qv[1];
    } else {
      T po = T(0), pvx = T(0), pvz = T(0);
#pragma unroll
      for (int p = 0; p < b; ++p) {
        if (p == bd.parent) {
          po = omega[p];
          pvx = vax[p];
          pvz = vaz[p];
        }
      }
      const int p = bd.parent;
      omega[b] = po + bd.sign * qv[b + 2];
      vax[b] = pvx + po * (f.awz[b] - f.awz[p]);
      vaz[b] = pvz - po * (f.awx[b] - f.awx[p]);
    }
  }
#pragma unroll
  for (int d = 0; d < N; ++d) fq[d] = T(0);
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const Body<T>& bd = m.body[b];
    const T c = f.c[b], s = f.s[b];
    const T px = f.ox[b] + c * bd.comx + s * bd.comz;
    const T pz = f.oz[b] - s * bd.comx + c * bd.comz;
    const T vpx = vax[b] + omega[b] * (pz - f.awz[b]);
    const T vpz = vaz[b] - omega[b] * (px - f.awx[b]);
    const T sz = -s;  // the z-convention axis is (cos theta_z, sin theta_z) = (c, -s)
    const T v_par = vpx * c + vpz * sz;
    const T v_perp = -vpx * sz + vpz * c;
    const T f_par = -(m.visc_f + m.c_par * d_abs(v_par)) * v_par;
    const T f_perp = -(m.visc_f + m.c_perp * d_abs(v_perp)) * v_perp;
    const T fx = f_par * c - f_perp * sz;
    const T fz = f_par * sz + f_perp * c;
    const T w_z = -omega[b];
    const T tq = -(m.visc_t + m.c_rot * d_abs(w_z)) * w_z;
    fq[0] = fq[0] + fx;
    fq[1] = fq[1] + fz;
#pragma unroll
    for (int e = 0; e < NB; ++e) {
      if (!((bd.chain >> e) & 1u)) continue;
      const T se = m.body[e].sign;
      const T jx = se * (pz - f.awz[e]);
      const T jz = (-se) * (px - f.awx[e]);
      fq[e + 2] = fq[e + 2] + jx * fx + jz * fz - se * tq;
    }
  }
#pragma unroll
  for (int d = 0; d < N; ++d) out[d] = out[d] + fq[d];
}

// wk.L L^T = wk.M (plus h diag(damping) with DAMPED: the Euler-implicit
// velocity update) and wk.inv = 1 / diag(L), by the first lane in registers
// (at most 9 dofs: 45 entries, a chain of N square roots that no lane could
// shorten), column by column as the plain version's unrolled factor, each
// column scaled by its pivot's reciprocal; the other lanes wait.
template <bool DAMPED, typename T, int N, int R, int W>
__device__ __forceinline__ void factor(const Model<T>& m, Work<T, N, R>& wk) {
  if (Lanes<W>::lane() == 0) {
    T a[N][N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j) a[i][j] = wk.M[i][j];
      if (DAMPED) a[i][i] = a[i][i] + m.h_damping[i];
    }
    T inv[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      T d = a[j][j];
#pragma unroll
      for (int k = 0; k < j; ++k) d = d - a[j][k] * a[j][k];
      a[j][j] = d_sqrt(d);
      inv[j] = T(1) / a[j][j];
#pragma unroll
      for (int i = j + 1; i < N; ++i) {
        T s = a[i][j];
#pragma unroll
        for (int k = 0; k < j; ++k) s = s - a[i][k] * a[j][k];
        a[i][j] = s * inv[j];
      }
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j) wk.L[i][j] = a[i][j];
      wk.inv[i] = inv[i];
    }
  }
  Lanes<W>::sync();
}

// x = (L L^T)^-1 b on every lane, L and 1 / diag(L) read from the workspace
template <typename T, int N, int R>
__device__ __forceinline__ void chol_solve(const Work<T, N, R>& wk, const T (&b)[N], T (&x)[N]) {
  T y[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    T s = b[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - wk.L[i][k] * y[k];
    y[i] = s * wk.inv[i];
  }
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    T s = y[i];
#pragma unroll
    for (int k = i + 1; k < N; ++k) s = s - wk.L[k][i] * x[k];
    x[i] = s * wk.inv[i];
  }
}

// Appends the valid row with Jacobian j at compacted position `at`: J, its
// column of W = L^-1 J^T by forward substitution against the factor (every
// lane of the group reads the same L entry at once), rhs = aref - j .
// a_smooth, its regularizer and its row of the model.
template <typename T, int N, int R>
__device__ __forceinline__ void put_row(Work<T, N, R>& wk, int at, const T (&j)[N], T aref, T reg,
                                        int model_row, const T (&a_smooth)[N]) {
  T y[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    T s = j[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - wk.L[i][k] * y[k];
    y[i] = s * wk.inv[i];
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    wk.w[at][i] = y[i];
    wk.J[at][i] = j[i];
  }
  wk.rhs[at] = aref - dot_row(j, a_smooth);
  wk.reg[at] = reg;
  wk.idx[at] = model_row;
}

// The rows valid at (q, qv), compacted in the model's order into the
// workspace (put_row); returns their count. Lane l tests the candidates l,
// l + W, ... of each kind (joint limits; plane-capsule contacts, three rows
// each: the two pyramid rows and the merged normal row at R/2; capsule
// pairs by Ericson's closest points); a ballot and a popcount give each
// valid one its place.
template <typename T, int N, int R, int W>
__device__ int contact_rows(const Model<T>& m, const T (&q)[N], const T (&qv)[N],
                            const T (&a_smooth)[N], Work<T, N, R>& wk) {
  constexpr int NB = N - 2;
  const Frames<T, N>& f = wk.f;
  const int lane = Lanes<W>::lane();
  const unsigned below = Lanes<W>::below();
  int nv = 0;
  for (int c0 = 0; c0 < m.n_limits; c0 += W) {
    const int l = c0 + lane;
    bool valid = false;
    T pos = T(0), sgn = T(1);
    if (l < m.n_limits) {
      const Limit<T>& lm = m.lim[l];
      const T qd = pick(q, lm.dof);
      const T d_lo = qd - lm.lo;
      const T d_hi = lm.hi - qd;
      const bool lower = d_lo < d_hi;
      pos = lower ? d_lo : d_hi;
      sgn = lower ? T(1) : T(-1);
      valid = pos < T(0);
    }
    const unsigned bal = Lanes<W>::ballot(valid);
    if (valid) {
      const Limit<T>& lm = m.lim[l];
      const T imp = impedance(pos, lm.imp);
      T j[N];
#pragma unroll
      for (int d = 0; d < N; ++d) j[d] = (d == lm.dof) ? sgn : T(0);
      put_row(wk, nv + popc(bal & below), j,
              (-lm.imp.bc) * (sgn * pick(qv, lm.dof)) - lm.imp.kc * imp * pos,
              (T(1) - imp) / imp * lm.invweight, l, a_smooth);
    }
    nv += popc(bal);
  }
  const int row_c = m.n_limits;
  for (int c0 = 0; c0 < m.n_contacts; c0 += W) {
    const int ci = c0 + lane;
    bool active = false;
    T px = T(0), dist = T(0);
    if (ci < m.n_contacts) {
      const Contact<T>& ct = m.con[ci];
      const int b = ct.body;
      px = f.ox[b] + f.c[b] * ct.lx + f.s[b] * ct.lz;
      const T pz = f.oz[b] - f.s[b] * ct.lx + f.c[b] * ct.lz;
      dist = pz - ct.radius;
      active = dist < ct.margin;
    }
    const unsigned bal = Lanes<W>::ballot(active);
    if (active) {
      const Contact<T>& ct = m.con[ci];
      const unsigned chain = m.body[ct.body].chain;
      const T cpz = T(0.5) * dist;  // contact point z (midpoint of the overlap)
      T jn[N], jt[N];
      jn[0] = T(0);
      jn[1] = T(1);
      jt[0] = T(1);
      jt[1] = T(0);
#pragma unroll
      for (int e = 0; e < NB; ++e) {
        const bool on = (chain >> e) & 1u;
        const T se = m.body[e].sign;
        jn[e + 2] = on ? (-se) * (px - f.awx[e]) : T(0);
        jt[e + 2] = on ? se * (cpz - f.awz[e]) : T(0);
      }
      const T pos_m = dist - ct.margin;
      const T imp = impedance(pos_m, ct.imp);
      const T reg = (T(1) - imp) / imp * ct.bw * ct.rfac;
      const T jv_n = dot_row(jn, qv);
      const T jv_t = dot_row(jt, qv);
      const T base = (-ct.imp.kc) * imp * pos_m;
      const T nbc = -ct.imp.bc;
      const int at = nv + 3 * popc(bal & below);
      const int row = row_c + 3 * ci;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const T mu = k == 0 ? ct.mu : -ct.mu;
        T j[N];
#pragma unroll
        for (int d = 0; d < N; ++d) j[d] = jn[d] + mu * jt[d];
        put_row(wk, at + k, j, nbc * (jv_n + mu * jv_t) + base, reg, row + k, a_smooth);
      }
      put_row(wk, at + 2, jn, nbc * jv_n + base, T(0.5) * reg, row + 2, a_smooth);
    }
    nv += 3 * popc(bal);
  }
  const int row_p = row_c + 3 * m.n_contacts;
  for (int c0 = 0; c0 < m.n_pairs; c0 += W) {
    const int pi = c0 + lane;
    bool valid = false;
    T nx = T(0), nz = T(0), cx = T(0), cz = T(0), dist = T(0);
    if (pi < m.n_pairs) {
      const Pair<T>& pr = m.pair[pi];
      const int b1 = pr.body1, b2 = pr.body2;
      const T o1x = f.ox[b1], o1z = f.oz[b1], c1 = f.c[b1], s1 = f.s[b1];
      const T o2x = f.ox[b2], o2z = f.oz[b2], c2 = f.c[b2], s2 = f.s[b2];
      const T p1x = o1x + c1 * pr.a1x + s1 * pr.a1z, p1z = o1z - s1 * pr.a1x + c1 * pr.a1z;
      const T q1x = o1x + c1 * pr.b1x + s1 * pr.b1z, q1z = o1z - s1 * pr.b1x + c1 * pr.b1z;
      const T p2x = o2x + c2 * pr.a2x + s2 * pr.a2z, p2z = o2z - s2 * pr.a2x + c2 * pr.a2z;
      const T q2x = o2x + c2 * pr.b2x + s2 * pr.b2z, q2z = o2z - s2 * pr.b2x + c2 * pr.b2z;
      // closest points between the two segments (Ericson's algorithm)
      const T d1x = q1x - p1x, d1z = q1z - p1z;
      const T d2x = q2x - p2x, d2z = q2z - p2z;
      const T rx = p1x - p2x, rz = p1z - p2z;
      const T la = d1x * d1x + d1z * d1z;
      const T le = d2x * d2x + d2z * d2z;
      const T lf = d2x * rx + d2z * rz;
      const T lc = d1x * rx + d1z * rz;
      const T lb = d1x * d2x + d1z * d2z;
      const T denom = la * le - lb * lb;
      const T den = denom < T(1e-30) ? T(1e-30) : denom;
      T s_seg = denom > T(1e-12) * la * le ? clip((lb * lf - lc * le) / den, T(0), T(1)) : T(0);
      const T t_raw = (lb * s_seg + lf) / le;
      const T t_seg = clip(t_raw, T(0), T(1));
      s_seg = t_raw < T(0) ? clip(-lc / la, T(0), T(1))
                           : (t_raw > T(1) ? clip((lb - lc) / la, T(0), T(1)) : s_seg);
      const T c1x = p1x + s_seg * d1x, c1z = p1z + s_seg * d1z;
      const T c2x = p2x + t_seg * d2x, c2z = p2z + t_seg * d2z;
      const T dx = c2x - c1x, dz = c2z - c1z;
      const T l2 = dx * dx + dz * dz;
      const T seg_len = d_sqrt(l2 < T(1e-24) ? T(1e-24) : l2);
      nx = dx / seg_len;  // normal: geom1 -> geom2
      nz = dz / seg_len;
      dist = seg_len - pr.r1 - pr.r2;
      cx = c1x + nx * (pr.r1 + T(0.5) * dist);
      cz = c1z + nz * (pr.r1 + T(0.5) * dist);
      valid = dist < pr.margin;
    }
    const unsigned bal = Lanes<W>::ballot(valid);
    if (valid) {
      const Pair<T>& pr = m.pair[pi];
      T j[N];
      j[0] = T(0);
      j[1] = T(0);
#pragma unroll
      for (int e = 0; e < NB; ++e) {
        const T se = m.body[e].sign;
        const T coef = ((pr.plus >> e) & 1u) ? se : (((pr.minus >> e) & 1u) ? -se : T(0));
        j[e + 2] = coef != T(0) ? coef * (nx * (cz - f.awz[e]) - nz * (cx - f.awx[e])) : T(0);
      }
      const T jv = dot_row(j, qv);
      const T pos_m = dist - pr.margin;
      const T imp = impedance(pos_m, pr.imp);
      put_row(wk, nv + popc(bal & below), j, (-pr.imp.bc) * jv - pr.imp.kc * imp * pos_m,
              (T(1) - imp) / imp * pr.bw, row_p + pi, a_smooth);
    }
    nv += popc(bal);
  }
  Lanes<W>::sync();  // the rows are visible to every lane
  return nv;
}

// The sums over the nv rows of terms[k] (row r in slot r / W of lane r mod
// W) in row order, the plain version's serial order, with the same bits on
// every lane of the group, by shuffles (the wide path's): K sums at once,
// their shuffles interleaved.
template <int K, int W, typename T, int SL>
__device__ __forceinline__ void shuffle_sums(const T (&terms)[K][SL], int nv, T (&sums)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) sums[k] = T(0);
#pragma unroll
  for (int s = 0; s < SL; ++s) {
    const int n = nv - s * W < W ? nv - s * W : W;
    for (int l = 0; l < n; ++l) {
      T x[K];
#pragma unroll
      for (int k = 0; k < K; ++k) x[k] = lane_value<W>(terms[k][s], l);
#pragma unroll
      for (int k = 0; k < K; ++k) sums[k] = sums[k] + x[k];
    }
  }
}

// Entries c .. c + 3 of a row in shared memory, 16-byte aligned: one 16-byte
// load in f32, two in f64 (element by element in the host build)
template <typename T>
__device__ __forceinline__ void load4(const T* p, T (&x)[4]) {
#ifdef __CUDACC__
  if constexpr (sizeof(T) == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  } else {
    const double2 u = reinterpret_cast<const double2*>(p)[0];
    const double2 v = reinterpret_cast<const double2*>(p)[1];
    x[0] = u.x;
    x[1] = u.y;
    x[2] = v.x;
    x[3] = v.y;
  }
#else
  for (int i = 0; i < 4; ++i) x[i] = p[i];
#endif
}

// sums[k] = rows[k][0] + ... + rows[k][n - 1] in index order, n <= kDense,
// from 16-byte loads that every lane makes alike (broadcasts): K chains side
// by side. The loop over the pieces stays rolled: unrolled, it cost the
// Hopper's float build 12 bytes of spills.
template <int K, typename T>
__device__ __forceinline__ void row_sums(const T* const (&rows)[K], int n, T (&sums)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) sums[k] = T(0);
  int c = 0;
#pragma unroll 1
  for (int q = 0; q < kDense / 4; ++q, c += 4) {
    if (c + 4 > n) break;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      T x[4];
      load4(rows[k] + c, x);
#pragma unroll
      for (int i = 0; i < 4; ++i) sums[k] = sums[k] + x[i];
    }
  }
  if (c < n) {  // the last n mod 4 entries
#pragma unroll
    for (int k = 0; k < K; ++k) {
      T x[4];
      load4(rows[k] + c, x);
#pragma unroll
      for (int i = 0; i < 3; ++i)
        if (c + i < n) sums[k] = sums[k] + x[i];
    }
  }
}

// The sums over the nv <= D rows of terms[k] in row order, as shuffle_sums
// adds them: each lane stores its rows' terms into the dense path's vectors
// first, first + 1, ...; one barrier; every lane adds each vector up.
template <int K, int W, typename T, int N, int R, int SL>
__device__ __forceinline__ void dense_sums(Work<T, N, R>& wk, int first, const T (&terms)[K][SL],
                                           int nv, T (&sums)[K]) {
  const int lane = Lanes<W>::lane();
#pragma unroll
  for (int s = 0; s < SL; ++s) {
    const int r = lane + s * W;
    if (r < nv) {
#pragma unroll
      for (int k = 0; k < K; ++k) wk.vec[first + k][r] = terms[k][s];
    }
  }
  Lanes<W>::sync();
  const T* rows[K];
#pragma unroll
  for (int k = 0; k < K; ++k) rows[k] = wk.vec[first + k];
  row_sums(rows, nv, sums);
}

// The QP's row-order sums: from the vectors on the dense path, by shuffles
// beyond it
template <bool DENSE, int K, int W, typename T, int N, int R, int SL>
__device__ __forceinline__ void qp_sums(Work<T, N, R>& wk, int first, const T (&terms)[K][SL],
                                        int nv, T (&sums)[K]) {
  if constexpr (DENSE) {
    dense_sums<K, W>(wk, first, terms, nv, sums);
  } else {
    shuffle_sums<K, W>(terms, nv, sums);
  }
}

// acc[j] = the row ar of A dotted with vector j of vecs (DV entries apart)
// over entries 0 .. nv - 1, each in column order; four entries of A a load,
// read once for all NV vectors
template <int NV, int DV, typename T>
__device__ __forceinline__ void dense_dots(const T* ar, const T* vecs, int nv, T (&acc)[NV]) {
#pragma unroll
  for (int j = 0; j < NV; ++j) acc[j] = T(0);
  int c = 0;
#pragma unroll
  for (int q = 0; q < DV / 4; ++q, c += 4) {
    if (c + 4 > nv) break;
    T av[4];
    load4(ar + c, av);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      T xv[4];
      load4(vecs + j * DV + c, xv);
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j] = acc[j] + av[i] * xv[i];
    }
  }
  if (c < nv) {  // the last nv mod 4 entries
    T av[4];
    load4(ar + c, av);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      T xv[4];
      load4(vecs + j * DV + c, xv);
#pragma unroll
      for (int i = 0; i < 3; ++i)
        if (c + i < nv) acc[j] = acc[j] + av[i] * xv[i];
    }
  }
}

// The slots of a lane that can hold one of nv <= kDense rows: one at W = 32
template <int W, int RW>
constexpr int kDenseSlots = (kDense + W - 1) / W < RW ? (kDense + W - 1) / W : RW;

// Row r of A = W^T W + diag R by the lane of row r, for nv <= D rows; once
// its barrier is passed, w is dead and its room holds the vectors
template <int W, int SL, typename T, int N, int R>
__device__ void form_dense(Work<T, N, R>& wk, int nv) {
  const int lane = Lanes<W>::lane();
#pragma unroll
  for (int s = 0; s < SL; ++s) {
    const int r = lane + s * W;
    if (r < nv) {
      T wr[N];
#pragma unroll
      for (int d = 0; d < N; ++d) wr[d] = wk.w[r][d];
      for (int c = 0; c < nv; ++c) {
        T acc = T(0);
#pragma unroll
        for (int d = 0; d < N; ++d) acc = acc + wr[d] * wk.w[c][d];
        wk.A[r][c] = c == r ? acc + wk.reg[r] : acc;
      }
    }
  }
  Lanes<W>::sync();
}

// The row of A that the lane of row r reads: its own, or, for a lane past
// A's D rows (it holds no row; the Hopper's and the Swimmer's groups), row
// 0, whose products it drops
template <int W, int SL, typename T, int N, int R>
__device__ __forceinline__ const T* dense_row(const Work<T, N, R>& wk, int r) {
  constexpr int D = Work<T, N, R>::D;
  if constexpr (W * SL > D) r = r < D ? r : 0;
  return wk.A[r];
}

// out = mask ? A (mask ? v : 0) : 0 over the nv <= D rows: each lane stores
// its rows' entries of v into vector kVecPoint once, then dots its row of A
// with it. No barrier before the stores: the step before each application
// is a row-order sum, whose barrier follows every lane's last read of the
// vector (form_dense's before the first).
template <bool MASK, int W, typename T, int N, int R, int SL>
__device__ __forceinline__ void apply_dense(Work<T, N, R>& wk, int nv, const T (&v)[SL],
                                            const bool (&act)[SL], T (&out)[SL]) {
  PLANAR_STAMP(kPhQp);
  const int lane = Lanes<W>::lane();
  T* vec = wk.vec[kVecPoint];
#pragma unroll
  for (int s = 0; s < SL; ++s) {
    const int r = lane + s * W;
    if (r < nv) vec[r] = (!MASK || act[s]) ? v[s] : T(0);
  }
  Lanes<W>::sync();
#pragma unroll
  for (int s = 0; s < SL; ++s) {
    if (s * W < nv) {
      const int r = lane + s * W;  // a lane past nv dots a row it then drops
      T acc[1];
      dense_dots<1, Work<T, N, R>::DV>(dense_row<W, SL>(wk, r), vec, nv, acc);
      out[s] = (r < nv && (!MASK || act[s])) ? acc[0] : T(0);
    }
  }
  PLANAR_STAMP(kPhApply);
}

// out = mask ? (W^T W + diag R) (mask ? v : 0) : 0 over nv > D rows (slot s
// of lane l is row l + s W): the masked vector goes to wk.vbuf, lane d sums
// W^T's row d (wk.u, in row order) and each row's lane dots its column of W
// with u.
template <bool MASK, int W, typename T, int N, int R, int RW>
__device__ __forceinline__ void apply_wide(Work<T, N, R>& wk, int nv, const T (&v)[RW],
                                           const bool (&act)[RW], T (&out)[RW]) {
  PLANAR_STAMP(kPhQp);
  const int lane = Lanes<W>::lane();
  Lanes<W>::sync();  // every lane has read the previous vector and sums
#pragma unroll
  for (int s = 0; s < RW; ++s) {
    const int r = lane + s * W;
    if (s * W < nv && r < nv) wk.vbuf[r] = (!MASK || act[s]) ? v[s] : T(0);
  }
  Lanes<W>::sync();
  for (int d = lane; d < N; d += W) {
    T acc = T(0);
    for (int c = 0; c < nv; ++c) acc = acc + wk.w[c][d] * wk.vbuf[c];
    wk.u[d] = acc;
  }
  Lanes<W>::sync();
  T u[N];
#pragma unroll
  for (int d = 0; d < N; ++d) u[d] = wk.u[d];
#pragma unroll
  for (int s = 0; s < RW; ++s) {
    const int r = lane + s * W;
    if (s * W < nv) {
      T o = T(0);
      if (r < nv && (!MASK || act[s])) {
#pragma unroll
        for (int d = 0; d < N; ++d) o = o + wk.w[r][d] * u[d];
        o = o + wk.reg[r] * wk.vbuf[r];
      }
      out[s] = o;
    }
  }
  PLANAR_STAMP(kPhApply);
}

template <bool MASK, bool DENSE, int W, typename T, int N, int R, int SL>
__device__ __forceinline__ void apply_rows(Work<T, N, R>& wk, int nv, const T (&v)[SL],
                                           const bool (&act)[SL], T (&out)[SL]) {
  if constexpr (DENSE) {
    apply_dense<MASK, W>(wk, nv, v, act, out);
  } else {
    apply_wide<MASK, W>(wk, nv, v, act, out);
  }
}

__constant__ double kArc[kLadder] = {1.0, 0.5, 0.25, 0.1, 0.03, 0.01};  // arc search ladder

// lam(t) = max(lam + t x, 0), the arc search's point t on a row
template <typename T>
__device__ __forceinline__ T arc_point(T lam, T x, T t) {
  const T v = lam + t * x;
  return v < T(0) ? T(0) : v;
}

// The arc search's kLadder points at once on the dense path: p(t) at each t
// of the ladder, A p(t) from one pass over A's rows, and f_b = rhs . p(t),
// f_a = p(t) . A p(t), each summed in row order: per point the operations
// and order of one masked application and its sums. The points and f_b's
// terms are stored together, f_b summed after the first barrier, f_a's terms
// stored after the pass and summed after the second; p(t) is formed again
// where it is needed. No barrier before the first stores: the step before
// is a row-order sum into another vector.
template <int W, typename T, int N, int R, int SL>
__device__ __forceinline__ void arc_dense(Work<T, N, R>& wk, int nv, const T (&lam)[SL],
                                          const T (&x)[SL], const bool (&act)[SL],
                                          const T (&rhs)[SL], T (&f_a)[kLadder],
                                          T (&f_b)[kLadder]) {
  PLANAR_STAMP(kPhQp);
  const int lane = Lanes<W>::lane();
#pragma unroll
  for (int j = 0; j < kLadder; ++j) {
    const T t = static_cast<T>(kArc[j]);
#pragma unroll
    for (int s = 0; s < SL; ++s) {
      const int r = lane + s * W;
      if (r < nv) {
        const T p = arc_point(lam[s], x[s], t);
        wk.vec[kVecPoint + j][r] = act[s] ? p : T(0);
        wk.vec[kVecFb + j][r] = rhs[s] * p;
      }
    }
  }
  Lanes<W>::sync();
  const T* rows[kLadder];
#pragma unroll
  for (int j = 0; j < kLadder; ++j) rows[j] = wk.vec[kVecFb + j];
  row_sums(rows, nv, f_b);
#pragma unroll
  for (int s = 0; s < SL; ++s) {
    if (s * W < nv) {
      const int r = lane + s * W;
      T acc[kLadder];
      dense_dots<kLadder, Work<T, N, R>::DV>(dense_row<W, SL>(wk, r), wk.vec[kVecPoint], nv,
                                             acc);
      if (r < nv) {
#pragma unroll
        for (int j = 0; j < kLadder; ++j) {
          const T ap = act[s] ? acc[j] : T(0);
          wk.vec[kVecFa + j][r] = arc_point(lam[s], x[s], static_cast<T>(kArc[j])) * ap;
        }
      }
    }
  }
  PLANAR_STAMP(kPhApply);
  Lanes<W>::sync();
#pragma unroll
  for (int j = 0; j < kLadder; ++j) rows[j] = wk.vec[kVecFa + j];
  row_sums(rows, nv, f_a);
}

// Box QP min 1/2 lam^T (J M^-1 J^T + diag R) lam - rhs^T lam, lam >= 0, over
// the nv valid rows: the fixed-iteration active set / CG / projected arc
// search of the plain version's _qp_iterate, each lane holding its rows'
// iterates in SL slots of registers (slot s of lane l is row l + s W; one
// slot on the dense path's W = 32 lanes) and every scalar (f_lg, f_rl, rs,
// denom, f_a, f_b) summed in row order with the same bits on every lane, so
// that all lanes take every branch alike. On the dense path (DENSE: nv <= D)
// each application dots A's rows, each sum adds the rows' terms stored in
// the vectors, and the arc search's points share one pass over A
// (arc_dense); beyond it an application is W^T (W v) + R v, a sum takes a
// shuffle a row and the arc search applies the operator point by point. A
// row that is not valid has lambda = 0 and adds exact zeros to every sum of
// the plain version, so leaving it out changes nothing, and a sample with no
// valid row skips its QP (every iterate would stay 0). wk.lam_full holds the
// warm start of each of the model's nr rows on entry and the solution (0 on
// rows not valid) on exit; wk.qfrc gets J^T lam, dof d summed in row order
// by lane d mod W.
template <int SL, bool DENSE, typename T, int N, int R, int W>
__device__ __forceinline__ void qp_rows(const Model<T>& m, Work<T, N, R>& wk, int nv, int nr) {
  const int lane = Lanes<W>::lane();
  // slots with s W >= nv hold no row on any lane and are skipped
  T lam[SL], rhs[SL], x[SL], res[SL], p[SL], ap[SL];
  bool act[SL];
#pragma unroll
  for (int s = 0; s < SL; ++s) {
    const int r = lane + s * W;
    const bool live = r < nv;
    lam[s] = live ? wk.lam_full[wk.idx[r]] : T(0);
    rhs[s] = live ? wk.rhs[r] : T(0);
    x[s] = res[s] = p[s] = ap[s] = T(0);
    act[s] = false;
  }
  Lanes<W>::sync();  // every warm start is read
  for (int r = lane; r < nr; r += W) wk.lam_full[r] = T(0);
  if (nv > 0) {
    // on the dense path form_dense's barrier orders the zeros before the
    // solution's stores
    if constexpr (DENSE) form_dense<W, SL>(wk, nv);
    for (int it = 0; it < m.outer; ++it) {
      apply_rows<false, DENSE, W>(wk, nv, lam, act, ap);
      T terms[2][SL], sums[2];
#pragma unroll
      for (int s = 0; s < SL; ++s) {
        terms[0][s] = terms[1][s] = T(0);
        if (s * W < nv) {
          const T g = ap[s] - rhs[s];
          act[s] = lane + s * W < nv && (lam[s] > T(0) || g < T(0));
          x[s] = act[s] ? lam[s] : T(0);
          terms[0][s] = lam[s] * g;
          terms[1][s] = rhs[s] * lam[s];
        }
      }
      qp_sums<DENSE, 2, W>(wk, kSumLg, terms, nv, sums);
      T best_f = T(0.5) * sums[0] - T(0.5) * sums[1];
      apply_rows<true, DENSE, W>(wk, nv, x, act, ap);
      T sq[1][SL];
#pragma unroll
      for (int s = 0; s < SL; ++s) {
        sq[0][s] = T(0);
        if (s * W < nv) {
          res[s] = act[s] ? rhs[s] - ap[s] : T(0);
          p[s] = res[s];
          sq[0][s] = res[s] * res[s];
        }
      }
      T rs[1];
      qp_sums<DENSE, 1, W>(wk, kSumRs, sq, nv, rs);
      for (int k = 0; k < m.cg; ++k) {
        apply_rows<true, DENSE, W>(wk, nv, p, act, ap);
#pragma unroll
        for (int s = 0; s < SL; ++s) {
          if (s * W < nv) sq[0][s] = p[s] * ap[s];
        }
        T denom[1];
        qp_sums<DENSE, 1, W>(wk, kSumDenom, sq, nv, denom);
        const T alpha =
            denom[0] > T(1e-30) ? rs[0] / (denom[0] < T(1e-30) ? T(1e-30) : denom[0]) : T(0);
#pragma unroll
        for (int s = 0; s < SL; ++s) {
          if (s * W < nv) {
            x[s] = x[s] + alpha * p[s];
            res[s] = res[s] - alpha * ap[s];
            sq[0][s] = res[s] * res[s];
          }
        }
        T rs_new[1];
        qp_sums<DENSE, 1, W>(wk, kSumRs, sq, nv, rs_new);
        const T beta = rs[0] > T(1e-30) ? rs_new[0] / (rs[0] < T(1e-30) ? T(1e-30) : rs[0])
                                        : T(0);
#pragma unroll
        for (int s = 0; s < SL; ++s) {
          if (s * W < nv) p[s] = res[s] + beta * p[s];
        }
        rs[0] = rs_new[0];
      }
      // projected arc search over the fixed ladder; x becomes delta; the
      // best t is kept by its index and lam(t) formed again from it
#pragma unroll
      for (int s = 0; s < SL; ++s) {
        if (s * W < nv) x[s] = act[s] ? x[s] - lam[s] : T(0);
      }
      int best_a = -1;
      if constexpr (DENSE) {  // the points side by side
        T f_a[kLadder], f_b[kLadder];
        arc_dense<W>(wk, nv, lam, x, act, rhs, f_a, f_b);
#pragma unroll
        for (int a = 0; a < kLadder; ++a) {
          const T f_t = T(0.5) * f_a[a] - f_b[a];
          if (f_t < best_f) {
            best_f = f_t;
            best_a = a;
          }
        }
      } else {  // p holds lam(t)
#pragma unroll 1
        for (int a = 0; a < kLadder; ++a) {
          const T t = static_cast<T>(kArc[a]);
#pragma unroll
          for (int s = 0; s < SL; ++s) {
            if (s * W < nv) p[s] = arc_point(lam[s], x[s], t);
          }
          apply_wide<true, W>(wk, nv, p, act, ap);
#pragma unroll
          for (int s = 0; s < SL; ++s) {
            if (s * W < nv) {
              terms[0][s] = p[s] * ap[s];
              terms[1][s] = rhs[s] * p[s];
            }
          }
          shuffle_sums<2, W>(terms, nv, sums);
          const T f_t = T(0.5) * sums[0] - sums[1];
          if (f_t < best_f) {
            best_f = f_t;
            best_a = a;
          }
        }
      }
      if (best_a >= 0) {
        const T t = static_cast<T>(kArc[best_a]);
#pragma unroll
        for (int s = 0; s < SL; ++s) {
          if (s * W < nv) lam[s] = arc_point(lam[s], x[s], t);
        }
      }
    }
    if constexpr (!DENSE) Lanes<W>::sync();  // every lane is done zeroing lam_full
#pragma unroll
    for (int s = 0; s < SL; ++s) {
      const int r = lane + s * W;
      if (r < nv) wk.lam_full[wk.idx[r]] = lam[s];
    }
  }
  Lanes<W>::sync();
  for (int d = lane; d < N; d += W) {
    T acc = T(0);
    for (int r = 0; r < nv; ++r) acc = acc + wk.J[r][d] * wk.lam_full[wk.idx[r]];
    wk.qfrc[d] = acc;
  }
  Lanes<W>::sync();
  PLANAR_STAMP(kPhQp);
}

// The QP of the nv valid rows: on the dense path (nv <= D, and every nv of a
// build whose row capacity is no more than kDense) or the wide one, each its
// own instance of qp_rows.
template <typename T, int N, int R, int W>
__device__ void solve_qp(const Model<T>& m, Work<T, N, R>& wk, int nv, int nr) {
  constexpr int RW = (R + W - 1) / W;
  if constexpr (R > kDense) {
    if (nv > kDense) {
      qp_rows<RW, false, T, N, R, W>(m, wk, nv, nr);
      return;
    }
  }
  qp_rows<kDenseSlots<W, RW>, true, T, N, R, W>(m, wk, nv, nr);
}

// One constrained forward pass at (q, qv) by the sample's lanes together:
// the acceleration, the same on every lane. M, its factor L, the smooth
// force (the fluid force included when FLUID) and the constraint force;
// wk.lam_full warm-starts the QP and returns its solution. With EULER the QP
// sees the undamped M and the acceleration solves (M + h diag(damping)) acc
// = smooth + qfrc (the Euler-implicit velocity update); else acc = M^-1
// (smooth + qfrc). Kept out of line: RK4 calls it 4 times per substep, and
// inlining each copy made the build several times longer.
template <typename T, int N, bool FLUID, bool EULER, int R, int W>
__device__ __noinline__ void forward(const Model<T>& m, int nr, const T (&q)[N], const T (&qv)[N],
                                     const T (&tau)[N], Work<T, N, R>& wk, T (&acc)[N]) {
  PLANAR_STAMP(kPhIntegrate);
  frames<T, N, R, W>(m, q, wk);
  PLANAR_STAMP(kPhFrames);
  mass_and_bias<T, N, R, W>(m, qv, wk);
  PLANAR_STAMP(kPhMass);
  factor<false, T, N, R, W>(m, wk);
  T smooth[N];
#pragma unroll
  for (int d = 0; d < N; ++d)
    smooth[d] = tau[d] - wk.bias[d] - m.damping[d] * qv[d] - m.stiffness[d] * q[d];
  PLANAR_STAMP(kPhFactor);
  if constexpr (FLUID) add_fluid_force(static_cast<const FluidModel<T>&>(m), qv, wk.f, smooth);
  PLANAR_STAMP(kPhFluid);
  T a_smooth[N];
  chol_solve(wk, smooth, a_smooth);
  PLANAR_STAMP(kPhFactor);
  const int nv = contact_rows<T, N, R, W>(m, q, qv, a_smooth, wk);
  PLANAR_STAMP(kPhRows);
  PLANAR_ROWS(nv);
  solve_qp<T, N, R, W>(m, wk, nv, nr);
#pragma unroll
  for (int d = 0; d < N; ++d) smooth[d] = smooth[d] + wk.qfrc[d];
  if constexpr (EULER) factor<true, T, N, R, W>(m, wk);
  chol_solve(wk, smooth, acc);
  PLANAR_STAMP(kPhFactor);
}

template <typename T, int N, bool FLUID, bool EULER, int R, int W>
__device__ void substep(const Model<T>& m, int nr, T (&q)[N], T (&qv)[N], const T (&tau)[N],
                        Work<T, N, R>& wk) {
  const T h = m.h;
  if constexpr (EULER) {
    T acc[N];
    forward<T, N, FLUID, EULER, R, W>(m, nr, q, qv, tau, wk, acc);
#pragma unroll
    for (int d = 0; d < N; ++d) {
      qv[d] = qv[d] + h * acc[d];
      q[d] = q[d] + h * qv[d];
    }
  } else {
    const T hh = m.h_half;
    T k1v[N], k2v[N], k3v[N], k4v[N], qs[N], vs[N], v2[N], v3[N], v4[N];
    forward<T, N, FLUID, EULER, R, W>(m, nr, q, qv, tau, wk, k1v);
#pragma unroll
    for (int d = 0; d < N; ++d) {
      qs[d] = q[d] + hh * qv[d];
      v2[d] = qv[d] + hh * k1v[d];
    }
    forward<T, N, FLUID, EULER, R, W>(m, nr, qs, v2, tau, wk, k2v);
#pragma unroll
    for (int d = 0; d < N; ++d) {
      qs[d] = q[d] + hh * v2[d];
      v3[d] = qv[d] + hh * k2v[d];
    }
    forward<T, N, FLUID, EULER, R, W>(m, nr, qs, v3, tau, wk, k3v);
#pragma unroll
    for (int d = 0; d < N; ++d) {
      qs[d] = q[d] + h * v3[d];
      v4[d] = qv[d] + h * k3v[d];
    }
    forward<T, N, FLUID, EULER, R, W>(m, nr, qs, v4, tau, wk, k4v);
    const T h6 = m.h_sixth;
#pragma unroll
    for (int d = 0; d < N; ++d) {
      vs[d] = qv[d] + h6 * (k1v[d] + T(2) * k2v[d] + T(2) * k3v[d] + k4v[d]);
      q[d] = q[d] + h6 * (qv[d] + T(2) * v2[d] + T(2) * v3[d] + v4[d]);
      qv[d] = vs[d];
    }
  }
}

// One control step: frame_skip substeps from lambda = 0, lambda chained.
template <typename T, int N, bool FLUID, bool EULER, int R, int W>
__device__ void control_step(const Model<T>& m, int nr, T (&q)[N], T (&qv)[N],
                             const T (&a)[N - 3], Work<T, N, R>& wk) {
  T tau[N];
  tau[0] = T(0);
  tau[1] = T(0);
  tau[2] = T(0);
#pragma unroll
  for (int i = 0; i < N - 3; ++i) tau[i + 3] = m.gear[i] * a[i];
  Lanes<W>::sync();  // every lane is done with the previous step's lambda
  for (int r = Lanes<W>::lane(); r < nr; r += W) wk.lam_full[r] = T(0);
  Lanes<W>::sync();
  for (int s = 0; s < m.frame_skip; ++s) substep<T, N, FLUID, EULER, R, W>(m, nr, q, qv, tau, wk);
}

// What the W lanes of a rollout kernel's group do for sample k: from x0 +
// k * x_stride they apply `horizon` control steps; action i of step t is
// controls[t * c_t + i * c_i + k * c_k], clamped to [-1, 1] for the torque
// (the reward reads it as given, as the plain version does). Every lane
// carries the state (each computes the same values); the first writes
// costs[k] (the rollout entries) or the state to x_out (the step entries,
// horizon 1) where the pointer is not null.
template <typename T, int N, bool FLUID, bool EULER, int R, int W>
__device__ void run_sample(const Model<T>& m, int k, const T* x0, long long x_stride,
                           const T* controls, long long c_t, long long c_i, long long c_k,
                           int horizon, T* costs, T* x_out, Work<T, N, R>& wk) {
  PLANAR_STAMP_START();
  constexpr int NA = N - 3;
  const int nr = m.n_limits + 3 * m.n_contacts + m.n_pairs;
  T q[N], qv[N];
  const T* xk = x0 + k * x_stride;
#pragma unroll
  for (int d = 0; d < N; ++d) {
    q[d] = xk[d];
    qv[d] = xk[N + d];
  }
  T cost = T(0);
  for (int t = 0; t < horizon; ++t) {
    T a[NA], ac[NA];
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      a[i] = controls[t * c_t + i * c_i + k * c_k];
      ac[i] = clip(a[i], T(-1), T(1));
    }
    const T x_before = q[0];
    control_step<T, N, FLUID, EULER, R, W>(m, nr, q, qv, ac, wk);
    T rew = m.healthy + (q[0] - x_before) * m.inv_dt;
#pragma unroll
    for (int i = 0; i < NA; ++i) rew = rew - m.ctrl_w * (a[i] * a[i]);
    cost = cost - rew;
    PLANAR_STAMP(kPhIntegrate);
  }
  if (Lanes<W>::lane() != 0) return;
  if (costs) costs[k] = cost;
  if (x_out) {
    T* xo = x_out + static_cast<long long>(k) * 2 * N;
#pragma unroll
    for (int d = 0; d < N; ++d) {
      xo[d] = q[d];
      xo[N + d] = qv[d];
    }
  }
}

// Reads the flat arrays packed by the wrapper; returns false if their layout
// or counts do not fit (ints: header, then per body parent and chain mask,
// per contact its body, per limit its dof, per pair body1, body2 and the two
// masks; doubles: header, per dof damping, armature, stiffness, h*damping,
// the gears, per body its 9 constants, per limit 8, per contact 12, per pair 17,
// then, for a fluid model (fluid = true, the Swimmer's 5 dofs), its 5 fluid
// coefficients; the contact models have 6 or 9 dofs).
template <typename T>
bool make_model(const int* ip, int n_int, const double* dp, int n_double, bool fluid,
                int* n_dof, Model<T>* out) {
  if (n_int < kIntHeader || n_double < kDoubleHeader) return false;
  Model<T>& m = *out;
  m = Model<T>{};
  const int nd = ip[0], nb = ip[1];
  m.n_contacts = ip[2];
  m.n_limits = ip[3];
  m.n_pairs = ip[4];
  m.rk4 = ip[5];
  m.frame_skip = ip[6];
  m.outer = ip[7];
  m.cg = ip[8];
  const int na = ip[9];
  if ((fluid ? nd != 5 : (nd != 6 && nd != 9)) || nb != nd - 2 || na != nd - 3 || m.n_contacts < 0 ||
      m.n_contacts > kMaxContacts || m.n_limits < 0 || m.n_limits > kMaxLimits ||
      m.n_pairs < 0 || m.n_pairs > kMaxPairs || m.frame_skip < 0 || m.outer < 0 || m.cg < 0)
    return false;
  if (n_int != kIntHeader + 2 * nb + m.n_contacts + m.n_limits + 4 * m.n_pairs) return false;
  if (n_double != kDoubleHeader + 4 * nd + na + 9 * nb + 8 * m.n_limits + 12 * m.n_contacts +
                      17 * m.n_pairs + (fluid ? 5 : 0))
    return false;
  *n_dof = nd;
  const int* ic = ip + kIntHeader;
  const double* dc = dp;
  m.root_x = T(dc[0]);
  m.root_z = T(dc[1]);
  m.gravity = T(dc[2]);
  m.h = T(dc[3]);
  m.h_half = T(dc[4]);
  m.h_sixth = T(dc[5]);
  m.healthy = T(dc[6]);
  m.ctrl_w = T(dc[7]);
  m.inv_dt = T(dc[8]);
  dc += kDoubleHeader;
  for (int d = 0; d < nd; ++d, dc += 4) {
    m.damping[d] = T(dc[0]);
    m.armature[d] = T(dc[1]);
    m.stiffness[d] = T(dc[2]);
    m.h_damping[d] = T(dc[3]);
  }
  for (int i = 0; i < na; ++i) m.gear[i] = T(*dc++);
  auto imp = [](const double* v) {
    return Imp<T>{T(v[0]), T(v[1]), T(v[2]), T(v[3]), T(v[4])};
  };
  for (int b = 0; b < nb; ++b, dc += 9) {
    Body<T>& bd = m.body[b];
    bd.pax = T(dc[0]);
    bd.paz = T(dc[1]);
    bd.ax = T(dc[2]);
    bd.az = T(dc[3]);
    bd.sign = T(dc[4]);
    bd.comx = T(dc[5]);
    bd.comz = T(dc[6]);
    bd.mass = T(dc[7]);
    bd.iyy = T(dc[8]);
    bd.parent = *ic++;
    bd.chain = static_cast<unsigned>(*ic++);
    if (bd.parent >= b) return false;  // parents come first
  }
  for (int l = 0; l < m.n_limits; ++l, dc += 8) {
    Limit<T>& lm = m.lim[l];
    lm.lo = T(dc[0]);
    lm.hi = T(dc[1]);
    lm.invweight = T(dc[2]);
    lm.imp = imp(dc + 3);
    lm.dof = ic[m.n_contacts + l];
  }
  for (int c = 0; c < m.n_contacts; ++c, dc += 12) {
    Contact<T>& ct = m.con[c];
    ct.lx = T(dc[0]);
    ct.lz = T(dc[1]);
    ct.radius = T(dc[2]);
    ct.mu = T(dc[3]);
    ct.margin = T(dc[4]);
    ct.bw = T(dc[5]);
    ct.rfac = T(dc[6]);
    ct.imp = imp(dc + 7);
    ct.body = ic[c];
    if (ct.body < 0 || ct.body >= nb) return false;
  }
  ic += m.n_contacts + m.n_limits;
  for (int p = 0; p < m.n_pairs; ++p, dc += 17, ic += 4) {
    Pair<T>& pr = m.pair[p];
    pr.a1x = T(dc[0]);
    pr.a1z = T(dc[1]);
    pr.b1x = T(dc[2]);
    pr.b1z = T(dc[3]);
    pr.r1 = T(dc[4]);
    pr.a2x = T(dc[5]);
    pr.a2z = T(dc[6]);
    pr.b2x = T(dc[7]);
    pr.b2z = T(dc[8]);
    pr.r2 = T(dc[9]);
    pr.margin = T(dc[10]);
    pr.bw = T(dc[11]);
    pr.imp = imp(dc + 12);
    pr.body1 = ic[0];
    pr.body2 = ic[1];
    pr.plus = static_cast<unsigned>(ic[2]);
    pr.minus = static_cast<unsigned>(ic[3]);
    if (pr.body1 < 0 || pr.body1 >= nb || pr.body2 < 0 || pr.body2 >= nb) return false;
  }
  for (int l = 0; l < m.n_limits; ++l)
    if (m.lim[l].dof < 0 || m.lim[l].dof >= nd) return false;
  return true;
}

// make_model for a fluid model: the packed model, then its 5 fluid
// coefficients, the last doubles.
template <typename T>
bool make_fluid_model(const int* ip, int n_int, const double* dp, int n_double, int* n_dof,
                      FluidModel<T>* out) {
  if (!make_model<T>(ip, n_int, dp, n_double, true, n_dof, out)) return false;
  const double* fc = dp + n_double - 5;
  out->visc_f = T(fc[0]);
  out->c_par = T(fc[1]);
  out->c_perp = T(fc[2]);
  out->visc_t = T(fc[3]);
  out->c_rot = T(fc[4]);
  return true;
}


#ifdef __CUDACC__
constexpr int kMaxWarps = 8;  // warps of a block at most

// The model into the block's shared memory: lanes read it at addresses that
// differ (each its own row), which the kernel parameters' constant bank
// would serialize.
template <typename MT>
__device__ __forceinline__ void copy_model(const MT& src, MT& dst) {
  static_assert(sizeof(MT) % sizeof(int) == 0, "the model copies as ints");
  const int* s = reinterpret_cast<const int*>(&src);
  int* d = reinterpret_cast<int*>(&dst);
  for (int i = threadIdx.x; i < static_cast<int>(sizeof(MT) / sizeof(int)); i += blockDim.x)
    d[i] = s[i];
  __syncthreads();
}

// The one kernel behind a build's two entries: group g of the block (lanes
// g W .. g W + W - 1) runs sample blockIdx.x * groups + g (run_sample), its
// workspace the group's slice of dynamic shared memory. MT is the model's
// type (FluidModel with FLUID).
// At most 128 registers a thread in float (two blocks of kMaxWarps an SM):
// a float build issues the most instructions with 16 warps an SM, and one
// that took more registers ran K = 2048 in two waves (scripts/planar_k_scan.py).
template <typename MT, typename T, int N, bool FLUID, bool EULER, int R, int W>
__global__ void __launch_bounds__(kMaxWarps * 32, sizeof(T) == 4 ? 2 : 1)
rollout_kernel(const T* __restrict__ x0, long long x_stride, const T* __restrict__ controls,
               long long c_t, long long c_i, long long c_k, int num_k, int horizon,
               T* __restrict__ costs, T* __restrict__ x_out, const __grid_constant__ MT m) {
  __shared__ MT sm;
  copy_model(m, sm);
  extern __shared__ __align__(16) unsigned char smem[];
  const int groups = blockDim.x / W;
  const int g = threadIdx.x / W;
  const int k = blockIdx.x * groups + g;
  if (k >= num_k) return;  // the whole group
  run_sample<T, N, FLUID, EULER, R, W>(sm, k, x0, x_stride, controls, c_t, c_i, c_k, horizon,
                                       costs, x_out, reinterpret_cast<Work<T, N, R>*>(smem)[g]);
}

// One build of the kernel and its launch. Its warps a block: of 1 ..
// kMaxWarps (as many as fit in one block's shared memory), the count that
// keeps the most warps resident on an SM under the build's shared memory
// and registers, the smaller on a tie (a finer last wave). Chosen once per
// build; the first call also lets the kernel take the dynamic shared memory
// it needs.
template <typename MT, typename T, int N, bool FLUID, bool EULER, int R, int W>
struct Build {
  static constexpr int kLanes = W;
  static constexpr int kWork = static_cast<int>(sizeof(Work<T, N, R>));

  static int warps() {
    static int warps = 0;
    if (warps == 0) {
      const auto kern = rollout_kernel<MT, T, N, FLUID, EULER, R, W>;
      constexpr int per_warp = (32 / W) * kWork;
      int dev = 0, smem_max = 0;
      if (cudaGetDevice(&dev) != cudaSuccess ||
          cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
              cudaSuccess)
        return 0;
      smem_max -= static_cast<int>(sizeof(MT));  // the block's copy of the model
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

  static int launch(const MT& m, const void* x0, long long x_stride, const void* controls,
                    long long c_t, long long c_i, long long c_k, int num_k, int horizon,
                    void* costs, void* x_out, void* stream) {
    const int nw = warps();
    if (nw < 1) {
      const cudaError_t e = cudaGetLastError();
      return static_cast<int>(e != cudaSuccess ? e : cudaErrorInvalidConfiguration);
    }
    const int groups = 32 * nw / W;
    const dim3 grid((num_k + groups - 1) / groups);
    rollout_kernel<MT, T, N, FLUID, EULER, R, W>
        <<<grid, 32 * nw, groups * kWork, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const T*>(x0), x_stride, static_cast<const T*>(controls), c_t, c_i, c_k,
            num_k, horizon, static_cast<T*>(costs), static_cast<T*>(x_out), m);
    return static_cast<int>(cudaGetLastError());
  }
};
#endif  // __CUDACC__

}  // namespace planar
