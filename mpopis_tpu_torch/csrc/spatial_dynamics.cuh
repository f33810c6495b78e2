// Spatial (3D) contact dynamics of one sample, for the rollout kernel in
// spatial_rollout.cu: quaternion forward kinematics, the analytic mass matrix
// and bias, joint springs, the joint-limit and floor-contact rows (condim-3
// pyramids or one condim-1 normal row), the capsule-cylinder and the
// capsule-capsule (self) pair rows, the warm-started box QP, the RK4 substep
// over the quaternion manifold and the Euler-implicit substep, and the
// control step with its reward family.
//
// What a build takes is fixed at compile time by the feature mask F (kEuler,
// kSlide, kCondim1, kCylinder, kPusher, kSelfPairs, kSprings, kComX,
// kStandup below): the branches of a feature compile only into the builds
// that have it, so the Ant build (F = 0: RK4, free and hinge joints, condim-3
// contacts, the `locomotion` family with the root-x track) holds none of the
// others' code. The Pusher's F has the first five (Euler, slide joints,
// condim-1 floor contacts, capsule-cylinder pairs, the `pusher` family); the
// Humanoid's has self pairs, springs and the com-x track; the Standup's self
// pairs, springs and the `standup` family. The row capacity follows F too
// (RowCap): 128 rows, or 248 with self pairs.
//
// A transcription of the plain PyTorch version
// (mpopis_tpu_torch/models/spatial_contact.py), which keeps the JAX package's
// association order of every sum; nvcc contracts multiply-adds into FMAs, so
// the double instantiation agrees with it to rounding, not bit for bit.
//
// The model is a POD struct read by every thread of a launch at the same
// addresses (uniform loads). Bodies, joints, contacts and limits are run-time
// counts below fixed maxima; the dof count N and the qpos size NQ are template
// parameters, so every per-dof loop unrolls.
//
// The QP keeps only the rows that are valid at this state (joint limits past
// their range, contacts inside their margin), compacted: a row that is not
// valid has lambda = 0 and contributes exact zeros to every sum of the plain
// version, so skipping it changes nothing, and a sample with no valid row
// skips its QP (every iterate would stay 0).
#pragma once

namespace spatial {

constexpr int kMaxBodies = 16;
constexpr int kMaxJoints = 24;
constexpr int kMaxDof = 32;
constexpr int kMaxContacts = 32;
constexpr int kMaxLimits = 24;
constexpr int kMaxAct = 24;
constexpr int kMaxRows = 128;  // rows of one model (Ant: 108)

enum JointKind { kFree = 0, kHinge = 1, kSlide = 2 };

// the feature mask of a build
constexpr int kEuler = 1;     // the Euler-implicit substep (else RK4)
constexpr int kSlideJoints = 2;  // slide joints
constexpr int kCondim1 = 4;   // condim-1 floor contacts (one normal row)
constexpr int kCylinder = 8;  // capsule-cylinder pairs (one row each)
constexpr int kPusher = 16;   // the `pusher` reward family (else `locomotion`)
constexpr int kSelfPairs = 32;  // sphere/capsule self pairs (one row each)
constexpr int kSprings = 64;    // joint springs in the smooth force
constexpr int kComX = 128;      // the com-x track of `locomotion` (else the root's x)
constexpr int kStandup = 256;   // the `standup` reward family
constexpr int kMaxPairs = 4;
constexpr int kMaxSelfPairs = 112;
constexpr int kMaxRowsWide = 248;  // rows of a build with self pairs (Humanoid: 242)
constexpr int kCarryBodies = 3;  // the `pusher` family's xpos bodies

// the row capacity of a build: local arrays of every thread are this long
template <int F>
struct RowCap {
  static constexpr int n = (F & kSelfPairs) ? kMaxRowsWide : kMaxRows;
};

// entries of the state's tail the reward family carries
template <int F>
struct Carry {
  static constexpr int n = (F & kPusher) ? 3 * kCarryBodies : 1;
};

template <typename T>
struct Imp {  // solimp impedance and solref stiffness/damping of one row
  T d0e, dspan, width, kc, bc;
};

template <typename T>
struct Body {
  T pos[3], rot[9];  // static offset and rotation in the parent frame
  T com[3], mass, inertia[9];  // body-frame inertia, symmetric
  int parent, j0, nj;  // joints j0 .. j0 + nj - 1
  unsigned chain;      // bit d set: dof d moves this body
};

template <typename T>
struct Joint {
  T axis[3], anchor[3];  // owning body's frame
  T k[9], k2[9];         // hinge: Rodrigues K and K^2 of the axis
  int body, kind, dof, qadr;
};

template <typename T>
struct Contact {
  T local[3], axis[3];  // sphere centre and capsule axis, body frame
  T radius, mu, margin, bw, rfac;
  Imp<T> imp;
  int body, has_axis, condim;
};

template <typename T>
struct CylPair {  // capsule (body1) against an upright solid cylinder (body2)
  T a1[3], b1[3], center2[3];  // capsule axis ends, cylinder centre: own frames
  T r1, r2, hh2, margin, bw;   // radii, cylinder half height, margin, sum of invweights
  Imp<T> imp;
  int body1, body2;
};

template <typename T>
struct CapPair {  // sphere/capsule (body1) against sphere/capsule (body2)
  T a1[3], d1[3], a2[3], d2[3];  // segment starts and start-to-end vectors, own frames
  T lale, den_eps, le, inv_la, inv_le;  // la le, 1e-12 la le, le, 1/la, 1/le (la = |d1|^2)
  T r1, r2, margin, bw;          // radii, margin, the bodies' summed invweight
  Imp<T> imp;
  int body1, body2, seg1, seg2;  // seg: the end is a capsule (else a sphere)
};

template <typename T>
struct Limit {
  T lo, hi, margin, invweight;
  Imp<T> imp;
  int dof, qadr;
};

template <typename T>
struct Model {
  Body<T> body[kMaxBodies];
  Joint<T> jnt[kMaxJoints];
  Contact<T> con[kMaxContacts];
  Limit<T> lim[kMaxLimits];
  CylPair<T> cyl[kMaxPairs];
  T damping[kMaxDof], armature[kMaxDof], h_damping[kMaxDof];
  int dof_rot[kMaxDof];  // rotational dof
  T gear[kMaxAct];
  int act_dof[kMaxAct];
  T gravity, floor_z, h, half_h, healthy, fwd_inv_dt, ctrl_w, act_clip;
  T ch[4], half_ch[4], w[4];  // RK4 stage c*h, c*h/2 and weights
  int n_dof, n_q, nb, nj, n_contacts, n_limits, n_act, n_cyl, n_rows;
  int frame_skip, outer, cg, features;
  int carry_body[kCarryBodies];
  // The self pairs, springs and total mass follow every older field, so the
  // Ant and Pusher builds read their fields at the offsets they always had.
  CapPair<T> cap[kMaxSelfPairs];
  T stiffness[kMaxDof], springref[kMaxDof];
  int spring_qadr[kMaxDof];  // qpos of a 1-dof joint's dof (-1 on free dofs)
  T inv_total_mass;
  int n_cap;
};

__device__ __forceinline__ float d_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double d_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float d_rsqrt(float x) { return rsqrtf(x); }
__device__ __forceinline__ double d_rsqrt(double x) { return rsqrt(x); }
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

// out = r v (r row-major 3x3)
template <typename T>
__device__ __forceinline__ void rvec(const T* r, const T* v, T* out) {
#pragma unroll
  for (int i = 0; i < 3; ++i) out[i] = r[3 * i] * v[0] + r[3 * i + 1] * v[1] + r[3 * i + 2] * v[2];
}

// out = a b
template <typename T>
__device__ __forceinline__ void rmul(const T* a, const T* b, T* out) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
      out[3 * i + j] = a[3 * i] * b[j] + a[3 * i + 1] * b[3 + j] + a[3 * i + 2] * b[6 + j];
  }
}

template <typename T>
__device__ __forceinline__ void cross(const T* a, const T* b, T* out) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

template <typename T>
__device__ __forceinline__ T dot3(const T* a, const T* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

template <typename T>
__device__ __forceinline__ void qmat(T w, T x, T y, T z, T* r) {
  r[0] = T(1) - T(2) * (y * y + z * z);
  r[1] = T(2) * (x * y - w * z);
  r[2] = T(2) * (x * z + w * y);
  r[3] = T(2) * (x * y + w * z);
  r[4] = T(1) - T(2) * (x * x + z * z);
  r[5] = T(2) * (y * z - w * x);
  r[6] = T(2) * (x * z - w * y);
  r[7] = T(2) * (y * z + w * x);
  r[8] = T(1) - T(2) * (x * x + y * y);
}

// R I R^T of a symmetric body inertia: the upper triangle, mirrored
template <typename T>
__device__ __forceinline__ void sym_rotate(const T* r, const T* inertia, T* out) {
  T tmp[9];
  rmul(r, inertia, tmp);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = i; j < 3; ++j) {
      out[3 * i + j] = tmp[3 * i] * r[3 * j] + tmp[3 * i + 1] * r[3 * j + 1] +
                       tmp[3 * i + 2] * r[3 * j + 2];
      out[3 * j + i] = out[3 * i + j];
    }
  }
}

// World kinematics of every body, and per dof its world axis and anchor
template <typename T, int N>
struct Kin {
  T o[kMaxBodies][3], R[kMaxBodies][9];
  T ax[N][3], an[N][3];
};

template <typename T, int N, int NQ, int F>
__device__ void compute_frames(const Model<T>& m, const T (&q)[NQ], Kin<T, N>& kin) {
  for (int b = 0; b < m.nb; ++b) {
    const Body<T>& bd = m.body[b];
    T o[3], r[9], t[3], r2[9];
    if (bd.parent < 0) {
#pragma unroll
      for (int i = 0; i < 9; ++i) r[i] = (i % 4 == 0) ? T(1) : T(0);
      o[0] = o[1] = o[2] = T(0);
    } else {
#pragma unroll
      for (int i = 0; i < 3; ++i) o[i] = kin.o[bd.parent][i];
#pragma unroll
      for (int i = 0; i < 9; ++i) r[i] = kin.R[bd.parent][i];
    }
    rvec(r, bd.pos, t);
#pragma unroll
    for (int i = 0; i < 3; ++i) o[i] = o[i] + t[i];
    rmul(r, bd.rot, r2);
#pragma unroll
    for (int i = 0; i < 9; ++i) r[i] = r2[i];
    for (int jj = bd.j0; jj < bd.j0 + bd.nj; ++jj) {
      const Joint<T>& J = m.jnt[jj];
      const int d = J.dof;
      if (J.kind == kFree) {
#pragma unroll
        for (int i = 0; i < 3; ++i) o[i] = q[J.qadr + i];
        qmat(q[J.qadr + 3], q[J.qadr + 4], q[J.qadr + 5], q[J.qadr + 6], r);
#pragma unroll
        for (int i = 0; i < 3; ++i) {
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            kin.ax[d + i][c] = (c == i) ? T(1) : T(0);
            kin.ax[d + 3 + i][c] = r[3 * c + i];
            kin.an[d + i][c] = o[c];
            kin.an[d + 3 + i][c] = o[c];
          }
        }
      } else if ((F & kSlideJoints) && J.kind == kSlide) {  // translate along the axis
        rvec(r, J.axis, kin.ax[d]);
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          o[i] = o[i] + q[J.qadr] * kin.ax[d][i];
          kin.an[d][i] = o[i];
        }
      } else {  // hinge
        T aw[3];
        rvec(r, J.anchor, t);
#pragma unroll
        for (int i = 0; i < 3; ++i) aw[i] = o[i] + t[i];
        rvec(r, J.axis, kin.ax[d]);
#pragma unroll
        for (int i = 0; i < 3; ++i) kin.an[d][i] = aw[i];
        T s, c;
        d_sincos(q[J.qadr], &s, &c);
        const T one_c = T(1) - c;
        T ra[9];
#pragma unroll
        for (int i = 0; i < 9; ++i)
          ra[i] = ((i % 4 == 0 ? T(1) : T(0)) + s * J.k[i]) + one_c * J.k2[i];
        rmul(r, ra, r2);
#pragma unroll
        for (int i = 0; i < 9; ++i) r[i] = r2[i];
        rvec(r, J.anchor, t);
#pragma unroll
        for (int i = 0; i < 3; ++i) o[i] = aw[i] - t[i];
      }
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) kin.o[b][i] = o[i];
#pragma unroll
    for (int i = 0; i < 9; ++i) kin.R[b][i] = r[i];
  }
}

// Jacobian columns of the point p fixed to body b: translation dofs give
// their axis, rotational dofs a x (p - anchor); dofs off b's chain 0. Jw
// (optional) gets a on the chain's rotational dofs.
template <typename T, int N>
__device__ __forceinline__ void point_jac(const Model<T>& m, const Kin<T, N>& kin, int b,
                                          const T* p, T (&jv)[N][3], T (*jw)[3]) {
  const unsigned chain = m.body[b].chain;
#pragma unroll
  for (int d = 0; d < N; ++d) {
    const bool on = (chain >> d) & 1u;
    const bool rot = m.dof_rot[d] != 0;
    T rel[3], cr[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) rel[i] = p[i] - kin.an[d][i];
    cross(kin.ax[d], rel, cr);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      jv[d][i] = on ? (rot ? cr[i] : kin.ax[d][i]) : T(0);
      if (jw) jw[d][i] = (on && rot) ? kin.ax[d][i] : T(0);
    }
  }
}

// Mass matrix (lower triangle) and bias: q''=0 propagation of each body's
// angular velocity and acceleration and its origin's velocity and
// acceleration, then per body the com Jacobian, m Jv^T Jv + Jw^T Iw Jw and
// the wrench m (a_com - g), Iw alpha + w x Iw w projected on the columns.
template <typename T, int N, int F>
__device__ void mass_and_bias(const Model<T>& m, const Kin<T, N>& kin, const T (&qv)[N],
                              T (&M)[N][N], T (&bias)[N]) {
  T om[kMaxBodies][3], al[kMaxBodies][3], vo[kMaxBodies][3], ao[kMaxBodies][3];
  for (int b = 0; b < m.nb; ++b) {
    const Body<T>& bd = m.body[b];
    T w_[3], a_[3], v_[3], c_[3];
    if (bd.parent < 0) {
#pragma unroll
      for (int i = 0; i < 3; ++i) w_[i] = a_[i] = v_[i] = c_[i] = T(0);
    } else {
      const int p = bd.parent;
      T d[3], t1[3], t2[3], t3[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        w_[i] = om[p][i];
        a_[i] = al[p][i];
        d[i] = kin.o[b][i] - kin.o[p][i];
      }
      cross(w_, d, t1);
      cross(a_, d, t2);
      cross(w_, t1, t3);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        v_[i] = vo[p][i] + t1[i];
        c_[i] = (ao[p][i] + t2[i]) + t3[i];
      }
    }
    for (int jj = bd.j0; jj < bd.j0 + bd.nj; ++jj) {
      const Joint<T>& J = m.jnt[jj];
      const int d = J.dof;
      if (J.kind == kFree) {
        T wl[3] = {qv[d + 3], qv[d + 4], qv[d + 5]};
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          v_[i] = qv[d + i];
          c_[i] = T(0);
          a_[i] = T(0);  // d/dt(R w_local) = w x w = 0 at w' = 0
        }
        rvec(kin.R[b], wl, w_);  // a free joint is its body's only joint
      } else if ((F & kSlideJoints) && J.kind == kSlide) {
        T va[3], t1[3];
#pragma unroll
        for (int i = 0; i < 3; ++i) va[i] = qv[d] * kin.ax[d][i];
        cross(w_, va, t1);
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          v_[i] = v_[i] + va[i];
          c_[i] = c_[i] + t1[i];
        }
      } else {  // hinge: to the anchor, add the joint rate, back to the origin
        T dw[3], dd[3], aq[3], t1[3], t2[3], t3[3], vw[3], aw[3];
#pragma unroll
        for (int i = 0; i < 3; ++i) dw[i] = kin.an[d][i] - kin.o[b][i];
        cross(w_, dw, t1);
        cross(a_, dw, t2);
        cross(w_, t1, t3);
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          vw[i] = v_[i] + t1[i];
          aw[i] = (c_[i] + t2[i]) + t3[i];
          aq[i] = qv[d] * kin.ax[d][i];
        }
        cross(w_, aq, t1);
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          a_[i] = a_[i] + t1[i];
          w_[i] = w_[i] + aq[i];
          dd[i] = kin.o[b][i] - kin.an[d][i];
        }
        cross(w_, dd, t1);
        cross(a_, dd, t2);
        cross(w_, t1, t3);
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          v_[i] = vw[i] + t1[i];
          c_[i] = (aw[i] + t2[i]) + t3[i];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      om[b][i] = w_[i];
      al[b][i] = a_[i];
      vo[b][i] = v_[i];
      ao[b][i] = c_[i];
    }
  }

#pragma unroll
  for (int i = 0; i < N; ++i) {
    bias[i] = T(0);
#pragma unroll
    for (int j = 0; j <= i; ++j) M[i][j] = (i == j) ? m.armature[i] : T(0);
  }
  for (int b = 0; b < m.nb; ++b) {
    const Body<T>& bd = m.body[b];
    const unsigned chain = bd.chain;
    T r_com[3], com_w[3], iw[9];
    rvec(kin.R[b], bd.com, r_com);
#pragma unroll
    for (int i = 0; i < 3; ++i) com_w[i] = kin.o[b][i] + r_com[i];
    T jv[N][3], jw[N][3], iwj[N][3];
    point_jac(m, kin, b, com_w, jv, jw);
    sym_rotate(kin.R[b], bd.inertia, iw);
#pragma unroll
    for (int d = 0; d < N; ++d) rvec(iw, jw[d], iwj[d]);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (!((chain >> i) & 1u)) continue;
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        if (!((chain >> j) & 1u)) continue;
        M[i][j] = M[i][j] + (bd.mass * dot3(jv[i], jv[j]) + dot3(iwj[i], jw[j]));
      }
    }
    T vcom[3], acom[3], t1[3], t2[3], t3[3], f[3], tq[3], iwa[3], iww[3];
    cross(om[b], r_com, t1);
#pragma unroll
    for (int i = 0; i < 3; ++i) vcom[i] = vo[b][i] + t1[i];
    cross(al[b], r_com, t2);
#pragma unroll
    for (int i = 0; i < 3; ++i) t1[i] = vcom[i] - vo[b][i];
    cross(om[b], t1, t3);
#pragma unroll
    for (int i = 0; i < 3; ++i) acom[i] = (ao[b][i] + t2[i]) + t3[i];
    f[0] = bd.mass * acom[0];
    f[1] = bd.mass * acom[1];
    f[2] = bd.mass * (acom[2] + m.gravity);
    rvec(iw, al[b], iwa);
    rvec(iw, om[b], iww);
    cross(om[b], iww, t1);
#pragma unroll
    for (int i = 0; i < 3; ++i) tq[i] = iwa[i] + t1[i];
#pragma unroll
    for (int d = 0; d < N; ++d) {
      if ((chain >> d) & 1u) bias[d] = bias[d] + (dot3(jv[d], f) + dot3(jw[d], tq));
    }
  }
}

template <typename T, int N>
__device__ __forceinline__ void cholesky(const T (&M)[N][N], T (&L)[N][N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    T d = M[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) d = d - L[j][k] * L[j][k];
    L[j][j] = d_sqrt(d);
#pragma unroll
    for (int i = j + 1; i < N; ++i) {
      T s = M[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) s = s - L[i][k] * L[j][k];
      L[i][j] = s / L[j][j];
    }
  }
}

// x = (L L^T)^-1 b
template <typename T, int N>
__device__ __forceinline__ void chol_solve(const T (&L)[N][N], const T (&b)[N], T (&x)[N]) {
  T y[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    T s = b[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - L[i][k] * y[k];
    y[i] = s / L[i][i];
  }
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    T s = y[i];
#pragma unroll
    for (int k = i + 1; k < N; ++k) s = s - L[k][i] * x[k];
    x[i] = s / L[i][i];
  }
}

template <typename T, int N>
__device__ __forceinline__ T dot_row(const T (&j)[N], const T (&v)[N]) {
  T s = T(0);
#pragma unroll
  for (int d = 0; d < N; ++d) s = s + j[d] * v[d];
  return s;
}

// The rows valid at this state, compacted, up to R of them; idx maps each to
// its row of the model (the index of its lambda warm start).
template <typename T, int N, int R>
struct Rows {
  T J[R][N];
  T aref[R], reg[R];
  int idx[R];
  int nv;
};

// Capsule (body1) against an upright solid cylinder (body2): the distance,
// the normal from body1 to body2 and the contact point, as the plain
// version's capsule_cylinder. The capsule-axis witness point minimizes the
// distance to the solid cylinder, convex along the segment: 40 bisections on
// the sign of its derivative u(p(s)) . d, u the outward unit direction at the
// point (inside the solid, the max(er, ez) subgradient); then the side, cap
// or rim region of the point gives the distance and the normal.
template <typename T, bool WITNESS>
__device__ __forceinline__ void cylinder_unit(T px, T py, T pz, T r2, T hh, T& ux, T& uy, T& uz,
                                              T& er, T& ez, bool& inside, T& d_out, T& dr) {
  const T q2 = px * px + py * py;
  dr = d_sqrt(q2 < T(1e-24) ? T(1e-24) : q2);
  er = dr - r2;
  ez = d_abs(pz) - hh;
  inside = er < T(0) && ez < T(0);
  const T erp = er < T(0) ? T(0) : er;
  const T ezp = ez < T(0) ? T(0) : ez;
  const T o2 = erp * erp + ezp * ezp;
  d_out = d_sqrt(o2 < T(1e-24) ? T(1e-24) : o2);
  const T zsign = pz >= T(0) ? T(1) : T(-1);
  const bool radial = er > ez;
  if (inside) {
    ux = radial ? px / dr : T(0);
    uy = radial ? py / dr : T(0);
    uz = radial ? T(0) : zsign;
  } else if (WITNESS) {  // the plain version's two association orders
    ux = erp * (px / dr) / d_out;
    uy = erp * (py / dr) / d_out;
    uz = ezp * zsign / d_out;
  } else {
    ux = erp * px / (dr * d_out);
    uy = erp * py / (dr * d_out);
    uz = ezp * zsign / d_out;
  }
}

template <typename T, int N>
__device__ void capsule_cylinder(const Kin<T, N>& kin, const CylPair<T>& pr, T& dist, T (&nvec)[3],
                                 T (&cp)[3]) {
  T a[3], b[3], c[3], d1[3], t[3];
  rvec(kin.R[pr.body1], pr.a1, t);
#pragma unroll
  for (int i = 0; i < 3; ++i) a[i] = kin.o[pr.body1][i] + t[i];
  rvec(kin.R[pr.body1], pr.b1, t);
#pragma unroll
  for (int i = 0; i < 3; ++i) b[i] = kin.o[pr.body1][i] + t[i];
  rvec(kin.R[pr.body2], pr.center2, t);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    c[i] = kin.o[pr.body2][i] + t[i];
    d1[i] = b[i] - a[i];
  }
  T lo = T(0), hi = T(1), ux, uy, uz, er, ez, d_out, dr;
  bool inside;
#pragma unroll 1
  for (int it = 0; it < 40; ++it) {
    const T mid = T(0.5) * (lo + hi);
    cylinder_unit<T, false>(a[0] + mid * d1[0] - c[0], a[1] + mid * d1[1] - c[1],
                  a[2] + mid * d1[2] - c[2], pr.r2, pr.hh2, ux, uy, uz, er, ez, inside, d_out,
                  dr);
    const bool going_down = ux * d1[0] + uy * d1[1] + uz * d1[2] < T(0);
    lo = going_down ? mid : lo;
    hi = going_down ? hi : mid;
  }
  const T s1 = T(0.5) * (lo + hi);
  T p1[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) p1[i] = a[i] + s1 * d1[i];
  // the normal from the cylinder surface toward p1: radial on the side wall,
  // vertical on the caps, mixed on the rim
  cylinder_unit<T, true>(p1[0] - c[0], p1[1] - c[1], p1[2] - c[2], pr.r2, pr.hh2, ux, uy, uz, er, ez,
                inside, d_out, dr);
  const T d_pt = inside ? (er > ez ? er : ez) : d_out;
  dist = d_pt - pr.r1;
  // MuJoCo's frame: the normal points geom1 (capsule) -> geom2 (cylinder)
  nvec[0] = -ux;
  nvec[1] = -uy;
  nvec[2] = -uz;
  const T reach = pr.r1 + T(0.5) * dist;
#pragma unroll
  for (int i = 0; i < 3; ++i) cp[i] = p1[i] + nvec[i] * reach;
}

// Sphere/capsule against sphere/capsule (a self pair): the distance, the
// normal from body1 to body2 and the contact point, as the plain version's
// capsule_capsule. The closest points of the two axis segments (Ericson), an
// end that is a sphere taking the point-against-segment form; then dist =
// |c2 - c1| - r1 - r2 and the point c1 + n (r1 + dist / 2).
template <typename T, int N>
__device__ void capsule_capsule(const Kin<T, N>& kin, const CapPair<T>& pr, T& dist,
                                T (&nvec)[3], T (&cp)[3]) {
  T a1[3], a2[3], d1[3], d2[3], c1[3], c2[3], t[3];
  rvec(kin.R[pr.body1], pr.a1, t);
#pragma unroll
  for (int i = 0; i < 3; ++i) a1[i] = kin.o[pr.body1][i] + t[i];
  rvec(kin.R[pr.body2], pr.a2, t);
#pragma unroll
  for (int i = 0; i < 3; ++i) a2[i] = kin.o[pr.body2][i] + t[i];
  rvec(kin.R[pr.body1], pr.d1, d1);
  rvec(kin.R[pr.body2], pr.d2, d2);
  T s = T(0), u = T(0);  // the points' parameters along d1 and d2
  if (pr.seg1 && pr.seg2) {
    T r[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) r[i] = a1[i] - a2[i];
    const T lf = dot3(d2, r), lc = dot3(d1, r), lb = dot3(d1, d2);
    const T den = pr.lale - lb * lb;
    if (den > pr.den_eps) s = clip((lb * lf - lc * pr.le) / (den < T(1e-30) ? T(1e-30) : den),
                                   T(0), T(1));
    const T u_raw = (lb * s + lf) * pr.inv_le;
    if (u_raw < T(0))
      s = clip(-lc * pr.inv_la, T(0), T(1));
    else if (u_raw > T(1))
      s = clip((lb - lc) * pr.inv_la, T(0), T(1));
    u = clip(u_raw, T(0), T(1));
  } else if (pr.seg2) {  // a sphere against a capsule
    T r[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) r[i] = a1[i] - a2[i];
    u = clip(dot3(r, d2) * pr.inv_le, T(0), T(1));
  } else if (pr.seg1) {  // a capsule against a sphere
    T r[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) r[i] = a2[i] - a1[i];
    s = clip(dot3(r, d1) * pr.inv_la, T(0), T(1));
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    c1[i] = pr.seg1 ? a1[i] + s * d1[i] : a1[i];
    c2[i] = pr.seg2 ? a2[i] + u * d2[i] : a2[i];
    t[i] = c2[i] - c1[i];
  }
  const T l2 = dot3(t, t);
  const T ln = d_sqrt(l2 < T(1e-24) ? T(1e-24) : l2);
  const T inv = T(1) / ln;
  dist = (ln - pr.r1) - pr.r2;
  const T reach = pr.r1 + T(0.5) * dist;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    nvec[i] = inv * t[i];
    cp[i] = c1[i] + reach * nvec[i];
  }
}

template <typename T, int N, int NQ, int F, int R>
__device__ void contact_rows(const Model<T>& m, const T (&q)[NQ], const T (&qv)[N],
                             const Kin<T, N>& kin, Rows<T, N, R>& rows) {
  int nv = 0, r = 0;
  for (int l = 0; l < m.n_limits; ++l, ++r) {
    const Limit<T>& lm = m.lim[l];
    const T qd = q[lm.qadr];
    const T d_lo = (qd - lm.lo) - lm.margin;
    const T d_hi = (lm.hi - qd) - lm.margin;
    const bool lower = d_lo < d_hi;
    const T pos = lower ? d_lo : d_hi;
    if (!(pos < T(0))) continue;
    const T sgn = lower ? T(1) : T(-1);
    const T imp = impedance(pos, lm.imp);
#pragma unroll
    for (int d = 0; d < N; ++d) rows.J[nv][d] = (d == lm.dof) ? sgn : T(0);
    rows.aref[nv] = (-lm.imp.bc) * (sgn * qv[lm.dof]) - lm.imp.kc * imp * pos;
    rows.reg[nv] = (T(1) - imp) / imp * lm.invweight;
    rows.idx[nv] = r;
    ++nv;
  }
  for (int ci = 0; ci < m.n_contacts; ++ci) {
    const Contact<T>& ct = m.con[ci];
    T p[3];
    rvec(kin.R[ct.body], ct.local, p);
#pragma unroll
    for (int i = 0; i < 3; ++i) p[i] = kin.o[ct.body][i] + p[i];
    const T dist = (p[2] - m.floor_z) - ct.radius;
    const bool normal_only = (F & kCondim1) && ct.condim == 1;
    if (!(dist < ct.margin)) {
      r += normal_only ? 1 : 4;
      continue;
    }
    const T cp[3] = {p[0], p[1], m.floor_z + T(0.5) * dist};
    T jv[N][3];
    point_jac(m, kin, ct.body, cp, jv, static_cast<T(*)[3]>(nullptr));
    T jn[N];
#pragma unroll
    for (int d = 0; d < N; ++d) jn[d] = jv[d][2];
    const T pos_m = dist - ct.margin;
    const T imp = impedance(pos_m, ct.imp);
    const T jv_n = dot_row(jn, qv);
    const T base = (-ct.imp.kc) * imp * pos_m;
    const T nbc = -ct.imp.bc;
    if (normal_only) {  // frictionless: the normal row, no pyramid factor in R
#pragma unroll
      for (int d = 0; d < N; ++d) rows.J[nv][d] = jn[d];
      rows.aref[nv] = nbc * jv_n + base;
      rows.reg[nv] = (T(1) - imp) / imp * ct.bw;
      rows.idx[nv] = r;
      ++nv;
      ++r;
      continue;
    }
    // tangents: t1 = normalized xy-projection of the world capsule axis,
    // (0, 1, 0) for a sphere; t2 = n x t1 = (-t1y, t1x, 0)
    T t1x = T(0), t1y = T(1);
    if (ct.has_axis) {
      T a[3];
      rvec(kin.R[ct.body], ct.axis, a);
      const T n2 = a[0] * a[0] + a[1] * a[1];
      const T nrm = d_sqrt(n2 < T(1e-24) ? T(1e-24) : n2);
      t1x = a[0] / nrm;
      t1y = a[1] / nrm;
    }
    T jt1[N], jt2[N];
#pragma unroll
    for (int d = 0; d < N; ++d) {
      jt1[d] = jv[d][0] * t1x + jv[d][1] * t1y;
      jt2[d] = jv[d][0] * (-t1y) + jv[d][1] * t1x;
    }
    const T jv_t1 = dot_row(jt1, qv);
    const T jv_t2 = dot_row(jt2, qv);
    const T reg = (T(1) - imp) / imp * ct.bw * ct.rfac;
    const T mus[2] = {ct.mu, -ct.mu};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const T mu = mus[k & 1];
      const T(&jt)[N] = k < 2 ? jt1 : jt2;
      const T jv_t = k < 2 ? jv_t1 : jv_t2;
#pragma unroll
      for (int d = 0; d < N; ++d) rows.J[nv][d] = jn[d] + mu * jt[d];
      rows.aref[nv] = nbc * (jv_n + mu * jv_t) + base;
      rows.reg[nv] = reg;
      rows.idx[nv] = r + k;
      ++nv;
    }
    r += 4;
  }
  if (F & kCylinder) {
    for (int pi = 0; pi < m.n_cyl; ++pi, ++r) {
      const CylPair<T>& pr = m.cyl[pi];
      T dist, nvec[3], cp[3];
      capsule_cylinder(kin, pr, dist, nvec, cp);
      if (!(dist < pr.margin)) continue;
      // J = n . (v2(cp) - v1(cp)) over both bodies' dof columns
      T jv1[N][3], jv2[N][3];
      point_jac(m, kin, pr.body1, cp, jv1, static_cast<T(*)[3]>(nullptr));
      point_jac(m, kin, pr.body2, cp, jv2, static_cast<T(*)[3]>(nullptr));
#pragma unroll
      for (int d = 0; d < N; ++d) rows.J[nv][d] = -dot3(jv1[d], nvec) + dot3(jv2[d], nvec);
      const T pos_m = dist - pr.margin;
      const T imp = impedance(pos_m, pr.imp);
      rows.aref[nv] = (-pr.imp.bc) * dot_row(rows.J[nv], qv) - pr.imp.kc * imp * pos_m;
      rows.reg[nv] = (T(1) - imp) / imp * pr.bw;
      rows.idx[nv] = r;
      ++nv;
    }
  }
  if (F & kSelfPairs) {  // the same rows for the self pairs
    for (int pi = 0; pi < m.n_cap; ++pi, ++r) {
      const CapPair<T>& pr = m.cap[pi];
      T dist, nvec[3], cp[3];
      capsule_capsule(kin, pr, dist, nvec, cp);
      if (!(dist < pr.margin)) continue;
      T jv1[N][3], jv2[N][3];
      point_jac(m, kin, pr.body1, cp, jv1, static_cast<T(*)[3]>(nullptr));
      point_jac(m, kin, pr.body2, cp, jv2, static_cast<T(*)[3]>(nullptr));
#pragma unroll
      for (int d = 0; d < N; ++d) rows.J[nv][d] = -dot3(jv1[d], nvec) + dot3(jv2[d], nvec);
      const T pos_m = dist - pr.margin;
      const T imp = impedance(pos_m, pr.imp);
      rows.aref[nv] = (-pr.imp.bc) * dot_row(rows.J[nv], qv) - pr.imp.kc * imp * pos_m;
      rows.reg[nv] = (T(1) - imp) / imp * pr.bw;
      rows.idx[nv] = r;
      ++nv;
    }
  }
  rows.nv = nv;
}

// out = mask ? J (L L^T)^-1 J^T (mask ? v : 0) + R (mask ? v : 0) : 0 over the
// compacted rows; a null mask means every row
template <typename T, int N, int R>
__device__ void ar_apply(const Rows<T, N, R>& rows, const T (&L)[N][N], const T* v, const bool* mask,
                         T* out) {
  const int nv = rows.nv;
  T u[N];
#pragma unroll
  for (int d = 0; d < N; ++d) u[d] = T(0);
  for (int r = 0; r < nv; ++r) {
    if (mask && !mask[r]) continue;
    const T vr = v[r];
#pragma unroll
    for (int d = 0; d < N; ++d) u[d] = u[d] + rows.J[r][d] * vr;
  }
  T w[N];
  chol_solve(L, u, w);
  for (int r = 0; r < nv; ++r) {
    if (mask && !mask[r]) {
      out[r] = T(0);
      continue;
    }
    out[r] = dot_row(rows.J[r], w) + rows.reg[r] * v[r];
  }
}

__constant__ double kArc[6] = {1.0, 0.5, 0.25, 0.1, 0.03, 0.01};  // arc search ladder

// Box QP min 1/2 lam^T (J M^-1 J^T + diag R) lam - rhs^T lam, lam >= 0, over
// the valid rows: the fixed-iteration active set / CG / projected arc search
// of the plain version's _qp_iterate. lam_full holds the warm start of every
// model row on entry and the solution (0 on rows not valid) on exit. Returns
// J^T lam.
template <typename T, int N, int R>
__device__ void solve_qp(const Model<T>& m, const Rows<T, N, R>& rows, const T (&L)[N][N],
                         const T (&a_smooth)[N], T* lam_full, T (&qfrc)[N]) {
  const int nv = rows.nv;
  T lam[R], rhs[R], g[R], x[R], res[R], p[R];
  T ap[R], best[R];
  bool act[R];
  for (int r = 0; r < nv; ++r) {
    lam[r] = lam_full[rows.idx[r]];
    rhs[r] = rows.aref[r] - dot_row(rows.J[r], a_smooth);
  }
  for (int r = 0; r < m.n_rows; ++r) lam_full[r] = T(0);
#pragma unroll
  for (int d = 0; d < N; ++d) qfrc[d] = T(0);
  if (nv == 0) return;  // every iterate would stay 0

  for (int it = 0; it < m.outer; ++it) {
    ar_apply(rows, L, lam, static_cast<const bool*>(nullptr), g);
    T f_lg = T(0), f_rl = T(0);
    for (int r = 0; r < nv; ++r) {
      g[r] = g[r] - rhs[r];
      act[r] = lam[r] > T(0) || g[r] < T(0);
      x[r] = act[r] ? lam[r] : T(0);
      f_lg = f_lg + lam[r] * g[r];
      f_rl = f_rl + rhs[r] * lam[r];
    }
    T best_f = T(0.5) * f_lg - T(0.5) * f_rl;
    ar_apply(rows, L, x, act, ap);
    T rs = T(0);
    for (int r = 0; r < nv; ++r) {
      res[r] = act[r] ? rhs[r] - ap[r] : T(0);
      p[r] = res[r];
      rs = rs + res[r] * res[r];
    }
    for (int k = 0; k < m.cg; ++k) {
      ar_apply(rows, L, p, act, ap);
      T denom = T(0);
      for (int r = 0; r < nv; ++r) denom = denom + p[r] * ap[r];
      const T alpha = denom > T(1e-30) ? rs / (denom < T(1e-30) ? T(1e-30) : denom) : T(0);
      T rs_new = T(0);
      for (int r = 0; r < nv; ++r) {
        x[r] = x[r] + alpha * p[r];
        res[r] = res[r] - alpha * ap[r];
        rs_new = rs_new + res[r] * res[r];
      }
      const T beta = rs > T(1e-30) ? rs_new / (rs < T(1e-30) ? T(1e-30) : rs) : T(0);
      for (int r = 0; r < nv; ++r) p[r] = res[r] + beta * p[r];
      rs = rs_new;
    }
    // projected arc search over the fixed ladder; x becomes delta, p lam(t)
    for (int r = 0; r < nv; ++r) {
      x[r] = act[r] ? x[r] - lam[r] : T(0);
      best[r] = lam[r];
    }
#pragma unroll 1
    for (int a = 0; a < 6; ++a) {
      const T t = static_cast<T>(kArc[a]);
      for (int r = 0; r < nv; ++r) {
        const T v = lam[r] + t * x[r];
        p[r] = v < T(0) ? T(0) : v;
      }
      ar_apply(rows, L, p, act, ap);
      T f_a = T(0), f_b = T(0);
      for (int r = 0; r < nv; ++r) {
        f_a = f_a + p[r] * ap[r];
        f_b = f_b + rhs[r] * p[r];
      }
      const T f_t = T(0.5) * f_a - f_b;
      if (f_t < best_f) {
        best_f = f_t;
        for (int r = 0; r < nv; ++r) best[r] = p[r];
      }
    }
    for (int r = 0; r < nv; ++r) lam[r] = best[r];
  }
  for (int r = 0; r < nv; ++r) {
    lam_full[rows.idx[r]] = lam[r];
#pragma unroll
    for (int d = 0; d < N; ++d) qfrc[d] = qfrc[d] + rows.J[r][d] * lam[r];
  }
}

// One constrained forward pass (mj_forward) at (q, qv): the acceleration;
// lam_full warm-starts the QP and returns its solution. With kEuler the QP
// sees the undamped M and the acceleration solves (M + h diag(damping)) acc =
// smooth + qfrc (the implicit damping of mj_Euler). With kSprings the smooth
// force pulls each sprung hinge toward its springref. Kept out of line: RK4
// calls it 4 times per substep.
template <typename T, int N, int NQ, int F, int R>
__device__ __noinline__ void forward_acc(const Model<T>& m, const T (&q)[NQ], const T (&qv)[N],
                                         const T (&tau)[N], T* lam_full, Rows<T, N, R>& rows,
                                         T (&acc)[N]) {
  Kin<T, N> kin;
  compute_frames<T, N, NQ, F>(m, q, kin);
  T M[N][N], L[N][N], bias[N], smooth[N], a_smooth[N], qfrc[N];
  mass_and_bias<T, N, F>(m, kin, qv, M, bias);
  cholesky(M, L);
#pragma unroll
  for (int d = 0; d < N; ++d) smooth[d] = tau[d] - bias[d] - m.damping[d] * qv[d];
  if (F & kSprings) {
#pragma unroll
    for (int d = 0; d < N; ++d)
      if (m.stiffness[d] != T(0))
        smooth[d] = smooth[d] - m.stiffness[d] * (q[m.spring_qadr[d]] - m.springref[d]);
  }
  chol_solve(L, smooth, a_smooth);
  contact_rows<T, N, NQ, F, R>(m, q, qv, kin, rows);
  solve_qp(m, rows, L, a_smooth, lam_full, qfrc);
#pragma unroll
  for (int d = 0; d < N; ++d) smooth[d] = smooth[d] + qfrc[d];
  if (F & kEuler) {
#pragma unroll
    for (int d = 0; d < N; ++d) M[d][d] = M[d][d] + m.h_damping[d];
    cholesky(M, L);
  }
  chol_solve(L, smooth, acc);
}

// qpos (+) hh v (mj_integratePos); half_hh = hh / 2
template <typename T, int N, int NQ>
__device__ void integrate_pos(const Model<T>& m, const T (&q)[NQ], const T (&v)[N], T hh,
                              T half_hh, T (&out)[NQ]) {
  for (int jj = 0; jj < m.nj; ++jj) {
    const Joint<T>& J = m.jnt[jj];
    const int a = J.qadr, d = J.dof;
    if (J.kind != kFree) {
      out[a] = q[a] + hh * v[d];
      continue;
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) out[a + i] = q[a + i] + hh * v[d + i];
    const T wx = v[d + 3], wy = v[d + 4], wz = v[d + 5];
    const T n2 = wx * wx + wy * wy + wz * wz;
    const T nrm = d_sqrt(n2 < T(1e-30) ? T(1e-30) : n2);
    const T half = half_hh * nrm;
    T sh, cw;
    d_sincos(half, &sh, &cw);
    const T sfac = n2 < T(1e-24) ? half_hh : sh / nrm;
    const T ex = sfac * wx, ey = sfac * wy, ez = sfac * wz;
    const T w = q[a + 3], x = q[a + 4], y = q[a + 5], z = q[a + 6];
    const T nw = w * cw - x * ex - y * ey - z * ez;
    const T nx = w * ex + x * cw + y * ez - z * ey;
    const T ny = w * ey - x * ez + y * cw + z * ex;
    const T nz = w * ez + x * ey - y * ex + z * cw;
    const T inv = d_rsqrt(nw * nw + nx * nx + ny * ny + nz * nz);
    out[a + 3] = nw * inv;
    out[a + 4] = nx * inv;
    out[a + 5] = ny * inv;
    out[a + 6] = nz * inv;
  }
}

// Every free joint's quaternion normalized
template <typename T, int NQ>
__device__ void normalize_quats(const Model<T>& m, T (&q)[NQ]) {
  for (int jj = 0; jj < m.nj; ++jj) {
    const Joint<T>& J = m.jnt[jj];
    if (J.kind != kFree) continue;
    const int a = J.qadr + 3;
    const T inv = d_rsqrt(q[a] * q[a] + q[a + 1] * q[a + 1] + q[a + 2] * q[a + 2] +
                          q[a + 3] * q[a + 3]);
#pragma unroll
    for (int i = 0; i < 4; ++i) q[a + i] = q[a + i] * inv;
  }
}

// One RK4 substep: positions of each stage from the normalized q0 by the
// previous stage's velocity, the weighted velocities accumulated stage by
// stage, lambda chained through the stages; q_snap gets the last stage's
// qpos (what mj_step leaves in data.xpos).
template <typename T, int N, int NQ, int F, int R>
__device__ void rk4_substep(const Model<T>& m, T (&q)[NQ], T (&qv)[N], const T (&tau)[N],
                            T* lam_full, Rows<T, N, R>& rows, T (&q_snap)[NQ]) {
  normalize_quats(m, q);
  T kq[N], kv[N], accq[N], accv[N], vs[N], acc[N];
#pragma unroll
  for (int d = 0; d < N; ++d) {
    kq[d] = qv[d];
    kv[d] = accq[d] = accv[d] = T(0);
  }
#pragma unroll 1
  for (int s = 0; s < 4; ++s) {
    integrate_pos(m, q, kq, m.ch[s], m.half_ch[s], q_snap);
#pragma unroll
    for (int d = 0; d < N; ++d) vs[d] = qv[d] + m.ch[s] * kv[d];
    forward_acc<T, N, NQ, F, R>(m, q_snap, vs, tau, lam_full, rows, acc);
#pragma unroll
    for (int d = 0; d < N; ++d) {
      accq[d] = accq[d] + m.w[s] * vs[d];
      accv[d] = accv[d] + m.w[s] * acc[d];
      kq[d] = vs[d];
      kv[d] = acc[d];
    }
  }
  T qn[NQ];
  integrate_pos(m, q, accq, m.h, m.half_h, qn);
#pragma unroll
  for (int i = 0; i < NQ; ++i) q[i] = qn[i];
#pragma unroll
  for (int d = 0; d < N; ++d) qv[d] = qv[d] + m.h * accv[d];
}

// One Euler-implicit substep: the velocity by the implicitly damped
// acceleration, then the positions by the new velocity; q_snap gets the
// pre-integration (normalized) qpos, which mj_step leaves in data.xpos.
template <typename T, int N, int NQ, int F, int R>
__device__ void euler_substep(const Model<T>& m, T (&q)[NQ], T (&qv)[N], const T (&tau)[N],
                              T* lam_full, Rows<T, N, R>& rows, T (&q_snap)[NQ]) {
  normalize_quats(m, q);
  T acc[N];
  forward_acc<T, N, NQ, F, R>(m, q, qv, tau, lam_full, rows, acc);
#pragma unroll
  for (int d = 0; d < N; ++d) qv[d] = qv[d] + m.h * acc[d];
#pragma unroll
  for (int i = 0; i < NQ; ++i) q_snap[i] = q[i];
  integrate_pos(m, q_snap, qv, m.h, m.half_h, q);
}

constexpr int kIntHeader = 16;
constexpr int kDoubleHeader = 20;
constexpr int kIntsPerBody = 4, kIntsPerJoint = 4, kIntsPerContact = 3, kIntsPerLimit = 2;
constexpr int kIntsPerPair = 2, kIntsPerSelfPair = 4;
constexpr int kDoublesPerDof = 3, kDoublesPerBody = 22, kDoublesPerJoint = 24;
constexpr int kDoublesPerContact = 16, kDoublesPerLimit = 9, kDoublesPerPair = 19;
constexpr int kDoublesPerSelfPair = 26, kDoublesPerSpring = 2;

// One control step from the state (q, qv) under the actions a (clamped to
// +-act_clip for the torque): frame_skip substeps from lambda = 0, lambda
// chained; q_snap gets the snapshot of the last substep.
template <typename T, int N, int NQ, int F, int R>
__device__ void control_step(const Model<T>& m, T (&q)[NQ], T (&qv)[N], const T* a, T* lam_full,
                             Rows<T, N, R>& rows, T (&q_snap)[NQ]) {
  T tau[N];
#pragma unroll
  for (int d = 0; d < N; ++d) tau[d] = T(0);
  for (int i = 0; i < m.n_act; ++i) {
    const int dof = m.act_dof[i];
#pragma unroll
    for (int d = 0; d < N; ++d)
      if (d == dof) tau[d] = m.gear[i] * clip(a[i], -m.act_clip, m.act_clip);
  }
  for (int r = 0; r < m.n_rows; ++r) lam_full[r] = T(0);
#pragma unroll
  for (int i = 0; i < NQ; ++i) q_snap[i] = q[i];
  for (int s = 0; s < m.frame_skip; ++s) {
    if (F & kEuler)
      euler_substep<T, N, NQ, F, R>(m, q, qv, tau, lam_full, rows, q_snap);
    else
      rk4_substep<T, N, NQ, F, R>(m, q, qv, tau, lam_full, rows, q_snap);
  }
}

template <typename T>
__device__ __forceinline__ T dist3(const T* x, int i, int j) {
  const T d0 = x[i] - x[j], d1 = x[i + 1] - x[j + 1], d2 = x[i + 2] - x[j + 2];
  const T s = d0 * d0 + d1 * d1 + d2 * d2;
  return d_sqrt(s < T(1e-30) ? T(1e-30) : s);
}

// The body-mass-weighted world com x of the frames (gymnasium's mass_center
// over data.xipos), summed in the plain version's order.
template <typename T, int N>
__device__ T com_x(const Model<T>& m, const Kin<T, N>& kin) {
  T s = T(0);
  for (int b = 0; b < m.nb; ++b) {
    const Body<T>& bd = m.body[b];
    const T* r = kin.R[b];
    const T cx = ((kin.o[b][0] + r[0] * bd.com[0]) + r[1] * bd.com[1]) + r[2] * bd.com[2];
    s = s + bd.mass * cx;
  }
  return s * m.inv_total_mass;
}

// Adds the wrench (torque about com, force) of the force f at the point cp,
// times sgn, to a body's row of acc
template <typename T>
__device__ __forceinline__ void add_wrench(T (*acc)[6], int body, const T* cp, const T* com,
                                           const T* f, T sgn) {
  T rel[3], tq[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) rel[i] = cp[i] - com[i];
  cross(rel, f, tq);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    acc[body][i] = acc[body][i] + sgn * tq[i];
    acc[body][3 + i] = acc[body][3 + i] + sgn * f[i];
  }
}

// Sum over the bodies of |cfrc_ext|^2 of the QP forces lam (model rows) at
// the frames, as the plain version's contact_force_ssq: per body the world
// (torque about the whole robot's com, force); a pyramid's force is
// n sum(lam) + mu t1 (lam0 - lam1) + mu t2 (lam2 - lam3), a condim-1 or pair
// row's n lam, +f on body2 and -f on body1; limit rows carry no force.
template <typename T, int N, int F>
__device__ T contact_force_ssq(const Model<T>& m, const Kin<T, N>& kin, const T* lam) {
  T com[3] = {T(0), T(0), T(0)}, acc[kMaxBodies][6];
  for (int b = 0; b < m.nb; ++b) {
    const Body<T>& bd = m.body[b];
    T t[3];
    rvec(kin.R[b], bd.com, t);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      com[i] = com[i] + bd.mass * (kin.o[b][i] + t[i]);
      acc[b][i] = acc[b][3 + i] = T(0);
    }
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) com[i] = m.inv_total_mass * com[i];
  int r = m.n_limits;
  for (int ci = 0; ci < m.n_contacts; ++ci) {
    const Contact<T>& ct = m.con[ci];
    T p[3], f[3];
    rvec(kin.R[ct.body], ct.local, p);
#pragma unroll
    for (int i = 0; i < 3; ++i) p[i] = kin.o[ct.body][i] + p[i];
    const T dist = (p[2] - m.floor_z) - ct.radius;
    const T cp[3] = {p[0], p[1], m.floor_z + T(0.5) * dist};
    if ((F & kCondim1) && ct.condim == 1) {
      f[0] = f[1] = T(0);
      f[2] = lam[r];
      r += 1;
    } else {
      T t1x = T(0), t1y = T(1);
      if (ct.has_axis) {
        T a[3];
        rvec(kin.R[ct.body], ct.axis, a);
        const T n2 = a[0] * a[0] + a[1] * a[1];
        const T nrm = d_sqrt(n2 < T(1e-24) ? T(1e-24) : n2);
        t1x = a[0] / nrm;
        t1y = a[1] / nrm;
      }
      const T fn = ((lam[r] + lam[r + 1]) + lam[r + 2]) + lam[r + 3];
      const T ft1 = ct.mu * (lam[r] - lam[r + 1]);
      const T ft2 = ct.mu * (lam[r + 2] - lam[r + 3]);
      f[0] = ft1 * t1x + ft2 * (-t1y);
      f[1] = ft1 * t1y + ft2 * t1x;
      f[2] = fn;
      r += 4;
    }
    add_wrench(acc, ct.body, cp, com, f, T(1));
  }
  if (F & kCylinder) {
    for (int pi = 0; pi < m.n_cyl; ++pi, ++r) {
      const CylPair<T>& pr = m.cyl[pi];
      T dist, nvec[3], cp[3], f[3];
      capsule_cylinder(kin, pr, dist, nvec, cp);
#pragma unroll
      for (int i = 0; i < 3; ++i) f[i] = lam[r] * nvec[i];
      add_wrench(acc, pr.body2, cp, com, f, T(1));
      add_wrench(acc, pr.body1, cp, com, f, T(-1));
    }
  }
  if (F & kSelfPairs) {
    for (int pi = 0; pi < m.n_cap; ++pi, ++r) {
      const CapPair<T>& pr = m.cap[pi];
      T dist, nvec[3], cp[3], f[3];
      capsule_capsule(kin, pr, dist, nvec, cp);
#pragma unroll
      for (int i = 0; i < 3; ++i) f[i] = lam[r] * nvec[i];
      add_wrench(acc, pr.body2, cp, com, f, T(1));
      add_wrench(acc, pr.body1, cp, com, f, T(-1));
    }
  }
  T s = T(0);
  for (int b = 0; b < m.nb; ++b) {
#pragma unroll
    for (int c = 0; c < 6; ++c) s = s + acc[b][c] * acc[b][c];
  }
  return s;
}

// What one thread of the kernel does for sample k: from x0 + k * x_stride
// (qpos, qvel, the family's carry) it applies `horizon` control steps; action
// i of step t is controls[t * c_t + i * c_i + k * c_k]. Per step the family
// reads the snapshot into the new carry and rewards:
//   locomotion: carry = the snapshot's root x (the `q0` track) or, with
//     kComX, its mass-weighted com x; reward = healthy + (carry' - carry)
//     fwd_w / dt - ctrl_w sum a^2;
//   pusher: carry = the frame origins of the tips, object and goal bodies
//     (their data.xpos); reward = -|obj - goal| - ctrl_w sum a^2
//     - 0.5 |obj - tips| of the previous carry (the pre-step data.xpos);
//   standup: carry = the snapshot's sum of |cfrc_ext|^2 from the last QP's
//     lambda; reward = q'[2] / h - ctrl_w sum a^2 - min(0.5e-6 carry', 10)
//     + healthy.
// The reward reads the action as given, or clipped to +-act_clip with kComX
// and in the `standup` family. Writes costs[k] (the rollout entry) or the
// state to x_out (the step entry, horizon 1) where not null.
template <typename T, int N, int NQ, int F, int R>
__device__ void run_sample(const Model<T>& m, int k, const T* x0, long long x_stride,
                           const T* controls, long long c_t, long long c_i, long long c_k,
                           int horizon, T* costs, T* x_out, T* lam_full, Rows<T, N, R>& rows) {
  constexpr int NC = Carry<F>::n;
  T a[kMaxAct], q[NQ], qv[N], carry[NC], q_snap[NQ];
  const T* xk = x0 + k * x_stride;
#pragma unroll
  for (int i = 0; i < NQ; ++i) q[i] = xk[i];
#pragma unroll
  for (int d = 0; d < N; ++d) qv[d] = xk[NQ + d];
#pragma unroll
  for (int i = 0; i < NC; ++i) carry[i] = xk[NQ + N + i];
  T cost = T(0);
  for (int t = 0; t < horizon; ++t) {
    for (int i = 0; i < m.n_act; ++i) a[i] = controls[t * c_t + i * c_i + k * c_k];
    control_step<T, N, NQ, F, R>(m, q, qv, a, lam_full, rows, q_snap);
    T ssq = T(0);
    for (int i = 0; i < m.n_act; ++i) ssq = ssq + a[i] * a[i];
    T rew;
    if (F & kStandup) {
      Kin<T, N> kin;
      compute_frames<T, N, NQ, F>(m, q_snap, kin);
      const T cfrc = contact_force_ssq<T, N, F>(m, kin, lam_full);
      T ssq_c = T(0);
      for (int i = 0; i < m.n_act; ++i) {
        const T ai = clip(a[i], -m.act_clip, m.act_clip);
        ssq_c = ssq_c + ai * ai;
      }
      const T impact = T(0.5e-6) * cfrc;
      rew = ((q[2] / m.h - m.ctrl_w * ssq_c) - (impact < T(10) ? impact : T(10))) + m.healthy;
      carry[0] = cfrc;
    } else if (F & kComX) {
      Kin<T, N> kin;
      compute_frames<T, N, NQ, F>(m, q_snap, kin);
      const T track = com_x(m, kin);
      rew = m.healthy + (track - carry[0]) * m.fwd_inv_dt;
      for (int i = 0; i < m.n_act; ++i) {
        const T ai = clip(a[i], -m.act_clip, m.act_clip);
        rew = rew - m.ctrl_w * (ai * ai);
      }
      carry[0] = track;
    } else if (F & kPusher) {
      rew = -dist3(carry, 3, 6) - m.ctrl_w * ssq - T(0.5) * dist3(carry, 3, 0);
      Kin<T, N> kin;
      compute_frames<T, N, NQ, F>(m, q_snap, kin);
#pragma unroll
      for (int b = 0; b < kCarryBodies; ++b) {
#pragma unroll
        for (int i = 0; i < 3; ++i) carry[3 * b + i] = kin.o[m.carry_body[b]][i];
      }
    } else {
      rew = m.healthy + (q_snap[0] - carry[0]) * m.fwd_inv_dt;
      for (int i = 0; i < m.n_act; ++i) rew = rew - m.ctrl_w * (a[i] * a[i]);
      carry[0] = q_snap[0];
    }
    cost = cost - rew;
  }
  if (costs) costs[k] = cost;
  if (x_out) {
    T* xo = x_out + static_cast<long long>(k) * (NQ + N + NC);
#pragma unroll
    for (int i = 0; i < NQ; ++i) xo[i] = q[i];
#pragma unroll
    for (int d = 0; d < N; ++d) xo[NQ + d] = qv[d];
#pragma unroll
    for (int i = 0; i < NC; ++i) xo[NQ + N + i] = carry[i];
  }
}

// Reads the flat arrays packed by the wrapper into the device struct; returns
// false if their layout or counts do not fit, or if the model has what the
// feature mask it declares does not take.
//   ints: header (n_dof, n_q, bodies, joints, contacts, limits, actuators,
//     cylinder pairs, self pairs, frame_skip, outer, cg, the feature mask,
//     the 3 carry bodies of the `pusher` family or -1); per body parent,
//     first joint, joint count, chain dof mask; per joint body, kind, dof,
//     qadr; per contact body, has_axis, condim; per limit dof, qadr; per
//     actuator dof; per cylinder pair body1, body2; per self pair body1,
//     body2, and whether each end is a capsule.
//   doubles: header (gravity, floor_z, h, h/2, healthy, fwd_w/dt, ctrl_w, the
//     action clip, the 4 stage c*h, the 4 stage c*h/2, the 4 stage weights);
//     per dof damping, armature, h*damping; per body pos, rotation (9), com,
//     mass, inertia (6); per joint axis, anchor, K (9), K^2 (9); per contact
//     local, axis, radius, mu, margin, body invweight, pyramid factor,
//     impedance (5); per limit lo, hi, margin, dof invweight, impedance (5);
//     per actuator its gear; per cylinder pair a1, b1, centre (3 each), r1,
//     r2, half height, margin, the bodies' summed invweight, impedance (5);
//     per self pair a1, d1, a2, d2 (3 each), la le, 1e-12 la le, le, 1/la,
//     1/le, r1, r2, margin, the summed invweight, impedance (5); with
//     kSprings, per dof stiffness and springref.
// The total mass is summed here, in double, in body order.
template <typename T>
bool make_model(const int* ip, int n_int, const double* dp, int n_double, Model<T>* out) {
  if (n_int < kIntHeader || n_double < kDoubleHeader) return false;
  Model<T>& m = *out;
  m = Model<T>{};
  const int nd = ip[0], nq = ip[1], nb = ip[2], nj = ip[3], nc = ip[4], nl = ip[5], na = ip[6];
  const int n_cyl = ip[7], n_self = ip[8];
  m.n_dof = nd;
  m.n_q = nq;
  m.nb = nb;
  m.nj = nj;
  m.n_contacts = nc;
  m.n_limits = nl;
  m.n_act = na;
  m.n_cyl = n_cyl;
  m.frame_skip = ip[9];
  m.outer = ip[10];
  m.cg = ip[11];
  m.features = ip[12];
  const int fx = m.features;
  if (nd < 1 || nd > kMaxDof || nq < nd || nb < 1 || nb > kMaxBodies || nj < 0 ||
      nj > kMaxJoints || nc < 0 || nc > kMaxContacts || nl < 0 || nl > kMaxLimits || na < 0 ||
      na > kMaxAct || n_cyl < 0 || n_cyl > kMaxPairs || (n_cyl > 0 && !(fx & kCylinder)) ||
      n_self < 0 || n_self > kMaxSelfPairs || (n_self > 0 && !(fx & kSelfPairs)) ||
      m.frame_skip < 0 || m.outer < 0 || m.cg < 0)
    return false;
  m.n_cap = n_self;
  for (int b = 0; b < kCarryBodies; ++b) {
    m.carry_body[b] = ip[13 + b];
    if ((fx & kPusher) && (m.carry_body[b] < 0 || m.carry_body[b] >= nb)) return false;
  }
  if (n_int != kIntHeader + kIntsPerBody * nb + kIntsPerJoint * nj + kIntsPerContact * nc +
                   kIntsPerLimit * nl + na + kIntsPerPair * n_cyl + kIntsPerSelfPair * n_self)
    return false;
  if (n_double != kDoubleHeader + kDoublesPerDof * nd + kDoublesPerBody * nb +
                      kDoublesPerJoint * nj + kDoublesPerContact * nc + kDoublesPerLimit * nl +
                      na + kDoublesPerPair * n_cyl + kDoublesPerSelfPair * n_self +
                      ((fx & kSprings) ? kDoublesPerSpring * nd : 0))
    return false;
  const int* ic = ip + kIntHeader;
  const double* dc = dp;
  m.gravity = T(dc[0]);
  m.floor_z = T(dc[1]);
  m.h = T(dc[2]);
  m.half_h = T(dc[3]);
  m.healthy = T(dc[4]);
  m.fwd_inv_dt = T(dc[5]);
  m.ctrl_w = T(dc[6]);
  m.act_clip = T(dc[7]);
  for (int s = 0; s < 4; ++s) {
    m.ch[s] = T(dc[8 + s]);
    m.half_ch[s] = T(dc[12 + s]);
    m.w[s] = T(dc[16 + s]);
  }
  dc += kDoubleHeader;
  for (int d = 0; d < nd; ++d, dc += kDoublesPerDof) {
    m.damping[d] = T(dc[0]);
    m.armature[d] = T(dc[1]);
    m.h_damping[d] = T(dc[2]);
    m.dof_rot[d] = 0;
    m.spring_qadr[d] = -1;
  }
  double total_mass = 0.0;
  for (int b = 0; b < nb; ++b, dc += kDoublesPerBody, ic += kIntsPerBody) {
    Body<T>& bd = m.body[b];
    total_mass += dc[15];
    for (int i = 0; i < 3; ++i) {
      bd.pos[i] = T(dc[i]);
      bd.com[i] = T(dc[12 + i]);
    }
    for (int i = 0; i < 9; ++i) bd.rot[i] = T(dc[3 + i]);
    bd.mass = T(dc[15]);
    const double* in = dc + 16;  // xx, xy, xz, yy, yz, zz
    const double full[9] = {in[0], in[1], in[2], in[1], in[3], in[4], in[2], in[4], in[5]};
    for (int i = 0; i < 9; ++i) bd.inertia[i] = T(full[i]);
    bd.parent = ic[0];
    bd.j0 = ic[1];
    bd.nj = ic[2];
    bd.chain = static_cast<unsigned>(ic[3]);
    if (bd.parent >= b || bd.j0 < 0 || bd.nj < 0 || bd.j0 + bd.nj > nj) return false;
  }
  for (int j = 0; j < nj; ++j, dc += kDoublesPerJoint, ic += kIntsPerJoint) {
    Joint<T>& J = m.jnt[j];
    for (int i = 0; i < 3; ++i) {
      J.axis[i] = T(dc[i]);
      J.anchor[i] = T(dc[3 + i]);
    }
    for (int i = 0; i < 9; ++i) {
      J.k[i] = T(dc[6 + i]);
      J.k2[i] = T(dc[15 + i]);
    }
    J.body = ic[0];
    J.kind = ic[1];
    J.dof = ic[2];
    J.qadr = ic[3];
    if (J.body < 0 || J.body >= nb || J.kind < kFree || J.kind > kSlide ||
        (J.kind == kSlide && !(fx & kSlideJoints)))
      return false;
    const int ndj = J.kind == kFree ? 6 : 1, nqj = J.kind == kFree ? 7 : 1;
    if (J.dof < 0 || J.dof + ndj > nd || J.qadr < 0 || J.qadr + nqj > nq) return false;
    // a free joint is alone on its body (the bias reads its rotation there)
    if (J.kind == kFree && m.body[J.body].nj != 1) return false;
    if (J.kind == kFree) {
      for (int i = 3; i < 6; ++i) m.dof_rot[J.dof + i] = 1;
    } else if (J.kind == kHinge) {
      m.dof_rot[J.dof] = 1;
    }
    if (J.kind != kFree) m.spring_qadr[J.dof] = J.qadr;
  }
  m.inv_total_mass = T(1.0 / total_mass);
  auto imp = [](const double* v) {
    return Imp<T>{T(v[0]), T(v[1]), T(v[2]), T(v[3]), T(v[4])};
  };
  for (int c = 0; c < nc; ++c, dc += kDoublesPerContact, ic += kIntsPerContact) {
    Contact<T>& ct = m.con[c];
    for (int i = 0; i < 3; ++i) {
      ct.local[i] = T(dc[i]);
      ct.axis[i] = T(dc[3 + i]);
    }
    ct.radius = T(dc[6]);
    ct.mu = T(dc[7]);
    ct.margin = T(dc[8]);
    ct.bw = T(dc[9]);
    ct.rfac = T(dc[10]);
    ct.imp = imp(dc + 11);
    ct.body = ic[0];
    ct.has_axis = ic[1];
    ct.condim = ic[2];
    if (ct.body < 0 || ct.body >= nb || (ct.condim != 3 && ct.condim != 1) ||
        (ct.condim == 1 && !(fx & kCondim1)))
      return false;
    m.n_rows += ct.condim == 3 ? 4 : 1;
  }
  for (int l = 0; l < nl; ++l, dc += kDoublesPerLimit, ic += kIntsPerLimit) {
    Limit<T>& lm = m.lim[l];
    lm.lo = T(dc[0]);
    lm.hi = T(dc[1]);
    lm.margin = T(dc[2]);
    lm.invweight = T(dc[3]);
    lm.imp = imp(dc + 4);
    lm.dof = ic[0];
    lm.qadr = ic[1];
    if (lm.dof < 0 || lm.dof >= nd || lm.qadr < 0 || lm.qadr >= nq) return false;
  }
  for (int i = 0; i < na; ++i) {
    m.gear[i] = T(dc[i]);
    m.act_dof[i] = ic[i];
    if (ic[i] < 0 || ic[i] >= nd) return false;
  }
  dc += na;
  ic += na;
  for (int p = 0; p < n_cyl; ++p, dc += kDoublesPerPair, ic += kIntsPerPair) {
    CylPair<T>& pr = m.cyl[p];
    for (int i = 0; i < 3; ++i) {
      pr.a1[i] = T(dc[i]);
      pr.b1[i] = T(dc[3 + i]);
      pr.center2[i] = T(dc[6 + i]);
    }
    pr.r1 = T(dc[9]);
    pr.r2 = T(dc[10]);
    pr.hh2 = T(dc[11]);
    pr.margin = T(dc[12]);
    pr.bw = T(dc[13]);
    pr.imp = imp(dc + 14);
    pr.body1 = ic[0];
    pr.body2 = ic[1];
    if (pr.body1 < 0 || pr.body1 >= nb || pr.body2 < 0 || pr.body2 >= nb) return false;
  }
  for (int p = 0; p < n_self; ++p, dc += kDoublesPerSelfPair, ic += kIntsPerSelfPair) {
    CapPair<T>& pr = m.cap[p];
    for (int i = 0; i < 3; ++i) {
      pr.a1[i] = T(dc[i]);
      pr.d1[i] = T(dc[3 + i]);
      pr.a2[i] = T(dc[6 + i]);
      pr.d2[i] = T(dc[9 + i]);
    }
    pr.lale = T(dc[12]);
    pr.den_eps = T(dc[13]);
    pr.le = T(dc[14]);
    pr.inv_la = T(dc[15]);
    pr.inv_le = T(dc[16]);
    pr.r1 = T(dc[17]);
    pr.r2 = T(dc[18]);
    pr.margin = T(dc[19]);
    pr.bw = T(dc[20]);
    pr.imp = imp(dc + 21);
    pr.body1 = ic[0];
    pr.body2 = ic[1];
    pr.seg1 = ic[2];
    pr.seg2 = ic[3];
    if (pr.body1 < 0 || pr.body1 >= nb || pr.body2 < 0 || pr.body2 >= nb) return false;
  }
  for (int d = 0; d < nd; ++d) {
    m.stiffness[d] = (fx & kSprings) ? T(dc[kDoublesPerSpring * d]) : T(0);
    m.springref[d] = (fx & kSprings) ? T(dc[kDoublesPerSpring * d + 1]) : T(0);
    if (m.stiffness[d] != T(0) && m.spring_qadr[d] < 0) return false;  // a sprung free dof
  }
  // the rows: limits, then 4 per condim-3 contact or 1 per condim-1 one
  // (counted above), then one per cylinder pair and one per self pair
  m.n_rows += nl + n_cyl + n_self;
  return m.n_rows <= ((fx & kSelfPairs) ? kMaxRowsWide : kMaxRows);
}

}  // namespace spatial
