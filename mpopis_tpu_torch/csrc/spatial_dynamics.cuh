// Spatial (3D) contact dynamics of one sample, for the rollout kernel in
// spatial_rollout.cu: quaternion forward kinematics, the analytic mass matrix
// and bias, the joint-limit and floor-contact rows (condim 3 pyramids), the
// warm-started box QP and the RK4 substep over the quaternion manifold.
// Free and hinge joints only, no joint springs, no contact pairs: what Ant
// has (make_model refuses the rest).
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

enum JointKind { kFree = 0, kHinge = 1 };

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
  int body, has_axis;
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
  T damping[kMaxDof], armature[kMaxDof];
  int dof_rot[kMaxDof];  // rotational dof
  T gear[kMaxAct];
  int act_dof[kMaxAct];
  T gravity, floor_z, h, half_h, healthy, fwd_inv_dt, ctrl_w;
  T ch[4], half_ch[4], w[4];  // RK4 stage c*h, c*h/2 and weights
  int n_dof, n_q, nb, nj, n_contacts, n_limits, n_act, n_rows;
  int frame_skip, outer, cg;
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

template <typename T, int N, int NQ>
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
template <typename T, int N>
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

// The rows valid at this state, compacted; idx maps each to its row of the
// model (the index of its lambda warm start).
template <typename T, int N>
struct Rows {
  T J[kMaxRows][N];
  T aref[kMaxRows], reg[kMaxRows];
  int idx[kMaxRows];
  int nv;
};

template <typename T, int N, int NQ>
__device__ void contact_rows(const Model<T>& m, const T (&q)[NQ], const T (&qv)[N],
                             const Kin<T, N>& kin, Rows<T, N>& rows) {
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
    if (!(dist < ct.margin)) {
      r += 4;
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
  rows.nv = nv;
}

// out = mask ? J (L L^T)^-1 J^T (mask ? v : 0) + R (mask ? v : 0) : 0 over the
// compacted rows; a null mask means every row
template <typename T, int N>
__device__ void ar_apply(const Rows<T, N>& rows, const T (&L)[N][N], const T* v, const bool* mask,
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
template <typename T, int N>
__device__ void solve_qp(const Model<T>& m, const Rows<T, N>& rows, const T (&L)[N][N],
                         const T (&a_smooth)[N], T* lam_full, T (&qfrc)[N]) {
  const int nv = rows.nv;
  T lam[kMaxRows], rhs[kMaxRows], g[kMaxRows], x[kMaxRows], res[kMaxRows], p[kMaxRows];
  T ap[kMaxRows], best[kMaxRows];
  bool act[kMaxRows];
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
// lam_full warm-starts the QP and returns its solution. Kept out of line:
// RK4 calls it 4 times per substep.
template <typename T, int N, int NQ>
__device__ __noinline__ void forward_acc(const Model<T>& m, const T (&q)[NQ], const T (&qv)[N],
                                         const T (&tau)[N], T* lam_full, Rows<T, N>& rows,
                                         T (&acc)[N]) {
  Kin<T, N> kin;
  compute_frames(m, q, kin);
  T M[N][N], L[N][N], bias[N], smooth[N], a_smooth[N], qfrc[N];
  mass_and_bias(m, kin, qv, M, bias);
  cholesky(M, L);
#pragma unroll
  for (int d = 0; d < N; ++d) smooth[d] = tau[d] - bias[d] - m.damping[d] * qv[d];
  chol_solve(L, smooth, a_smooth);
  contact_rows(m, q, qv, kin, rows);
  solve_qp(m, rows, L, a_smooth, lam_full, qfrc);
#pragma unroll
  for (int d = 0; d < N; ++d) smooth[d] = smooth[d] + qfrc[d];
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

// One RK4 substep: positions of each stage from the normalized q0 by the
// previous stage's velocity, the weighted velocities accumulated stage by
// stage, lambda chained through the stages; q4 gets the last stage's qpos.
template <typename T, int N, int NQ>
__device__ void rk4_substep(const Model<T>& m, T (&q)[NQ], T (&qv)[N], const T (&tau)[N],
                            T* lam_full, Rows<T, N>& rows, T (&q4)[NQ]) {
  for (int jj = 0; jj < m.nj; ++jj) {
    const Joint<T>& J = m.jnt[jj];
    if (J.kind != kFree) continue;
    const int a = J.qadr + 3;
    const T inv = d_rsqrt(q[a] * q[a] + q[a + 1] * q[a + 1] + q[a + 2] * q[a + 2] +
                          q[a + 3] * q[a + 3]);
#pragma unroll
    for (int i = 0; i < 4; ++i) q[a + i] = q[a + i] * inv;
  }
  T kq[N], kv[N], accq[N], accv[N], vs[N], acc[N];
#pragma unroll
  for (int d = 0; d < N; ++d) {
    kq[d] = qv[d];
    kv[d] = accq[d] = accv[d] = T(0);
  }
#pragma unroll 1
  for (int s = 0; s < 4; ++s) {
    integrate_pos(m, q, kq, m.ch[s], m.half_ch[s], q4);
#pragma unroll
    for (int d = 0; d < N; ++d) vs[d] = qv[d] + m.ch[s] * kv[d];
    forward_acc(m, q4, vs, tau, lam_full, rows, acc);
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

constexpr int kIntHeader = 12;
constexpr int kDoubleHeader = 19;
constexpr int kIntsPerBody = 4, kIntsPerJoint = 4, kIntsPerContact = 2, kIntsPerLimit = 2;
constexpr int kDoublesPerDof = 2, kDoublesPerBody = 22, kDoublesPerJoint = 24;
constexpr int kDoublesPerContact = 16, kDoublesPerLimit = 9;

// One control step from the state (q, qv, track) under the actions a
// (clamped for the torque). Returns the new track value; reward reads a as given.
template <typename T, int N, int NQ>
__device__ T control_step(const Model<T>& m, T (&q)[NQ], T (&qv)[N], const T* a, T* lam_full,
                          Rows<T, N>& rows) {
  T tau[N];
#pragma unroll
  for (int d = 0; d < N; ++d) tau[d] = T(0);
  for (int i = 0; i < m.n_act; ++i) {
    const int dof = m.act_dof[i];
#pragma unroll
    for (int d = 0; d < N; ++d)
      if (d == dof) tau[d] = m.gear[i] * clip(a[i], T(-1), T(1));
  }
  for (int r = 0; r < m.n_rows; ++r) lam_full[r] = T(0);
  T q4[NQ];
#pragma unroll
  for (int i = 0; i < NQ; ++i) q4[i] = q[i];
  for (int s = 0; s < m.frame_skip; ++s) rk4_substep(m, q, qv, tau, lam_full, rows, q4);
  return q4[0];  // the `q0` track: the root's x
}

// Reads the flat arrays packed by the wrapper into the device struct; returns
// false if their layout or counts do not fit what the kernel takes.
//   ints: header (n_dof, n_q, bodies, joints, contacts, limits, actuators,
//     cylinder pairs, self pairs, frame_skip, outer, cg); per body parent,
//     first joint, joint count, chain dof mask; per joint body, kind, dof,
//     qadr; per contact body, has_axis; per limit dof, qadr; per actuator dof.
//   doubles: header (gravity, floor_z, h, h/2, healthy, fwd_w/dt, ctrl_w, the
//     4 stage c*h, the 4 stage c*h/2, the 4 stage weights); per dof damping,
//     armature; per body pos, rotation (9), com, mass, inertia (6); per joint
//     axis, anchor, K (9), K^2 (9); per contact local, axis, radius, mu,
//     margin, body invweight, pyramid factor, impedance (5); per limit lo, hi,
//     margin, dof invweight, impedance (5); per actuator its gear.
// The pair counts must be 0: a model with pairs is refused until their rows
// are taken, and their tables will follow the actuators'.
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
  m.frame_skip = ip[9];
  m.outer = ip[10];
  m.cg = ip[11];
  if (nd < 1 || nd > kMaxDof || nq < nd || nb < 1 || nb > kMaxBodies || nj < 0 ||
      nj > kMaxJoints || nc < 0 || nc > kMaxContacts || nl < 0 || nl > kMaxLimits || na < 0 ||
      na > kMaxAct || n_cyl != 0 || n_self != 0 || m.frame_skip < 0 || m.outer < 0 || m.cg < 0)
    return false;
  if (n_int != kIntHeader + kIntsPerBody * nb + kIntsPerJoint * nj + kIntsPerContact * nc +
                   kIntsPerLimit * nl + na)
    return false;
  if (n_double != kDoubleHeader + kDoublesPerDof * nd + kDoublesPerBody * nb +
                      kDoublesPerJoint * nj + kDoublesPerContact * nc + kDoublesPerLimit * nl + na)
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
  for (int s = 0; s < 4; ++s) {
    m.ch[s] = T(dc[7 + s]);
    m.half_ch[s] = T(dc[11 + s]);
    m.w[s] = T(dc[15 + s]);
  }
  dc += kDoubleHeader;
  for (int d = 0; d < nd; ++d, dc += kDoublesPerDof) {
    m.damping[d] = T(dc[0]);
    m.armature[d] = T(dc[1]);
    m.dof_rot[d] = 0;
  }
  for (int b = 0; b < nb; ++b, dc += kDoublesPerBody, ic += kIntsPerBody) {
    Body<T>& bd = m.body[b];
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
    if (J.body < 0 || J.body >= nb || J.kind < kFree || J.kind > kHinge) return false;
    const int ndj = J.kind == kFree ? 6 : 1, nqj = J.kind == kFree ? 7 : 1;
    if (J.dof < 0 || J.dof + ndj > nd || J.qadr < 0 || J.qadr + nqj > nq) return false;
    // a free joint is alone on its body (the bias reads its rotation there)
    if (J.kind == kFree && m.body[J.body].nj != 1) return false;
    if (J.kind == kFree) {
      for (int i = 3; i < 6; ++i) m.dof_rot[J.dof + i] = 1;
    } else {
      m.dof_rot[J.dof] = 1;
    }
  }
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
    if (ct.body < 0 || ct.body >= nb) return false;
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
  m.n_rows = nl + 4 * nc;  // each contact a condim-3 pyramid
  return m.n_rows <= kMaxRows;
}

}  // namespace spatial
