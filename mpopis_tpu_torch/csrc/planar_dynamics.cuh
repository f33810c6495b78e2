// Planar contact dynamics of one sample, for the rollout kernels in
// planar_rollout.cu (HalfCheetah, Hopper, Walker2d) and swimmer_rollout.cu
// (Swimmer): frames, the analytic mass matrix and bias, the constraint rows
// (joint limits; three rows per plane-capsule contact, the merged normal row
// at R/2; capsule-capsule pairs by Ericson's closest points), the
// warm-started box QP (fixed-iteration active set / CG / projected arc
// search), the Euler-implicit and RK4 substeps, the control step with its
// locomotion reward, and the host-side reader of the packed model.
//
// A transcription of the plain PyTorch version
// (mpopis_tpu_torch/models/planar_contact.py). The dof count N is a template
// parameter (5 for the Swimmer, 6 for Hopper, 9 for HalfCheetah and
// Walker2d), so every dof loop unrolls; body b owns hinge dof b + 2. FLUID, a
// compile-time flag, adds the Swimmer's inertia-box fluid force
// (models/swimmer_device.py::fluid_force) to the smooth force at every
// integrator stage; without it the code is the contact tasks' alone.
//
// The header compiles as host C++ too (tests/planar_host_check.cpp defines
// the CUDA keywords away), so its arithmetic is checked where there is no
// card.
#pragma once

namespace planar {

constexpr int kMaxBodies = 7;
constexpr int kMaxDof = kMaxBodies + 2;
constexpr int kMaxContacts = 16;
constexpr int kMaxLimits = 6;
constexpr int kMaxPairs = 3;
constexpr int kMaxRows = kMaxLimits + 3 * kMaxContacts + kMaxPairs;
constexpr int kBlock = 32;
constexpr int kIntHeader = 10;
constexpr int kDoubleHeader = 9;

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

template <typename T, int N>
struct Frames {
  static constexpr int NB = N - 2;
  T ox[NB], oz[NB], th[NB], awx[NB], awz[NB], c[NB], s[NB];

  // (origin x, origin z, cos, sin) of a body given at run time
  __device__ __forceinline__ void of(int b, T& x, T& z, T& cb, T& sb) const {
#pragma unroll
    for (int e = 0; e < NB; ++e) {
      if (e == b) {
        x = ox[e];
        z = oz[e];
        cb = c[e];
        sb = s[e];
      }
    }
  }
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
      T pox = T(0), poz = T(0), pth = T(0), cp = T(0), sp = T(0);
#pragma unroll
      for (int p = 0; p < b; ++p) {
        if (p == bd.parent) {
          pox = f.ox[p];
          poz = f.oz[p];
          pth = f.th[p];
          cp = f.c[p];
          sp = f.s[p];
        }
      }
      f.th[b] = pth + bd.sign * q[b + 2];
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

// Mass matrix (lower triangle) and bias, body by body in the plain version's
// order: armature, then per body m (Jx Jx^T + Jz Jz^T) and I w w^T.
template <typename T, int N>
__device__ __forceinline__ void mass_and_bias(const Model<T>& m, const T (&qv)[N],
                                              const Frames<T, N>& f, T (&M)[N][N],
                                              T (&bias)[N]) {
  constexpr int NB = N - 2;
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
      T po = T(0), pvx = T(0), pvz = T(0), pax = T(0), paz = T(0), pwx = T(0), pwz = T(0);
#pragma unroll
      for (int p = 0; p < b; ++p) {
        if (p == bd.parent) {
          po = omega[p];
          pvx = vax[p];
          pvz = vaz[p];
          pax = aax[p];
          paz = aaz[p];
          pwx = f.awx[p];
          pwz = f.awz[p];
        }
      }
      omega[b] = po + bd.sign * qv[b + 2];
      const T dx = f.awx[b] - pwx, dz = f.awz[b] - pwz;
      vax[b] = pvx + po * dz;
      vaz[b] = pvz - po * dx;
      const T vdx = vax[b] - pvx, vdz = vaz[b] - pvz;
      aax[b] = pax + po * vdz;
      aaz[b] = paz - po * vdx;
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    bias[i] = T(0);
#pragma unroll
    for (int j = 0; j <= i; ++j) M[i][j] = (i == j) ? m.armature[i] : T(0);
  }
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const Body<T>& bd = m.body[b];
    const T px = f.ox[b] + f.c[b] * bd.comx + f.s[b] * bd.comz;
    const T pz = f.oz[b] - f.s[b] * bd.comx + f.c[b] * bd.comz;
    T jx[N], jz[N], w[N];
    jx[0] = T(1);
    jz[0] = T(0);
    jx[1] = T(0);
    jz[1] = T(1);
    w[0] = T(0);
    w[1] = T(0);
#pragma unroll
    for (int e = 0; e < NB; ++e) {
      const bool on = (bd.chain >> e) & 1u;
      const T se = m.body[e].sign;
      jx[e + 2] = on ? se * (pz - f.awz[e]) : T(0);
      jz[e + 2] = on ? (-se) * (px - f.awx[e]) : T(0);
      w[e + 2] = on ? se : T(0);
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j) M[i][j] = M[i][j] + bd.mass * (jx[i] * jx[j] + jz[i] * jz[j]);
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j) M[i][j] = M[i][j] + bd.iyy * w[i] * w[j];
    }
    const T rx = px - f.awx[b], rz = pz - f.awz[b];
    const T vpx = vax[b] + omega[b] * rz;
    const T vpz = vaz[b] - omega[b] * rx;
    const T apx = aax[b] + omega[b] * (vpz - vaz[b]);
    const T apz = aaz[b] - omega[b] * (vpx - vax[b]);
    const T fx = bd.mass * apx;
    const T fz = bd.mass * (apz + m.gravity);
#pragma unroll
    for (int i = 0; i < N; ++i) bias[i] = bias[i] + (jx[i] * fx + jz[i] * fz);
  }
}

// The inertia-box fluid force of each link pulled back through its com
// Jacobian, added to out; in z-convention (theta_z = -theta, w_z = -w), as
// the plain version's fluid_force.
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
      T po = T(0), pvx = T(0), pvz = T(0), pwx = T(0), pwz = T(0);
#pragma unroll
      for (int p = 0; p < b; ++p) {
        if (p == bd.parent) {
          po = omega[p];
          pvx = vax[p];
          pvz = vaz[p];
          pwx = f.awx[p];
          pwz = f.awz[p];
        }
      }
      omega[b] = po + bd.sign * qv[b + 2];
      vax[b] = pvx + po * (f.awz[b] - pwz);
      vaz[b] = pvz - po * (f.awx[b] - pwx);
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
struct Rows {
  T J[kMaxRows][N];
  T aref[kMaxRows], reg[kMaxRows];
  bool valid[kMaxRows];
};

template <typename T, int N>
__device__ __forceinline__ T dot_row(const T (&j)[N], const T (&v)[N]) {
  T s = T(0);
#pragma unroll
  for (int d = 0; d < N; ++d) s = s + j[d] * v[d];
  return s;
}

template <typename T, int N>
__device__ void contact_rows(const Model<T>& m, const T (&q)[N], const T (&qv)[N],
                             const Frames<T, N>& f, Rows<T, N>& rows) {
  constexpr int NB = N - 2;
  int r = 0;
  for (int l = 0; l < m.n_limits; ++l, ++r) {
    const Limit<T>& lm = m.lim[l];
    T qd = T(0), qvd = T(0);
#pragma unroll
    for (int d = 0; d < N; ++d) {
      if (d == lm.dof) {
        qd = q[d];
        qvd = qv[d];
      }
    }
    const T d_lo = qd - lm.lo;
    const T d_hi = lm.hi - qd;
    const bool lower = d_lo < d_hi;
    const T pos = lower ? d_lo : d_hi;
    const T sgn = lower ? T(1) : T(-1);
    const T imp = impedance(pos, lm.imp);
#pragma unroll
    for (int d = 0; d < N; ++d) rows.J[r][d] = (d == lm.dof) ? sgn : T(0);
    rows.aref[r] = (-lm.imp.bc) * (sgn * qvd) - lm.imp.kc * imp * pos;
    rows.reg[r] = (T(1) - imp) / imp * lm.invweight;
    rows.valid[r] = pos < T(0);
  }
  for (int ci = 0; ci < m.n_contacts; ++ci) {
    const Contact<T>& ct = m.con[ci];
    T obx = T(0), obz = T(0), cb = T(0), sb = T(0);
    f.of(ct.body, obx, obz, cb, sb);
    const unsigned chain = m.body[ct.body].chain;
    const T px = obx + cb * ct.lx + sb * ct.lz;
    const T pz = obz - sb * ct.lx + cb * ct.lz;
    const T dist = pz - ct.radius;
    const bool active = dist < ct.margin;
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
    const T mus[2] = {ct.mu, -ct.mu};
#pragma unroll
    for (int k = 0; k < 2; ++k, ++r) {
#pragma unroll
      for (int d = 0; d < N; ++d) rows.J[r][d] = jn[d] + mus[k] * jt[d];
      rows.aref[r] = nbc * (jv_n + mus[k] * jv_t) + base;
      rows.reg[r] = reg;
      rows.valid[r] = active;
    }
    // the merged pure-normal pair of pyramid rows: R/2
#pragma unroll
    for (int d = 0; d < N; ++d) rows.J[r][d] = jn[d];
    rows.aref[r] = nbc * jv_n + base;
    rows.reg[r] = T(0.5) * reg;
    rows.valid[r] = active;
    ++r;
  }
  for (int pi = 0; pi < m.n_pairs; ++pi, ++r) {
    const Pair<T>& pr = m.pair[pi];
    T o1x = T(0), o1z = T(0), c1 = T(0), s1 = T(0), o2x = T(0), o2z = T(0), c2 = T(0), s2 = T(0);
    f.of(pr.body1, o1x, o1z, c1, s1);
    f.of(pr.body2, o2x, o2z, c2, s2);
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
    const T nx = dx / seg_len, nz = dz / seg_len;  // normal: geom1 -> geom2
    const T dist = seg_len - pr.r1 - pr.r2;
    const T cx = c1x + nx * (pr.r1 + T(0.5) * dist);
    const T cz = c1z + nz * (pr.r1 + T(0.5) * dist);
    rows.J[r][0] = T(0);
    rows.J[r][1] = T(0);
#pragma unroll
    for (int e = 0; e < NB; ++e) {
      const T se = m.body[e].sign;
      const T coef = ((pr.plus >> e) & 1u) ? se : (((pr.minus >> e) & 1u) ? -se : T(0));
      rows.J[r][e + 2] = coef != T(0) ? coef * (nx * (cz - f.awz[e]) - nz * (cx - f.awx[e]))
                                      : T(0);
    }
    const T jv = dot_row(rows.J[r], qv);
    const T pos_m = dist - pr.margin;
    const T imp = impedance(pos_m, pr.imp);
    rows.aref[r] = (-pr.imp.bc) * jv - pr.imp.kc * imp * pos_m;
    rows.reg[r] = (T(1) - imp) / imp * pr.bw;
    rows.valid[r] = dist < pr.margin;
  }
}

// out = mask ? J (L L^T)^-1 J^T (mask ? v : 0) + R (mask ? v : 0) : 0; a null
// mask means every row.
template <typename T, int N>
__device__ void ar_apply(const Rows<T, N>& rows, int nr, const T (&L)[N][N], const T* v,
                         const bool* mask, T* out) {
  T u[N];
#pragma unroll
  for (int d = 0; d < N; ++d) u[d] = T(0);
  for (int r = 0; r < nr; ++r) {
    if (mask && !mask[r]) continue;
    const T vr = v[r];
#pragma unroll
    for (int d = 0; d < N; ++d) u[d] = u[d] + rows.J[r][d] * vr;
  }
  T w[N];
  chol_solve(L, u, w);
  for (int r = 0; r < nr; ++r) {
    if (mask && !mask[r]) {
      out[r] = T(0);
      continue;
    }
    out[r] = dot_row(rows.J[r], w) + rows.reg[r] * v[r];
  }
}

__constant__ double kArc[6] = {1.0, 0.5, 0.25, 0.1, 0.03, 0.01};  // arc search ladder

// Box QP min 1/2 lam^T (J M^-1 J^T + diag R) lam - rhs^T lam, lam >= 0; lam
// holds the warm start on entry and the solution on exit. Returns J^T lam.
template <typename T, int N>
__device__ void solve_qp(const Model<T>& m, const Rows<T, N>& rows, int nr, const T (&L)[N][N],
                         const T (&a_smooth)[N], T* lam, T (&qfrc)[N]) {
  T rhs[kMaxRows], g[kMaxRows], x[kMaxRows], res[kMaxRows], p[kMaxRows], ap[kMaxRows];
  T best[kMaxRows];
  bool act[kMaxRows];
  bool any = false;
  for (int r = 0; r < nr; ++r) {
    rhs[r] = rows.valid[r] ? rows.aref[r] - dot_row(rows.J[r], a_smooth) : T(0);
    lam[r] = rows.valid[r] ? lam[r] : T(0);
    any = any || rows.valid[r];
  }
#pragma unroll
  for (int d = 0; d < N; ++d) qfrc[d] = T(0);
  if (!any) return;  // every iterate would stay 0

  for (int it = 0; it < m.outer; ++it) {
    ar_apply(rows, nr, L, lam, static_cast<const bool*>(nullptr), g);
    T f_lg = T(0), f_rl = T(0);
    for (int r = 0; r < nr; ++r) {
      g[r] = g[r] - rhs[r];
      act[r] = rows.valid[r] && (lam[r] > T(0) || g[r] < T(0));
      x[r] = act[r] ? lam[r] : T(0);
      f_lg = f_lg + lam[r] * g[r];
      f_rl = f_rl + rhs[r] * lam[r];
    }
    T best_f = T(0.5) * f_lg - T(0.5) * f_rl;
    ar_apply(rows, nr, L, x, act, ap);
    T rs = T(0);
    for (int r = 0; r < nr; ++r) {
      res[r] = act[r] ? rhs[r] - ap[r] : T(0);
      p[r] = res[r];
      rs = rs + res[r] * res[r];
    }
    for (int k = 0; k < m.cg; ++k) {
      ar_apply(rows, nr, L, p, act, ap);
      T denom = T(0);
      for (int r = 0; r < nr; ++r) denom = denom + p[r] * ap[r];
      const T alpha = denom > T(1e-30) ? rs / (denom < T(1e-30) ? T(1e-30) : denom) : T(0);
      T rs_new = T(0);
      for (int r = 0; r < nr; ++r) {
        x[r] = x[r] + alpha * p[r];
        res[r] = res[r] - alpha * ap[r];
        rs_new = rs_new + res[r] * res[r];
      }
      const T beta = rs > T(1e-30) ? rs_new / (rs < T(1e-30) ? T(1e-30) : rs) : T(0);
      for (int r = 0; r < nr; ++r) p[r] = res[r] + beta * p[r];
      rs = rs_new;
    }
    // projected arc search over the fixed ladder; x becomes delta, p lam(t)
    for (int r = 0; r < nr; ++r) {
      x[r] = act[r] ? x[r] - lam[r] : T(0);
      best[r] = lam[r];
    }
#pragma unroll 1
    for (int a = 0; a < 6; ++a) {
      const T t = static_cast<T>(kArc[a]);
      for (int r = 0; r < nr; ++r) {
        const T v = lam[r] + t * x[r];
        p[r] = v < T(0) ? T(0) : v;
      }
      ar_apply(rows, nr, L, p, act, ap);
      T f_a = T(0), f_b = T(0);
      for (int r = 0; r < nr; ++r) {
        f_a = f_a + p[r] * ap[r];
        f_b = f_b + rhs[r] * p[r];
      }
      const T f_t = T(0.5) * f_a - f_b;
      if (f_t < best_f) {
        best_f = f_t;
        for (int r = 0; r < nr; ++r) best[r] = p[r];
      }
    }
    for (int r = 0; r < nr; ++r) lam[r] = best[r];
  }
  for (int r = 0; r < nr; ++r) {
#pragma unroll
    for (int d = 0; d < N; ++d) qfrc[d] = qfrc[d] + rows.J[r][d] * lam[r];
  }
}

template <typename T, int N>
struct Scratch {
  Rows<T, N> rows;
  T lam[kMaxRows];
};

// One constrained forward pass: M, its factor L, the smooth force (the fluid
// force included when FLUID) and the constraint force; lam warm-starts the QP
// and returns its solution. Kept out of line: RK4 calls it 4 times per
// substep, and inlining each copy made the build several times longer.
template <typename T, int N, bool FLUID>
__device__ __noinline__ void forward(const Model<T>& m, int nr, const T (&q)[N], const T (&qv)[N],
                        const T (&tau)[N], Scratch<T, N>& sc, T (&M)[N][N], T (&L)[N][N],
                        T (&smooth)[N], T (&qfrc)[N]) {
  Frames<T, N> f;
  compute_frames(m, q, f);
  T bias[N];
  mass_and_bias(m, qv, f, M, bias);
  cholesky(M, L);
#pragma unroll
  for (int d = 0; d < N; ++d)
    smooth[d] = tau[d] - bias[d] - m.damping[d] * qv[d] - m.stiffness[d] * q[d];
  if constexpr (FLUID) add_fluid_force(static_cast<const FluidModel<T>&>(m), qv, f, smooth);
  T a_smooth[N];
  chol_solve(L, smooth, a_smooth);
  contact_rows(m, q, qv, f, sc.rows);
  solve_qp(m, sc.rows, nr, L, a_smooth, sc.lam, qfrc);
}

template <typename T, int N, bool FLUID>
__device__ void qacc(const Model<T>& m, int nr, const T (&q)[N], const T (&qv)[N],
                     const T (&tau)[N], Scratch<T, N>& sc, T (&acc)[N]) {
  T M[N][N], L[N][N], smooth[N], qfrc[N], rhs[N];
  forward<T, N, FLUID>(m, nr, q, qv, tau, sc, M, L, smooth, qfrc);
#pragma unroll
  for (int d = 0; d < N; ++d) rhs[d] = smooth[d] + qfrc[d];
  chol_solve(L, rhs, acc);
}

template <typename T, int N, bool FLUID>
__device__ void substep(const Model<T>& m, int nr, T (&q)[N], T (&qv)[N], const T (&tau)[N],
                        Scratch<T, N>& sc) {
  const T h = m.h;
  if (!m.rk4) {
    T M[N][N], L[N][N], smooth[N], qfrc[N], rhs[N], acc[N];
    forward<T, N, FLUID>(m, nr, q, qv, tau, sc, M, L, smooth, qfrc);
#pragma unroll
    for (int d = 0; d < N; ++d) {
      M[d][d] = M[d][d] + m.h_damping[d];
      rhs[d] = smooth[d] + qfrc[d];
    }
    cholesky(M, L);
    chol_solve(L, rhs, acc);
#pragma unroll
    for (int d = 0; d < N; ++d) {
      qv[d] = qv[d] + h * acc[d];
      q[d] = q[d] + h * qv[d];
    }
    return;
  }
  const T hh = m.h_half;
  T k1v[N], k2v[N], k3v[N], k4v[N], qs[N], vs[N], v2[N], v3[N], v4[N];
  qacc<T, N, FLUID>(m, nr, q, qv, tau, sc, k1v);
#pragma unroll
  for (int d = 0; d < N; ++d) {
    qs[d] = q[d] + hh * qv[d];
    v2[d] = qv[d] + hh * k1v[d];
  }
  qacc<T, N, FLUID>(m, nr, qs, v2, tau, sc, k2v);
#pragma unroll
  for (int d = 0; d < N; ++d) {
    qs[d] = q[d] + hh * v2[d];
    v3[d] = qv[d] + hh * k2v[d];
  }
  qacc<T, N, FLUID>(m, nr, qs, v3, tau, sc, k3v);
#pragma unroll
  for (int d = 0; d < N; ++d) {
    qs[d] = q[d] + h * v3[d];
    v4[d] = qv[d] + h * k3v[d];
  }
  qacc<T, N, FLUID>(m, nr, qs, v4, tau, sc, k4v);
  const T h6 = m.h_sixth;
#pragma unroll
  for (int d = 0; d < N; ++d) {
    vs[d] = qv[d] + h6 * (k1v[d] + T(2) * k2v[d] + T(2) * k3v[d] + k4v[d]);
    q[d] = q[d] + h6 * (qv[d] + T(2) * v2[d] + T(2) * v3[d] + v4[d]);
    qv[d] = vs[d];
  }
}

// One control step: frame_skip substeps from lambda = 0, lambda chained.
template <typename T, int N, bool FLUID>
__device__ void control_step(const Model<T>& m, int nr, T (&q)[N], T (&qv)[N],
                             const T (&a)[N - 3], Scratch<T, N>& sc) {
  T tau[N];
  tau[0] = T(0);
  tau[1] = T(0);
  tau[2] = T(0);
#pragma unroll
  for (int i = 0; i < N - 3; ++i) tau[i + 3] = m.gear[i] * a[i];
  for (int r = 0; r < nr; ++r) sc.lam[r] = T(0);
  for (int s = 0; s < m.frame_skip; ++s) substep<T, N, FLUID>(m, nr, q, qv, tau, sc);
}

// What one thread of a rollout kernel does for sample k: from x0 + k * x_stride
// it applies `horizon` control steps; action i of step t is
// controls[t * c_t + i * c_i + k * c_k], clamped to [-1, 1] for the torque
// (the reward reads it as given, as the plain version does). Writes costs[k]
// (the rollout entries) or the state to x_out (the step entries, horizon 1)
// where the pointer is not null.
template <typename T, int N, bool FLUID>
__device__ __forceinline__ void run_sample(const Model<T>& m, int k, const T* x0,
                                           long long x_stride, const T* controls, long long c_t,
                                           long long c_i, long long c_k, int horizon, T* costs,
                                           T* x_out, Scratch<T, N>& sc) {
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
    control_step<T, N, FLUID>(m, nr, q, qv, ac, sc);
    T rew = m.healthy + (q[0] - x_before) * m.inv_dt;
#pragma unroll
    for (int i = 0; i < NA; ++i) rew = rew - m.ctrl_w * (a[i] * a[i]);
    cost = cost - rew;
  }
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

}  // namespace planar
