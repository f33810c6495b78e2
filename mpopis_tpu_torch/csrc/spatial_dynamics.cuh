// Spatial (3D) contact dynamics of one sample, run by the W lanes of a warp,
// for the rollout kernel in spatial_rollout.cu: quaternion forward
// kinematics, the analytic mass matrix
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
// The arithmetic of the plain PyTorch version
// (mpopis_tpu_torch/models/spatial_contact.py) spread over the lanes: the
// double instantiation agrees with it to rounding, not bit for bit (nvcc
// contracts multiply-adds into FMAs, the lanes' sums of per-dof vectors are
// trees, the QP's scalars follow the row order only up to kDense rows, and
// the QP applies J M^-1 J^T as W^T W with W = L^-1 J^T).
//
// The lanes of one sample (Lanes<W>: a warp on the card, W = 32; one lane in
// the host build of tests/spatial_host_check.cpp, W = 1, where every lane
// primitive is the identity) share a workspace (Work) in shared memory:
// - every lane carries the state, the actions and the per-dof vectors in
//   registers and computes the same integration and reward;
// - the first lane walks the body tree (the frames, the bodies' motion);
// - lane b forms body b's com, inertia and wrench; the lanes take the mass
//   matrix's lower-triangle entries and the bias entries;
// - the factor of M is one warp's (block_linalg.cuh's chol_diag_block);
// - lane l tests candidate rows l, l + W, ... of each kind and forms the
//   valid ones, compacted in the model's order by a ballot and popcount;
// - the QP's rows and iterates lie on the lanes, and every lane sums its
//   scalars over the lanes in lane order (each lane stores its term in the
//   warp's shared memory, every lane adds the stored terms in order from
//   16-byte loads: the same bits on every lane): up to kDense = 32 valid
//   rows, one row a lane, that is the plain version's serial row order, and
//   the operator is the dense A, read 16 bytes at a time; beyond, each lane
//   first adds its own rows (l, l + 32, ...), then the lanes are added in
//   order, and the operator W^T W v sums its per-dof vector over the lanes
//   as a tree (lane_sums).
// There are no atomics: a sample's result does not depend on scheduling.
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

#include "lanes.cuh"
#ifdef __CUDACC__
#include "block_linalg.cuh"
#endif

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

// The phases of a forward pass that scripts/spatial_phase_times.py times: a
// stamp charges the time since the previous one (or since the sample's
// start) to its phase, and SPATIAL_ROWS counts the pass by its valid rows.
// The script builds a copy with SPATIAL_STAMP, SPATIAL_STAMP_START and
// SPATIAL_ROWS defined; otherwise each is nothing.
enum Phase {
  kPhFrames, kPhMass, kPhFactor, kPhLimits, kPhFloor, kPhCylinder, kPhSelf, kPhApply, kPhQp,
  kPhIntegrate, kPhReward, kPhases
};
#ifndef SPATIAL_STAMP
#define SPATIAL_STAMP(phase) ((void)0)
#define SPATIAL_STAMP_START() ((void)0)
#endif
#ifndef SPATIAL_ROWS
#define SPATIAL_ROWS(nv) ((void)0)
#endif

// the row capacity of a build: a sample's workspace holds this many rows
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
  int row;  // its first row of the model
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

// The lanes that run one sample (lanes.cuh): a warp on the card (W = 32),
// one lane in the host build (W = 1), where every primitive is the identity.
using mpopis::Lanes;
using mpopis::popc;

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


// The Jacobian columns of dof d (on the chain of the body that carries p) at
// the point p: a translation dof gives its axis, a rotational dof a x (p -
// anchor); jw gets a on a rotational dof, else 0.
template <typename T, int N>
__device__ __forceinline__ void dof_jac(const Model<T>& m, const Kin<T, N>& kin, int d, const T* p,
                                        T (&jv)[3], T (&jw)[3]) {
  const bool rot = m.dof_rot[d] != 0;
  T rel[3], cr[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) rel[i] = p[i] - kin.an[d][i];
  cross(kin.ax[d], rel, cr);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    jv[i] = rot ? cr[i] : kin.ax[d][i];
    jw[i] = rot ? kin.ax[d][i] : T(0);
  }
}

// Row i and column j <= i of entry e of a lower triangle counted row by row
// (e = i (i + 1) / 2 + j)
__device__ __forceinline__ void tri_index(int e, int& i, int& j) {
  int r = static_cast<int>((d_sqrt(8.0f * static_cast<float>(e) + 1.0f) - 1.0f) * 0.5f);
  while (r * (r + 1) / 2 > e) --r;
  while ((r + 1) * (r + 2) / 2 <= e) ++r;
  i = r;
  j = e - r * (r + 1) / 2;
}

// v[i] with i known only at run time, without indexing the register array
template <typename T, int N>
__device__ __forceinline__ T pick(const T (&v)[N], int i) {
  T out = T(0);
#pragma unroll
  for (int d = 0; d < N; ++d) out = d == i ? v[d] : out;
  return out;
}

// Per body: the q''=0 motion of its frame (angular velocity and acceleration,
// origin velocity and acceleration), its com in the world, its world inertia
// and its wrench (m (a_com - g); Iw alpha + w x Iw w); and the columns of
// the body in hand.
template <typename T>
struct BodyWork {
  T om[kMaxBodies][3], al[kMaxBodies][3], vo[kMaxBodies][3], ao[kMaxBodies][3];
  T com[kMaxBodies][3], iw[kMaxBodies][9], f[kMaxBodies][3], tq[kMaxBodies][3];
  T jac[kMaxDof][9];  // one body's com Jacobian columns per dof: jv, jw, Iw jw
};

// At most kDense valid rows (the common case) the QP applies the dense
// A = W^T W + diag R, formed once per forward pass, one dot per row. A's rows
// lie kDenseStride<T> entries apart: a multiple of 16 bytes and 4 words more
// than a multiple of 32 words (36 f32, 34 f64), so that the 8 lanes of a
// quarter warp read their rows' 16-byte pieces from distinct banks. After A lie kLadder vectors of kDense
// entries: the lanes store the vectors that A is applied to there and read
// them back as broadcasts.
constexpr int kDense = 32;
constexpr int kLadder = 6;  // the arc search's points
template <typename T>
constexpr int kDenseStride = kDense + 16 / static_cast<int>(sizeof(T));
template <typename T>
constexpr int kDenseArea = kDense * kDenseStride<T> + kLadder * kDense;

// One sample's workspace: its warp's slice of shared memory on the card, one
// static instance in the host build. The rows valid at this state are
// compacted in the model's row order: row i keeps its column w[i] of W =
// L^-1 J^T (row stride S odd, so that the 32 lanes' rows meet distinct
// banks), rhs = aref - J a_smooth, its regularizer and idx, its row of the
// model (where its lambda warm start lies in lam_full). The body scratch of
// the mass matrix shares w's space: it is dead before the rows are built.
// With at most kDense valid rows, the QP's dense A and its vectors follow
// w's first kDense rows (dense_rows), in w's space where it has the room.
// Once the QP has read rhs into its lanes, rhs holds the lanes' terms of its
// row-order sums, and reg too on the dense path (scratch_row).
template <typename T, int N, int R, int F>
struct alignas(16) Work {
  static constexpr int S = N | 1;
  union {
    T w[R][S];
    BodyWork<T> body;
    T dense[kDense * S + kDenseArea<T>];
  };
  alignas(16) T rhs[R];
  alignas(16) T reg[R];
  T lam_full[R];
  int idx[R];
  T L[N][N];                     // M's lower triangle, then its factor in place
  T M[(F & kEuler) ? N : 1][N];  // M, for the Euler factor of M + h diag(damping)
  T inv[N];                      // 1 / L[i][i]
  T bias[N];
  T u[N];  // the lanes' sums of a vector (lane_sums)
  Kin<T, N> kin;
};

// The frames of q into kin, by the first lane; the other lanes wait.
template <typename T, int N, int NQ, int F, int W>
__device__ __forceinline__ void frames(const Model<T>& m, const T (&q)[NQ], Kin<T, N>& kin) {
  Lanes<W>::sync();  // every lane is done with the previous frames
  if (Lanes<W>::lane() == 0) compute_frames<T, N, NQ, F>(m, q, kin);
  Lanes<W>::sync();
}

// Mass matrix (lower triangle, into M and, with kEuler, keep) and bias: the
// first lane propagates each body's angular velocity and acceleration and
// its origin's velocity and acceleration at q''=0 down the tree; lane b then
// forms body b's com, world inertia and wrench; the lanes take the entries
// M[i][j] = armature + sum_b (m Jv_i . Jv_j + Iw Jw_i . Jw_j) and the bias
// entries sum_b (Jv_d . f + Jw_d . tq), each summed over the bodies in the
// plain version's order.
template <typename T, int N, int F, int W>
__device__ void mass_and_bias(const Model<T>& m, const Kin<T, N>& kin, const T (&qv)[N],
                              BodyWork<T>& bw, T (&M)[N][N], T (&keep)[(F & kEuler) ? N : 1][N],
                              T (&bias)[N]) {
  const int lane = Lanes<W>::lane();
  if (lane == 0) {
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
          w_[i] = bw.om[p][i];
          a_[i] = bw.al[p][i];
          d[i] = kin.o[b][i] - kin.o[p][i];
        }
        cross(w_, d, t1);
        cross(a_, d, t2);
        cross(w_, t1, t3);
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          v_[i] = bw.vo[p][i] + t1[i];
          c_[i] = (bw.ao[p][i] + t2[i]) + t3[i];
        }
      }
      for (int jj = bd.j0; jj < bd.j0 + bd.nj; ++jj) {
        const Joint<T>& J = m.jnt[jj];
        const int d = J.dof;
        if (J.kind == kFree) {
          T wl[3];
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            wl[i] = pick(qv, d + 3 + i);
            v_[i] = pick(qv, d + i);
            c_[i] = T(0);
            a_[i] = T(0);  // d/dt(R w_local) = w x w = 0 at w' = 0
          }
          rvec(kin.R[b], wl, w_);  // a free joint is its body's only joint
        } else if ((F & kSlideJoints) && J.kind == kSlide) {
          T va[3], t1[3];
          const T qd = pick(qv, d);
#pragma unroll
          for (int i = 0; i < 3; ++i) va[i] = qd * kin.ax[d][i];
          cross(w_, va, t1);
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            v_[i] = v_[i] + va[i];
            c_[i] = c_[i] + t1[i];
          }
        } else {  // hinge: to the anchor, add the joint rate, back to the origin
          T dw[3], dd[3], aq[3], t1[3], t2[3], t3[3], vw[3], aw[3];
          const T qd = pick(qv, d);
#pragma unroll
          for (int i = 0; i < 3; ++i) dw[i] = kin.an[d][i] - kin.o[b][i];
          cross(w_, dw, t1);
          cross(a_, dw, t2);
          cross(w_, t1, t3);
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            vw[i] = v_[i] + t1[i];
            aw[i] = (c_[i] + t2[i]) + t3[i];
            aq[i] = qd * kin.ax[d][i];
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
        bw.om[b][i] = w_[i];
        bw.al[b][i] = a_[i];
        bw.vo[b][i] = v_[i];
        bw.ao[b][i] = c_[i];
      }
    }
  }
  Lanes<W>::sync();
  for (int b = lane; b < m.nb; b += W) {
    const Body<T>& bd = m.body[b];
    T r_com[3], vcom[3], acom[3], t1[3], t2[3], t3[3], iwa[3], iww[3];
    rvec(kin.R[b], bd.com, r_com);
#pragma unroll
    for (int i = 0; i < 3; ++i) bw.com[b][i] = kin.o[b][i] + r_com[i];
    sym_rotate(kin.R[b], bd.inertia, bw.iw[b]);
    cross(bw.om[b], r_com, t1);
#pragma unroll
    for (int i = 0; i < 3; ++i) vcom[i] = bw.vo[b][i] + t1[i];
    cross(bw.al[b], r_com, t2);
#pragma unroll
    for (int i = 0; i < 3; ++i) t1[i] = vcom[i] - bw.vo[b][i];
    cross(bw.om[b], t1, t3);
#pragma unroll
    for (int i = 0; i < 3; ++i) acom[i] = (bw.ao[b][i] + t2[i]) + t3[i];
    bw.f[b][0] = bd.mass * acom[0];
    bw.f[b][1] = bd.mass * acom[1];
    bw.f[b][2] = bd.mass * (acom[2] + m.gravity);
    rvec(bw.iw[b], bw.al[b], iwa);
    rvec(bw.iw[b], bw.om[b], iww);
    cross(bw.om[b], iww, t1);
#pragma unroll
    for (int i = 0; i < 3; ++i) bw.tq[b][i] = iwa[i] + t1[i];
  }
  // Body by body, lane d forms dof d's com Jacobian columns (jv, jw, and Iw
  // jw) into jac[d] and adds its bias term; then each lane adds the body's
  // term to its entries of M, held in registers (entry e = lane + W t).
  constexpr int kEntries = N * (N + 1) / 2;
  constexpr int kPerLane = (kEntries + W - 1) / W;
  T acc[kPerLane];
  int ei[kPerLane], ej[kPerLane];
#pragma unroll
  for (int t = 0; t < kPerLane; ++t) {
    const int e = lane + W * t;
    int i = 0, j = 0;
    if (e < kEntries) tri_index(e, i, j);
    ei[t] = i;
    ej[t] = j;
    acc[t] = (e < kEntries && i == j) ? m.armature[i] : T(0);
  }
  for (int d = lane; d < N; d += W) bias[d] = T(0);  // dof d's lane alone adds to bias[d]
  for (int b = 0; b < m.nb; ++b) {
    const unsigned chain = m.body[b].chain;
    for (int d = lane; d < N; d += W) {
      if ((chain >> d) & 1u) {
        T jv[3], jw[3];
        dof_jac(m, kin, d, bw.com[b], jv, jw);
        bias[d] = bias[d] + (dot3(jv, bw.f[b]) + dot3(jw, bw.tq[b]));
        rvec(bw.iw[b], jw, bw.jac[d] + 6);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          bw.jac[d][c] = jv[c];
          bw.jac[d][3 + c] = jw[c];
        }
      }
    }
    Lanes<W>::sync();
    const T mass = m.body[b].mass;
#pragma unroll
    for (int t = 0; t < kPerLane; ++t) {
      const int i = ei[t], j = ej[t];
      if (lane + W * t < kEntries && ((chain >> i) & 1u) && ((chain >> j) & 1u)) {
        const T* a = bw.jac[i];
        const T* c = bw.jac[j];
        acc[t] = acc[t] + (mass * dot3(a, c) + dot3(a + 6, c + 3));
      }
    }
    Lanes<W>::sync();  // every lane is done with this body's columns
  }
#pragma unroll
  for (int t = 0; t < kPerLane; ++t) {
    if (lane + W * t < kEntries) {
      M[ei[t]][ej[t]] = acc[t];
      if constexpr ((F & kEuler) != 0) keep[ei[t]][ej[t]] = acc[t];
    }
  }
  Lanes<W>::sync();
}

// L L^T = the matrix in a's lower triangle, in place, and inv[i] = 1 /
// L[i][i]. On a warp it is block_linalg.cuh's chol_diag_block (lane i holds
// row i in registers; the columns move by shuffles); the host build's one
// lane runs the columns in turn.
template <typename T, int N, int W>
__device__ __forceinline__ void factor(T (&a)[N][N], T (&inv)[N]) {
  static_assert(N <= 32, "a factor is one warp's rows");
  if constexpr (W == 1) {
    for (int j = 0; j < N; ++j) {
      T d = a[j][j];
      for (int k = 0; k < j; ++k) d = d - a[j][k] * a[j][k];
      a[j][j] = d_sqrt(d);
      inv[j] = T(1) / a[j][j];
      for (int i = j + 1; i < N; ++i) {
        T s = a[i][j];
        for (int k = 0; k < j; ++k) s = s - a[i][k] * a[j][k];
        a[i][j] = s * inv[j];
      }
    }
  } else {
#ifdef __CUDACC__
    __syncwarp();  // a is complete
    mpopis::chol_diag_block(&a[0][0], N, 0, N, inv);
    __syncwarp();
#endif
  }
}

// x = (L L^T)^-1 b, on every lane (b the same on every lane). On a warp,
// lane i keeps the partial sum of row i: at step k lane k's sum is final,
// its quotient goes to every lane by a shuffle and the rows below lose it,
// the forward sweep in the serial order of terms; one lane substitutes row
// by row.
template <typename T, int N, int W>
__device__ __forceinline__ void chol_solve(const T (&L)[N][N], const T (&inv)[N], const T (&b)[N],
                                           T (&x)[N]) {
  if constexpr (W == 1) {
    T y[N];
    for (int i = 0; i < N; ++i) {
      T s = b[i];
      for (int k = 0; k < i; ++k) s = s - L[i][k] * y[k];
      y[i] = s * inv[i];
    }
    for (int i = N - 1; i >= 0; --i) {
      T s = y[i];
      for (int k = i + 1; k < N; ++k) s = s - L[k][i] * x[k];
      x[i] = s * inv[i];
    }
  } else {
#ifdef __CUDACC__
    const int lane = threadIdx.x & 31;
    const int row = lane < N ? lane : N - 1;
    T y[N];
    T c = pick(b, lane);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      y[k] = __shfl_sync(0xffffffffu, c * inv[k], k);
      if (lane > k && lane < N) c = c - L[row][k] * y[k];
    }
    c = pick(y, lane);
#pragma unroll
    for (int k = N - 1; k >= 0; --k) {
      x[k] = __shfl_sync(0xffffffffu, c * inv[k], k);
      if (lane < k) c = c - L[k][lane] * x[k];
    }
#endif
  }
}

template <typename T, int N>
__device__ __forceinline__ T dot_row(const T (&j)[N], const T (&v)[N]) {
  T s = T(0);
#pragma unroll
  for (int d = 0; d < N; ++d) s = s + j[d] * v[d];
  return s;
}

#ifdef __CUDACC__
// One step of lane_sums' recursive halving and the steps after it: a lane
// keeps half of v[0 .. 2H) (the upper half where lane & H) in v[0 .. H) and
// adds its partner's copy of that half. H is a template parameter, so every
// index is known at compile time and v stays in registers.
template <int H, typename T, int P>
__device__ __forceinline__ void halve(T (&v)[P], int lane) {
  if constexpr (H >= 1) {
    const bool up = (lane & H) != 0;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const T send = up ? v[i] : v[i + H];
      const T keep = up ? v[i + H] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, H);
    }
    halve<H / 2>(v, lane);
  }
}
#endif

// out[d] = the sum over the lanes of part[d], d < N, into shared memory,
// visible to every lane on return. On a warp, recursive halving: at each of
// log2(P) steps (P = 16 or 32 >= N) a lane keeps half of its values and adds
// its partner's copy of that half, 31 shuffles for P = 32 against 5 N for N
// butterflies; lane l ends with component l mod P, and the groups of P < 32
// lanes then add across. The order is fixed: no atomics.
template <typename T, int N, int W>
__device__ __forceinline__ void lane_sums(const T (&part)[N], T* out) {
  Lanes<W>::sync();  // every lane has read the previous sums
  if constexpr (W == 1) {
    for (int d = 0; d < N; ++d) out[d] = part[d];
  } else {
#ifdef __CUDACC__
    constexpr int P = N <= 16 ? 16 : 32;
    const int lane = Lanes<W>::lane();
    T v[P];
#pragma unroll
    for (int i = 0; i < P; ++i) v[i] = i < N ? part[i] : T(0);
    halve<P / 2>(v, lane);
    if constexpr (P < 32) v[0] = v[0] + __shfl_xor_sync(0xffffffffu, v[0], 16);
    if (lane < N) out[lane] = v[0];
#endif
  }
  Lanes<W>::sync();
}

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

// Appends the valid row with Jacobian j at compacted position `at`: its
// column of W = L^-1 J^T by forward substitution against the factor in
// shared memory (every lane of the warp reads the same L entry at once),
// rhs = aref - j . a_smooth, its regularizer and its row of the model.
template <typename T, int N, int R, int F>
__device__ __forceinline__ void put_row(Work<T, N, R, F>& wk, int at, const T (&j)[N], T aref,
                                        T reg, int model_row, const T (&a_smooth)[N]) {
  T y[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    T s = j[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - wk.L[i][k] * y[k];
    y[i] = s * wk.inv[i];
  }
#pragma unroll
  for (int i = 0; i < N; ++i) wk.w[at][i] = y[i];
  wk.rhs[at] = aref - dot_row(j, a_smooth);
  wk.reg[at] = reg;
  wk.idx[at] = model_row;
}

// A pair row (cylinder or self pair): J = n . (v2(cp) - v1(cp)) over both
// bodies' dof columns, as the plain version's -Jv1 n + Jv2 n.
template <typename T, int N, int R, int F>
__device__ __forceinline__ void pair_row(const Model<T>& m, Work<T, N, R, F>& wk, int at, int body1,
                                         int body2, T dist, const T (&nvec)[3], const T (&cp)[3],
                                         T margin, const Imp<T>& im, T bw, int model_row,
                                         const T (&qv)[N], const T (&a_smooth)[N]) {
  const unsigned c1 = m.body[body1].chain, c2 = m.body[body2].chain;
  T j[N];
#pragma unroll
  for (int d = 0; d < N; ++d) {
    T jv[3], jw[3];
    dof_jac(m, wk.kin, d, cp, jv, jw);
    const T dn = dot3(jv, nvec);
    j[d] = -(((c1 >> d) & 1u) ? dn : T(0)) + (((c2 >> d) & 1u) ? dn : T(0));
  }
  const T pos_m = dist - margin;
  const T imp = impedance(pos_m, im);
  put_row(wk, at, j, (-im.bc) * dot_row(j, qv) - im.kc * imp * pos_m, (T(1) - imp) / imp * bw,
          model_row, a_smooth);
}

// The rows valid at this state into wk, compacted in the model's row order
// (limits, floor contacts, cylinder pairs, self pairs); returns their count,
// the same on every lane. Lane l takes candidates l, l + W, ... of each
// kind; a ballot of the valid ones and the popcount of the lanes below give
// each its place.
template <typename T, int N, int NQ, int F, int R, int W>
__device__ int contact_rows(const Model<T>& m, const T (&q)[NQ], const T (&qv)[N],
                            const T (&a_smooth)[N], Work<T, N, R, F>& wk) {
  const Kin<T, N>& kin = wk.kin;
  const int lane = Lanes<W>::lane();
  const unsigned below = Lanes<W>::below();
  int nv = 0;
  for (int c0 = 0; c0 < m.n_limits; c0 += W) {
    const int l = c0 + lane;
    bool valid = false;
    T pos = T(0), sgn = T(1);
    if (l < m.n_limits) {
      const Limit<T>& lm = m.lim[l];
      const T qd = pick(q, lm.qadr);
      const T d_lo = (qd - lm.lo) - lm.margin;
      const T d_hi = (lm.hi - qd) - lm.margin;
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
  SPATIAL_STAMP(kPhLimits);
  for (int c0 = 0; c0 < m.n_contacts; c0 += W) {
    const int ci = c0 + lane;
    bool valid = false, normal_only = false;
    T dist = T(0), p[3] = {T(0), T(0), T(0)};
    if (ci < m.n_contacts) {
      const Contact<T>& ct = m.con[ci];
      rvec(kin.R[ct.body], ct.local, p);
#pragma unroll
      for (int i = 0; i < 3; ++i) p[i] = kin.o[ct.body][i] + p[i];
      dist = (p[2] - m.floor_z) - ct.radius;
      normal_only = (F & kCondim1) && ct.condim == 1;
      valid = dist < ct.margin;
    }
    const unsigned b4 = Lanes<W>::ballot(valid && !normal_only);
    const unsigned b1 = (F & kCondim1) ? Lanes<W>::ballot(valid && normal_only) : 0u;
    if (valid) {
      const Contact<T>& ct = m.con[ci];
      const int at = nv + 4 * popc(b4 & below) + popc(b1 & below);
      const T cp[3] = {p[0], p[1], m.floor_z + T(0.5) * dist};
      const unsigned chain = m.body[ct.body].chain;
      T jx[N], jy[N], jn[N];  // the point's Jacobian rows
#pragma unroll
      for (int d = 0; d < N; ++d) {
        T jv[3], jw[3];
        dof_jac(m, kin, d, cp, jv, jw);
        const bool on = (chain >> d) & 1u;
        jx[d] = on ? jv[0] : T(0);
        jy[d] = on ? jv[1] : T(0);
        jn[d] = on ? jv[2] : T(0);
      }
      const T pos_m = dist - ct.margin;
      const T imp = impedance(pos_m, ct.imp);
      const T jv_n = dot_row(jn, qv);
      const T base = (-ct.imp.kc) * imp * pos_m;
      const T nbc = -ct.imp.bc;
      if (normal_only) {  // frictionless: the normal row, no pyramid factor in R
        put_row(wk, at, jn, nbc * jv_n + base, (T(1) - imp) / imp * ct.bw, ct.row, a_smooth);
      } else {
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
          jt1[d] = jx[d] * t1x + jy[d] * t1y;
          jt2[d] = jx[d] * (-t1y) + jy[d] * t1x;
        }
        const T jv_t1 = dot_row(jt1, qv);
        const T jv_t2 = dot_row(jt2, qv);
        const T reg = (T(1) - imp) / imp * ct.bw * ct.rfac;
#pragma unroll 1
        for (int k = 0; k < 4; ++k) {
          const T mu = (k & 1) ? -ct.mu : ct.mu;
          T j[N];
#pragma unroll
          for (int d = 0; d < N; ++d) j[d] = jn[d] + mu * (k < 2 ? jt1[d] : jt2[d]);
          put_row(wk, at + k, j, nbc * (jv_n + mu * (k < 2 ? jv_t1 : jv_t2)) + base, reg,
                  ct.row + k, a_smooth);
        }
      }
    }
    nv += 4 * popc(b4) + popc(b1);
  }
  SPATIAL_STAMP(kPhFloor);
  if (F & kCylinder) {
    const int row0 = m.n_rows - m.n_cap - m.n_cyl;
    for (int c0 = 0; c0 < m.n_cyl; c0 += W) {
      const int pi = c0 + lane;
      bool valid = false;
      T dist = T(0), nvec[3], cp[3];
      if (pi < m.n_cyl) {
        capsule_cylinder(kin, m.cyl[pi], dist, nvec, cp);
        valid = dist < m.cyl[pi].margin;
      }
      const unsigned bal = Lanes<W>::ballot(valid);
      if (valid) {
        const CylPair<T>& pr = m.cyl[pi];
        pair_row(m, wk, nv + popc(bal & below), pr.body1, pr.body2, dist, nvec, cp, pr.margin,
                 pr.imp, pr.bw, row0 + pi, qv, a_smooth);
      }
      nv += popc(bal);
    }
    SPATIAL_STAMP(kPhCylinder);
  }
  if (F & kSelfPairs) {
    const int row0 = m.n_rows - m.n_cap;
    for (int c0 = 0; c0 < m.n_cap; c0 += W) {
      const int pi = c0 + lane;
      bool valid = false;
      T dist = T(0), nvec[3], cp[3];
      if (pi < m.n_cap) {
        capsule_capsule(kin, m.cap[pi], dist, nvec, cp);
        valid = dist < m.cap[pi].margin;
      }
      const unsigned bal = Lanes<W>::ballot(valid);
      if (valid) {
        const CapPair<T>& pr = m.cap[pi];
        pair_row(m, wk, nv + popc(bal & below), pr.body1, pr.body2, dist, nvec, cp, pr.margin,
                 pr.imp, pr.bw, row0 + pi, qv, a_smooth);
      }
      nv += popc(bal);
    }
    SPATIAL_STAMP(kPhSelf);
  }
  Lanes<W>::sync();  // the rows are visible to every lane
  return nv;
}

// out = mask ? W^T W (mask ? v : 0) + R (mask ? v : 0) : 0 = (J M^-1 J^T +
// diag R) v over the compacted rows, which lie on the lanes: slot s of lane
// l is row l + s W. Each lane sums W v over its rows, lane_sums adds the
// lanes' N partial sums, and each lane dots its rows' columns with that sum.
// MASK false: every row.
template <bool MASK, int W, typename T, int N, int R, int F, int RW>
__device__ __forceinline__ void apply(const Work<T, N, R, F>& wk, T* u_out, int nv,
                                      const T (&v)[RW], const bool (&act)[RW], T (&out)[RW]) {
  SPATIAL_STAMP(kPhQp);
  const int lane = Lanes<W>::lane();
  T part[N];
#pragma unroll
  for (int d = 0; d < N; ++d) part[d] = T(0);
#pragma unroll
  for (int s = 0; s < RW; ++s) {
    const int r = lane + s * W;
    if (s * W < nv && r < nv && (!MASK || act[s])) {  // s * W < nv: the same on every lane
      const T vr = v[s];
#pragma unroll
      for (int d = 0; d < N; ++d) part[d] = part[d] + wk.w[r][d] * vr;
    }
  }
  lane_sums<T, N, W>(part, u_out);
  T u[N];
#pragma unroll
  for (int d = 0; d < N; ++d) u[d] = u_out[d];
#pragma unroll
  for (int s = 0; s < RW; ++s) {
    const int r = lane + s * W;
    T o = T(0);
    if (s * W < nv && r < nv && (!MASK || act[s])) {
#pragma unroll
      for (int d = 0; d < N; ++d) o = o + wk.w[r][d] * u[d];
      o = o + wk.reg[r] * v[s];
    }
    out[s] = o;
  }
  SPATIAL_STAMP(kPhApply);
}

template <typename T, int N, int R, int F>
__device__ __forceinline__ T* dense_rows(Work<T, N, R, F>& wk) {
  constexpr int kWords = kDenseStride<T> * static_cast<int>(sizeof(T)) / 4;
  static_assert(kDenseStride<T> * sizeof(T) % 16 == 0 && kWords % 32 == 4,
                "A's rows 16-byte aligned, a quarter warp's rows on distinct banks");
  static_assert(kDense * Work<T, N, R, F>::S * sizeof(T) % 16 == 0, "A 16-byte aligned");
  return wk.dense + kDense * Work<T, N, R, F>::S;
}

// vector j (< kLadder) of the dense path
template <typename T, int N, int R, int F>
__device__ __forceinline__ T* dense_vec(Work<T, N, R, F>& wk, int j) {
  return dense_rows(wk) + kDense * kDenseStride<T> + j * kDense;
}

// scratch row i of kDense entries for the lanes' terms of a row-order sum:
// rows 0-3 in rhs (dead once the QP has read it), 4-7 in reg (dead on the
// dense path once A holds it)
template <typename T, int N, int R, int F>
__device__ __forceinline__ T* scratch_row(Work<T, N, R, F>& wk, int i) {
  static_assert(R >= 4 * kDense, "four scratch rows in rhs and four in reg");
  return i < 4 ? wk.rhs + i * kDense : wk.reg + (i - 4) * kDense;
}

// The slots of a lane that can hold one of nv <= kDense rows
template <int W, int RW>
constexpr int kDenseSlots = (kDense + W - 1) / W < RW ? (kDense + W - 1) / W : RW;

// Row i of A = W^T W + diag R by the lane of row i, for the nv <= kDense rows
template <int W, typename T, int N, int R, int F>
__device__ void form_dense(Work<T, N, R, F>& wk, int nv) {
  constexpr int DS = kDenseSlots<W, (R + W - 1) / W>;
  T* a = dense_rows(wk);
  const int lane = Lanes<W>::lane();
#pragma unroll
  for (int s = 0; s < DS; ++s) {
    const int r = lane + s * W;
    if (s * W < nv && r < nv) {
      T wr[N];
#pragma unroll
      for (int d = 0; d < N; ++d) wr[d] = wk.w[r][d];
      for (int c = 0; c < nv; ++c) {
        T acc = T(0);
#pragma unroll
        for (int d = 0; d < N; ++d) acc = acc + wr[d] * wk.w[c][d];
        a[r * kDenseStride<T> + c] = c == r ? acc + wk.reg[r] : acc;
      }
    }
  }
  Lanes<W>::sync();
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

// acc[j] = row ar of A dotted with vector j of vecs (kDense apart) over
// entries 0 .. nv - 1, each in column order; four entries of A a load, read
// once for all NV vectors
template <int NV, typename T>
__device__ __forceinline__ void dense_dots(const T* ar, const T* vecs, int nv, T (&acc)[NV]) {
#pragma unroll
  for (int j = 0; j < NV; ++j) acc[j] = T(0);
  int c = 0;
#pragma unroll
  for (int q = 0; q < kDense / 4; ++q, c += 4) {
    if (c + 4 > nv) break;
    T av[4];
    load4(ar + c, av);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      T xv[4];
      load4(vecs + j * kDense + c, xv);
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
      load4(vecs + j * kDense + c, xv);
#pragma unroll
      for (int i = 0; i < 3; ++i)
        if (c + i < nv) acc[j] = acc[j] + av[i] * xv[i];
    }
  }
}

// sums[k] = the sum of rows[k][0 .. n) in index order, from 16-byte loads
// that every lane makes alike (broadcasts): K chains side by side
template <int K, typename T>
__device__ __forceinline__ void row_sums(const T* const (&rows)[K], int n, T (&sums)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) sums[k] = T(0);
  int c = 0;
#pragma unroll
  for (int q = 0; q < kDense / 4; ++q, c += 4) {  // n <= kDense
    if (c + 4 > n) break;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      T x[4];
      load4(rows[k] + c, x);
#pragma unroll
      for (int i = 0; i < 4; ++i) sums[k] = sums[k] + x[i];
    }
  }
  if (c < n) {
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

// v[k] = the sum over lanes 0 .. n - 1 of their v[k] in lane order, on
// every lane, as Lanes::sum adds them (n the same on every lane): each lane
// stores its terms into scratch rows, then every lane sums the rows
template <int K, int W, typename T, int N, int R, int F>
__device__ __forceinline__ void lane_order_sums(Work<T, N, R, F>& wk, T (&v)[K], int n) {
  if constexpr (W > 1) {
    static_assert(K <= 4, "the scratch rows in rhs");
    const int lane = Lanes<W>::lane();
    const T* rows[K];
    Lanes<W>::sync();  // every lane has read the previous sums
#pragma unroll
    for (int k = 0; k < K; ++k) {
      T* row = scratch_row(wk, k);
      row[lane] = v[k];
      rows[k] = row;
    }
    Lanes<W>::sync();
    row_sums(rows, n, v);
  }
}

template <int W, typename T, int N, int R, int F>
__device__ __forceinline__ T lane_order_sum(Work<T, N, R, F>& wk, T v, int n) {
  T one[1] = {v};
  lane_order_sums<1, W>(wk, one, n);
  return one[0];
}

// out = mask ? A (mask ? v : 0) : 0 over the nv <= kDense rows: each lane
// stores its rows' entries of v into the warp's vector once, then dots its
// row of A with it
template <bool MASK, int W, typename T, int N, int R, int F, int RW>
__device__ __forceinline__ void apply_dense(Work<T, N, R, F>& wk, int nv, const T (&v)[RW],
                                            const bool (&act)[RW], T (&out)[RW]) {
  SPATIAL_STAMP(kPhQp);
  constexpr int DS = kDenseSlots<W, RW>;
  const T* a = dense_rows(wk);
  T* vec = dense_vec(wk, 0);
  const int lane = Lanes<W>::lane();
  Lanes<W>::sync();  // every lane is done with the previous vector
#pragma unroll
  for (int s = 0; s < DS; ++s) {
    const int r = lane + s * W;
    if (r < nv) vec[r] = (!MASK || act[s]) ? v[s] : T(0);
  }
  Lanes<W>::sync();
#pragma unroll
  for (int s = 0; s < DS; ++s) {
    if (s * W < nv) {
      const int r = lane + s * W;  // < kDense: a lane past nv dots a row it then drops
      T acc[1];
      dense_dots(a + r * kDenseStride<T>, vec, nv, acc);
      out[s] = (r < nv && (!MASK || act[s])) ? acc[0] : T(0);
    }
  }
  SPATIAL_STAMP(kPhApply);
}

// The operator on the rows: dense A on the dense path, else W^T W v + R v
template <bool MASK, bool DENSE, int W, typename T, int N, int R, int F, int RW>
__device__ __forceinline__ void apply_rows(Work<T, N, R, F>& wk, int nv, const T (&v)[RW],
                                           const bool (&act)[RW], T (&out)[RW]) {
  if constexpr (DENSE) {
    apply_dense<MASK, W>(wk, nv, v, act, out);
  } else {
    apply<MASK, W>(wk, wk.u, nv, v, act, out);
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
// and order of one masked application and its sums. f_b's terms are summed
// beside the pass, f_a's after it; p(t) is formed again where it is needed.
template <int W, typename T, int N, int R, int F, int RW>
__device__ __forceinline__ void arc_dense(Work<T, N, R, F>& wk, int nv, int nl,
                                          const T (&lam)[RW], const T (&x)[RW],
                                          const bool (&act)[RW], const T (&rhs)[RW],
                                          T (&f_a)[kLadder], T (&f_b)[kLadder]) {
  SPATIAL_STAMP(kPhQp);
  constexpr int DS = kDenseSlots<W, RW>;
  const T* a = dense_rows(wk);
  T* vec = dense_vec(wk, 0);
  const int lane = Lanes<W>::lane();
  Lanes<W>::sync();  // every lane is done with the previous vectors and sums
#pragma unroll
  for (int j = 0; j < kLadder; ++j) {
    const T t = static_cast<T>(kArc[j]);
    f_b[j] = T(0);
#pragma unroll
    for (int s = 0; s < DS; ++s) {
      if (s * W < nv) {
        const T p = arc_point(lam[s], x[s], t);
        const int r = lane + s * W;
        if (r < nv) vec[j * kDense + r] = act[s] ? p : T(0);
        f_b[j] = f_b[j] + rhs[s] * p;
      }
    }
    if constexpr (W > 1) scratch_row(wk, j)[lane] = f_b[j];
  }
  Lanes<W>::sync();
  if constexpr (W > 1) {
    const T* rows[kLadder];
#pragma unroll
    for (int j = 0; j < kLadder; ++j) rows[j] = scratch_row(wk, j);
    row_sums(rows, nl, f_b);
  }
#pragma unroll
  for (int j = 0; j < kLadder; ++j) f_a[j] = T(0);
#pragma unroll
  for (int s = 0; s < DS; ++s) {
    if (s * W < nv) {
      const int r = lane + s * W;
      T acc[kLadder];
      dense_dots(a + r * kDenseStride<T>, vec, nv, acc);
#pragma unroll
      for (int j = 0; j < kLadder; ++j) {
        const T ap = r < nv && act[s] ? acc[j] : T(0);
        f_a[j] = f_a[j] + arc_point(lam[s], x[s], static_cast<T>(kArc[j])) * ap;
      }
    }
  }
  SPATIAL_STAMP(kPhApply);
  if constexpr (W > 1) {
    Lanes<W>::sync();  // every lane has read the vectors and f_b's terms
#pragma unroll
    for (int j = 0; j < kLadder; ++j) scratch_row(wk, j)[lane] = f_a[j];
    Lanes<W>::sync();
    const T* rows[kLadder];
#pragma unroll
    for (int j = 0; j < kLadder; ++j) rows[j] = scratch_row(wk, j);
    row_sums(rows, nl, f_a);
  }
}

// Box QP min 1/2 lam^T (J M^-1 J^T + diag R) lam - rhs^T lam, lam >= 0, over
// the valid rows: the fixed-iteration active set / CG / projected arc search
// of the plain version's _qp_iterate, each lane holding its rows' iterates in
// SL slots of registers (one on the dense path's warp, where the lane's row
// is its only one) and every scalar (f_lg, f_rl, rs, denom, f_a, f_b) summed over
// the lanes in lane order (lane_order_sums: each lane stores its term, every
// lane adds the stored terms in order) with the same bits on every lane, so
// that all lanes take every branch alike. Up to kDense valid rows that is
// the row order, and the arc search's points share one pass over A
// (arc_dense); beyond, each lane's slots (rows l, l + W, ...) are added
// first, then the lanes in order. Near a contact switch the QP turns
// rounding into other iterates, so the order of these sums shows: with tree
// sums the Standup's f64 CEMPPI step lay 11x further from the plain path
// than the plain path moves under a nudge of its inputs, with the row order
// 4.5x (chip_smoke.py phase 34; H100 80GB HBM3, 700 W). wk.lam_full holds
// the warm start of every model row on entry and the solution (0 on rows not
// valid) on exit. qfrc = J^T lam = L (W lam).
template <int SL, bool DENSE, typename T, int N, int R, int F, int W>
__device__ __forceinline__ void qp_rows(const Model<T>& m, Work<T, N, R, F>& wk, int nv,
                                        T (&qfrc)[N]) {
  const int lane = Lanes<W>::lane();
  // slot s of a lane holds row lane + s W; slots with s W >= nv hold no row
  // on any lane and are skipped (their values stay 0)
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
  for (int r = lane; r < m.n_rows; r += W) wk.lam_full[r] = T(0);
  Lanes<W>::sync();
  if constexpr (DENSE) form_dense<W>(wk, nv);
  // the lanes that hold rows: on the wide path every lane, a constant
  const int nl = DENSE && nv < W ? nv : W;

  for (int it = 0; it < m.outer; ++it) {
    apply_rows<false, DENSE, W>(wk, nv, lam, act, ap);
    T f_lg = T(0), f_rl = T(0);
#pragma unroll
    for (int s = 0; s < SL; ++s) {
      if (s * W < nv) {
        const T g = ap[s] - rhs[s];
        act[s] = lane + s * W < nv && (lam[s] > T(0) || g < T(0));
        x[s] = act[s] ? lam[s] : T(0);
        f_lg = f_lg + lam[s] * g;
        f_rl = f_rl + rhs[s] * lam[s];
      }
    }
    T lg_rl[2] = {f_lg, f_rl};
    lane_order_sums<2, W>(wk, lg_rl, nl);
    T best_f = T(0.5) * lg_rl[0] - T(0.5) * lg_rl[1];
    apply_rows<true, DENSE, W>(wk, nv, x, act, ap);
    T rs = T(0);
#pragma unroll
    for (int s = 0; s < SL; ++s) {
      if (s * W < nv) {
        res[s] = act[s] ? rhs[s] - ap[s] : T(0);
        p[s] = res[s];
        rs = rs + res[s] * res[s];
      }
    }
    rs = lane_order_sum<W>(wk, rs, nl);
    for (int k = 0; k < m.cg; ++k) {
      apply_rows<true, DENSE, W>(wk, nv, p, act, ap);
      T denom = T(0);
#pragma unroll
      for (int s = 0; s < SL; ++s) {
        if (s * W < nv) denom = denom + p[s] * ap[s];
      }
      denom = lane_order_sum<W>(wk, denom, nl);
      const T alpha = denom > T(1e-30) ? rs / (denom < T(1e-30) ? T(1e-30) : denom) : T(0);
      T rs_new = T(0);
#pragma unroll
      for (int s = 0; s < SL; ++s) {
        if (s * W < nv) {
          x[s] = x[s] + alpha * p[s];
          res[s] = res[s] - alpha * ap[s];
          rs_new = rs_new + res[s] * res[s];
        }
      }
      rs_new = lane_order_sum<W>(wk, rs_new, nl);
      const T beta = rs > T(1e-30) ? rs_new / (rs < T(1e-30) ? T(1e-30) : rs) : T(0);
#pragma unroll
      for (int s = 0; s < SL; ++s) {
        if (s * W < nv) p[s] = res[s] + beta * p[s];
      }
      rs = rs_new;
    }
    // projected arc search over the fixed ladder; x becomes delta, p lam(t);
    // the best t is kept by its index and lam(t) formed again from it
#pragma unroll
    for (int s = 0; s < SL; ++s) {
      if (s * W < nv) x[s] = act[s] ? x[s] - lam[s] : T(0);
    }
    int best_a = -1;
    if constexpr (DENSE) {  // the points side by side
      T f_a[kLadder], f_b[kLadder];
      arc_dense<W>(wk, nv, nl, lam, x, act, rhs, f_a, f_b);
#pragma unroll
      for (int a = 0; a < kLadder; ++a) {
        const T f_t = T(0.5) * f_a[a] - f_b[a];
        if (f_t < best_f) {
          best_f = f_t;
          best_a = a;
        }
      }
    } else {
#pragma unroll 1
      for (int a = 0; a < kLadder; ++a) {
        const T t = static_cast<T>(kArc[a]);
#pragma unroll
        for (int s = 0; s < SL; ++s) {
          if (s * W < nv) p[s] = arc_point(lam[s], x[s], t);
        }
        apply<true, W>(wk, wk.u, nv, p, act, ap);
        T f_ab[2] = {T(0), T(0)};
#pragma unroll
        for (int s = 0; s < SL; ++s) {
          if (s * W < nv) {
            f_ab[0] = f_ab[0] + p[s] * ap[s];
            f_ab[1] = f_ab[1] + rhs[s] * p[s];
          }
        }
        lane_order_sums<2, W>(wk, f_ab, nl);
        const T f_t = T(0.5) * f_ab[0] - f_ab[1];
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
  T part[N];
#pragma unroll
  for (int d = 0; d < N; ++d) part[d] = T(0);
#pragma unroll
  for (int s = 0; s < SL; ++s) {
    const int r = lane + s * W;
    if (s * W < nv && r < nv) {
      wk.lam_full[wk.idx[r]] = lam[s];
#pragma unroll
      for (int d = 0; d < N; ++d) part[d] = part[d] + wk.w[r][d] * lam[s];
    }
  }
  lane_sums<T, N, W>(part, wk.u);  // its barriers order the lam_full writes too
  if constexpr (W == 1) {
    for (int i = 0; i < N; ++i) {
      T s = T(0);
      for (int k = 0; k <= i; ++k) s = s + wk.L[i][k] * wk.u[k];
      qfrc[i] = s;
    }
  } else {
#ifdef __CUDACC__
    T mine = T(0);  // lane i: row i of L (W lam)
    if (lane < N) {
      for (int k = 0; k <= lane; ++k) mine = mine + wk.L[lane][k] * wk.u[k];
    }
#pragma unroll
    for (int i = 0; i < N; ++i) qfrc[i] = __shfl_sync(0xffffffffu, mine, i);
#endif
  }
  SPATIAL_STAMP(kPhQp);
}

// The QP of the nv valid rows: skipped without a row, else on the dense path
// (nv <= kDense) or the wide one, each its own instance of qp_rows.
template <typename T, int N, int R, int F, int W>
__device__ void solve_qp(const Model<T>& m, Work<T, N, R, F>& wk, int nv, T (&qfrc)[N]) {
  constexpr int RW = (R + W - 1) / W;
  if (nv == 0) {  // every iterate would stay 0
    Lanes<W>::sync();
    for (int r = Lanes<W>::lane(); r < m.n_rows; r += W) wk.lam_full[r] = T(0);
    Lanes<W>::sync();
#pragma unroll
    for (int d = 0; d < N; ++d) qfrc[d] = T(0);
  } else if (nv <= kDense) {
    qp_rows<kDenseSlots<W, RW>, true, T, N, R, F, W>(m, wk, nv, qfrc);
  } else {
    qp_rows<RW, false, T, N, R, F, W>(m, wk, nv, qfrc);
  }
}

// One constrained forward pass (mj_forward) at (q, qv), run by the sample's
// lanes together: the acceleration, the same on every lane; wk.lam_full
// warm-starts the QP and returns its solution. With kEuler the QP sees the
// undamped M and the acceleration solves (M + h diag(damping)) acc = smooth +
// qfrc (the implicit damping of mj_Euler). With kSprings the smooth force
// pulls each sprung hinge toward its springref. Kept out of line: RK4 calls
// it 4 times per substep.
template <typename T, int N, int NQ, int F, int R, int W>
__device__ __noinline__ void forward_acc(const Model<T>& m, const T (&q)[NQ], const T (&qv)[N],
                                         const T (&tau)[N], Work<T, N, R, F>& wk, T (&acc)[N]) {
  SPATIAL_STAMP(kPhIntegrate);
  frames<T, N, NQ, F, W>(m, q, wk.kin);
  SPATIAL_STAMP(kPhFrames);
  mass_and_bias<T, N, F, W>(m, wk.kin, qv, wk.body, wk.L, wk.M, wk.bias);
  SPATIAL_STAMP(kPhMass);
  factor<T, N, W>(wk.L, wk.inv);
  T smooth[N], a_smooth[N], qfrc[N];
#pragma unroll
  for (int d = 0; d < N; ++d) smooth[d] = tau[d] - wk.bias[d] - m.damping[d] * qv[d];
  if (F & kSprings) {
#pragma unroll
    for (int d = 0; d < N; ++d)
      if (m.stiffness[d] != T(0))
        smooth[d] = smooth[d] - m.stiffness[d] * (pick(q, m.spring_qadr[d]) - m.springref[d]);
  }
  chol_solve<T, N, W>(wk.L, wk.inv, smooth, a_smooth);
  SPATIAL_STAMP(kPhFactor);
  const int nv = contact_rows<T, N, NQ, F, R, W>(m, q, qv, a_smooth, wk);
  SPATIAL_ROWS(nv);
  solve_qp<T, N, R, F, W>(m, wk, nv, qfrc);
#pragma unroll
  for (int d = 0; d < N; ++d) smooth[d] = smooth[d] + qfrc[d];
  if constexpr ((F & kEuler) != 0) {
    Lanes<W>::sync();  // every lane is done with the first factor
    constexpr int kEntries = N * (N + 1) / 2;
    for (int e = Lanes<W>::lane(); e < kEntries; e += W) {
      int i, j;
      tri_index(e, i, j);
      wk.L[i][j] = i == j ? wk.M[i][i] + m.h_damping[i] : wk.M[i][j];
    }
    Lanes<W>::sync();
    factor<T, N, W>(wk.L, wk.inv);
  }
  chol_solve<T, N, W>(wk.L, wk.inv, smooth, acc);
  SPATIAL_STAMP(kPhFactor);
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
template <typename T, int N, int NQ, int F, int R, int W>
__device__ void rk4_substep(const Model<T>& m, T (&q)[NQ], T (&qv)[N], const T (&tau)[N],
                            Work<T, N, R, F>& wk, T (&q_snap)[NQ]) {
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
    forward_acc<T, N, NQ, F, R, W>(m, q_snap, vs, tau, wk, acc);
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
template <typename T, int N, int NQ, int F, int R, int W>
__device__ void euler_substep(const Model<T>& m, T (&q)[NQ], T (&qv)[N], const T (&tau)[N],
                              Work<T, N, R, F>& wk, T (&q_snap)[NQ]) {
  normalize_quats(m, q);
  T acc[N];
  forward_acc<T, N, NQ, F, R, W>(m, q, qv, tau, wk, acc);
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
template <typename T, int N, int NQ, int F, int R, int W>
__device__ void control_step(const Model<T>& m, T (&q)[NQ], T (&qv)[N], const T* a,
                             Work<T, N, R, F>& wk, T (&q_snap)[NQ]) {
  T tau[N];
#pragma unroll
  for (int d = 0; d < N; ++d) tau[d] = T(0);
  for (int i = 0; i < m.n_act; ++i) {
    const int dof = m.act_dof[i];
#pragma unroll
    for (int d = 0; d < N; ++d)
      if (d == dof) tau[d] = m.gear[i] * clip(a[i], -m.act_clip, m.act_clip);
  }
  Lanes<W>::sync();  // every lane is done with the last step's lambda
  for (int r = Lanes<W>::lane(); r < m.n_rows; r += W) wk.lam_full[r] = T(0);
#pragma unroll
  for (int i = 0; i < NQ; ++i) q_snap[i] = q[i];
  for (int s = 0; s < m.frame_skip; ++s) {
    if (F & kEuler)
      euler_substep<T, N, NQ, F, R, W>(m, q, qv, tau, wk, q_snap);
    else
      rk4_substep<T, N, NQ, F, R, W>(m, q, qv, tau, wk, q_snap);
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
// row's n lam, +f on body2 and -f on body1; limit rows carry no force. Lane
// l takes contacts and pairs l, l + W, ...; each body's wrench is summed
// over the lanes in lane order, so every lane returns the same value.
template <typename T, int N, int F, int W>
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
  const int lane = Lanes<W>::lane();
  for (int ci = lane; ci < m.n_contacts; ci += W) {
    const Contact<T>& ct = m.con[ci];
    const int r = ct.row;
    T p[3], f[3];
    rvec(kin.R[ct.body], ct.local, p);
#pragma unroll
    for (int i = 0; i < 3; ++i) p[i] = kin.o[ct.body][i] + p[i];
    const T dist = (p[2] - m.floor_z) - ct.radius;
    const T cp[3] = {p[0], p[1], m.floor_z + T(0.5) * dist};
    if ((F & kCondim1) && ct.condim == 1) {
      f[0] = f[1] = T(0);
      f[2] = lam[r];
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
    }
    add_wrench(acc, ct.body, cp, com, f, T(1));
  }
  if (F & kCylinder) {
    for (int pi = lane; pi < m.n_cyl; pi += W) {
      const CylPair<T>& pr = m.cyl[pi];
      const int r = m.n_rows - m.n_cap - m.n_cyl + pi;
      T dist, nvec[3], cp[3], f[3];
      capsule_cylinder(kin, pr, dist, nvec, cp);
#pragma unroll
      for (int i = 0; i < 3; ++i) f[i] = lam[r] * nvec[i];
      add_wrench(acc, pr.body2, cp, com, f, T(1));
      add_wrench(acc, pr.body1, cp, com, f, T(-1));
    }
  }
  if (F & kSelfPairs) {
    for (int pi = lane; pi < m.n_cap; pi += W) {
      const CapPair<T>& pr = m.cap[pi];
      const int r = m.n_rows - m.n_cap + pi;
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
    for (int c = 0; c < 6; ++c) {
      const T a = Lanes<W>::sum(acc[b][c], W);
      s = s + a * a;
    }
  }
  return s;
}

// What the W lanes of the kernel do for sample k: from x0 + k * x_stride
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
// and in the `standup` family. Every lane carries the state (each computes
// the same values); the first writes costs[k] (the rollout entry) or the
// state to x_out (the step entry, horizon 1) where not null.
template <typename T, int N, int NQ, int F, int R, int W>
__device__ void run_sample(const Model<T>& m, int k, const T* x0, long long x_stride,
                           const T* controls, long long c_t, long long c_i, long long c_k,
                           int horizon, T* costs, T* x_out, Work<T, N, R, F>& wk) {
  SPATIAL_STAMP_START();
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
    control_step<T, N, NQ, F, R, W>(m, q, qv, a, wk, q_snap);
    SPATIAL_STAMP(kPhIntegrate);
    T ssq = T(0);
    for (int i = 0; i < m.n_act; ++i) ssq = ssq + a[i] * a[i];
    T rew;
    if (F & kStandup) {
      frames<T, N, NQ, F, W>(m, q_snap, wk.kin);
      const T cfrc = contact_force_ssq<T, N, F, W>(m, wk.kin, wk.lam_full);
      T ssq_c = T(0);
      for (int i = 0; i < m.n_act; ++i) {
        const T ai = clip(a[i], -m.act_clip, m.act_clip);
        ssq_c = ssq_c + ai * ai;
      }
      const T impact = T(0.5e-6) * cfrc;
      rew = ((q[2] / m.h - m.ctrl_w * ssq_c) - (impact < T(10) ? impact : T(10))) + m.healthy;
      carry[0] = cfrc;
    } else if (F & kComX) {
      frames<T, N, NQ, F, W>(m, q_snap, wk.kin);
      const T track = com_x(m, wk.kin);
      rew = m.healthy + (track - carry[0]) * m.fwd_inv_dt;
      for (int i = 0; i < m.n_act; ++i) {
        const T ai = clip(a[i], -m.act_clip, m.act_clip);
        rew = rew - m.ctrl_w * (ai * ai);
      }
      carry[0] = track;
    } else if (F & kPusher) {
      rew = -dist3(carry, 3, 6) - m.ctrl_w * ssq - T(0.5) * dist3(carry, 3, 0);
      frames<T, N, NQ, F, W>(m, q_snap, wk.kin);
#pragma unroll
      for (int b = 0; b < kCarryBodies; ++b) {
#pragma unroll
        for (int i = 0; i < 3; ++i) carry[3 * b + i] = wk.kin.o[m.carry_body[b]][i];
      }
    } else {
      rew = m.healthy + (q_snap[0] - carry[0]) * m.fwd_inv_dt;
      for (int i = 0; i < m.n_act; ++i) rew = rew - m.ctrl_w * (a[i] * a[i]);
      carry[0] = q_snap[0];
    }
    cost = cost - rew;
    SPATIAL_STAMP(kPhReward);
  }
  if (Lanes<W>::lane() != 0) return;
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
    ct.row = nl + m.n_rows;
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
