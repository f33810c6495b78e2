"""Frozen copy of `mpopis_tpu_torch/models/spatial_contact.py` at commit 3b1bee442fec:
the spatial contact dynamics (Ant's family), up to but not including
the env classes.

The benchmark's plain reference: it imports nothing of the program, and a
later change to the program leaves it as it is. Only the imports differ from
the original, which follows below as it stood.

The original's docstring:

Spatial (3D) MuJoCo dynamics with contacts (Ant, Pusher): the model
tables, quaternion forward kinematics, the analytic mass matrix and bias,
the constraint rows, the box-QP contact solve, and the RK4 substep over the
quaternion manifold and the Euler-implicit substep.

Counterpart of `mpopis_tpu/models/spatial_contact.py`, where every probed
convention is documented (free-joint qvel = world linear velocity then the
body-frame angular velocity; the free root's rotational Jacobian columns
are the root rotation's columns crossed with (p − root); α_root = 0 in the
bias; floor contacts as sphere / capsule-end centres against the z = floor
plane with the contact point at z = dist/2 and pyramidal condim-3 rows
n ± μt1, n ± μt2, t1 the normalized xy-projection of the capsule axis or
(0, 1, 0) for a sphere, condim-1 contacts as one normal row with no pyramid
factor in R; the capsule–cylinder pairs' witness point by bisection;
mj_RungeKutta with stage positions integrated from q₀ and the stage-4
positions left in data.xpos; Euler with the QP against the undamped M and
the pre-integration positions left in data.xpos). The tables are copies of
the JAX package's dataclasses (`utils/convert.py::spatial_model` rebuilds
one from the other and the tests pin them field by field).

The JAX package writes the substep over tuples of scalars and folds the
static constants; the port writes it over batched tensors — a batch of
states is (..., n) — with exact zeros where the JAX package skips a term
(adding an exact zero or multiplying by an exact one changes no bit), and
keeps the JAX package's association order of every sum. The QP is the
planar family's dense stacked-row solve (`planar_contact.solve_qp`). This
is the plain version the CUDA kernel `csrc/spatial_rollout.cu` is held
against.

The Humanoid's and the Standup's additions: the capsule–capsule self pairs
(`capsule_capsule`, their rows after the cylinder pairs), joint springs in
the smooth force, and `contact_force_ssq`, the Σ‖cfrc_ext‖² the Standup's
reward reads.
"""


from __future__ import annotations

import dataclasses
import functools
from types import SimpleNamespace

import numpy as np
import torch

from benchmark.reference.linalg import chol_solve, chol_unrolled
from benchmark.reference.planar_contact import (
    _impedance_rows,
    solimp_tensors,
    solve_qp,
)

# mj_RungeKutta's stage nodes and weights
RK4_STAGES = ((0.0, 1.0 / 6.0), (0.5, 1.0 / 3.0), (0.5, 1.0 / 3.0), (1.0, 1.0 / 6.0))


@dataclasses.dataclass(frozen=True)
class SJoint:
    """One joint attached to a body. kind: 'free' | 'hinge' | 'slide'.
    `axis` and `anchor` (jnt_pos) are in the owning body's frame;
    `dof`/`qadr` index into qvel/qpos."""

    kind: str
    dof: int
    qadr: int
    axis: tuple[float, float, float] = (0.0, 0.0, 1.0)
    anchor: tuple[float, float, float] = (0.0, 0.0, 0.0)


@dataclasses.dataclass(frozen=True)
class SCBody:
    """One body of the spatial tree: `pos`/`quat` the static frame offset
    in the parent frame, `joints` in declaration order, `inertia` the full
    body-frame inertia (ixx, ixy, ixz, iyy, iyz, izz)."""

    parent: int
    pos: tuple[float, float, float]
    quat: tuple[float, float, float, float]
    joints: tuple[SJoint, ...]
    com: tuple[float, float, float]
    mass: float
    inertia: tuple[float, float, float, float, float, float]


@dataclasses.dataclass(frozen=True)
class SCContact:
    """One candidate floor contact: a sphere (or capsule end sphere) centre
    against the floor plane. `axis_local` is the capsule axis in the body
    frame (None for a sphere); condim 3 gives 4 pyramid rows, 1 a single
    frictionless normal row."""

    body: int
    local: tuple[float, float, float]
    radius: float
    mu: float
    margin: float
    solimp: tuple[float, float, float]
    axis_local: tuple[float, float, float] | None = None
    condim: int = 3


@dataclasses.dataclass(frozen=True)
class SCPairCylinder:
    """Capsule (body1) against an upright cylinder (body2): the Pusher's
    arm–object pair, one frictionless row (condim 1)."""

    body1: int
    a1: tuple[float, float, float]
    b1: tuple[float, float, float]
    r1: float
    body2: int
    center2: tuple[float, float, float]
    r2: float
    hh2: float
    mu: float
    margin: float
    solimp: tuple[float, float, float]
    condim: int = 1


@dataclasses.dataclass(frozen=True)
class SCPairCapsule:
    """Sphere/capsule against sphere/capsule on two bodies: the Humanoid's
    frictionless self-collision pairs, one row each. A sphere is a
    zero-length segment (a == b)."""

    body1: int
    a1: tuple[float, float, float]
    b1: tuple[float, float, float]
    r1: float
    body2: int
    a2: tuple[float, float, float]
    b2: tuple[float, float, float]
    r2: float
    margin: float
    solimp: tuple[float, float, float]
    condim: int = 1


@dataclasses.dataclass(frozen=True)
class SCLimit:
    dof: int
    lo: float
    hi: float
    solimp: tuple[float, float, float]
    margin: float = 0.0


@dataclasses.dataclass(frozen=True)
class SpatialContactModel:
    """Static constant table for one spatial MJCF model."""

    n_dof: int
    n_q: int
    bodies: tuple[SCBody, ...]
    contacts: tuple[SCContact, ...]
    limits: tuple[SCLimit, ...]
    damping: tuple[float, ...]
    armature: tuple[float, ...]
    stiffness: tuple[float, ...]  # per dof, springs pull toward springref
    springref: tuple[float, ...]
    dof_invweight0: tuple[float, ...]
    body_invweight0: tuple[float, ...]  # per body, translation component
    timestep: float
    integrator: str  # "rk4" | "euler_implicit"
    gravity: float = 9.81
    floor_z: float = 0.0
    pairs: tuple[SCPairCylinder, ...] = ()
    self_pairs: tuple[SCPairCapsule, ...] = ()

    @property
    def n_rows(self) -> int:
        """Limit rows + 4 pyramid rows per condim-3 contact or pair + 1 row
        per condim-1 contact, pair and self pair."""
        assert all(p.condim == 1 for p in self.self_pairs)
        return (
            len(self.limits)
            + sum(4 if c.condim == 3 else 1 for c in self.contacts)
            + sum(4 if p.condim == 3 else 1 for p in self.pairs)
            + len(self.self_pairs)
        )

    @property
    def chains(self):
        """Tuple of root-ward body-index chains, one per body."""
        out = []
        for bi in range(len(self.bodies)):
            chain = []
            cur = bi
            while cur != -1:
                chain.append(cur)
                cur = self.bodies[cur].parent
            out.append(tuple(chain))
        return tuple(out)

    @property
    def dof_joints(self):
        """All (body_index, joint) pairs in tree order."""
        return tuple((bi, j) for bi, b in enumerate(self.bodies) for j in b.joints)

    def kb(self, dmax: float) -> tuple[float, float]:
        tc = max(0.02, 2.0 * self.timestep)
        return 1.0 / (dmax * tc) ** 2, 2.0 / (dmax * tc)


def joint_dofs(j: SJoint) -> range:
    """The dof indices a joint owns: 6 for a free joint, else 1."""
    return range(j.dof, j.dof + (6 if j.kind == "free" else 1))


def quat_matrix(w: float, x: float, y: float, z: float):
    """Row-major 3×3 rotation of a constant quaternion, in double, in the JAX
    package's `_qmat` order."""
    return (
        (1.0 - 2.0 * (y * y + z * z), 2.0 * (x * y - w * z), 2.0 * (x * z + w * y)),
        (2.0 * (x * y + w * z), 1.0 - 2.0 * (x * x + z * z), 2.0 * (y * z - w * x)),
        (2.0 * (x * z - w * y), 2.0 * (y * z + w * x), 1.0 - 2.0 * (x * x + y * y)),
    )


def hinge_k(axis):
    """(K, K²) of a constant unit axis: the Rodrigues coefficient matrices,
    K² summed in double as the JAX package's `_axis_rot_static` does."""
    ax, ay, az = axis
    k = ((0.0, -az, ay), (az, 0.0, -ax), (-ay, ax, 0.0))
    k2 = tuple(tuple(sum(k[i][l] * k[l][j] for l in range(3)) for j in range(3))
               for i in range(3))
    return k, k2


@functools.lru_cache(maxsize=None)
def _tables(model: SpatialContactModel, dtype: torch.dtype, device: torch.device):
    """The model's constants as tensors of one dtype on one device; every
    derived constant computed in double and rounded once."""
    n, nb = model.n_dof, len(model.bodies)

    def t(v, dt=dtype):
        return torch.as_tensor(np.asarray(v), dtype=dt, device=device)

    is_rot = np.zeros(n, dtype=bool)  # rotational dof: free rotation or hinge
    free_dof = np.zeros(n, dtype=bool)
    dof_qadr = np.zeros(n, dtype=np.int64)  # qpos of a 1-dof joint (0 for free dofs)
    free = []
    for _bi, j in model.dof_joints:
        if j.kind == "free":
            is_rot[j.dof + 3: j.dof + 6] = True
            free_dof[j.dof: j.dof + 6] = True
            free.append(j)
        else:
            is_rot[j.dof] = j.kind == "hinge"
            dof_qadr[j.dof] = j.qadr
    chain = np.zeros((nb, n), dtype=bool)  # chain[b, d]: dof d moves body b
    for b, bodies in enumerate(model.chains):
        for c in bodies:
            for j in model.bodies[c].joints:
                chain[b, list(joint_dofs(j))] = True
    hinge = {}  # per hinge dof: (axis, anchor, K, K²) in its body's frame
    slide = {}  # per slide dof: its axis
    for _bi, j in model.dof_joints:
        if j.kind == "hinge":
            hinge[j.dof] = (t(j.axis), t(j.anchor), *(t(m) for m in hinge_k(j.axis)))
        elif j.kind == "slide":
            slide[j.dof] = t(j.axis)

    def inertia(i6):
        xx, xy, xz, yy, yz, zz = i6
        return ((xx, xy, xz), (xy, yy, yz), (xz, yz, zz))

    lim, con, prs, sps = model.limits, model.contacts, model.pairs, model.self_pairs
    assert all(p.condim == 1 for p in prs)
    # rows per contact: 4 pyramid rows (condim 3) or 1 normal row (condim 1),
    # gathered from [the C×4 pyramid rows, the C normal rows] in model order
    order, con_row = [], []
    for ci, c in enumerate(con):
        con_row.append(len(lim) + len(order))
        order += [4 * ci + r for r in range(4)] if c.condim == 3 else [4 * len(con) + ci]
    # self pairs: the segments in their body frames, their static squared
    # lengths (0 for a sphere) and the constants of the closest-point algebra,
    # in double; 1/length² is 1 where a sphere never reads it
    seg = [(tuple(b - a for a, b in zip(p.a1, p.b1)), tuple(b - a for a, b in zip(p.a2, p.b2)))
           for p in sps]
    la = [sum(c * c for c in d1) for d1, _ in seg]
    le = [sum(c * c for c in d2) for _, d2 in seg]
    return SimpleNamespace(
        n=n,
        is_rot=t(is_rot, torch.bool),
        free_dof=t(free_dof, torch.bool),
        dof_qadr=t(dof_qadr, torch.long),
        free=tuple(free),
        eye3=t(np.eye(3)),
        chain=t(chain, torch.bool),
        hinge=hinge,
        slide=slide,
        body_pos=t([b.pos for b in model.bodies]),
        body_rot=t([quat_matrix(*b.quat) for b in model.bodies]),
        body_com=t([b.com for b in model.bodies]),
        body_mass=[b.mass for b in model.bodies],
        body_inertia=t([inertia(b.inertia) for b in model.bodies]),
        damping=t(model.damping),
        stiffness=t(model.stiffness),
        springref=t(model.springref),
        armature_diag=torch.diag(t(model.armature)),
        lim_dof=t([lm.dof for lm in lim], torch.long),
        lim_qadr=t([dof_qadr[lm.dof] for lm in lim], torch.long),
        lim_lo=t([lm.lo for lm in lim]),
        lim_hi=t([lm.hi for lm in lim]),
        lim_margin=t([lm.margin for lm in lim]),
        lim_invweight=t([model.dof_invweight0[lm.dof] for lm in lim]),
        lim_j=torch.nn.functional.one_hot(
            t([lm.dof for lm in lim], torch.long), n
        ).to(dtype) if lim else None,
        lim_imp=solimp_tensors(model, lim, t),
        con_body=t([c.body for c in con], torch.long),
        con_local=t([c.local for c in con]),
        con_radius=t([c.radius for c in con]),
        con_margin=t([c.margin for c in con]),
        con_mu=t([c.mu for c in con]),
        con_neg_mu=t([-c.mu for c in con]),
        con_bw=t([model.body_invweight0[c.body] for c in con]),
        con_rfac=t([2.0 * c.mu * c.mu * (1.0 + c.mu * c.mu) for c in con]),
        con_has_axis=t([c.axis_local is not None for c in con], torch.bool),
        con_axis=t([c.axis_local or (0.0, 0.0, 0.0) for c in con]),
        con_pyramid=t([c.condim == 3 for c in con], torch.bool),
        con_order=t(order, torch.long),
        con_row=t(con_row, torch.long),
        con_imp=solimp_tensors(model, con, t),
        h_damping_diag=torch.diag(t([model.timestep * d for d in model.damping])),
        pair_b1=t([p.body1 for p in prs], torch.long),
        pair_b2=t([p.body2 for p in prs], torch.long),
        pair_a1=t([p.a1 for p in prs]).reshape(-1, 3),
        pair_b1_end=t([p.b1 for p in prs]).reshape(-1, 3),
        pair_center2=t([p.center2 for p in prs]).reshape(-1, 3),
        pair_r1=t([p.r1 for p in prs]),
        pair_r2=t([p.r2 for p in prs]),
        pair_hh2=t([p.hh2 for p in prs]),
        pair_margin=t([p.margin for p in prs]),
        pair_bw=t([model.body_invweight0[p.body1] + model.body_invweight0[p.body2]
                   for p in prs]),
        pair_imp=solimp_tensors(model, prs, t),
        self_b1=t([p.body1 for p in sps], torch.long),
        self_b2=t([p.body2 for p in sps], torch.long),
        self_a1=t([p.a1 for p in sps]).reshape(-1, 3),
        self_a2=t([p.a2 for p in sps]).reshape(-1, 3),
        self_d1=t([d1 for d1, _ in seg]).reshape(-1, 3),
        self_d2=t([d2 for _, d2 in seg]).reshape(-1, 3),
        self_seg1=t([v > 0.0 for v in la], torch.bool),
        self_seg2=t([v > 0.0 for v in le], torch.bool),
        self_lale=t([a * e for a, e in zip(la, le)]),
        self_den_eps=t([1e-12 * a * e for a, e in zip(la, le)]),
        self_inv_la=t([1.0 / v if v > 0.0 else 1.0 for v in la]),
        self_inv_le=t([1.0 / v if v > 0.0 else 1.0 for v in le]),
        self_le=t(le),
        self_r1=t([p.r1 for p in sps]),
        self_r2=t([p.r2 for p in sps]),
        self_margin=t([p.margin for p in sps]),
        self_bw=t([model.body_invweight0[p.body1] + model.body_invweight0[p.body2]
                   for p in sps]),
        self_imp=solimp_tensors(model, sps, t),
    )


def _tab(model, like: torch.Tensor):
    return _tables(model, like.dtype, like.device)


# -- 3-vector algebra in the JAX package's association order -----------------
def _dot3(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _cross(a, b):
    return torch.stack([
        a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
    ], dim=-1)


def _rvec(r, v):
    """r (..., 3, 3) applied to v (..., 3)."""
    return (r[..., :, 0] * v[..., None, 0] + r[..., :, 1] * v[..., None, 1]
            + r[..., :, 2] * v[..., None, 2])


def _rmul(a, b):
    """a @ b for (..., 3, 3) rotations."""
    return (a[..., :, 0:1] * b[..., 0:1, :] + a[..., :, 1:2] * b[..., 1:2, :]
            + a[..., :, 2:3] * b[..., 2:3, :])


def _qmat(w, x, y, z):
    """(..., 3, 3) rotation of the quaternions (w, x, y, z)."""
    return torch.stack([
        torch.stack([1.0 - 2.0 * (y * y + z * z), 2.0 * (x * y - w * z),
                     2.0 * (x * z + w * y)], dim=-1),
        torch.stack([2.0 * (x * y + w * z), 1.0 - 2.0 * (x * x + z * z),
                     2.0 * (y * z - w * x)], dim=-1),
        torch.stack([2.0 * (x * z - w * y), 2.0 * (y * z + w * x),
                     1.0 - 2.0 * (x * x + y * y)], dim=-1),
    ], dim=-2)


def _sym_rotate(r, inertia):
    """R · I · Rᵀ of a constant symmetric body inertia (3, 3); the upper
    triangle as the JAX package computes it, mirrored."""
    full = _rmul(_rmul(r, inertia), r.transpose(-1, -2))
    return torch.triu(full) + torch.triu(full, 1).transpose(-1, -2)


def _sym_vec(s, v):
    """S (..., 3, 3) applied to v (..., n, 3), one row of S at a time."""
    return torch.stack([
        s[..., None, k, 0] * v[..., 0] + s[..., None, k, 1] * v[..., 1]
        + s[..., None, k, 2] * v[..., 2]
        for k in range(3)
    ], dim=-1)


def _seqdot(a, b):
    """Σ_d a[..., d]·b[..., d] summed in dof order, as `_jdotv` does."""
    s = a[..., 0] * b[..., 0]
    for d in range(1, a.shape[-1]):
        s = s + a[..., d] * b[..., d]
    return s


def _outer_dot(a, b):
    """(..., n, n): entry (i, j) = a_i · b_j over the last axis of (..., n, 3)."""
    return (a[..., :, None, 0] * b[..., None, :, 0] + a[..., :, None, 1] * b[..., None, :, 1]
            + a[..., :, None, 2] * b[..., None, :, 2])


def normalize_quat(model: SpatialContactModel, q: torch.Tensor) -> torch.Tensor:
    """Every free joint's quaternion of qpos (..., n_q) normalized."""
    tab = _tab(model, q)
    parts, at = [], 0
    for j in tab.free:
        a = j.qadr + 3
        w, x, y, z = (q[..., a + i] for i in range(4))
        inv = torch.rsqrt(w * w + x * x + y * y + z * z)
        parts += [q[..., at:a], q[..., a:a + 4] * inv.unsqueeze(-1)]
        at = a + 4
    return torch.cat(parts + [q[..., at:]], dim=-1) if parts else q


@dataclasses.dataclass
class Frames:
    """World kinematics: per body origin (..., 3) and rotation (..., 3, 3);
    per dof the world axis and anchor (..., n, 3) (a free joint's translation
    dofs carry the unit vectors); per free joint (by dof) its rotation."""

    origin: list
    rot: list
    axis: torch.Tensor
    anchor: torch.Tensor
    free_rot: dict


def frames(model: SpatialContactModel, q: torch.Tensor) -> Frames:
    tab = _tab(model, q)
    nb, n = len(model.bodies), model.n_dof
    batch = q.shape[:-1]
    origin, rot = [None] * nb, [None] * nb
    axis, anchor, free_rot = [None] * n, [None] * n, {}
    zero3 = q.new_zeros(batch + (3,))
    eye = tab.eye3.expand(batch + (3, 3))
    for bi, b in enumerate(model.bodies):
        o, r = (zero3, eye) if b.parent == -1 else (origin[b.parent], rot[b.parent])
        o = o + _rvec(r, tab.body_pos[bi])
        r = _rmul(r, tab.body_rot[bi])
        for j in b.joints:
            if j.kind == "free":
                o = q[..., j.qadr: j.qadr + 3]
                r = _qmat(*(q[..., j.qadr + 3 + i] for i in range(4)))
                free_rot[j.dof] = r
                for i in range(3):
                    axis[j.dof + i] = tab.eye3[i].expand(batch + (3,))
                    axis[j.dof + 3 + i] = r[..., :, i]
                for i in range(6):
                    anchor[j.dof + i] = o
            elif j.kind == "slide":
                a_w = _rvec(r, tab.slide[j.dof])
                o = o + q[..., j.qadr, None] * a_w
                axis[j.dof], anchor[j.dof] = a_w, o
            else:  # hinge
                axis_b, anchor_b, k, k2 = tab.hinge[j.dof]
                anchor_w = o + _rvec(r, anchor_b)
                axis[j.dof] = _rvec(r, axis_b)
                anchor[j.dof] = anchor_w
                ang = q[..., j.qadr, None, None]
                rot_j = (tab.eye3 + torch.sin(ang) * k) + (1.0 - torch.cos(ang)) * k2
                r = _rmul(r, rot_j)
                o = anchor_w - _rvec(r, anchor_b)
        origin[bi], rot[bi] = o, r
    return Frames(origin=origin, rot=rot, axis=torch.stack(axis, dim=-2),
                  anchor=torch.stack(anchor, dim=-2), free_rot=free_rot)


def point_jacobians(model: SpatialContactModel, fr: Frames, bodies, points: torch.Tensor):
    """Jacobian columns at world points (..., m, 3) fixed to `bodies` (m,):
    (Jv, Jω), each (..., m, n, 3) — translation dofs give their axis (Jω = 0),
    rotational dofs a × (p − anchor) and a, dofs off the body's chain 0."""
    tab = _tab(model, points)
    rel = points[..., :, None, :] - fr.anchor[..., None, :, :]
    a = fr.axis[..., None, :, :].expand(rel.shape)
    on = tab.chain[bodies][..., None]  # (m, n, 1)
    rot = tab.is_rot[:, None]
    jv = torch.where(on, torch.where(rot, _cross(a, rel), a), 0.0)
    jw = torch.where(on & rot, a, 0.0)
    return jv, jw


def _com_jacobians(model, fr):
    """Per body the world com (..., nb, 3) and its (Jv, Jω) (..., nb, n, 3)."""
    tab = _tab(model, fr.axis)
    com = torch.stack([o + _rvec(r, tab.body_com[bi])
                       for bi, (o, r) in enumerate(zip(fr.origin, fr.rot))], dim=-2)
    jv, jw = point_jacobians(model, fr, torch.arange(len(model.bodies)), com)
    return com, jv, jw


def mass_entries_analytic(model: SpatialContactModel, q: torch.Tensor, fr=None, jac=None):
    """Mass matrix (..., n, n): diag(armature) + Σ_b m_b Jv_bᵀJv_b + Jω_bᵀ I_w Jω_b,
    accumulated body by body; the lower triangle mirrored."""
    tab = _tab(model, q)
    fr = frames(model, q) if fr is None else fr
    _, jv, jw = _com_jacobians(model, fr) if jac is None else jac
    m = tab.armature_diag.expand(q.shape[:-1] + (model.n_dof, model.n_dof))
    for bi, r in enumerate(fr.rot):
        jvb, jwb = jv[..., bi, :, :], jw[..., bi, :, :]
        iwj = _sym_vec(_sym_rotate(r, tab.body_inertia[bi]), jwb)
        m = m + (tab.body_mass[bi] * _outer_dot(jvb, jvb) + _outer_dot(iwj, jwb))
    return torch.tril(m) + torch.tril(m, -1).transpose(-1, -2)


def bias_analytic(model: SpatialContactModel, q: torch.Tensor, qv: torch.Tensor, fr=None,
                  jac=None):
    """Coriolis/centrifugal + gyroscopic + gravity generalized forces (..., n):
    ω/α and origin velocity/acceleration propagated with q̈ = 0, the per-body
    wrench m(a_com − g), I_w α + ω × I_w ω projected on the com columns."""
    tab = _tab(model, q)
    fr = frames(model, q) if fr is None else fr
    _, jv, jw = _com_jacobians(model, fr) if jac is None else jac
    nb = len(model.bodies)
    omega, alpha, vel_o, acc_o = [None] * nb, [None] * nb, [None] * nb, [None] * nb
    zero3 = q.new_zeros(q.shape[:-1] + (3,))
    for bi, b in enumerate(model.bodies):
        if b.parent == -1:
            om, al, vo, ao = zero3, zero3, zero3, zero3
        else:
            p = b.parent
            om, al = omega[p], alpha[p]
            d = fr.origin[bi] - fr.origin[p]
            vo = vel_o[p] + _cross(om, d)
            ao = (acc_o[p] + _cross(al, d)) + _cross(om, _cross(om, d))
        for j in b.joints:
            if j.kind == "free":
                vo = qv[..., j.dof: j.dof + 3]
                ao = zero3
                om = _rvec(fr.free_rot[j.dof], qv[..., j.dof + 3: j.dof + 6])
                al = zero3  # d/dt(R ω_local) = ω × ω = 0 at ω̇ = 0
            elif j.kind == "slide":
                va = qv[..., j.dof, None] * fr.axis[..., j.dof, :]
                vo = vo + va
                ao = ao + _cross(om, va)
            else:  # hinge: to the anchor, add the joint rate, back to the origin
                w = fr.anchor[..., j.dof, :]
                dw = w - fr.origin[bi]
                vw = vo + _cross(om, dw)
                aw = (ao + _cross(al, dw)) + _cross(om, _cross(om, dw))
                aq = qv[..., j.dof, None] * fr.axis[..., j.dof, :]
                al = al + _cross(om, aq)
                om = om + aq
                do = fr.origin[bi] - w
                vo = vw + _cross(om, do)
                ao = (aw + _cross(al, do)) + _cross(om, _cross(om, do))
        omega[bi], alpha[bi], vel_o[bi], acc_o[bi] = om, al, vo, ao

    out = torch.zeros_like(qv)
    g = model.gravity
    for bi, (b, r) in enumerate(zip(model.bodies, fr.rot)):
        r_com = _rvec(r, tab.body_com[bi])
        vcom = vel_o[bi] + _cross(omega[bi], r_com)
        acom = (acc_o[bi] + _cross(alpha[bi], r_com)) + _cross(omega[bi], vcom - vel_o[bi])
        iw = _sym_rotate(r, tab.body_inertia[bi])
        f = torch.stack([b.mass * acom[..., 0], b.mass * acom[..., 1],
                         b.mass * (acom[..., 2] + g)], dim=-1)
        t = (_sym_vec(iw, alpha[bi][..., None, :])[..., 0, :]
             + _cross(omega[bi], _sym_vec(iw, omega[bi][..., None, :])[..., 0, :]))
        out = out + (_dot3(jv[..., bi, :, :], f[..., None, :])
                     + _dot3(jw[..., bi, :, :], t[..., None, :]))
    return out


def q_of_dof(model: SpatialContactModel, q: torch.Tensor) -> torch.Tensor:
    """qpos of each dof's 1-dof joint (..., n), 0 on free-joint dofs."""
    tab = _tab(model, q)
    return torch.where(tab.free_dof, 0.0, q[..., tab.dof_qadr])


def contact_rows(model: SpatialContactModel, q: torch.Tensor, qv: torch.Tensor, fr=None):
    """Constraint rows in the dense stacked form: (J (..., R, n), aref (..., R),
    R (..., R), active (..., R) bool), rows ordered as in the JAX package:
    limits, then per contact n + μt1, n − μt1, n + μt2, n − μt2 (condim 3) or
    the normal row (condim 1), then one row per capsule–cylinder pair, then
    one per self pair."""
    tab = _tab(model, q)
    fr = frames(model, q) if fr is None else fr
    js, arefs, regs, acts = [], [], [], []

    if model.limits:
        qd, qvd = q[..., tab.lim_qadr], qv[..., tab.lim_dof]
        d_lo = (qd - tab.lim_lo) - tab.lim_margin
        d_hi = (tab.lim_hi - qd) - tab.lim_margin
        lower_closer = d_lo < d_hi
        pos = torch.where(lower_closer, d_lo, d_hi)
        sgn = torch.where(lower_closer, 1.0, -1.0).to(q.dtype)
        imp = _impedance_rows(pos, tab.lim_imp)
        js.append(sgn.unsqueeze(-1) * tab.lim_j)
        arefs.append(-tab.lim_imp["bc"] * (sgn * qvd) - tab.lim_imp["kc"] * imp * pos)
        regs.append((1.0 - imp) / imp * tab.lim_invweight)
        acts.append(pos < 0.0)

    if model.contacts:
        org = torch.stack(fr.origin, dim=-2)[..., tab.con_body, :]  # (..., C, 3)
        rot = torch.stack(fr.rot, dim=-3)[..., tab.con_body, :, :]
        p = org + _rvec(rot, tab.con_local)
        dist = (p[..., 2] - model.floor_z) - tab.con_radius
        active = dist < tab.con_margin
        cp = torch.stack([p[..., 0], p[..., 1], model.floor_z + 0.5 * dist], dim=-1)
        jv, _ = point_jacobians(model, fr, tab.con_body, cp)  # (..., C, n, 3)
        jn = jv[..., 2]
        cimp = tab.con_imp
        pos_m = dist - tab.con_margin
        imp = _impedance_rows(pos_m, cimp)
        qv_c = qv.unsqueeze(-2)
        jv_n = _seqdot(jn, qv_c)
        base_aref = -cimp["kc"] * imp * pos_m
        neg_bc = -cimp["bc"]
        # tangents: t1 = normalized xy-projection of the world capsule axis,
        # (0, 1, 0) for a sphere; t2 = n × t1 = (−t1y, t1x, 0)
        a_w = _rvec(rot, tab.con_axis)
        nrm = torch.sqrt(torch.clamp(a_w[..., 0] * a_w[..., 0] + a_w[..., 1] * a_w[..., 1],
                                     min=1e-24))
        t1x = torch.where(tab.con_has_axis, a_w[..., 0] / nrm, 0.0).unsqueeze(-1)
        t1y = torch.where(tab.con_has_axis, a_w[..., 1] / nrm, 1.0).unsqueeze(-1)
        jt1 = jv[..., 0] * t1x + jv[..., 1] * t1y + jv[..., 2] * 0.0
        jt2 = jv[..., 0] * (-t1y) + jv[..., 1] * t1x + jv[..., 2] * 0.0
        jv_t1, jv_t2 = _seqdot(jt1, qv_c), _seqdot(jt2, qv_c)
        mu, neg_mu = tab.con_mu, tab.con_neg_mu
        r_pyr = (1.0 - imp) / imp * tab.con_bw * tab.con_rfac
        pyr_j = torch.stack([jn + mu[:, None] * jt1, jn + neg_mu[:, None] * jt1,
                             jn + mu[:, None] * jt2, jn + neg_mu[:, None] * jt2], dim=-2)
        pyr_aref = torch.stack([neg_bc * (jv_n + mu * jv_t1) + base_aref,
                                neg_bc * (jv_n + neg_mu * jv_t1) + base_aref,
                                neg_bc * (jv_n + mu * jv_t2) + base_aref,
                                neg_bc * (jv_n + neg_mu * jv_t2) + base_aref], dim=-1)
        # rows of every contact as both kinds, then each contact's own kept
        all_j = torch.cat([pyr_j.flatten(-3, -2), jn], dim=-2)
        all_aref = torch.cat([pyr_aref.flatten(-2), neg_bc * jv_n + base_aref], dim=-1)
        all_reg = torch.cat([r_pyr.unsqueeze(-1).expand(r_pyr.shape + (4,)).flatten(-2),
                             (1.0 - imp) / imp * tab.con_bw], dim=-1)
        all_act = torch.cat([active.unsqueeze(-1).expand(active.shape + (4,)).flatten(-2),
                             active], dim=-1)
        js.append(all_j[..., tab.con_order, :])
        arefs.append(all_aref[..., tab.con_order])
        regs.append(all_reg[..., tab.con_order])
        acts.append(all_act[..., tab.con_order])

    for pairs, geom, b1, b2, margin, bw, pimp in (
            (model.pairs, capsule_cylinder, tab.pair_b1, tab.pair_b2, tab.pair_margin,
             tab.pair_bw, tab.pair_imp),
            (model.self_pairs, capsule_capsule, tab.self_b1, tab.self_b2, tab.self_margin,
             tab.self_bw, tab.self_imp)):
        if not pairs:
            continue
        dist, nvec, cp = geom(model, fr)
        # J = n · (v₂(cp) − v₁(cp)) over both bodies' dof columns (a dof on
        # both chains cancels)
        jv1, _ = point_jacobians(model, fr, b1, cp)  # (..., P, n, 3)
        jv2, _ = point_jacobians(model, fr, b2, cp)
        nv = nvec.unsqueeze(-2)
        j = -_dot3(jv1, nv) + _dot3(jv2, nv)
        pos_m = dist - margin
        imp = _impedance_rows(pos_m, pimp)
        js.append(j)
        arefs.append(-pimp["bc"] * _seqdot(j, qv.unsqueeze(-2)) - pimp["kc"] * imp * pos_m)
        regs.append((1.0 - imp) / imp * bw)
        acts.append(dist < margin)

    return (torch.cat(js, dim=-2), torch.cat(arefs, dim=-1), torch.cat(regs, dim=-1),
            torch.cat(acts, dim=-1))


def capsule_cylinder(model: SpatialContactModel, fr: Frames, halvings: int = 40):
    """Capsule (body1) against upright solid cylinder (body2), per pair:
    (dist (..., P), normal body1 → body2 (..., P, 3), contact point
    (..., P, 3)). The capsule-axis witness point minimizes the distance to the
    solid cylinder, a convex function along the segment: `halvings`
    bisections on the sign of its derivative; then the side, cap or rim
    region of the point against the cylinder gives the distance and normal.
    Valid while the segment stays outside the solid cylinder."""
    tab = _tab(model, fr.axis)
    org = torch.stack(fr.origin, dim=-2)
    rot = torch.stack(fr.rot, dim=-3)
    o1, r1m = org[..., tab.pair_b1, :], rot[..., tab.pair_b1, :, :]
    a = o1 + _rvec(r1m, tab.pair_a1)
    b = o1 + _rvec(r1m, tab.pair_b1_end)
    c = org[..., tab.pair_b2, :] + _rvec(rot[..., tab.pair_b2, :, :], tab.pair_center2)
    hh, r2 = tab.pair_hh2, tab.pair_r2
    d1 = b - a

    def region(px, py, pz):
        """(er, ez, inside, erp, ezp, d_out, dr, zsign, use_radial) of a point
        relative to the cylinder's centre."""
        dr = torch.sqrt(torch.clamp(px * px + py * py, min=1e-24))
        er = dr - r2
        ez = torch.abs(pz) - hh
        inside = (er < 0.0) & (ez < 0.0)
        erp = torch.clamp(er, min=0.0)
        ezp = torch.clamp(ez, min=0.0)
        d_out = torch.sqrt(torch.clamp(erp * erp + ezp * ezp, min=1e-24))
        zsign = torch.where(pz >= 0.0, 1.0, -1.0).to(pz.dtype)
        return er, ez, inside, erp, ezp, d_out, dr, zsign, er > ez

    def unit(px, py, pz):
        """The outward unit direction at the witness point (inside the solid,
        the max(er, ez) subgradient)."""
        _er, _ez, inside, erp, ezp, d_out, dr, zsign, use_radial = region(px, py, pz)
        ux = torch.where(inside, torch.where(use_radial, px / dr, 0.0), erp * px / (dr * d_out))
        uy = torch.where(inside, torch.where(use_radial, py / dr, 0.0), erp * py / (dr * d_out))
        uz = torch.where(inside, torch.where(use_radial, 0.0, zsign), ezp * zsign / d_out)
        return ux, uy, uz

    def dderiv(s_):
        ux, uy, uz = unit(a[..., 0] + s_ * d1[..., 0] - c[..., 0],
                          a[..., 1] + s_ * d1[..., 1] - c[..., 1],
                          a[..., 2] + s_ * d1[..., 2] - c[..., 2])
        return ux * d1[..., 0] + uy * d1[..., 1] + uz * d1[..., 2]

    lo = torch.zeros_like(a[..., 0])
    hi = torch.ones_like(a[..., 0])
    for _ in range(halvings):
        mid = 0.5 * (lo + hi)
        going_down = dderiv(mid) < 0.0
        lo = torch.where(going_down, mid, lo)
        hi = torch.where(going_down, hi, mid)
    s1 = 0.5 * (lo + hi)
    p1 = a + s1.unsqueeze(-1) * d1  # the witness point on the capsule axis
    dx, dy, dzs = p1[..., 0] - c[..., 0], p1[..., 1] - c[..., 1], p1[..., 2] - c[..., 2]
    er, ez, inside, erp, ezp, d_out, dr, zsign, use_radial = region(dx, dy, dzs)
    d_pt = torch.where(inside, torch.maximum(er, ez), d_out)
    # the normal from the cylinder surface toward p1: radial on the side wall,
    # vertical on the caps, mixed on the rim
    rad_x, rad_y = dx / dr, dy / dr
    nx = torch.where(inside, torch.where(use_radial, rad_x, 0.0), erp * rad_x / d_out)
    ny = torch.where(inside, torch.where(use_radial, rad_y, 0.0), erp * rad_y / d_out)
    nz = torch.where(inside, torch.where(use_radial, 0.0, zsign), ezp * zsign / d_out)
    dist = d_pt - tab.pair_r1
    # MuJoCo's frame: the normal points geom1 (capsule) → geom2 (cylinder)
    nvec = torch.stack([-nx, -ny, -nz], dim=-1)
    cp = p1 + nvec * (tab.pair_r1 + 0.5 * dist).unsqueeze(-1)
    return dist, nvec, cp


def capsule_capsule(model: SpatialContactModel, fr: Frames):
    """Sphere/capsule against sphere/capsule, per self pair: (dist (..., P),
    normal body1 → body2 (..., P, 3), contact point (..., P, 3)). The closest
    points of the two axis segments (Ericson, branchless), a pair end that is
    a sphere taking the point-against-segment form of its type; then
    dist = |c2 − c1| − r1 − r2 and the contact point c1 + n·(r1 + dist/2).
    Each type's formula is the JAX package's `_capsule_capsule`, computed for
    every pair and selected by the pair's static type."""
    tab = _tab(model, fr.axis)
    org = torch.stack(fr.origin, dim=-2)
    rot = torch.stack(fr.rot, dim=-3)
    r1m, r2m = rot[..., tab.self_b1, :, :], rot[..., tab.self_b2, :, :]
    a1 = org[..., tab.self_b1, :] + _rvec(r1m, tab.self_a1)
    a2 = org[..., tab.self_b2, :] + _rvec(r2m, tab.self_a2)
    d1, d2 = _rvec(r1m, tab.self_d1), _rvec(r2m, tab.self_d2)
    # capsule against capsule
    r = a1 - a2
    lf, lc, lb = _dot3(d2, r), _dot3(d1, r), _dot3(d1, d2)
    den = tab.self_lale - lb * lb
    s = torch.where(den > tab.self_den_eps,
                    torch.clamp((lb * lf - lc * tab.self_le) / torch.clamp(den, min=1e-30),
                                0.0, 1.0), 0.0)
    t_raw = (lb * s + lf) * tab.self_inv_le
    s = torch.where(t_raw < 0.0, torch.clamp(-lc * tab.self_inv_la, 0.0, 1.0),
                    torch.where(t_raw > 1.0, torch.clamp((lb - lc) * tab.self_inv_la, 0.0, 1.0), s))
    t = torch.clamp(t_raw, 0.0, 1.0)
    # a sphere (body1's end) against a capsule, a capsule against a sphere
    t_sphere = torch.clamp(_dot3(a1 - a2, d2) * tab.self_inv_le, 0.0, 1.0)
    s_sphere = torch.clamp(_dot3(a2 - a1, d1) * tab.self_inv_la, 0.0, 1.0)
    seg1, seg2 = tab.self_seg1, tab.self_seg2
    s = torch.where(seg2, s, s_sphere)
    t = torch.where(seg1, t, t_sphere)
    c1 = torch.where(seg1[:, None], a1 + s.unsqueeze(-1) * d1, a1)
    c2 = torch.where(seg2[:, None], a2 + t.unsqueeze(-1) * d2, a2)
    dvec = c2 - c1
    ln = torch.sqrt(torch.clamp(_dot3(dvec, dvec), min=1e-24))
    nvec = (1.0 / ln).unsqueeze(-1) * dvec
    dist = ln - tab.self_r1 - tab.self_r2
    cp = c1 + (tab.self_r1 + 0.5 * dist).unsqueeze(-1) * nvec
    return dist, nvec, cp


def contact_force_ssq(model: SpatialContactModel, q: torch.Tensor, lam: torch.Tensor, fr=None):
    """Σ_b ‖cfrc_ext[b]‖² (..., ) of the contact forces λ (..., n_rows) at the
    positions q: per body the world (torque, force) about the whole robot's
    mass-weighted com; a pyramid's force is n·Σλ + μ·t₁(λ₀ − λ₁) + μ·t₂(λ₂ −
    λ₃), a condim-1 row's and a pair row's n·λ, +f on body2 and −f on body1;
    limit rows carry no force and the world body accumulates nothing. The
    sums run in the JAX package's order (contacts, then cylinder pairs, then
    self pairs, per body). HumanoidStandup's impact cost reads it at the last
    RK stage's positions with that stage's λ."""
    tab = _tab(model, q)
    fr = frames(model, q) if fr is None else fr
    com = None
    for bi, b in enumerate(model.bodies):
        term = b.mass * (fr.origin[bi] + _rvec(fr.rot[bi], tab.body_com[bi]))
        com = term if com is None else com + term
    com = (1.0 / sum(b.mass for b in model.bodies)) * com
    zero = torch.zeros_like(q[..., 0])
    # each contribution: (body, sign, contact point (..., 3), force (..., 3))
    parts = []
    if model.contacts:
        org = torch.stack(fr.origin, dim=-2)[..., tab.con_body, :]
        rot = torch.stack(fr.rot, dim=-3)[..., tab.con_body, :, :]
        p = org + _rvec(rot, tab.con_local)
        dist = (p[..., 2] - model.floor_z) - tab.con_radius
        cp = torch.stack([p[..., 0], p[..., 1], model.floor_z + 0.5 * dist], dim=-1)
        a_w = _rvec(rot, tab.con_axis)
        nrm = torch.sqrt(torch.clamp(a_w[..., 0] * a_w[..., 0] + a_w[..., 1] * a_w[..., 1],
                                     min=1e-24))
        t1x = torch.where(tab.con_has_axis, a_w[..., 0] / nrm, 0.0)
        t1y = torch.where(tab.con_has_axis, a_w[..., 1] / nrm, 1.0)
        last = model.n_rows - 1
        lams = [lam[..., torch.clamp(tab.con_row + i, max=last)] for i in range(4)]
        fn = ((lams[0] + lams[1]) + lams[2]) + lams[3]
        ft1 = tab.con_mu * (lams[0] - lams[1])
        ft2 = tab.con_mu * (lams[2] - lams[3])
        pyr = tab.con_pyramid
        f = torch.stack([torch.where(pyr, ft1 * t1x + ft2 * (-t1y), 0.0),
                         torch.where(pyr, ft1 * t1y + ft2 * t1x, 0.0),
                         torch.where(pyr, fn, lams[0])], dim=-1)
        parts += [(c.body, 1.0, cp[..., ci, :], f[..., ci, :])
                  for ci, c in enumerate(model.contacts)]
    for pairs, geom in ((model.pairs, capsule_cylinder), (model.self_pairs, capsule_capsule)):
        if not pairs:
            continue
        first = (model.n_rows - len(model.self_pairs) - len(model.pairs)
                 if geom is capsule_cylinder else model.n_rows - len(model.self_pairs))
        _dist, nvec, cp = geom(model, fr)
        f = lam[..., first: first + len(pairs), None] * nvec
        for i, pr in enumerate(pairs):
            parts += [(pr.body2, 1.0, cp[..., i, :], f[..., i, :]),
                      (pr.body1, -1.0, cp[..., i, :], f[..., i, :])]
    acc = {}
    for body, sgn, cp, f in parts:
        w = torch.cat([_cross(cp - com, f), f], dim=-1)
        w = -w if sgn < 0 else w
        acc[body] = w if body not in acc else acc[body] + w
    s = zero
    for body in sorted(acc):
        for c in range(6):
            s = s + acc[body][..., c] * acc[body][..., c]
    return s


def qfrc_smooth(model: SpatialContactModel, q, qv, tau, bias=None):
    """Actuation − bias − damping·q̇ − stiffness·(q − springref), (..., n)."""
    tab = _tab(model, q)
    b = bias_analytic(model, q, qv) if bias is None else bias
    s = tau - b - tab.damping * qv
    if any(model.stiffness):
        s = s - tab.stiffness * (q_of_dof(model, q) - tab.springref)
    return s


def _forward(model: SpatialContactModel, q, qv, tau, outer: int, cg: int, lam0):
    """One constrained forward pass: (M, L, smooth, qfrc_constraint, λ)."""
    fr = frames(model, q)
    jac = _com_jacobians(model, fr)
    m = mass_entries_analytic(model, q, fr, jac)
    l = chol_unrolled(m)
    smooth = qfrc_smooth(model, q, qv, tau, bias_analytic(model, q, qv, fr, jac))
    a_smooth = chol_solve(l, smooth)
    jmat, aref, r_reg, active = contact_rows(model, q, qv, fr)
    qfrc_c, lam = solve_qp(jmat, aref, r_reg, active, l, a_smooth, outer, cg, lam0)
    return m, l, smooth, qfrc_c, lam


def qacc_warm(model: SpatialContactModel, q, qv, tau, outer: int, cg: int, lam0=None):
    """Full constrained forward dynamics (one mj_forward), warm-startable:
    (qacc (..., n), λ)."""
    _, l, smooth, qfrc_c, lam = _forward(model, q, qv, tau, outer, cg, lam0)
    return chol_solve(l, smooth + qfrc_c), lam


def integrate_pos(model: SpatialContactModel, q: torch.Tensor, v: torch.Tensor, h: float):
    """qpos ⊕ h·v (mj_integratePos): linear for slide/hinge/translation,
    the quaternion times the exponential of the body-frame angular velocity
    for free joints, renormalized."""
    tab = _tab(model, q)
    lin = q[..., tab.dof_qadr] + h * v  # the 1-dof joints' new qpos (free dofs unused)
    pieces = [None] * model.n_q
    for _bi, j in model.dof_joints:
        if j.kind == "free":
            for i in range(3):
                pieces[j.qadr + i] = q[..., j.qadr + i] + h * v[..., j.dof + i]
            wx, wy, wz = v[..., j.dof + 3], v[..., j.dof + 4], v[..., j.dof + 5]
            n2 = wx * wx + wy * wy + wz * wz
            nrm = torch.sqrt(torch.clamp(n2, min=1e-30))
            half = 0.5 * h * nrm
            cw = torch.cos(half)
            sfac = torch.where(n2 < 1e-24, 0.5 * h, torch.sin(half) / nrm)
            ex, ey, ez = sfac * wx, sfac * wy, sfac * wz
            w, x, y, z = (q[..., j.qadr + 3 + i] for i in range(4))
            nw = w * cw - x * ex - y * ey - z * ez
            nx = w * ex + x * cw + y * ez - z * ey
            ny = w * ey - x * ez + y * cw + z * ex
            nz = w * ez + x * ey - y * ex + z * cw
            inv = torch.rsqrt(nw * nw + nx * nx + ny * ny + nz * nz)
            for i, c in enumerate((nw, nx, ny, nz)):
                pieces[j.qadr + 3 + i] = c * inv
        else:
            pieces[j.qadr] = lin[..., j.dof]
    return torch.stack(pieces, dim=-1)


def rk4_substep(model: SpatialContactModel, q, qv, tau, outer: int, cg: int, lam0=None):
    """mj_RungeKutta over the quaternion manifold, one physics timestep:
    each stage's positions integrate from the normalized q₀ by the previous
    stage's velocity (stage 1 at c = 0 still renormalizes), the weighted
    velocities accumulate stage by stage, λ warm starts chain through the
    stages. Returns (q', q̇', λ, q_stage4): mj_step leaves data.xpos at the
    last stage's positions."""
    h = model.timestep
    q = normalize_quat(model, q)
    lam = qv.new_zeros(qv.shape[:-1] + (model.n_rows,)) if lam0 is None else lam0
    kq, kv = qv, torch.zeros_like(qv)
    accq = accv = torch.zeros_like(qv)
    q_s = q
    for c, w in RK4_STAGES:
        q_s = integrate_pos(model, q, kq, c * h)
        v_s = qv + (c * h) * kv
        kv, lam = qacc_warm(model, q_s, v_s, tau, outer, cg, lam)
        accq = accq + w * v_s
        accv = accv + w * kv
        kq = v_s
    return integrate_pos(model, q, accq, h), qv + h * accv, lam, q_s


def euler_implicit_substep(model: SpatialContactModel, q, qv, tau, outer: int, cg: int,
                           lam0=None):
    """mj_Euler with implicit joint damping, one physics timestep: λ solved
    against the undamped M, then (M + h·D) Δv/h = smooth + qfrc_c and the
    positions integrated by the new velocity. Returns (q', q̇', λ, q): Euler
    runs no forward pass after integrating, so data.xpos holds the
    kinematics of the pre-integration (normalized) q."""
    h = model.timestep
    q = normalize_quat(model, q)
    m, _, smooth, qfrc_c, lam = _forward(model, q, qv, tau, outer, cg, lam0)
    ld = chol_unrolled(m + _tab(model, q).h_damping_diag)
    qv2 = qv + h * chol_solve(ld, smooth + qfrc_c)
    return integrate_pos(model, q, qv2, h), qv2, lam, q
