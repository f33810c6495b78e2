"""Planar MuJoCo dynamics with contacts (HalfCheetah, Hopper, Walker2d):
the model tables, the analytic mass matrix and bias, the constraint rows,
the box-QP contact solve and the Euler-implicit / RK4 substeps.

Counterpart of `mpopis_tpu/models/planar_contact.py`, where every probed
fact of the contact model is documented (pyramidal friction rows with the
merged normal row at R/2, tangential rows at the contact point's z =
dist/2, the solimp impedance, the regularizers, capsule-capsule pairs with
Ericson's closest points, the fixed-iteration active-set/CG/arc-search QP
with its warm start, the two integrators). The tables are copies of the
JAX package's dataclasses (`utils/convert.py::planar_model` rebuilds one
from the other and the tests pin them field by field).

The JAX package writes the substep over tuples of scalars with structural
zeros skipped. The port writes it in the dense stacked-row form of the
JAX package's `solve_qp_dense`: a batch of states is (..., n) tensors, the
rows' Jacobian is one (..., R, n) tensor whose structural zeros are exact
zeros, and the rows of each kind (limits, plane-capsule contacts, capsule
pairs) are built at once. This is the plain version the CUDA kernel
`csrc/planar_rollout.cu` is held against.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib
from types import SimpleNamespace

import numpy as np
import torch

from mpopis_tpu_torch.models.base import Env, EnvState, make_state
from mpopis_tpu_torch.models.planar import MIN_IMP, chol_solve, chol_unrolled
from mpopis_tpu_torch.utils.profiling import span

ARC_STEPS = (1.0, 0.5, 0.25, 0.1, 0.03, 0.01)  # the projected arc search's trial ladder


@dataclasses.dataclass(frozen=True)
class PCBody:
    """One body of the planar tree: `parent` indexes the body tuple (-1 =
    root), `pos` is the body origin in the parent frame, `anchor` the hinge
    anchor in this body's frame, `sign` the hinge axis sign, `com`, `mass`,
    `iyy` (body frame) the inertia, `dof` the hinge dof (2 = rooty)."""

    parent: int
    pos: tuple[float, float]
    anchor: tuple[float, float]
    sign: float
    com: tuple[float, float]
    mass: float
    iyy: float
    dof: int


@dataclasses.dataclass(frozen=True)
class PCContact:
    """One candidate contact: a capsule end sphere against the floor plane."""

    body: int
    local: tuple[float, float]
    radius: float
    mu: float
    margin: float  # includemargin (sum of the two geoms' margins)
    solimp: tuple[float, float, float]  # (d0, dmax, width)


@dataclasses.dataclass(frozen=True)
class PCCapsulePair:
    """A frictionless capsule-capsule self-collision pair (one row)."""

    body1: int
    a1: tuple[float, float]  # segment endpoints, body1 frame
    b1: tuple[float, float]
    r1: float
    body2: int
    a2: tuple[float, float]
    b2: tuple[float, float]
    r2: float
    margin: float
    solimp: tuple[float, float, float]


@dataclasses.dataclass(frozen=True)
class PCLimit:
    dof: int
    lo: float
    hi: float
    solimp: tuple[float, float, float]


@dataclasses.dataclass(frozen=True)
class PlanarContactModel:
    """Static constant table for one planar-locomotion MJCF model."""

    n_dof: int
    root_offset: tuple[float, float]  # torso origin = (q0+ox, q1+oz)
    bodies: tuple[PCBody, ...]
    contacts: tuple[PCContact, ...]
    limits: tuple[PCLimit, ...]
    damping: tuple[float, ...]
    armature: tuple[float, ...]
    stiffness: tuple[float, ...]
    gear: tuple[float, ...]  # actuated dofs 3..n_dof-1
    dof_invweight0: tuple[float, ...]
    body_invweight0: tuple[float, ...]  # per body, translation component
    timestep: float
    integrator: str  # "euler_implicit" | "rk4"
    gravity: float = 9.81
    pairs: tuple[PCCapsulePair, ...] = ()

    @property
    def n_rows(self) -> int:
        """Limit rows + [n+μt, n−μt, merged normal] per contact + one row per pair."""
        return len(self.limits) + 3 * len(self.contacts) + len(self.pairs)

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

    def kb(self, dmax: float) -> tuple[float, float]:
        """Constraint stiffness/damping from solref (0.02, 1), the timeconst
        clamped to at least 2·timestep."""
        tc = max(0.02, 2.0 * self.timestep)
        return 1.0 / (dmax * tc) ** 2, 2.0 / (dmax * tc)


def solimp_tensors(model, items, t) -> dict:
    """Per-row impedance and reference constants of rows with `solimp`:
    d0 clamped to mjMINIMP, dmax − d0, width and the solref stiffness and
    damping `model.kb(dmax)`, each made a tensor by `t`."""
    d0e = [max(it.solimp[0], MIN_IMP) for it in items]
    dmax = [it.solimp[1] for it in items]
    kb = [model.kb(it.solimp[1]) for it in items]
    return dict(
        d0e=t(d0e), dspan=t([m - d for m, d in zip(dmax, d0e)]),
        width=t([it.solimp[2] for it in items]),
        kc=t([k for k, _ in kb]), bc=t([b for _, b in kb]),
    )


@functools.lru_cache(maxsize=None)
def _tables(model: PlanarContactModel, dtype: torch.dtype, device: torch.device):
    """The model's row constants as tensors of one dtype on one device. Each
    derived constant is computed in double, as the JAX package computes its
    Python floats, and rounded once to `dtype`."""
    n = model.n_dof
    chains = model.chains
    nb = len(model.bodies)
    in_chain = np.zeros((nb, nb), dtype=bool)  # in_chain[b, c]: body c is on b's chain
    for b in range(nb):
        in_chain[b, list(chains[b])] = True
    hinge = sorted({b.dof for b in model.bodies})  # dofs owned by a hinge
    body_of = {b.dof: i for i, b in enumerate(model.bodies)}
    hinge_body = [body_of[d] for d in hinge]
    hinge_sign = [model.bodies[b].sign for b in hinge_body]

    def t(v, dt=dtype):
        return torch.as_tensor(np.asarray(v), dtype=dt, device=device)

    iyy_ww = []  # per body: I_b·w wᵀ, w the hinge signs of its chain
    for b, chain in zip(model.bodies, chains):
        w = np.zeros(n)
        for body in chain:
            w[model.bodies[body].dof] = model.bodies[body].sign
        iyy_ww.append(t(b.iyy * np.outer(w, w)))

    lim = model.limits
    con = model.contacts
    prs = model.pairs
    tab = SimpleNamespace(
        n=n,
        iyy_ww=iyy_ww,
        hinge=t(hinge, torch.long),
        hinge_body=t(hinge_body, torch.long),
        hinge_sign=t(hinge_sign),
        neg_hinge_sign=t([-s for s in hinge_sign]),
        damping=t(model.damping),
        stiffness=t(model.stiffness),
        armature_diag=torch.diag(t(model.armature)),
        h_damping_diag=torch.diag(t([model.timestep * d for d in model.damping])),
        gear=t(model.gear),
        lim_dof=t([lm.dof for lm in lim], torch.long),
        lim_lo=t([lm.lo for lm in lim]),
        lim_hi=t([lm.hi for lm in lim]),
        lim_invweight=t([model.dof_invweight0[lm.dof] for lm in lim]),
        lim_j=torch.nn.functional.one_hot(
            t([lm.dof for lm in lim], torch.long), n
        ).to(dtype) if lim else None,
        lim_imp=solimp_tensors(model, lim, t),
        con_body=t([c.body for c in con], torch.long),
        con_lx=t([c.local[0] for c in con]),
        con_lz=t([c.local[1] for c in con]),
        con_radius=t([c.radius for c in con]),
        con_margin=t([c.margin for c in con]),
        con_mu=t([c.mu for c in con]),
        con_neg_mu=t([-c.mu for c in con]),
        con_bw=t([model.body_invweight0[c.body] for c in con]),
        con_rfac=t([2.0 * c.mu * c.mu * (1.0 + c.mu * c.mu) for c in con]),
        # (contacts, hinge dofs): the hinge's body lies on the contact body's chain
        con_chain=t(in_chain[[c.body for c in con]][:, hinge_body], torch.bool),
        con_imp=solimp_tensors(model, con, t),
        n_pairs=len(prs),
    )
    if prs:
        b1 = [p.body1 for p in prs]
        b2 = [p.body2 for p in prs]
        on1 = in_chain[b1][:, hinge_body]
        on2 = in_chain[b2][:, hinge_body]
        # symmetric difference of the two chains: +sign on body2's side only,
        # −sign on body1's side only; the shared prefix cancels exactly
        coef = np.where(on2 & ~on1, 1.0, 0.0) - np.where(on1 & ~on2, 1.0, 0.0)
        tab.pair_b1 = t(b1, torch.long)
        tab.pair_b2 = t(b2, torch.long)
        tab.pair_pts = t([[p.a1, p.b1, p.a2, p.b2] for p in prs])  # (P, 4, 2)
        tab.pair_r1 = t([p.r1 for p in prs])
        tab.pair_r2 = t([p.r2 for p in prs])
        tab.pair_margin = t([p.margin for p in prs])
        tab.pair_coef = t(coef * np.asarray(hinge_sign)[None, :])
        tab.pair_on = t(coef != 0.0, torch.bool)
        tab.pair_bw = t([model.body_invweight0[p.body1] + model.body_invweight0[p.body2]
                         for p in prs])
        tab.pair_imp = solimp_tensors(model, prs, t)
    return tab


def _tab(model, like: torch.Tensor):
    return _tables(model, like.dtype, like.device)


def _impedance_rows(pos, imp):
    """`impedance` with per-row constants (d0 already clamped to mjMINIMP)."""
    x = torch.clamp(torch.abs(pos) / imp["width"], 0.0, 1.0)
    y = torch.where(x < 0.5, 2.0 * x * x, 1.0 - 2.0 * (1.0 - x) ** 2)
    return imp["d0e"] + imp["dspan"] * y


def frames(model: PlanarContactModel, q: torch.Tensor):
    """Per-body world origin (x, z), absolute angle and hinge-anchor world
    position from qpos (..., n): five lists of (...) tensors."""
    nb = len(model.bodies)
    ox, oz, th = [None] * nb, [None] * nb, [None] * nb
    awx, awz = [None] * nb, [None] * nb
    for bi, b in enumerate(model.bodies):
        if b.parent == -1:
            rx, rz = model.root_offset
            bx, bz = q[..., 0] + rx, q[..., 1] + rz
            th[bi] = b.sign * q[..., b.dof]
            ax, az = b.anchor
            if ax == 0.0 and az == 0.0:
                ox[bi], oz[bi] = bx, bz
                awx[bi], awz[bi] = bx, bz
            else:
                c, s = torch.cos(th[bi]), torch.sin(th[bi])
                awx[bi], awz[bi] = bx + ax, bz + az
                ox[bi] = awx[bi] - (c * ax + s * az)
                oz[bi] = awz[bi] - (-s * ax + c * az)
        else:
            p = b.parent
            cp, sp = torch.cos(th[p]), torch.sin(th[p])
            th[bi] = th[p] + b.sign * q[..., b.dof]
            px, pz = b.pos
            ax, az = b.anchor
            # anchor_world = origin_p + R_p·(pos + anchor)
            awx[bi] = ox[p] + cp * (px + ax) + sp * (pz + az)
            awz[bi] = oz[p] - sp * (px + ax) + cp * (pz + az)
            if ax == 0.0 and az == 0.0:
                ox[bi], oz[bi] = awx[bi], awz[bi]
            else:
                c, s = torch.cos(th[bi]), torch.sin(th[bi])
                ox[bi] = awx[bi] - (c * ax + s * az)
                oz[bi] = awz[bi] - (-s * ax + c * az)
    return ox, oz, th, awx, awz


def _com_jacobians(model, q, fr):
    """Per body: com world (px, pz) and the com Jacobian rows Jx, Jz (..., n)
    — identity columns for the root slides, s_d·rot(p − a_d) for the chain
    hinges, exact zeros elsewhere."""
    ox, oz, th, awx, awz = fr
    n = model.n_dof
    zero = torch.zeros_like(q[..., 0])
    one = torch.ones_like(q[..., 0])
    out = []
    for bi, (b, chain) in enumerate(zip(model.bodies, model.chains)):
        c, s = torch.cos(th[bi]), torch.sin(th[bi])
        cx, cz = b.com
        px = ox[bi] + c * cx + s * cz
        pz = oz[bi] - s * cx + c * cz
        jx = [one, zero] + [zero] * (n - 2)
        jz = [zero, one] + [zero] * (n - 2)
        for body in chain:
            bb = model.bodies[body]
            jx[bb.dof] = bb.sign * (pz - awz[body])
            jz[bb.dof] = -bb.sign * (px - awx[body])
        out.append((px, pz, torch.stack(jx, dim=-1), torch.stack(jz, dim=-1)))
    return out


def mass_entries_analytic(model: PlanarContactModel, q: torch.Tensor, fr=None, jac=None):
    """Mass matrix (..., n, n): Σ_b m_b (Jx_bᵀJx_b + Jz_bᵀJz_b) + Σ_b I_b w_b w_bᵀ
    + diag(armature), w_b the chain's hinge signs. Each entry accumulates body
    by body in the JAX package's order (zeros added where it skips)."""
    fr = frames(model, q) if fr is None else fr
    jac = _com_jacobians(model, q, fr) if jac is None else jac
    tab = _tab(model, q)
    m = tab.armature_diag.expand(q.shape[:-1] + (model.n_dof, model.n_dof))
    for b, iyy_ww, (_px, _pz, jx, jz) in zip(model.bodies, tab.iyy_ww, jac):
        m = m + b.mass * (jx.unsqueeze(-1) * jx.unsqueeze(-2) + jz.unsqueeze(-1) * jz.unsqueeze(-2))
        m = m + iyy_ww
    return m


def bias_analytic(model: PlanarContactModel, q: torch.Tensor, qv: torch.Tensor, fr=None,
                  jac=None):
    """Coriolis/centrifugal + gravity generalized forces (..., n), by the
    recursive velocity/acceleration propagation with q̈ = 0."""
    fr = frames(model, q) if fr is None else fr
    jac = _com_jacobians(model, q, fr) if jac is None else jac
    ox, oz, th, awx, awz = fr
    nb = len(model.bodies)
    omega = [None] * nb
    vax, vaz = [None] * nb, [None] * nb  # anchor velocity
    aax, aaz = [None] * nb, [None] * nb  # anchor acceleration (q̈=0)
    zero = torch.zeros_like(q[..., 0])
    for bi, b in enumerate(model.bodies):
        if b.parent == -1:
            omega[bi] = b.sign * qv[..., b.dof]
            vax[bi], vaz[bi] = qv[..., 0], qv[..., 1]
            aax[bi], aaz[bi] = zero, zero
        else:
            p = b.parent
            omega[bi] = omega[p] + b.sign * qv[..., b.dof]
            dx, dz = awx[bi] - awx[p], awz[bi] - awz[p]
            vax[bi] = vax[p] + omega[p] * dz
            vaz[bi] = vaz[p] - omega[p] * dx
            vdx, vdz = vax[bi] - vax[p], vaz[bi] - vaz[p]
            aax[bi] = aax[p] + omega[p] * vdz
            aaz[bi] = aaz[p] - omega[p] * vdx
    out = torch.zeros_like(q)
    g = model.gravity
    for bi, (b, (px, pz, jx, jz)) in enumerate(zip(model.bodies, jac)):
        rx, rz = px - awx[bi], pz - awz[bi]
        vpx = vax[bi] + omega[bi] * rz
        vpz = vaz[bi] - omega[bi] * rx
        apx = aax[bi] + omega[bi] * (vpz - vaz[bi])
        apz = aaz[bi] - omega[bi] * (vpx - vax[bi])
        fx = b.mass * apx
        fz = b.mass * (apz + g)
        out = out + (jx * fx.unsqueeze(-1) + jz * fz.unsqueeze(-1))
    return out


def _world(fr, body_idx, lx, lz):
    """World points of body-local points (lx, lz) on bodies `body_idx`."""
    ox, oz, th, _, _ = fr
    oxb = torch.stack(ox, dim=-1)[..., body_idx]
    ozb = torch.stack(oz, dim=-1)[..., body_idx]
    thb = torch.stack(th, dim=-1)[..., body_idx]
    c, s = torch.cos(thb), torch.sin(thb)
    return oxb + c * lx + s * lz, ozb - s * lx + c * lz


def contact_rows(model: PlanarContactModel, q: torch.Tensor, qv: torch.Tensor, fr=None):
    """Constraint rows in the dense stacked form: (J (..., R, n), aref (..., R),
    R (..., R), active (..., R) bool), rows ordered as in the JAX package:
    limits, then [n+μt, n−μt, merged normal] per contact, then pairs."""
    tab = _tab(model, q)
    n = model.n_dof
    fr = frames(model, q) if fr is None else fr
    _, _, _, awx, awz = fr
    awx_h = torch.stack(awx, dim=-1)[..., tab.hinge_body]  # (..., H) anchors of the hinges
    awz_h = torch.stack(awz, dim=-1)[..., tab.hinge_body]
    batch = q.shape[:-1]
    js, arefs, regs, acts = [], [], [], []

    if model.limits:
        qd, qvd = q[..., tab.lim_dof], qv[..., tab.lim_dof]
        d_lo = qd - tab.lim_lo
        d_hi = tab.lim_hi - qd
        lower_closer = d_lo < d_hi
        pos = torch.where(lower_closer, d_lo, d_hi)
        sgn = torch.where(lower_closer, 1.0, -1.0).to(q.dtype)
        imp = _impedance_rows(pos, tab.lim_imp)
        js.append(sgn.unsqueeze(-1) * tab.lim_j)
        arefs.append(-tab.lim_imp["bc"] * (sgn * qvd) - tab.lim_imp["kc"] * imp * pos)
        regs.append((1.0 - imp) / imp * tab.lim_invweight)
        acts.append(pos < 0.0)

    if model.contacts:
        px, pz = _world(fr, tab.con_body, tab.con_lx, tab.con_lz)  # (..., C)
        dist = pz - tab.con_radius
        active = dist < tab.con_margin
        cpz = 0.5 * dist  # contact point z (midpoint of the overlap)
        shp = batch + (len(model.contacts), n)
        jn = q.new_zeros(shp)
        jt = q.new_zeros(shp)
        jn[..., 1] = 1.0  # rootz
        jt[..., 0] = 1.0  # rootx
        jn_h = tab.neg_hinge_sign * (px.unsqueeze(-1) - awx_h.unsqueeze(-2))
        jt_h = tab.hinge_sign * (cpz.unsqueeze(-1) - awz_h.unsqueeze(-2))
        jn[..., tab.hinge] = torch.where(tab.con_chain, jn_h, 0.0)
        jt[..., tab.hinge] = torch.where(tab.con_chain, jt_h, 0.0)
        cimp = tab.con_imp
        pos_m = dist - tab.con_margin
        imp = _impedance_rows(pos_m, cimp)
        r_reg = (1.0 - imp) / imp * tab.con_bw * tab.con_rfac
        jv_n = torch.sum(jn * qv.unsqueeze(-2), dim=-1)
        jv_t = torch.sum(jt * qv.unsqueeze(-2), dim=-1)
        base_aref = -cimp["kc"] * imp * pos_m
        neg_bc = -cimp["bc"]
        mu_u, mu_d = tab.con_mu.unsqueeze(-1), tab.con_neg_mu.unsqueeze(-1)
        # per contact: n + μt, n − μt, then the merged pure-normal row at R/2
        js.append(torch.stack([jn + mu_u * jt, jn + mu_d * jt, jn], dim=-2).flatten(-3, -2))
        arefs.append(torch.stack([
            neg_bc * (jv_n + tab.con_mu * jv_t) + base_aref,
            neg_bc * (jv_n + tab.con_neg_mu * jv_t) + base_aref,
            neg_bc * jv_n + base_aref,
        ], dim=-1).flatten(-2))
        regs.append(torch.stack([r_reg, r_reg, 0.5 * r_reg], dim=-1).flatten(-2))
        acts.append(torch.stack([active, active, active], dim=-1).flatten(-2))

    if model.pairs:
        pts = tab.pair_pts
        p1x, p1z = _world(fr, tab.pair_b1, pts[:, 0, 0], pts[:, 0, 1])
        q1x, q1z = _world(fr, tab.pair_b1, pts[:, 1, 0], pts[:, 1, 1])
        p2x, p2z = _world(fr, tab.pair_b2, pts[:, 2, 0], pts[:, 2, 1])
        q2x, q2z = _world(fr, tab.pair_b2, pts[:, 3, 0], pts[:, 3, 1])
        # closest points between the two segments (Ericson's algorithm, branchless)
        d1x, d1z = q1x - p1x, q1z - p1z
        d2x, d2z = q2x - p2x, q2z - p2z
        rx, rz = p1x - p2x, p1z - p2z
        la = d1x * d1x + d1z * d1z
        le = d2x * d2x + d2z * d2z
        lf = d2x * rx + d2z * rz
        lc = d1x * rx + d1z * rz
        lb = d1x * d2x + d1z * d2z
        denom = la * le - lb * lb  # = L1²L2²sin²φ ≥ 0
        s_seg = torch.where(
            denom > 1e-12 * la * le,
            torch.clamp((lb * lf - lc * le) / torch.clamp(denom, min=1e-30), 0.0, 1.0),
            0.0,
        )
        t_raw = (lb * s_seg + lf) / le
        t_seg = torch.clamp(t_raw, 0.0, 1.0)
        s_seg = torch.where(
            t_raw < 0.0,
            torch.clamp(-lc / la, 0.0, 1.0),
            torch.where(t_raw > 1.0, torch.clamp((lb - lc) / la, 0.0, 1.0), s_seg),
        )
        c1x, c1z = p1x + s_seg * d1x, p1z + s_seg * d1z
        c2x, c2z = p2x + t_seg * d2x, p2z + t_seg * d2z
        dx, dz = c2x - c1x, c2z - c1z
        seg_len = torch.sqrt(torch.clamp(dx * dx + dz * dz, min=1e-24))
        nx, nz = dx / seg_len, dz / seg_len  # normal: geom1 → geom2
        dist = seg_len - tab.pair_r1 - tab.pair_r2
        active = dist < tab.pair_margin
        cx = c1x + nx * (tab.pair_r1 + 0.5 * dist)
        cz = c1z + nz * (tab.pair_r1 + 0.5 * dist)
        # J = n·(v₂(c) − v₁(c)) over the symmetric difference of the chains
        lever = (nx.unsqueeze(-1) * (cz.unsqueeze(-1) - awz_h.unsqueeze(-2))
                 - nz.unsqueeze(-1) * (cx.unsqueeze(-1) - awx_h.unsqueeze(-2)))
        j = q.new_zeros(batch + (tab.n_pairs, n))
        j[..., tab.hinge] = torch.where(tab.pair_on, tab.pair_coef * lever, 0.0)
        jv = torch.sum(j * qv.unsqueeze(-2), dim=-1)
        pimp = tab.pair_imp
        pos_m = dist - tab.pair_margin
        imp = _impedance_rows(pos_m, pimp)
        js.append(j)
        arefs.append(-pimp["bc"] * jv - pimp["kc"] * imp * pos_m)
        regs.append((1.0 - imp) / imp * tab.pair_bw)
        acts.append(active)

    return (torch.cat(js, dim=-2), torch.cat(arefs, dim=-1), torch.cat(regs, dim=-1),
            torch.cat(acts, dim=-1))


def _matvec(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (a @ v.unsqueeze(-1)).squeeze(-1)


def solve_qp(jmat, aref, r_reg, active, l_chol, a_smooth, outer: int, cg: int, lam0=None):
    """Fixed-iteration active-set/CG solve of the box-QP
    min ½λᵀ(J M⁻¹ Jᵀ + diag(R))λ − rhsᵀλ, λ ≥ 0, in the dense stacked form
    (the JAX package's `solve_qp_dense`). `lam0` warm-starts it (rows invalid
    at this state are zeroed first). Returns (qfrc_constraint (..., n), λ)."""
    jt_mat = jmat.transpose(-1, -2)
    rhs = torch.where(active, aref - _matvec(jmat, a_smooth), 0.0)

    def ar_apply(lam):
        w = chol_solve(l_chol, _matvec(jt_mat, lam))
        return _matvec(jmat, w) + r_reg * lam

    lam = _qp_iterate(ar_apply, rhs, active, lam0, outer, cg)
    return _matvec(jt_mat, lam), lam


def _qp_iterate(ar_apply, rhs, valid, lam0, outer: int, cg: int):
    """The active-set / CG / projected-arc-search iteration, rows on the last
    axis. A sample with no valid row keeps λ = 0 exactly (the JAX package
    skips its solve; every iterate would stay 0)."""
    lam = torch.zeros_like(rhs) if lam0 is None else torch.where(valid, lam0, 0.0)

    def rsum(v):
        return torch.sum(v, dim=-1, keepdim=True)

    for _ in range(outer):
        grad = ar_apply(lam) - rhs
        active = valid & ((lam > 0.0) | (grad < 0.0))

        def masked_ar(v, active=active):
            return torch.where(active, ar_apply(torch.where(active, v, 0.0)), 0.0)

        x = torch.where(active, lam, 0.0)
        r = torch.where(active, rhs - ar_apply(x), 0.0)
        p, rs = r, rsum(r * r)
        for _ in range(cg):
            ap = masked_ar(p)
            denom = rsum(p * ap)
            alpha = torch.where(denom > 1e-30, rs / torch.clamp(denom, min=1e-30), 0.0)
            x = x + alpha * p
            r = r - alpha * ap
            rs_new = rsum(r * r)
            beta = torch.where(rs > 1e-30, rs_new / torch.clamp(rs, min=1e-30), 0.0)
            p = r + beta * p
            rs = rs_new
        # projected arc search λ(t) = max(λ + t·(x − λ), 0) over a fixed ladder
        delta = torch.where(active, x - lam, 0.0)
        best_f = 0.5 * rsum(lam * grad) - 0.5 * rsum(rhs * lam)
        best_lam = lam
        for t in ARC_STEPS:
            lam_t = torch.clamp(lam + t * delta, min=0.0)
            g_t = masked_ar(lam_t)
            f_t = 0.5 * rsum(lam_t * g_t) - rsum(rhs * lam_t)
            take = f_t < best_f
            best_f = torch.where(take, f_t, best_f)
            best_lam = torch.where(take, lam_t, best_lam)
        lam = best_lam
    return torch.where(torch.any(valid, dim=-1, keepdim=True), lam, 0.0)


def qfrc_smooth(model: PlanarContactModel, q, qv, tau, bias=None, extra_force=None):
    """Actuation + passive (springs, explicit damping) − bias, (..., n), plus
    `extra_force(q, qv)` (..., n) where given: a state-dependent applied force
    such as the Swimmer's fluid force, evaluated anew at every stage."""
    tab = _tab(model, q)
    b = bias_analytic(model, q, qv) if bias is None else bias
    out = tau - b - tab.damping * qv - tab.stiffness * q
    return out if extra_force is None else out + extra_force(q, qv)


def _forward(model, q, qv, tau, outer, cg, lam0, extra_force=None):
    """One constrained forward pass: (M, L, smooth, qfrc_constraint, λ)."""
    fr = frames(model, q)
    jac = _com_jacobians(model, q, fr)
    m = mass_entries_analytic(model, q, fr, jac)
    l = chol_unrolled(m)
    smooth = qfrc_smooth(model, q, qv, tau, bias_analytic(model, q, qv, fr, jac), extra_force)
    a_smooth = chol_solve(l, smooth)
    jmat, aref, r_reg, active = contact_rows(model, q, qv, fr)
    qfrc_c, lam = solve_qp(jmat, aref, r_reg, active, l, a_smooth, outer, cg, lam0)
    return m, l, smooth, qfrc_c, lam


def qacc_warm(model, q, qv, tau, outer: int, cg: int, lam0=None, extra_force=None):
    """Full constrained forward dynamics (one mj_forward), warm-startable:
    (qacc (..., n), λ)."""
    _, l, smooth, qfrc_c, lam = _forward(model, q, qv, tau, outer, cg, lam0, extra_force)
    return chol_solve(l, smooth + qfrc_c), lam


def euler_implicit_substep(model, q, qv, tau, outer: int, cg: int, lam0=None, extra_force=None):
    """λ solved against the undamped M, then (M + h·D) Δv/h = smooth + qfrc_c."""
    h = model.timestep
    m, _, smooth, qfrc_c, lam = _forward(model, q, qv, tau, outer, cg, lam0, extra_force)
    ld = chol_unrolled(m + _tab(model, q).h_damping_diag)
    acc = chol_solve(ld, smooth + qfrc_c)
    qv2 = qv + h * acc
    return q + h * qv2, qv2, lam


def rk4_substep(model, q, qv, tau, outer: int, cg: int, lam0=None, extra_force=None):
    """mj_RungeKutta: the constrained dynamics (contact QP included) at each
    of the 4 stages, λ warm starts chained through the stages."""
    h = model.timestep
    k1v, lam = qacc_warm(model, q, qv, tau, outer, cg, lam0, extra_force)
    k1q = qv
    q2, v2 = q + 0.5 * h * k1q, qv + 0.5 * h * k1v
    k2v, lam = qacc_warm(model, q2, v2, tau, outer, cg, lam, extra_force)
    k2q = v2
    q3, v3 = q + 0.5 * h * k2q, qv + 0.5 * h * k2v
    k3v, lam = qacc_warm(model, q3, v3, tau, outer, cg, lam, extra_force)
    k3q = v3
    q4, v4 = q + h * k3q, qv + h * k3v
    k4v, lam = qacc_warm(model, q4, v4, tau, outer, cg, lam, extra_force)
    k4q = v4
    qn = q + (h / 6.0) * (k1q + 2.0 * k2q + 2.0 * k3q + k4q)
    vn = qv + (h / 6.0) * (k1v + 2.0 * k2v + 2.0 * k3v + k4v)
    return qn, vn, lam


def build_contact_stepper(model: PlanarContactModel, extra_force=None):
    """(substep, mass_entries, bias, qfrc_smooth, qacc_constrained) for the
    model, as the JAX package's builder returns them; substep(q, qv, tau,
    outer, cg, lam0=None) -> (q', qv', λ) with the model's integrator.
    `extra_force(q, qv)` (..., n), if given, joins the smooth force at every
    stage."""
    integrate = euler_implicit_substep if model.integrator == "euler_implicit" else rk4_substep
    return (
        functools.partial(integrate, model, extra_force=extra_force),
        functools.partial(mass_entries_analytic, model),
        functools.partial(bias_analytic, model),
        functools.partial(qfrc_smooth, model, extra_force=extra_force),
        lambda q, qv, tau, outer, cg: qacc_warm(model, q, qv, tau, outer, cg,
                                                extra_force=extra_force)[0],
    )


@dataclasses.dataclass(frozen=True, eq=False)
class ContactEnv(Env):
    """What the planar and spatial contact tasks share: the control step on
    the card or on the CPU, the step reward and the fused rollout costs.

    Subclasses set MODEL, FRAME_SKIP, HEALTHY, CTRL_W, INIT_QPOS, KERNEL and
    the Env class attributes, and define `plain_step` and `_reward`. KERNEL
    names the kernels' entries `{KERNEL}_step_states` and
    `{KERNEL}_rollout_costs_tak`, in the module `kernels/{KERNEL_MODULE}.py`
    (default `{KERNEL}_step`). `step` on a CUDA state runs one control step
    in the step entry; on a CPU state it runs `plain_step`, the plain PyTorch
    version. The tasks with a contact QP give it fixed iteration counts as
    the fields solver_outer/solver_cg (3, 6: control grade).
    """

    MODEL = None
    FRAME_SKIP = 1
    HEALTHY = 0.0
    CTRL_W = 0.0
    INIT_QPOS = ()
    KERNEL = ""
    KERNEL_MODULE = ""

    @property
    def dt(self) -> float:
        return self.MODEL.timestep * self.FRAME_SKIP

    def _kernel(self, entry: str):
        # imported at the call: the kernel modules import the models
        name = self.KERNEL_MODULE or f"{self.KERNEL}_step"
        module = importlib.import_module(f"mpopis_tpu_torch.kernels.{name}")
        return getattr(module, f"{self.KERNEL}_{entry}")

    def step(self, state: EnvState, action: torch.Tensor) -> EnvState:
        if state.x.device.type == "cpu":
            return self.plain_step(state, action)
        return EnvState(x=self._kernel("step_states")(self, state.x, action), t=state.t + 1,
                        done=state.done)

    def step_reward(self, state: EnvState, action: torch.Tensor):
        with span("mpopis.env_step"):
            new = self.step(state, action)
            return new, self._reward(state.x, new.x, action)

    def plain_step_reward(self, state: EnvState, action: torch.Tensor):
        new = self.plain_step(state, action)
        return new, self._reward(state.x, new.x, action)

    def fused_rollout_costs_tak(self, state: EnvState, controls_tak: torch.Tensor):
        """(K,) trajectory costs of clamped controls (T, na, K), contact QP
        included: one kernel launch on the card."""
        return self._kernel("rollout_costs_tak")(self, state.x, controls_tak)

    def fused_rollout_costs(self, state: EnvState, controls: torch.Tensor):
        """The same with (K, T, na) controls."""
        return self.fused_rollout_costs_tak(state, controls.permute(1, 2, 0).contiguous())


@dataclasses.dataclass(frozen=True, eq=False)
class PlanarContactEnv(ContactEnv):
    """A gymnasium v4 planar-locomotion task with these dynamics.

    Subclasses set MODEL, FRAME_SKIP, HEALTHY, CTRL_W, INIT_QPOS, OBS_CLIP
    and the Env class attributes. State x = [qpos(n), qvel(n)]; actions
    ∈ [−1, 1] scaled by the gears. reward_t = healthy + (x'−x)/dt −
    ctrl_w·Σa² (pre-step x, hence `step_reward`). The kernels are
    `kernels/planar_step.py`'s.
    """

    solver_outer: int = 3
    solver_cg: int = 6

    OBS_CLIP = None
    KERNEL = "planar"

    def reset(self) -> EnvState:
        n = self.MODEL.n_dof
        return make_state(self.tensor(np.concatenate([self.INIT_QPOS, np.zeros(n)])))

    def plain_step(self, state: EnvState, action: torch.Tensor) -> EnvState:
        """One control step: FRAME_SKIP substeps, λ warm starts chained across
        them and reset at the control-step boundary."""
        model = self.MODEL
        n = model.n_dof
        x = state.x
        a = torch.clamp(action, -1.0, 1.0)
        tau = torch.cat([a.new_zeros(a.shape[:-1] + (n - a.shape[-1],)),
                         _tab(model, a).gear * a], dim=-1)
        q, qv = x[..., :n], x[..., n:]
        lam = x.new_zeros(x.shape[:-1] + (model.n_rows,))
        substep = euler_implicit_substep if model.integrator == "euler_implicit" else rk4_substep
        for _ in range(self.FRAME_SKIP):
            q, qv, lam = substep(model, q, qv, tau, self.solver_outer, self.solver_cg, lam)
        return EnvState(x=torch.cat([q, qv], dim=-1).to(self.dtype), t=state.t + 1,
                        done=state.done)

    def _reward(self, x0, x1, action):
        x_vel = (x1[..., 0] - x0[..., 0]) / self.dt
        return self.HEALTHY + x_vel - self.CTRL_W * torch.sum(action * action, dim=-1)

    def reward(self, state: EnvState) -> torch.Tensor:
        """Instantaneous healthy + forward velocity (harness accounting)."""
        return self.HEALTHY + state.x[..., self.MODEL.n_dof]

    def observation(self, state: EnvState) -> torch.Tensor:
        """gym obs: qpos[1:] + qvel, the velocities clipped for Hopper/Walker2d."""
        n = self.MODEL.n_dof
        qv = state.x[..., n:]
        if self.OBS_CLIP is not None:
            qv = torch.clamp(qv, -self.OBS_CLIP, self.OBS_CLIP)
        return torch.cat([state.x[..., 1:n], qv], dim=-1)
