"""Closed-form planar MuJoCo toolkit: the soft-constraint constants, the
small Cholesky factor and solve the contact stepper runs every substep, and
the constrained dynamics of the contact-free chains (the pendulums).

Counterpart of `mpopis_tpu/models/planar.py`. The JAX package writes these
over tuples of scalars (one (K,) vector per matrix entry under vmap); the
port writes them over dense batched tensors — a mass matrix is one
(..., n, n) tensor — so a (K, n, n) batch factors in n column steps.

`build_planar_dynamics` is the energy route of the JAX builder, which
differentiates a kinematics function with `jax.jacfwd`, `jvp`, `grad` and
`vjp`. Here the kinematics are a table (`TrigKinematics`): every output of
a chain of slides and hinges in the vertical plane is linear in the slide
coordinates and in the sines and cosines of the absolute link angles, so
its Jacobian J and its second derivative along q̇ are closed forms, and

    M    = diag(armature) + Σₒ wₒ JₒᵀJₒ
    bias = Σₒ wₒ Jₒᵀ (q̇ᵀ∇²kinₒ q̇) + Σₒ cₒ Jₒ

which is Ṁq̇ − ∂T/∂q + ∂V/∂q, the quantity the JAX `bias` computes, in a
few batched tensor operations rather than nested transforms.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

# solimp defaults (0.9, 0.95, 0.001, 0.5, 2) and solref (0.02, 1)
_D0, _DMAX, _WIDTH, _MID = 0.9, 0.95, 0.001, 0.5
_SOLREF_TC = 0.02
MIN_IMP = 1e-4  # mjMINIMP: MuJoCo clamps d0 to it before the sigmoid


def _kb(timestep: float):
    """Constraint stiffness/damping from solref; MuJoCo clamps the
    timeconst to at least 2·timestep."""
    tc = max(_SOLREF_TC, 2.0 * timestep)
    return 1.0 / (_DMAX * tc) ** 2, 2.0 / (_DMAX * tc)


def impedance(pos: torch.Tensor, d0=_D0, dmax=_DMAX, width=_WIDTH) -> torch.Tensor:
    """solimp sigmoid d(|pos|), power 2, midpoint 0.5, with d0 clamped to
    mjMINIMP before the sigmoid (HalfCheetah's d0 = 0 becomes 1e-4)."""
    d0_eff = max(d0, MIN_IMP)
    x = torch.clamp(torch.abs(pos) / width, 0.0, 1.0)
    y = torch.where(x < _MID, 2.0 * x * x, 1.0 - 2.0 * (1.0 - x) ** 2)
    return d0_eff + (dmax - d0_eff) * y


def chol_unrolled(m: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of the symmetric (..., n, n) `m` (only its
    lower triangle is read), one column per step, unrolled over n. A matrix
    that is not positive definite gives NaNs, as the JAX unrolled factor
    does; nothing is checked, so on the card nothing synchronises."""
    n = m.shape[-1]
    cols = []
    for j in range(n):
        s = m[..., j:, j]
        if j:
            lp = torch.stack(cols, dim=-1)  # (..., n, j): the columns so far
            s = s - torch.sum(lp[..., j:, :] * lp[..., j : j + 1, :], dim=-1)
        d = torch.sqrt(s[..., :1])
        col = torch.cat([s[..., :1].new_zeros(s.shape[:-1] + (j,)), d, s[..., 1:] / d], dim=-1)
        cols.append(col)
    return torch.stack(cols, dim=-1)


def chol_solve(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve L Lᵀ x = b for b (..., n) with the factor of `chol_unrolled`.
    Counterpart of `chol_solve_unrolled`: forward then back substitution,
    here as two batched triangular solves."""
    y = torch.linalg.solve_triangular(l, b.unsqueeze(-1), upper=False)
    return torch.linalg.solve_triangular(l.transpose(-1, -2), y, upper=True).squeeze(-1)


@dataclasses.dataclass(frozen=True)
class LimitSpec:
    """A limited dof: range (lo, hi), dof_invweight0, and margin."""

    dof: int
    lo: float
    hi: float
    invweight: float
    margin: float = 0.0


@dataclasses.dataclass(frozen=True)
class TrigKinematics:
    """The kinematics outputs of a planar chain (com coordinates and absolute
    link angles) as a table over the dofs q (..., n):

        out = lin·q + sin_coef·sin(φ) + cos_coef·cos(φ),   φ = angles·q

    with `lin` and the two coefficient tables (n_out, ·) and `angles`
    (n_ang, n_dof) (each absolute angle a sum of hinge coordinates)."""

    lin: tuple
    sin_coef: tuple
    cos_coef: tuple
    angles: tuple

    def __call__(self, q: torch.Tensor) -> torch.Tensor:
        """The outputs (..., n_out) at q (..., n_dof)."""
        lin, sc, cc, ang = (torch.tensor(a, dtype=q.dtype, device=q.device)
                            for a in (self.lin, self.sin_coef, self.cos_coef, self.angles))
        phi = q @ ang.T
        return q @ lin.T + torch.sin(phi) @ sc.T + torch.cos(phi) @ cc.T


def build_planar_dynamics(
    kin: TrigKinematics,
    kin_weights: Sequence[float],
    pot_coeffs: Sequence[float],
    n_dof: int,
    damping: Sequence[float],
    armature: Sequence[float],
    limits: Sequence[LimitSpec] = (),
    timestep: float = 0.01,
):
    """Build qacc(q, qv, tau) for a planar chain: q, qv, tau (..., n_dof).

    kin_weights: kinetic-energy weight per output (mass for coordinates,
    inertia for angles); pot_coeffs: potential V = Σ cₒ·outₒ. Returns
    (qacc, mass): qacc(q, qv, tau) -> (acc, qfrc_constraint), both
    (..., n_dof), exactly mj_forward for the corresponding MJCF model;
    mass(q) (..., n, n)."""
    assert len(limits) <= 2, "projected solve implemented for ≤2 limits"
    kc, bc = _kb(timestep)
    ang = [list(r) for r in kin.angles]
    tables = {
        "lin": kin.lin, "sc": kin.sin_coef, "cc": kin.cos_coef, "ang": ang,
        "angT": [list(r) for r in zip(*ang)],
        "scT": [list(r) for r in zip(*kin.sin_coef)],
        "ccT": [list(r) for r in zip(*kin.cos_coef)],
        "w": list(kin_weights), "wcol": [[w] for w in kin_weights], "pots": list(pot_coeffs),
        "arm": [[armature[i] if i == j else 0.0 for j in range(n_dof)] for i in range(n_dof)],
        "damp": list(damping),
    }
    consts: dict = {}

    def const(q):
        """The tables as tensors of q's dtype on its device, made once each."""
        c = consts.get((q.dtype, q.device))
        if c is None:
            c = consts[(q.dtype, q.device)] = {
                name: torch.tensor(v, dtype=q.dtype, device=q.device) for name, v in tables.items()}
        return c

    def jacobian(q, c):
        """J (..., n_out, n_dof) and sin φ, cos φ of the absolute angles φ."""
        phi = q @ c["angT"]
        sin, cos = torch.sin(phi), torch.cos(phi)
        trig = c["sc"] * cos[..., None, :] - c["cc"] * sin[..., None, :]
        return c["lin"] + trig @ c["ang"], sin, cos

    def mass_from(jac, c):
        return c["arm"] + (jac * c["wcol"]).transpose(-1, -2) @ jac

    def bias_from(jac, sin, cos, qv, c):
        rate2 = (qv @ c["angT"]) ** 2
        curv = -((sin * rate2) @ c["scT"] + (cos * rate2) @ c["ccT"])  # q̇ᵀ∇²kinₒ q̇
        gen = curv * c["w"] + c["pots"]
        return (gen[..., None, :] @ jac)[..., 0, :]

    def mass(q):
        c = const(q)
        return mass_from(jacobian(q, c)[0], c)

    def limit_forces(q, qv, minv_cols, a_smooth):
        """Projected active-set solve for the (≤2) soft limits; returns the
        per-limit signed generalized forces (s·λ)."""
        arefs, signs, active, rs = [], [], [], []
        for spec in limits:
            qk = q[..., spec.dof]
            d_lo = (qk - spec.lo) - spec.margin
            d_hi = (spec.hi - qk) - spec.margin
            lower_closer = d_lo < d_hi
            pos = torch.where(lower_closer, d_lo, d_hi)
            s = torch.where(lower_closer, 1.0, -1.0).to(q.dtype)
            imp = impedance(pos)
            arefs.append(-bc * (s * qv[..., spec.dof]) - kc * imp * pos)
            signs.append(s)
            active.append(pos < 0.0)
            rs.append((1.0 - imp) / imp * spec.invweight)
        zero = torch.zeros_like(q[..., 0])
        if len(limits) == 1:
            d0 = limits[0].dof
            a00 = minv_cols[0][..., d0]
            rhs0 = torch.where(active[0], arefs[0] - signs[0] * a_smooth[..., d0], zero)
            lam0 = torch.clamp(rhs0 / (a00 + rs[0]), min=0.0)
            return (signs[0] * lam0,)
        d0, d1 = limits[0].dof, limits[1].dof
        s0, s1 = signs
        a00, a11 = minv_cols[0][..., d0], minv_cols[1][..., d1]
        a01 = s0 * s1 * minv_cols[1][..., d0]
        a10 = s0 * s1 * minv_cols[0][..., d1]
        rhs0 = torch.where(active[0], arefs[0] - s0 * a_smooth[..., d0], zero)
        rhs1 = torch.where(active[1], arefs[1] - s1 * a_smooth[..., d1], zero)
        r00, r11 = a00 + rs[0], a11 + rs[1]
        det = r00 * r11 - a01 * a10
        lb0 = (r11 * rhs0 - a01 * rhs1) / det
        lb1 = (-a10 * rhs0 + r00 * rhs1) / det
        l0 = rhs0 / r00
        l1 = rhs1 / r11
        ok_both = active[0] & active[1] & (lb0 >= 0.0) & (lb1 >= 0.0)
        ok_0 = active[0] & (l0 > 0.0) & ((~active[1]) | (a10 * l0 - rhs1 >= 0.0))
        ok_1 = active[1] & (l1 > 0.0) & ((~active[0]) | (a01 * l1 - rhs0 >= 0.0))
        lam0 = torch.clamp(torch.where(ok_both, lb0, torch.where(ok_0, l0, zero)), min=0.0)
        lam1 = torch.clamp(torch.where(ok_both, lb1, torch.where(ok_1, l1, zero)), min=0.0)
        return (s0 * lam0, s1 * lam1)

    def qacc(q, qv, tau):
        """(acc, qfrc_constraint), both (..., n_dof)."""
        c = const(q)
        jac, sin, cos = jacobian(q, c)
        minv = torch.linalg.inv_ex(mass_from(jac, c))[0]
        rhs = tau - bias_from(jac, sin, cos, qv, c) - c["damp"] * qv
        a_smooth = (minv @ rhs[..., None])[..., 0]
        if not limits:
            return a_smooth, torch.zeros_like(q)
        # M⁻¹'s columns of the limited dofs
        minv_cols = [minv[..., :, spec.dof] for spec in limits]
        forces = limit_forces(q, qv, minv_cols, a_smooth)
        zero = torch.zeros_like(q[..., 0])
        qfrc = [zero] * n_dof
        acc = a_smooth
        for col, f, spec in zip(minv_cols, forces, limits):
            qfrc[spec.dof] = qfrc[spec.dof] + f
            acc = acc + col * f[..., None]
        return acc, torch.stack(qfrc, dim=-1)

    return qacc, mass


def rk4_step(qacc, q, qv, tau, h: float):
    """One mj_RungeKutta step over q, qv (..., n). Returns (q', qv',
    q_stage4, qfrc_c_stage4): the stage-4 values are what data.xpos /
    qfrc_constraint hold after mj_step (no forward pass after integration),
    and what gymnasium's observations and rewards read."""
    half = 0.5 * h
    k1v, _ = qacc(q, qv, tau)
    k1q = qv
    q2, v2 = q + half * k1q, qv + half * k1v
    k2v, _ = qacc(q2, v2, tau)
    k2q = v2
    q3, v3 = q + half * k2q, qv + half * k2v
    k3v, _ = qacc(q3, v3, tau)
    k3q = v3
    q4, v4 = q + h * k3q, qv + h * k3v
    k4v, qfrc4 = qacc(q4, v4, tau)
    k4q = v4
    sixth = h / 6.0
    qn = q + sixth * (k1q + 2.0 * k2q + 2.0 * k3q + k4q)
    vn = qv + sixth * (k1v + 2.0 * k2v + 2.0 * k3v + k4v)
    return qn, vn, q4, qfrc4
