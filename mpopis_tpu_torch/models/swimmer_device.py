"""Swimmer-v4 with on-device dynamics: a free planar 3-link chain in a fluid.

Counterpart of `mpopis_tpu/models/swimmer_device.py`, its analytic route:
swimmer.xml's 2 slide + 3 hinge dofs (armature 0.1, no damping, no
gravity), 2 motors of gear 150, MuJoCo's inertia-box fluid model (density
4000, viscosity 0.1) as a state-dependent applied force evaluated at every
RK stage, the soft ±100° limits of both motor joints (2 QP rows, solved by
the fixed (2, 3) iterations, exact for 2 rows), RK4 at 0.01 s, frame skip 4.
The swimmer rotates about +z where the planar-contact tables rotate about
+y, so every hinge has sign −1 and the fluid model flips the link angles
and rates. The constants are copies of the JAX package's (a test pins them).

Obs/reward follow gymnasium swimmer_v4.py: obs = [qpos[2:], qvel] (8),
reward = (x' − x)/dt − 1e-4·Σa² with the pre-step torso x and the action as
given (the torque reads it clipped to [−1, 1]); the reset is qpos0 = 0.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mpopis_tpu_torch.models.base import EnvState, make_state
from mpopis_tpu_torch.models.planar_contact import (
    ContactEnv,
    PCBody,
    PCLimit,
    PlanarContactModel,
    frames,
    rk4_substep,
)

# --- constants from swimmer.xml via mjModel (f64) --------------------------
_MASS = 35.604716740684324  # per link (capsule r=0.1, l=1.0, density 1000)
_I_MAX = 3.9175660390264717  # principal inertia, short axes (in-plane rot)
_I_MIN = 0.17383479349863523  # about the capsule's long axis
_ARMATURE = 0.1
_GEAR = 150.0
_H = 0.01
_FRAME_SKIP = 4
_LIMIT = float(np.deg2rad(100.0))  # motor joint range
_RHO, _VISC = 4000.0, 0.1
# equivalent-box sides from the principal inertias
_S_SHORT = float(np.sqrt(6.0 * (_I_MAX + _I_MIN - _I_MAX) / _MASS))
_S_LONG = float(np.sqrt(6.0 * (_I_MAX + _I_MAX - _I_MIN) / _MASS))
_D_EQ = (2.0 * _S_SHORT + _S_LONG) / 3.0
_C_VISC_F = 3.0 * np.pi * _VISC * _D_EQ
_C_VISC_T = np.pi * _VISC * _D_EQ**3
_C_PAR = 0.5 * _RHO * _S_SHORT * _S_SHORT  # motion along the link axis
_C_PERP = 0.5 * _RHO * _S_SHORT * _S_LONG  # in-plane perpendicular motion
_C_ROT = _RHO / 64.0 * _S_SHORT * (_S_SHORT**4 + _S_LONG**4)
# mjModel.dof_invweight0[3:5]: constraint regularizer weights (R)
_INVWEIGHT = (0.38529334162134676, 0.3933336741383495)
# the fluid coefficients in the order the kernel reads them
FLUID = tuple(float(c) for c in (_C_VISC_F, _C_PAR, _C_PERP, _C_VISC_T, _C_ROT))
SOLVER = (2, 3)  # the 2-row limit QP's fixed (outer, cg) iterations: exact for 2 rows

PC_MODEL = PlanarContactModel(
    n_dof=5,
    root_offset=(0.0, 0.0),
    bodies=(
        PCBody(parent=-1, pos=(0.0, 0.0), anchor=(0.0, 0.0), sign=-1.0,
               com=(1.0, 0.0), mass=_MASS, iyy=_I_MAX, dof=2),  # torso
        PCBody(parent=0, pos=(0.5, 0.0), anchor=(0.0, 0.0), sign=-1.0,
               com=(-0.5, 0.0), mass=_MASS, iyy=_I_MAX, dof=3),  # mid
        PCBody(parent=1, pos=(-1.0, 0.0), anchor=(0.0, 0.0), sign=-1.0,
               com=(-0.5, 0.0), mass=_MASS, iyy=_I_MAX, dof=4),  # back
    ),
    contacts=(),
    limits=(
        PCLimit(dof=3, lo=-_LIMIT, hi=_LIMIT, solimp=(0.9, 0.95, 0.001)),
        PCLimit(dof=4, lo=-_LIMIT, hi=_LIMIT, solimp=(0.9, 0.95, 0.001)),
    ),
    damping=(0.0,) * 5,
    armature=(_ARMATURE,) * 5,
    stiffness=(0.0,) * 5,
    gear=(_GEAR, _GEAR),
    dof_invweight0=(0.0, 0.0, 0.0) + _INVWEIGHT,
    body_invweight0=(0.0, 0.0, 0.0),
    timestep=_H,
    integrator="rk4",
    gravity=0.0,
)


def fluid_force(q: torch.Tensor, qv: torch.Tensor) -> torch.Tensor:
    """Generalized inertia-box fluid forces (..., 5) through the chain
    Jacobians, in the JAX package's `_fluid_force_analytic` order
    (z-convention: θ_z = −θ, ω_z = −ω; coordinates coincide)."""
    model = PC_MODEL
    ox, oz, th, awx, awz = frames(model, q)
    nb = len(model.bodies)
    omega, vax, vaz = [None] * nb, [None] * nb, [None] * nb
    for bi, b in enumerate(model.bodies):
        if b.parent == -1:
            omega[bi] = b.sign * qv[..., b.dof]
            vax[bi], vaz[bi] = qv[..., 0], qv[..., 1]
        else:
            p = b.parent
            omega[bi] = omega[p] + b.sign * qv[..., b.dof]
            dx, dz = awx[bi] - awx[p], awz[bi] - awz[p]
            vax[bi] = vax[p] + omega[p] * dz
            vaz[bi] = vaz[p] - omega[p] * dx
    out = [torch.zeros_like(q[..., 0])] * 5
    for bi, (b, chain) in enumerate(zip(model.bodies, model.chains)):
        c, s = torch.cos(th[bi]), torch.sin(th[bi])
        cx, cz = b.com
        px = ox[bi] + c * cx + s * cz
        pz = oz[bi] - s * cx + c * cz
        vpx = vax[bi] + omega[bi] * (pz - awz[bi])
        vpz = vaz[bi] - omega[bi] * (px - awx[bi])
        sz = -s  # the z-convention axis is (cos θ_z, sin θ_z) = (c, −s)
        v_par = vpx * c + vpz * sz
        v_perp = -vpx * sz + vpz * c
        f_par = -(_C_VISC_F + _C_PAR * torch.abs(v_par)) * v_par
        f_perp = -(_C_VISC_F + _C_PERP * torch.abs(v_perp)) * v_perp
        fx = f_par * c - f_perp * sz
        fz = f_par * sz + f_perp * c
        w_z = -omega[bi]
        tq = -(_C_VISC_T + _C_ROT * torch.abs(w_z)) * w_z
        out[0] = out[0] + fx
        out[1] = out[1] + fz
        for body in chain:
            bb = model.bodies[body]
            jx = bb.sign * (pz - awz[body])
            jz = -bb.sign * (px - awx[body])
            # ∂θ_z/∂q_d = −sign (θ_z = −θ)
            out[bb.dof] = out[bb.dof] + jx * fx + jz * fz - bb.sign * tq
    return torch.stack(out, dim=-1)


def rk4_analytic(q, qv, tau, lam=None):
    """One mj_RungeKutta step (q', qv', λ) with the fluid force and the fixed
    (2, 3) limit solve, as the JAX package's `_rk4_analytic`; `tau` (..., 5)."""
    return rk4_substep(PC_MODEL, q, qv, tau, *SOLVER, lam, extra_force=fluid_force)


@dataclasses.dataclass(frozen=True, eq=False)
class SwimmerDeviceEnv(ContactEnv):
    """gymnasium Swimmer-v4: x = [qpos(5), qvel(5)] (10,), 2 torques ∈ [−1, 1]
    × gear 150. Its QP has the fixed iterations `SOLVER`, so the env has no
    solver fields (as in the JAX package); `solver_outer`/`solver_cg` are
    class constants the kernel's packing reads. The kernels are
    `kernels/planar_step.py`'s `swimmer_*` entries."""

    MODEL = PC_MODEL
    FRAME_SKIP = _FRAME_SKIP
    HEALTHY = 0.0
    CTRL_W = 1e-4
    INIT_QPOS = (0.0,) * 5
    FLUID = FLUID
    KERNEL = "swimmer"
    KERNEL_MODULE = "planar_step"
    solver_outer, solver_cg = SOLVER

    state_dim = 10
    action_dim = 2
    action_low = np.array([-1.0, -1.0])
    action_high = np.array([1.0, 1.0])

    def reset(self) -> EnvState:
        return make_state(self.tensor(np.zeros(10)))

    def plain_step(self, state: EnvState, action: torch.Tensor) -> EnvState:
        """One control step: FRAME_SKIP RK4 substeps, λ warm starts chained
        across them and reset at the control-step boundary."""
        x = state.x
        a = torch.clamp(action, -1.0, 1.0)
        tau = torch.cat([a.new_zeros(a.shape[:-1] + (3,)), _GEAR * a], dim=-1)
        q, qv = x[..., :5], x[..., 5:]
        lam = x.new_zeros(x.shape[:-1] + (PC_MODEL.n_rows,))
        for _ in range(self.FRAME_SKIP):
            q, qv, lam = rk4_analytic(q, qv, tau, lam)
        return EnvState(x=torch.cat([q, qv], dim=-1).to(self.dtype), t=state.t + 1,
                        done=state.done)

    def _reward(self, x0, x1, action):
        x_vel = (x1[..., 0] - x0[..., 0]) / self.dt
        return x_vel - self.CTRL_W * torch.sum(action * action, dim=-1)

    def reward(self, state: EnvState) -> torch.Tensor:
        """Instantaneous forward velocity (harness accounting)."""
        return state.x[..., 5]

    def observation(self, state: EnvState) -> torch.Tensor:
        """gym obs: qpos[2:] + qvel (8,)."""
        return torch.cat([state.x[..., 2:5], state.x[..., 5:]], dim=-1)
