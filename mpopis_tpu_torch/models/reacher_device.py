"""Reacher-v4 with on-device dynamics: MuJoCo-exact closed form.

Counterpart of `mpopis_tpu/models/reacher_device.py` (gymnasium's
Reacher-v4, reacher.xml):

- a 2-DoF planar arm; mass matrix M(q2) = [[a + 2b·cos q2, I2 + b·cos q2],
  [·, I2 + armature]] with constants probed from mj_fullM; Coriolis in
  closed form; joint damping 1; motor gear 200;
- RK4 at h = 0.01, frame_skip 2;
- joint1's soft limit (range ±3.0) in MuJoCo's constraint model, a single
  scalar constraint regularised by the model constant dof_invweight0[1].

Reward and observation follow reacher_v4.py: reward = −‖fingertip − target‖
− Σa², taken on the pre-step state through the stale stage-4 angles MuJoCo
leaves after mj_step (which the state carries). The reset is deterministic
(arm at 0, target at (0.1, −0.1)), as the JAX package's. The constants are
copies of the JAX package's (a test pins them).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mpopis_tpu_torch.models.base import Env, EnvState, make_state
from mpopis_tpu_torch.models.planar import _kb, impedance

# --- constants probed from reacher.xml via mj_fullM / mjModel (f64) -------
_A = 1.0007051618870246  # M00 constant part (incl. joint0 armature 1.0)
_B = 2.2410027595607144e-04  # cos-coupling inertia term
_I2 = 1.7903936532800e-04  # link-2 inertia about joint1 (no armature)
_ARMATURE = 1.0
_DAMPING = 1.0
_GEAR = 200.0
_H = 0.01  # option timestep
_FRAME_SKIP = 2  # gym Reacher frame_skip
_LIMIT = 3.0  # joint1 range ±3.0
_KC, _BC = _kb(_H)
_L1, _L2 = 0.1, 0.11  # link0 length, joint1->fingertip
_INVWEIGHT1 = 0.9998211549602818  # mjModel.dof_invweight0[1] (constraint R)
_Z = 0.0  # fingertip and target share z=0.01 -> vec z component is 0


def _qacc(q1, q2, v1, v2, tau1, tau2):
    """Constrained forward dynamics, exactly mj_forward on reacher.xml."""
    cb = _B * torch.cos(q2)
    sb = _B * torch.sin(q2)
    m00 = _A + 2.0 * cb
    m01 = _I2 + cb
    m11 = _I2 + _ARMATURE
    det = m00 * m11 - m01 * m01
    c1 = -sb * (2.0 * v1 * v2 + v2 * v2)
    c2 = sb * v1 * v1
    rhs1 = tau1 - c1 - _DAMPING * v1
    rhs2 = tau2 - c2 - _DAMPING * v2
    a1 = (m11 * rhs1 - m01 * rhs2) / det
    a2 = (-m01 * rhs1 + m00 * rhs2) / det

    # joint1 soft limit (single scalar constraint; sign s is the Jacobian)
    d_lo = q2 + _LIMIT
    d_hi = _LIMIT - q2
    lower_closer = d_lo < d_hi
    pos = torch.where(lower_closer, d_lo, d_hi)
    s = lower_closer.to(q2.dtype) * 2.0 - 1.0
    imp = impedance(pos)
    aref = -_BC * (s * v2) - _KC * imp * pos
    a_mat = m00 / det  # J M^-1 J^T for J = ±e2
    # MuJoCo regularizes with the model constant dof_invweight0, not the
    # state-dependent J M^-1 J^T
    r_reg = (1.0 - imp) / imp * _INVWEIGHT1
    lam = torch.clamp((aref - s * a2) / (a_mat + r_reg), min=0.0)
    lam = torch.where(pos < 0.0, lam, torch.zeros_like(lam))
    a1 = a1 + (-m01 / det) * (s * lam)
    a2 = a2 + (m00 / det) * (s * lam)
    return a1, a2


def _rk4(y, tau1, tau2):
    """One mj_RungeKutta step at h = _H over y = (q1, q2, v1, v2) (..., 4)
    with the ctrl held. Returns (y', the stage-4 y): mj_step leaves
    data.xpos at the last RK stage's kinematics."""

    def f(z):
        a1, a2 = _qacc(z[..., 0], z[..., 1], z[..., 2], z[..., 3], tau1, tau2)
        return torch.stack([z[..., 2], z[..., 3], a1, a2], dim=-1)

    k1 = f(y)
    k2 = f(y + 0.5 * _H * k1)
    k3 = f(y + 0.5 * _H * k2)
    y4 = y + _H * k3
    k4 = f(y4)
    return y + (_H / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4), y4


def _fingertip(q1, q2):
    c1, s1 = torch.cos(q1), torch.sin(q1)
    c12, s12 = torch.cos(q1 + q2), torch.sin(q1 + q2)
    return _L1 * c1 + _L2 * c12, _L1 * s1 + _L2 * s12


@dataclasses.dataclass(frozen=True, eq=False)
class ReacherDeviceEnv(Env):
    """gymnasium Reacher-v4. State x = [q1, q2, q̇1, q̇2, target_x,
    target_y, fk_q1, fk_q2], (fk_q1, fk_q2) the stale-kinematics angles;
    action [torque0, torque1] ∈ [−1, 1] (gear 200). `step_reward` gives
    gym's reward: the pre-step distance and the ctrl penalty."""

    target: tuple = (0.1, -0.1)  # qpos0 of the target slides (xml ref=)

    state_dim = 8
    action_dim = 2
    action_low = np.array([-1.0, -1.0])
    action_high = np.array([1.0, 1.0])

    @property
    def dt(self) -> float:
        return _H * _FRAME_SKIP

    def reset(self) -> EnvState:
        # fresh kinematics after reset (mj_forward runs at reset): fk = q
        x = np.zeros(8)
        x[4], x[5] = self.target
        return make_state(self.tensor(x))

    def step(self, state: EnvState, action: torch.Tensor) -> EnvState:
        a = torch.clamp(action, -1.0, 1.0)
        tau1, tau2 = _GEAR * a[..., 0], _GEAR * a[..., 1]
        x = state.x
        y = x[..., 0:4]
        for _ in range(_FRAME_SKIP):
            y, y4 = _rk4(y, tau1, tau2)
        x2 = torch.cat([y, x[..., 4:6], y4[..., 0:2]], dim=-1).to(self.dtype)
        return EnvState(x=x2, t=state.t + 1, done=state.done)

    def step_reward(self, state: EnvState, action: torch.Tensor):
        """Step + gym's reward (pre-step distance + ctrl penalty), so the
        rollout costs equal gym's totals."""
        return self.step(state, action), self.reward_pre(state, action)

    def reward_pre(self, state: EnvState, action: torch.Tensor) -> torch.Tensor:
        """−‖fingertip − target‖ − Σa² on the pre-step state, through the
        stale angles gym reads."""
        return self.reward(state) - torch.sum(action * action, dim=-1)

    def reward(self, state: EnvState) -> torch.Tensor:
        """The action-independent part (the distance), for the harness."""
        x = state.x
        fx, fy = _fingertip(x[..., 6], x[..., 7])
        dx = fx - x[..., 4]
        dy = fy - x[..., 5]
        return -torch.sqrt(dx * dx + dy * dy + _Z)

    def observation(self, state: EnvState) -> torch.Tensor:
        """gym obs: [cos θ (2), sin θ (2), target (2), θ̇ (2), fingertip − target (3)]."""
        x = state.x
        q1, q2 = x[..., 0], x[..., 1]
        fx, fy = _fingertip(x[..., 6], x[..., 7])
        return torch.stack([
            torch.cos(q1), torch.cos(q2), torch.sin(q1), torch.sin(q2), x[..., 4], x[..., 5],
            x[..., 2], x[..., 3], fx - x[..., 4], fy - x[..., 5], torch.zeros_like(fx),
        ], dim=-1)
