"""InvertedPendulum-v4 and InvertedDoublePendulum-v4 with on-device dynamics.

Counterpart of `mpopis_tpu/models/pendulum_device.py`: vertical-plane
cart-pole chains under gravity, RK4, soft slide/hinge limits — mj_step on
inverted_pendulum.xml / inverted_double_pendulum.xml through the planar
toolkit (`models/planar.py`). The constants are copies of the JAX
package's (a test pins them), and each chain's kinematics are a
`TrigKinematics` table, the same outputs the JAX package's `_ip_kin` and
`_idp_kin` compute.

InvertedPendulum-v4: 2 DoF (cart slide ±1 m, pole hinge ±90°, both damping
1, gear-100 motor with ctrlrange ±3), h = 0.02, frame_skip 2. gym ends an
episode at |angle| > 0.2; a batch rollout has no termination, so the alive
bonus is gated on the healthy condition, as in the JAX package.

InvertedDoublePendulum-v4: 3 DoF (cart slide ±1 m with margin 0.01, two
free hinges, damping 0.05, gear-500 motor, gravity (1e-5, 0, −9.81)),
h = 0.01, frame_skip 5. The reward and the observation's constraint-force
tail read MuJoCo's stale stage-4 kinematics (see `planar.rk4_step`), which
the state carries.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mpopis_tpu_torch.models.base import Env, EnvState, make_state
from mpopis_tpu_torch.models.planar import (
    LimitSpec,
    TrigKinematics,
    build_planar_dynamics,
    rk4_step,
)

_G = 9.81

# --- InvertedPendulum constants (inverted_pendulum.xml via mjModel) --------
_IP_M_CART = 10.47197551196598
_IP_M_POLE = 5.018591641363306
_IP_I_POLE = 0.18874976687308852  # about y at the pole com
_IP_COM = (0.0005, 0.3)  # pole com in body frame (x, z); geom is tilted
_IP_DAMPING = 1.0
_IP_GEAR = 100.0
_IP_CTRL = 3.0
_IP_H = 0.02
_IP_SKIP = 2
_IP_INVWEIGHT = (0.08367433805859587, 2.023912919848819)

# --- InvertedDoublePendulum constants (inverted_double_pendulum.xml) -------
_IDP_M_CART = 10.47197551196598
_IDP_M_POLE = 4.1987385815227585
_IDP_I_POLE = 0.15497066975016235
_IDP_COM_Z = 0.3  # both pole coms at +0.3 along the link
_IDP_LINK = 0.6  # pole length (pole2 body / tip site offset)
_IDP_DAMPING = 0.05
_IDP_GEAR = 500.0
_IDP_H = 0.01
_IDP_SKIP = 5  # gymnasium's class value (not the XML custom numeric 2)
_IDP_GX = 1e-5  # the model's tiny +x gravity component
_IDP_INVWEIGHT_SLIDE = 0.08467261918769675
_IDP_MARGIN = 0.01

# (cart_x, pole_com_x, pole_com_z, θ) over q = (x, θ): rotation about +y by
# θ maps body (px, pz) to world (c·px + s·pz, −s·px + c·pz)
_a, _b = _IP_COM
IP_KIN = TrigKinematics(
    lin=((1.0, 0.0), (1.0, 0.0), (0.0, 0.0), (0.0, 1.0)),
    sin_coef=((0.0,), (_b,), (-_a,), (0.0,)),
    cos_coef=((0.0,), (_a,), (_b,), (0.0,)),
    angles=((0.0, 1.0),),
)

_IP_QACC, _ip_mass = build_planar_dynamics(
    IP_KIN,
    kin_weights=(_IP_M_CART, _IP_M_POLE, _IP_M_POLE, _IP_I_POLE),
    # V = m·g·z_com (cart height constant)
    pot_coeffs=(0.0, 0.0, _IP_M_POLE * _G, 0.0),
    n_dof=2,
    damping=(_IP_DAMPING, _IP_DAMPING),
    armature=(0.0, 0.0),
    limits=(
        LimitSpec(dof=0, lo=-1.0, hi=1.0, invweight=_IP_INVWEIGHT[0]),
        LimitSpec(dof=1, lo=-float(np.pi / 2), hi=float(np.pi / 2), invweight=_IP_INVWEIGHT[1]),
    ),
    timestep=_IP_H,
)


@dataclasses.dataclass(frozen=True, eq=False)
class InvertedPendulumDeviceEnv(Env):
    """gymnasium InvertedPendulum-v4. State x = [cart_x, θ, ẋ, θ̇]; action =
    1 force ∈ [−3, 3] (ctrlrange) scaled by gear 100. Reward = 1 while
    healthy (|θ| ≤ 0.2), else 0."""

    state_dim = 4
    action_dim = 1
    action_low = np.array([-_IP_CTRL])
    action_high = np.array([_IP_CTRL])

    @property
    def dt(self) -> float:
        return _IP_H * _IP_SKIP

    def reset(self) -> EnvState:
        return make_state(torch.zeros(4, dtype=self.dtype, device=self.device))

    def step(self, state: EnvState, action: torch.Tensor) -> EnvState:
        x = state.x
        force = _IP_GEAR * torch.clamp(action[..., 0], -_IP_CTRL, _IP_CTRL)
        tau = torch.stack([force, torch.zeros_like(force)], dim=-1)
        q, qv = x[..., 0:2], x[..., 2:4]
        for _ in range(_IP_SKIP):
            q, qv, _, _ = rk4_step(_IP_QACC, q, qv, tau, _IP_H)
        return EnvState(x=torch.cat([q, qv], dim=-1).to(self.dtype), t=state.t + 1,
                        done=state.done)

    def reward(self, state: EnvState) -> torch.Tensor:
        healthy = torch.abs(state.x[..., 1]) <= 0.2
        return healthy.to(self.dtype)

    def observation(self, state: EnvState) -> torch.Tensor:
        return state.x  # gym obs: [qpos, qvel]


# (cart_x, p1_com_x, p1_com_z, p2_com_x, p2_com_z, θ1, θ2) over q = (x, a1, a2),
# absolute pole angles θ1 = a1, θ2 = a1 + a2; rotation about +y maps body
# (0, z) to world (s·z, c·z)
IDP_KIN = TrigKinematics(
    lin=((1.0, 0.0, 0.0), (1.0, 0.0, 0.0), (0.0, 0.0, 0.0), (1.0, 0.0, 0.0),
         (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 1.0, 1.0)),
    sin_coef=((0.0, 0.0), (_IDP_COM_Z, 0.0), (0.0, 0.0), (_IDP_LINK, _IDP_COM_Z),
              (0.0, 0.0), (0.0, 0.0), (0.0, 0.0)),
    cos_coef=((0.0, 0.0), (0.0, 0.0), (_IDP_COM_Z, 0.0), (0.0, 0.0),
              (_IDP_LINK, _IDP_COM_Z), (0.0, 0.0), (0.0, 0.0)),
    angles=((0.0, 1.0, 0.0), (0.0, 1.0, 1.0)),
)

_IDP_QACC, _idp_mass = build_planar_dynamics(
    IDP_KIN,
    kin_weights=(_IDP_M_CART, _IDP_M_POLE, _IDP_M_POLE, _IDP_M_POLE, _IDP_M_POLE,
                 _IDP_I_POLE, _IDP_I_POLE),
    # V = Σ m(g_z·z − g_x·x): the model has gravity (1e-5, 0, −9.81), so x
    # coordinates carry a tiny −m·g_x potential as well
    pot_coeffs=(-_IDP_M_CART * _IDP_GX, -_IDP_M_POLE * _IDP_GX, _IDP_M_POLE * _G,
                -_IDP_M_POLE * _IDP_GX, _IDP_M_POLE * _G, 0.0, 0.0),
    n_dof=3,
    damping=(_IDP_DAMPING,) * 3,
    armature=(0.0,) * 3,
    limits=(LimitSpec(dof=0, lo=-1.0, hi=1.0, invweight=_IDP_INVWEIGHT_SLIDE,
                      margin=_IDP_MARGIN),),
    timestep=_IDP_H,
)


def _idp_tip(x, a1, a2):
    """Tip-site world (x, z) from qpos (site at +0.6 on pole2)."""
    th1, th2 = a1, a1 + a2
    tx = x + torch.sin(th1) * _IDP_LINK + torch.sin(th2) * _IDP_LINK
    tz = torch.cos(th1) * _IDP_LINK + torch.cos(th2) * _IDP_LINK
    return tx, tz


@dataclasses.dataclass(frozen=True, eq=False)
class InvertedDoublePendulumDeviceEnv(Env):
    """gymnasium InvertedDoublePendulum-v4. State x = [qpos(3), qvel(3),
    fk_qpos(3), fk_qfrc_slide], the fk entries the stale stage-4 kinematics
    and slide constraint force MuJoCo leaves after mj_step (gym's obs and
    reward read them). Action = 1 force ∈ [−1, 1], gear 500."""

    state_dim = 10
    action_dim = 1
    action_low = np.array([-1.0])
    action_high = np.array([1.0])

    @property
    def dt(self) -> float:
        return _IDP_H * _IDP_SKIP

    def reset(self) -> EnvState:
        return make_state(torch.zeros(10, dtype=self.dtype, device=self.device))

    def step(self, state: EnvState, action: torch.Tensor) -> EnvState:
        x = state.x
        force = _IDP_GEAR * torch.clamp(action[..., 0], -1.0, 1.0)
        zero = torch.zeros_like(force)
        tau = torch.stack([force, zero, zero], dim=-1)
        q, qv = x[..., 0:3], x[..., 3:6]
        for _ in range(_IDP_SKIP):
            q, qv, q4, qfrc4 = rk4_step(_IDP_QACC, q, qv, tau, _IDP_H)
            f4 = qfrc4[..., 0]
        x2 = torch.cat([q, qv, q4, f4[..., None]], dim=-1).to(self.dtype)
        return EnvState(x=x2, t=state.t + 1, done=state.done)

    def reward(self, state: EnvState) -> torch.Tensor:
        """10 − dist − vel penalties on the post-step state, via the stale
        stage-4 site position."""
        x = state.x
        tx, tz = _idp_tip(x[..., 6], x[..., 7], x[..., 8])
        dist_pen = 0.01 * tx * tx + (tz - 2.0) ** 2
        v1, v2 = x[..., 4], x[..., 5]
        vel_pen = 1e-3 * v1 * v1 + 5e-3 * v2 * v2
        return (10.0 - dist_pen - vel_pen).to(self.dtype)

    def observation(self, state: EnvState) -> torch.Tensor:
        """gym obs: [x, sin(angles), cos(angles), clip(qvel, ±10),
        clip(qfrc_constraint, ±10)] (11)."""
        x = state.x
        a1, a2 = x[..., 1], x[..., 2]
        zero = torch.zeros_like(x[..., 0])
        return torch.stack([
            x[..., 0], torch.sin(a1), torch.sin(a2), torch.cos(a1), torch.cos(a2),
            torch.clamp(x[..., 3], -10.0, 10.0), torch.clamp(x[..., 4], -10.0, 10.0),
            torch.clamp(x[..., 5], -10.0, 10.0), torch.clamp(x[..., 9], -10.0, 10.0),
            zero, zero,
        ], dim=-1)
