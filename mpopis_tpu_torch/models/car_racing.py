"""Planar single-track (bicycle) car-racing dynamics with brush/Fiala tire
forces, batched over any leading dimensions.

Counterpart of `mpopis_tpu/models/car_racing.py` (Brown & Gerdes, IEEE
T-IV 5(1), 2020). State layout [x, y, Ψ, Vx, Vy, Ψ̇, δ, pedal]; action
[steer∈[-1,1], pedal∈[-1,1]]; semi-implicit Euler at δt inside dt action
steps (10 substeps by default); reward −1e6 off-track −5000 on |β|>β_limit
− centerline distance + 2‖v‖. All conditionals are `torch.where` selects,
so a (K, 8) batch of states steps as one tensor. These functions are the
plain version the CUDA rollout kernel is held against.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mpopis_tpu_torch.models.base import Env, EnvState, make_state
from mpopis_tpu_torch.models.track import Track, distance_query

_G = 9.81


@dataclasses.dataclass(frozen=True, eq=False)
class CarParams:
    """Physical parameters; a copy of the JAX package's table (a test pins
    the two to each other field by field)."""

    m: float = 2000.0  # mass (kg)
    i_zz: float = 3764.0  # yaw moment of inertia (kg m^2)
    h_cm: float = 0.3  # CoM height (m)
    l_f: float = 1.53  # CoM to front axle (m)
    l_r: float = 1.23  # CoM to rear axle (m)
    c_d0: float = 241.0  # constant drag (N)
    c_d1: float = 25.1  # linear drag (N s/m)
    c_af: float = 150000.0  # front cornering stiffness (N/rad)
    c_ar: float = 280000.0  # rear cornering stiffness (N/rad)
    mu_f: float = 0.9  # front tire friction
    mu_r: float = 0.9  # rear tire friction
    delta_max: float = float(np.deg2rad(18.0))  # steering limit (rad)
    delta_dot_max: float = float(np.deg2rad(90.0))  # steering rate limit
    fx_max: float = 7200.0  # max drive force (N)
    fx_min: float = 22500.0  # max brake force (N)
    lambda_brake: float = 0.6  # brake force front/rear split
    lambda_drive: float = 0.0  # drive force front/rear split
    beta_limit: float = float(np.deg2rad(45.0))  # sideslip penalty limit


def _tire_fy(alpha, mu, c_a, fz, fx):
    """Brush tire lateral force, branchless."""
    fy_max = torch.sqrt(torch.clamp((mu * fz) ** 2 - fx**2, min=1e-8))
    ta = torch.tan(alpha)
    cubic = (
        -c_a * ta
        + (c_a**2 / (3.0 * fy_max)) * torch.abs(ta) * ta
        - (c_a**3 / (27.0 * fy_max**2)) * ta**3
    )
    saturated = -fy_max * torch.sign(alpha)
    return torch.where(
        torch.abs(alpha) < torch.atan(3.0 * fy_max / c_a), cubic, saturated
    )


def step_car_state(p: CarParams, s: torch.Tensor, action: torch.Tensor, dt, ddt):
    """One action step = `dt/ddt` semi-implicit Euler substeps over states
    `s` (..., 8) and actions `action` (..., 2); returns (..., 8)."""
    x, y, psi, vx, vy, psid, delta = (s[..., i] for i in range(7))
    a_steer = action[..., 0]
    pedal = action[..., 1]

    target = a_steer * p.delta_max
    commanded_rate = torch.abs(target - delta) / dt
    ddelta_rate = torch.clamp(commanded_rate, max=p.delta_dot_max) * torch.sign(
        target - delta
    )

    ll = p.l_r + p.l_f
    # pedal-dependent force split (constant across substeps)
    lam = torch.where(
        pedal <= 0.0, pedal.new_tensor(p.lambda_brake), pedal.new_tensor(p.lambda_drive)
    )
    accel = p.fx_max * torch.clamp(pedal, min=0.0)

    n_sub = int(round(dt / ddt))
    for _ in range(n_sub):
        delta = delta + ddelta_rate * ddt

        alpha_f = torch.atan2(vy + p.l_f * psid, vx) - delta
        alpha_r = torch.atan2(vy - p.l_r * psid, vx)

        fx_aero = (p.c_d0 + p.c_d1 * torch.abs(vx)) * torch.sign(vx)

        brake = p.fx_min * torch.clamp(pedal, max=0.0) * torch.sign(vx)
        fx = accel + brake

        fxf = lam * fx
        fxr = (1.0 - lam) * fx
        fzf = (p.m * p.l_r * _G - p.h_cm * fx) / ll
        fzr = (p.m * p.l_f * _G + p.h_cm * fx) / ll
        fyf = _tire_fy(alpha_f, p.mu_f, p.c_af, fzf, fxf)
        fyr = _tire_fy(alpha_r, p.mu_r, p.c_ar, fzr, fxr)

        sin_d = torch.sin(delta)
        cos_d = torch.cos(delta)
        psidd = (p.l_f * (fxf * sin_d + fyf * cos_d) - p.l_r * fyr) / p.i_zz
        vy_dot = (fyf * cos_d + fxf * sin_d + fyr) / p.m - psid * vx
        vx_dot = (fxf * cos_d - fyf * sin_d + fxr - fx_aero) / p.m + psid * vy

        psid = psid + psidd * ddt
        vx = vx + vx_dot * ddt
        vy = vy + vy_dot * ddt
        psi = psi + psid * ddt
        psi = torch.atan2(torch.sin(psi), torch.cos(psi))
        x = x + (vx * torch.cos(psi) - vy * torch.sin(psi)) * ddt
        y = y + (vx * torch.sin(psi) + vy * torch.cos(psi)) * ddt

    return torch.stack([x, y, psi, vx, vy, psid, delta, pedal], dim=-1)


def car_reward(p: CarParams, pts: torch.Tensor, widths: torch.Tensor, s: torch.Tensor):
    """Reward on post-step states `s` (..., 8); returns (...,)."""
    within, dist = distance_query(pts, widths, s[..., :2])
    beta = torch.atan2(s[..., 4], s[..., 3])
    zero = s.new_tensor(0.0)
    rew = torch.where(within, zero, s.new_tensor(-1000000.0))
    rew = rew + torch.where(torch.abs(beta) > p.beta_limit, s.new_tensor(-5000.0), zero)
    rew = rew - dist
    rew = rew + 2.0 * torch.sqrt(s[..., 3] ** 2 + s[..., 4] ** 2)
    return rew


@dataclasses.dataclass(frozen=True, eq=False)
class CarRacingEnv(Env):
    params: CarParams = CarParams()
    dt: float = 0.1  # action step
    ddt: float = 0.01  # integration substep
    track: Track = None  # type: ignore[assignment]
    track_name: str = "curve"
    track_width: float = 15.0
    track_sample_factor: int = 20

    state_dim = 8
    action_dim = 2
    num_cars = 1
    action_low = np.array([-1.0, -1.0])
    action_high = np.array([1.0, 1.0])

    def __post_init__(self):
        if self.track is None:
            object.__setattr__(
                self,
                "track",
                Track.load(
                    self.track_name,
                    width=self.track_width,
                    sample_factor=self.track_sample_factor,
                ),
            )
        pts, widths = self.track.query_arrays(self.dtype, self.device)
        object.__setattr__(self, "pts", pts)
        object.__setattr__(self, "widths", widths)
        # (3, M) rows xs, ys, widths: the rollout kernel's track operand
        object.__setattr__(
            self, "track_xyw", torch.stack([pts[:, 0], pts[:, 1], widths]).contiguous()
        )

    def reset(self) -> EnvState:
        """Zeros except Ψ=90°, Vx=10."""
        x = np.zeros(8)
        x[2] = np.deg2rad(90.0)
        x[3] = 10.0
        return make_state(self.tensor(x))

    def step(self, state: EnvState, action: torch.Tensor) -> EnvState:
        x_new = step_car_state(self.params, state.x, action, self.dt, self.ddt)
        return EnvState(x=x_new, t=state.t + 1, done=state.done)

    def reward(self, state: EnvState) -> torch.Tensor:
        return car_reward(self.params, self.pts, self.widths, state.x)

    def fused_rollout_costs_tak(self, state: EnvState, controls_tak: torch.Tensor):
        """(K,) trajectory costs of clamped controls in the rollout kernel's
        (T, 2, K) layout (kernels/car_rollout.py)."""
        from mpopis_tpu_torch.kernels.car_rollout import car_rollout_costs_tak

        return car_rollout_costs_tak(self, state.x, controls_tak, controls_tak.shape[0])

    def fused_rollout_costs(self, state: EnvState, controls: torch.Tensor):
        """The same with clamped controls (K, T, 2), the layout of plain
        MPPI: one transpose into the kernel's layout."""
        return self.fused_rollout_costs_tak(state, controls.permute(1, 2, 0).contiguous())

    def within_track(self, state: EnvState):
        return distance_query(self.pts, self.widths, state.x[..., :2])
