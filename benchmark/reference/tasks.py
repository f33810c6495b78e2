"""The plain control step and rollout costs of the contact tasks.

Frozen from the plain paths of `mpopis_tpu_torch/models/planar_contact.py`
(`PlanarContactEnv.plain_step`, `_reward`), `models/spatial_contact.py`
(`SpatialContactEnv.plain_step`, `_tau`, `_carry`, `_reward`) and
`models/rollout.py` (`rollout_batch`) at commit 3b1bee442fec, written over a
batch of start states so that many checked rollouts run as one batch.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark.reference import planar_contact, spatial_contact
from benchmark.reference.ce import round_tf32


def contact_env_kwargs(config: dict) -> dict:
    """The port's env of a contact task, as the configuration states it:
    the contact solver's fixed iterations."""
    return {"solver_outer": config["solver_outer"], "solver_cg": config["solver_cg"]}


def contact_facts(env) -> dict:
    """What the port's env of a contact task says of itself, for the harness
    to hold against the configuration's file."""
    return {"frame_skip": env.FRAME_SKIP, "timestep": env.MODEL.timestep,
            "n_dof": env.MODEL.n_dof, "state_dim": env.state_dim,
            "action_dim": env.action_dim, "integrator": env.MODEL.integrator,
            "qp_rows": env.MODEL.n_rows}


def _matvec_tf32(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (round_tf32(a) @ round_tf32(v).unsqueeze(-1)).squeeze(-1)


class TF32Products:
    """The control's dynamics for the duration: every matrix product of the
    plain contact QP (`planar_contact._matvec`, which the spatial family
    shares) with its operands rounded to TF32, as a tensor core takes them,
    and TF32 allowed for the library's products on the card."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"

    def __enter__(self):
        self.matvec = planar_contact._matvec
        planar_contact._matvec = _matvec_tf32
        if self.cuda:
            self.flag = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = True
        return self

    def __exit__(self, *exc):
        planar_contact._matvec = self.matvec
        if self.cuda:
            torch.backends.cuda.matmul.allow_tf32 = self.flag
        return False


class _Rollouts:
    """Rollout costs from batches of start states, for either family."""

    def tf32_products(self, device) -> TF32Products:
        """A context in which the dynamics run as the control runs them."""
        return TF32Products(device)

    def rollout_costs(self, x0: torch.Tensor, controls: torch.Tensor) -> torch.Tensor:
        """Σ_t -reward_t of controls (B, T, as) from start states x0 (B, nx)."""
        x, cost = x0, x0.new_zeros(x0.shape[:-1])
        for t in range(controls.shape[1]):
            x1 = self.step(x, controls[:, t])
            cost = cost - self.reward(x, x1, controls[:, t])
            x = x1
        return cost

    @property
    def dt(self) -> float:
        return self.model.timestep * self.frame_skip


@dataclasses.dataclass(frozen=True)
class PlanarTask(_Rollouts):
    """A gymnasium v4 planar-locomotion task: x = [qpos(n), qvel(n)], actions
    in [-1, 1] times the gears; reward = healthy + (x' - x)/dt - ctrl_w·Σa²."""

    model: planar_contact.PlanarContactModel
    frame_skip: int
    healthy: float
    ctrl_w: float
    init_qpos: tuple
    action_dim: int
    solver_outer: int = 3
    solver_cg: int = 6

    module = planar_contact

    def reset_x(self, dtype, device) -> torch.Tensor:
        n = self.model.n_dof
        x = np.concatenate([self.init_qpos, np.zeros(n)])
        return torch.as_tensor(x, dtype=dtype, device=device)

    def step(self, x: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        """One control step of a batch of states (..., 2n): frame_skip
        substeps, λ warm starts chained across them from zero."""
        model = self.model
        n = model.n_dof
        a = torch.clamp(action, -1.0, 1.0)
        gear = planar_contact._tab(model, a).gear
        tau = torch.cat([a.new_zeros(a.shape[:-1] + (n - a.shape[-1],)), gear * a], dim=-1)
        q, qv = x[..., :n], x[..., n:]
        lam = x.new_zeros(x.shape[:-1] + (model.n_rows,))
        substep = (planar_contact.euler_implicit_substep if model.integrator == "euler_implicit"
                   else planar_contact.rk4_substep)
        for _ in range(self.frame_skip):
            q, qv, lam = substep(model, q, qv, tau, self.solver_outer, self.solver_cg, lam)
        return torch.cat([q, qv], dim=-1)

    def reward(self, x0, x1, action):
        x_vel = (x1[..., 0] - x0[..., 0]) / self.dt
        return self.healthy + x_vel - self.ctrl_w * torch.sum(action * action, dim=-1)


@dataclasses.dataclass(frozen=True)
class SpatialTask(_Rollouts):
    """A gymnasium v4 spatial locomotion task: x = [qpos(nq), qvel(n), the
    root's x at the last RK stage]; actions times the gears of `actuators`
    ((dof, gear) each); reward = healthy + fwd_w·(track' - track)/dt -
    ctrl_w·Σa², the action as given."""

    model: spatial_contact.SpatialContactModel
    frame_skip: int
    healthy: float
    ctrl_w: float
    init_qpos: tuple
    action_dim: int
    actuators: tuple
    fwd_w: float = 1.0
    action_clip: float = 1.0
    solver_outer: int = 3
    solver_cg: int = 6

    module = spatial_contact

    def reset_x(self, dtype, device) -> torch.Tensor:
        q0 = np.asarray(self.init_qpos, dtype=float)
        x = np.concatenate([q0, np.zeros(self.model.n_dof), q0[:1]])
        return torch.as_tensor(x, dtype=dtype, device=device)

    def _tau(self, a: torch.Tensor) -> torch.Tensor:
        dofs = [dof for dof, _ in self.actuators]
        gear = a.new_tensor([g for _, g in self.actuators])
        tau = a.new_zeros(a.shape[:-1] + (self.model.n_dof,))
        tau[..., dofs] = gear * a
        return tau

    def step(self, x: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        model = self.model
        substep = (spatial_contact.euler_implicit_substep
                   if model.integrator == "euler_implicit" else spatial_contact.rk4_substep)
        nq, n = model.n_q, model.n_dof
        tau = self._tau(torch.clamp(action, -self.action_clip, self.action_clip))
        q, qv = x[..., :nq], x[..., nq:nq + n]
        lam = x.new_zeros(x.shape[:-1] + (model.n_rows,))
        q_snap = q
        for _ in range(self.frame_skip):
            q, qv, lam, q_snap = substep(model, q, qv, tau, self.solver_outer, self.solver_cg,
                                         lam)
        return torch.cat([q, qv, q_snap[..., :1]], dim=-1)

    def reward(self, x0, x1, action):
        k = self.model.n_q + self.model.n_dof
        x_vel = (x1[..., k] - x0[..., k]) / self.dt
        return self.healthy + self.fwd_w * x_vel - self.ctrl_w * torch.sum(action * action,
                                                                            dim=-1)
