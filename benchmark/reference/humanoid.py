"""The plain control step and reward of Humanoid-v4 as the port runs it.

Frozen from `mpopis_tpu_torch/models/humanoid_device.py` (`com_x`,
`HumanoidDeviceEnv.reset`, `_carry`, `_reward`) and the plain step of
`models/spatial_contact.py` (`SpatialContactEnv.plain_step`) at commit
ab16cdf357dd, over a batch of states. Imports nothing of the program.

Where it departs from Gymnasium's `humanoid_v4.py`, as the port's docstring
states:
- the state is x = [qpos(24), qvel(23), com_x] and the port's observation
  is its kinematic prefix, [qpos[2:], qvel] (45 of Gymnasium's 376: no
  cinert, cvel, qfrc_actuator or cfrc_ext); the reward reads none of the
  rest, so the task keeps none of it;
- no episode ends: the rollouts and the closed loop run unterminated, where
  Gymnasium ends one when the torso leaves z in [1.0, 2.0];
- the reset is qpos0 with no reset noise (Gymnasium adds U(±0.01)).
What it keeps: reward = 5 + 1.25·(com_x' − com_x)/dt − 0.1·Σclip(a)², com_x
the mass-weighted x of the bodies' centres of mass (data.xipos), which
mj_step leaves at the last RK stage's positions, and the control cost of the
action clipped to the ctrlrange.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark.reference import spatial_contact
from benchmark.reference.tasks import SpatialTask


def com_x(model: spatial_contact.SpatialContactModel, q: torch.Tensor) -> torch.Tensor:
    """The body-mass-weighted world com x (...,) at the qpos q (..., nq):
    xipos_b = origin_b + R_b·ipos_b, summed in body order."""
    fr = spatial_contact.frames(model, q)
    masses = tuple(b.mass for b in model.bodies)
    s = None
    for bi, b in enumerate(model.bodies):
        r = fr.rot[bi]
        cx = ((fr.origin[bi][..., 0] + r[..., 0, 0] * b.com[0]) + r[..., 0, 1] * b.com[1]) + (
            r[..., 0, 2] * b.com[2])
        s = masses[bi] * cx if s is None else s + masses[bi] * cx
    return s * (1.0 / sum(masses))


@dataclasses.dataclass(frozen=True)
class HumanoidTask(SpatialTask):
    """Humanoid-v4: x = [qpos(nq), qvel(n), the stage-4 com x]; the
    track is the com x, which the reset starts at com_x(qpos0), and the
    control cost reads the clipped action."""

    def reset_x(self, dtype, device) -> torch.Tensor:
        q0 = torch.as_tensor(self.init_qpos, dtype=torch.float64)
        x = np.concatenate([self.init_qpos, np.zeros(self.model.n_dof),
                            [float(com_x(self.model, q0))]])
        return torch.as_tensor(x, dtype=dtype, device=device)

    def step(self, x: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        """One control step of a batch of states: frame_skip RK4 substeps, λ
        warm starts chained across them from zero, then the com x of the
        last substep's stage-4 positions."""
        model = self.model
        nq, n = model.n_q, model.n_dof
        tau = self._tau(torch.clamp(action, -self.action_clip, self.action_clip))
        q, qv = x[..., :nq], x[..., nq:nq + n]
        lam = x.new_zeros(x.shape[:-1] + (model.n_rows,))
        q_snap = q
        for _ in range(self.frame_skip):
            q, qv, lam, q_snap = spatial_contact.rk4_substep(model, q, qv, tau, self.solver_outer,
                                                             self.solver_cg, lam)
        return torch.cat([q, qv, com_x(model, q_snap).unsqueeze(-1)], dim=-1)

    def reward(self, x0, x1, action):
        k = self.model.n_q + self.model.n_dof
        a = torch.clamp(action, -self.action_clip, self.action_clip)
        x_vel = (x1[..., k] - x0[..., k]) / self.dt
        return self.healthy + self.fwd_w * x_vel - self.ctrl_w * torch.sum(a * a, dim=-1)
