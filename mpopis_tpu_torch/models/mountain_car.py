"""Continuous MountainCar.

Counterpart of `mpopis_tpu/models/mountain_car.py`: the Moore/Sutton
continuous mountain car with ReinforcementLearning.jl's parameters (goal
0.45, power 0.0015, gravity 0.0025, 200 steps) and the reference
example's reward override (+1e5 at the goal, +|velocity|, −1 for each step
that is not done). `done` is recomputed from the state every step, per
sample in a batch, and lives on the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mpopis_tpu_torch.models.base import Env, EnvState, done_mask, make_state


@dataclasses.dataclass(frozen=True, eq=False)
class MountainCarEnv(Env):
    min_pos: float = -1.2
    max_pos: float = 0.6
    max_speed: float = 0.07
    goal_pos: float = 0.45
    goal_velocity: float = 0.0
    power: float = 0.0015
    gravity: float = 0.0025
    max_steps: int = 200

    random_reset = True
    state_dim = 2
    action_dim = 1
    action_low = np.array([-1.0])
    action_high = np.array([1.0])

    def reset(self, generator: torch.Generator | None = None) -> EnvState:
        """Position −0.5 at rest; with a generator, a position uniform in
        [−0.6, −0.4) drawn from it. The JAX package draws that start from
        `jax.random`, so the two packages' random starts differ."""
        if generator is None:
            pos = -0.5
        else:
            pos = -0.6 + 0.2 * float(torch.rand((), generator=generator, dtype=torch.float64))
        return make_state(self.tensor([pos, 0.0]))

    def step(self, state: EnvState, action: torch.Tensor) -> EnvState:
        a = action[..., 0]
        pos, v = state.x[..., 0], state.x[..., 1]
        v = v + a * self.power - torch.cos(3.0 * pos) * self.gravity
        v = torch.clamp(v, -self.max_speed, self.max_speed)
        pos = pos + v
        pos = torch.clamp(pos, self.min_pos, self.max_pos)
        # the wall at the left edge kills leftward velocity
        v = torch.where((pos == self.min_pos) & (v < 0), torch.zeros_like(v), v)
        t = state.t + 1
        done = ((pos >= self.goal_pos) & (v >= self.goal_velocity)) | (t >= self.max_steps)
        return EnvState(x=torch.stack([pos, v], dim=-1), t=t, done=done)

    def reward(self, state: EnvState) -> torch.Tensor:
        """The reference's override: +1e5 at the goal, +|v|, −1 per step
        that is not done."""
        pos, v = state.x[..., 0], state.x[..., 1]
        at_goal = (pos >= self.goal_pos) & (v >= self.goal_velocity)
        rew = at_goal.to(self.dtype) * 100000.0
        rew = rew + torch.abs(v)
        rew = rew - (~done_mask(state)).to(self.dtype)
        return rew.to(self.dtype)
