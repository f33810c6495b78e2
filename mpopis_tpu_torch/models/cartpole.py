"""Continuous CartPole.

Counterpart of `mpopis_tpu/models/cartpole.py`: the Barto–Sutton–Anderson
cart-pole with ReinforcementLearning.jl's parameters. State [x, ẋ, θ, θ̇];
the action a ∈ [−1, 1] scales forcemag; reward 1 for each step that is not
done. `done` is recomputed from the state every step (it does not stick),
per sample in a batch, and lives on the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mpopis_tpu_torch.models.base import Env, EnvState, done_mask, make_state


@dataclasses.dataclass(frozen=True, eq=False)
class CartPoleEnv(Env):
    gravity: float = 9.8
    masscart: float = 1.0
    masspole: float = 0.1
    halflength: float = 0.5
    forcemag: float = 10.0
    max_steps: int = 200
    dt: float = 0.02
    theta_threshold: float = 12.0 * np.pi / 180.0
    x_threshold: float = 2.4

    random_reset = True
    state_dim = 4
    action_dim = 1
    action_low = np.array([-1.0])
    action_high = np.array([1.0])

    @property
    def total_mass(self) -> float:
        return self.masscart + self.masspole

    @property
    def pole_mass_length(self) -> float:
        return self.masspole * self.halflength

    def reset(self, generator: torch.Generator | None = None) -> EnvState:
        """Zeros; with a generator, each entry uniform in [−0.05, 0.05)
        drawn from it. The JAX package draws that start from `jax.random`,
        so the two packages' random starts differ."""
        if generator is None:
            x = np.zeros(4)
        else:
            x = -0.05 + 0.1 * torch.rand(4, generator=generator, dtype=torch.float64).numpy()
        return make_state(self.tensor(x))

    def step(self, state: EnvState, action: torch.Tensor) -> EnvState:
        force = action[..., 0] * self.forcemag
        x, xdot, theta, thetadot = (state.x[..., i] for i in range(4))
        costh = torch.cos(theta)
        sinth = torch.sin(theta)
        tmp = (force + self.pole_mass_length * thetadot**2 * sinth) / self.total_mass
        thetaacc = (self.gravity * sinth - costh * tmp) / (
            self.halflength * (4.0 / 3.0 - self.masspole * costh**2 / self.total_mass)
        )
        xacc = tmp - self.pole_mass_length * thetaacc * costh / self.total_mass
        x = x + self.dt * xdot
        xdot = xdot + self.dt * xacc
        theta = theta + self.dt * thetadot
        thetadot = thetadot + self.dt * thetaacc
        t = state.t + 1
        done = ((torch.abs(x) > self.x_threshold) | (torch.abs(theta) > self.theta_threshold)
                | (t > self.max_steps))
        return EnvState(x=torch.stack([x, xdot, theta, thetadot], dim=-1), t=t, done=done)

    def reward(self, state: EnvState) -> torch.Tensor:
        return (~done_mask(state)).to(self.dtype)
