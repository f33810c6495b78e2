"""Multi-car racing: N cars under one policy, an 8N-dim state and a 2N-dim
action, batched over the car axis as one (..., N, 8) tensor.

Counterpart of `mpopis_tpu/models/multi_car.py`. The joint reward is the
sum of the cars' rewards, minus every pairwise distance, minus 11000 for
each pair within 4 m. The reset staggers the cars along x. The class
reuses the one-car environment's track and kernel entry points: the
rollout kernel (`kernels/car_rollout.py`) takes 1..4 cars.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mpopis_tpu_torch.models.base import EnvState, make_state
from mpopis_tpu_torch.models.car_racing import CarRacingEnv, car_reward, step_car_state
from mpopis_tpu_torch.models.track import distance_query

COLLISION_PENALTY, COLLISION_DIST = 11000.0, 4.0


@dataclasses.dataclass(frozen=True, eq=False)
class MultiCarRacingEnv(CarRacingEnv):
    num_cars: int = 2

    def __post_init__(self):
        super().__post_init__()
        object.__setattr__(self, "action_low", np.tile([-1.0, -1.0], self.num_cars))
        object.__setattr__(self, "action_high", np.tile([1.0, 1.0], self.num_cars))

    @property
    def state_dim(self) -> int:
        return 8 * self.num_cars

    @property
    def action_dim(self) -> int:
        return 2 * self.num_cars

    def reset(self) -> EnvState:
        """Each car at Ψ = 90°, Vx = 10; car i (1-based) at x = 5·i/2 for
        even i and 5·(1 − i)/2 for odd i."""
        n = self.num_cars
        cars = np.zeros((n, 8))
        cars[:, 2] = np.deg2rad(90.0)
        cars[:, 3] = 10.0
        for i in range(2, n + 1):
            cars[i - 1, 0] = (i / 2) * 5.0 if i % 2 == 0 else ((1 - i) / 2) * 5.0
        return make_state(self.tensor(cars.reshape(-1)))

    def _cars(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape(*x.shape[:-1], self.num_cars, 8)

    def step(self, state: EnvState, action: torch.Tensor) -> EnvState:
        acts = action.reshape(*action.shape[:-1], self.num_cars, 2)
        stepped = step_car_state(self.params, self._cars(state.x), acts, self.dt, self.ddt)
        return EnvState(x=stepped.reshape(state.x.shape), t=state.t + 1, done=state.done)

    def reward(self, state: EnvState) -> torch.Tensor:
        cars = self._cars(state.x)
        rew = torch.sum(car_reward(self.params, self.pts, self.widths, cars), dim=-1)
        pos = cars[..., :2]
        diff = pos[..., :, None, :] - pos[..., None, :, :]
        dists = torch.sqrt(torch.sum(diff * diff, dim=-1) + 1e-30)
        iu = torch.triu_indices(self.num_cars, self.num_cars, offset=1, device=pos.device)
        pair = dists[..., iu[0], iu[1]]
        rew = rew - torch.sum(pair, dim=-1)
        return rew - COLLISION_PENALTY * torch.sum(pair <= COLLISION_DIST, dim=-1).to(rew.dtype)

    def within_track(self, state: EnvState):
        """(every car within the track, each car's centerline distance (..., N))."""
        w, d = distance_query(self.pts, self.widths, self._cars(state.x)[..., :2])
        return torch.all(w, dim=-1), d

    def betas(self, state: EnvState) -> torch.Tensor:
        cars = self._cars(state.x)
        return torch.atan2(cars[..., 4], cars[..., 3])

    def exceed_beta(self, state: EnvState) -> torch.Tensor:
        return torch.any(torch.abs(self.betas(state)) > self.params.beta_limit, dim=-1)
