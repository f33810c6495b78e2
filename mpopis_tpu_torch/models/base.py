"""Environment (dynamics model) protocol.

Counterpart of `mpopis_tpu/models/base.py`: an environment is an immutable
parameter object with functions over an explicit `EnvState` value. The
state vector may carry leading batch dimensions — `x` of shape (..., n) —
so K candidate rollouts step as one (K, n) tensor instead of a vmap.
"""

from __future__ import annotations

import dataclasses

import torch

from mpopis_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class EnvState:
    """Value-type environment state: the flat state vector `x` (..., n),
    the step counter `t` and the termination flag `done`. `done` is a
    Python bool for the environments that never end, and a bool tensor (...)
    on x's device for those that compute it from the state each step
    (MountainCar, CartPole), so a batch of rollouts ends per sample and
    nothing is read back to the host to know it."""

    x: torch.Tensor
    t: int = 0
    done: bool | torch.Tensor = False

    def replace(self, **changes) -> "EnvState":
        return dataclasses.replace(self, **changes)


def make_state(x, t: int = 0, done: bool = False) -> EnvState:
    return EnvState(x=torch.as_tensor(x), t=int(t), done=bool(done))


def done_mask(state: EnvState) -> torch.Tensor:
    """`state.done` as a bool tensor of x's batch shape on x's device (a
    Python bool is filled in on the device, never copied from the host)."""
    if isinstance(state.done, torch.Tensor):
        return state.done
    return torch.full(state.x.shape[:-1], bool(state.done), device=state.x.device)


@dataclasses.dataclass(frozen=True, eq=False)
class Env:
    """Base environment. Subclasses define physics params as dataclass
    fields and implement `reset`, `step`, `reward`. An environment lives on
    the card unless the caller asks for the CPU (`device="cpu"`).

    Required class-level attributes on subclasses: state_dim, action_dim,
    action_low, action_high ((action_dim,) numpy arrays).
    """

    dtype: torch.dtype = torch.float32
    device: torch.device | str = "cuda"
    # True where `reset(generator)` draws a random start from a torch.Generator
    random_reset = False

    def reset(self) -> EnvState:
        raise NotImplementedError

    def step(self, state: EnvState, action: torch.Tensor) -> EnvState:
        raise NotImplementedError

    def reward(self, state: EnvState) -> torch.Tensor:
        raise NotImplementedError

    def step_reward(self, state: EnvState, action: torch.Tensor):
        """Step + the reward the driver accounts for this action: the
        post-step reward(s') by default."""
        with span("mpopis.env_step"):
            s2 = self.step(state, action)
            return s2, self.reward(s2)

    def tensor(self, a) -> torch.Tensor:
        """`a` as a tensor of this environment's dtype on its device."""
        return torch.as_tensor(a, dtype=self.dtype, device=self.device)

    @property
    def control_bounds(self):
        """(low, high) each (action_dim,) for candidate-control clamping."""
        return self.tensor(self.action_low), self.tensor(self.action_high)
