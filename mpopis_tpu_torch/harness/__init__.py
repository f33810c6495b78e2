"""Experiment drivers and the CLI (`python -m mpopis_tpu_torch car ...`)."""

from mpopis_tpu_torch.harness.factory import get_policy
from mpopis_tpu_torch.harness.simulate import (
    simulate_car_racing,
    simulate_cartpole,
    simulate_mountaincar,
)
from mpopis_tpu_torch.harness.simulate_mujoco import simulate_mujoco
from mpopis_tpu_torch.harness.stats import quantile_ci

__all__ = [
    "get_policy",
    "simulate_car_racing",
    "simulate_cartpole",
    "simulate_mountaincar",
    "simulate_mujoco",
    "quantile_ci",
]
