from mpopis_tpu_torch.models.base import Env, EnvState, make_state
from mpopis_tpu_torch.models.car_racing import (
    CarParams,
    CarRacingEnv,
    car_reward,
    step_car_state,
)
from mpopis_tpu_torch.models.rollout import rollout_batch
from mpopis_tpu_torch.models.track import Track, distance_query

__all__ = [
    "Env",
    "EnvState",
    "make_state",
    "CarParams",
    "CarRacingEnv",
    "car_reward",
    "step_car_state",
    "rollout_batch",
    "Track",
    "distance_query",
]
