from mpopis_tpu_torch.models.ant_device import AntDeviceEnv
from mpopis_tpu_torch.models.base import Env, EnvState, make_state
from mpopis_tpu_torch.models.car_racing import (
    CarParams,
    CarRacingEnv,
    car_reward,
    step_car_state,
)
from mpopis_tpu_torch.models.cheetah_device import CheetahDeviceEnv
from mpopis_tpu_torch.models.hopper_device import HopperDeviceEnv
from mpopis_tpu_torch.models.humanoid_device import HumanoidDeviceEnv
from mpopis_tpu_torch.models.humanoidstandup_device import HumanoidStandupDeviceEnv
from mpopis_tpu_torch.models.planar_contact import PlanarContactEnv, PlanarContactModel
from mpopis_tpu_torch.models.pusher_device import PusherDeviceEnv
from mpopis_tpu_torch.models.rollout import rollout_batch
from mpopis_tpu_torch.models.spatial_contact import SpatialContactEnv, SpatialContactModel
from mpopis_tpu_torch.models.swimmer_device import SwimmerDeviceEnv
from mpopis_tpu_torch.models.track import Track, distance_query
from mpopis_tpu_torch.models.walker2d_device import Walker2dDeviceEnv

__all__ = [
    "AntDeviceEnv",
    "Env",
    "EnvState",
    "make_state",
    "CarParams",
    "CarRacingEnv",
    "car_reward",
    "step_car_state",
    "CheetahDeviceEnv",
    "HopperDeviceEnv",
    "HumanoidDeviceEnv",
    "HumanoidStandupDeviceEnv",
    "Walker2dDeviceEnv",
    "PlanarContactEnv",
    "PlanarContactModel",
    "PusherDeviceEnv",
    "SpatialContactEnv",
    "SpatialContactModel",
    "SwimmerDeviceEnv",
    "rollout_batch",
    "Track",
    "distance_query",
]
