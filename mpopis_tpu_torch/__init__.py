"""mpopis_tpu_torch — the PyTorch + CUDA port of `mpopis_tpu`.

The JAX package `mpopis_tpu` is the reference; this package mirrors its
layout (models/, ops/, policies/, kernels/, harness/, utils/) so each
module's counterpart is found by name. It imports torch and numpy and
never jax. The hot rollout of the car-racing main path is a hand-written
CUDA kernel (`csrc/car_rollout.cu`), built with nvcc at first use; on CPU
tensors every kernel wrapper runs its plain PyTorch version instead.

Ported: every environment and policy kind of the JAX package, its
harness and CLI, the host MuJoCo engine, plots and gifs, checkpoints and
phase timers. Not yet: the sample axis over several GPUs (`car --sharded`).
"""

from mpopis_tpu_torch.models import CarParams, CarRacingEnv, Env, EnvState, Track
from mpopis_tpu_torch.policies import Policy, PolicyConfig, PolicyState, make_policy

__version__ = "0.1.0"

__all__ = [
    "CarParams",
    "CarRacingEnv",
    "Env",
    "EnvState",
    "Track",
    "Policy",
    "PolicyConfig",
    "PolicyState",
    "make_policy",
]
