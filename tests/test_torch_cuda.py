"""The CUDA car rollout kernel against its plain PyTorch version, on the card.

Marked `cuda`; without a card every test skips. This file imports neither
jax nor the JAX package, so it runs on a machine without jax:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from mpopis_tpu_torch.kernels import car_rollout
from mpopis_tpu_torch.models import CarRacingEnv, make_state

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _controls(seed, k, t, dtype, device):
    ctrl = np.random.default_rng(seed).uniform(-1, 1, size=(t, 2, k))
    return torch.as_tensor(ctrl, dtype=dtype, device=device)


@pytest.mark.parametrize("dtype,rtol,atol", [
    (torch.float32, 2e-4, 2e-3),  # the JAX kernel tests' float32 tolerance
    (torch.float64, 1e-9, 0.0),  # same algebra as the plain version
])
def test_kernel_matches_plain_version(cuda_device, dtype, rtol, atol):
    env = CarRacingEnv(dtype=dtype, device=cuda_device)
    x0 = env.reset().x
    for k, t in ((64, 12), (150, 5)):
        ctrl = _controls(k, k, t, dtype, cuda_device)
        before = car_rollout.LAUNCHES
        got = car_rollout.car_rollout_costs_tak(env, x0, ctrl, t)
        assert car_rollout.LAUNCHES == before + 1
        want = car_rollout.car_rollout_costs_tak_reference(env, x0, ctrl, t)
        torch.cuda.synchronize()
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=rtol, atol=atol)


def test_wrapper_rejects_bad_inputs(cuda_device):
    env = CarRacingEnv(device=cuda_device)
    x0 = env.reset().x
    ctrl = torch.zeros((5, 2, 8), device=cuda_device)
    with pytest.raises(ValueError, match="shape"):
        car_rollout.car_rollout_costs_tak(env, x0, ctrl, 4)
    with pytest.raises(ValueError, match="dtype"):
        car_rollout.car_rollout_costs_tak(env, x0, ctrl.half(), 5)
    with pytest.raises(ValueError, match="state0_x"):
        car_rollout.car_rollout_costs_tak(env, make_state(torch.zeros(8)).x, ctrl, 5)
    with pytest.raises(ValueError, match="contiguous"):
        car_rollout.car_rollout_costs_tak(env, x0, ctrl.transpose(0, 2)[:5], 5)
