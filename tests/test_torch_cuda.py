"""The CUDA kernels (car rollout, planar-contact rollout and control step)
against their plain PyTorch versions, on the card.

Marked `cuda`; without a card every test skips. This file imports neither
jax nor the JAX package, so it runs on a machine without jax:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from mpopis_tpu_torch.kernels import car_rollout, planar_step
from mpopis_tpu_torch.models import (
    CarRacingEnv,
    CheetahDeviceEnv,
    HopperDeviceEnv,
    Walker2dDeviceEnv,
    make_state,
)

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


PLANAR = {"cheetah": CheetahDeviceEnv, "hopper": HopperDeviceEnv, "walker2d": Walker2dDeviceEnv}
LOWERED = {"cheetah": -0.35, "hopper": 1.15, "walker2d": 1.17}  # x[1]: contacts fire at once


@pytest.mark.parametrize("name", sorted(PLANAR))
@pytest.mark.parametrize("dtype,rtol,atol", [
    (torch.float32, 2e-4, 2e-4),  # the JAX kernel tests' float32 tolerance from reset
    (torch.float64, 1e-9, 0.0),  # from reset no contact switches: the algebra agrees
])
def test_planar_kernel_matches_plain_version(cuda_device, name, dtype, rtol, atol):
    env = PLANAR[name](dtype=dtype, device=cuda_device)
    x0 = env.reset().x
    ctrl = torch.as_tensor(np.random.default_rng(64).uniform(-1, 1, (3, env.action_dim, 64)),
                           dtype=dtype, device=cuda_device)
    before = planar_step.LAUNCHES
    got = env.fused_rollout_costs_tak(make_state(x0), ctrl)
    assert planar_step.LAUNCHES == before + 1
    want = planar_step.planar_rollout_costs_tak_reference(env, x0, ctrl)
    assert planar_step.LAUNCHES == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", sorted(PLANAR))
def test_planar_kernel_matches_plain_version_in_contact(cuda_device, name):
    """The JAX package's contact kernel test (K=5, T=4, controls from seed 7,
    solver (2, 6), rtol 2e-4 / atol 2e-3), from a lowered start."""
    env = PLANAR[name](dtype=torch.float32, device=cuda_device, solver_outer=2, solver_cg=6)
    x0 = env.reset().x.clone()
    x0[1] = LOWERED[name]
    assert planar_step.first_substep_active_rows(env, x0)[1] > 0
    ctrl = torch.as_tensor(np.random.default_rng(7).uniform(-1, 1, (5, 4, env.action_dim)),
                           dtype=torch.float32, device=cuda_device).permute(1, 2, 0).contiguous()
    got = planar_step.planar_rollout_costs_tak(env, x0, ctrl)
    want = planar_step.planar_rollout_costs_tak_reference(env, x0, ctrl)
    assert bool(torch.all(torch.isfinite(got)))
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=2e-4, atol=2e-3)


@pytest.mark.parametrize("name", sorted(PLANAR))
def test_planar_step_kernel_matches_plain_step(cuda_device, name):
    env = PLANAR[name](dtype=torch.float64, device=cuda_device)
    rng = np.random.default_rng(3)
    xs = env.reset().x + torch.as_tensor(rng.uniform(-0.01, 0.01, (32, env.state_dim)),
                                         device=cuda_device)
    acts = torch.as_tensor(rng.uniform(-1, 1, (32, env.action_dim)), device=cuda_device)
    before = planar_step.STEP_LAUNCHES
    got = env.step(make_state(xs), acts)
    assert planar_step.STEP_LAUNCHES == before + 1 and got.t == 1
    want = env.plain_step(make_state(xs), acts).x
    assert planar_step.STEP_LAUNCHES == before + 1
    np.testing.assert_allclose(got.x.cpu().numpy(), want.cpu().numpy(), rtol=1e-9, atol=1e-12)


def test_planar_wrappers_reject_bad_inputs(cuda_device):
    env = CheetahDeviceEnv(device=cuda_device)
    x0 = env.reset().x
    ctrl = torch.zeros((4, 6, 8), device=cuda_device)
    before = (planar_step.LAUNCHES, planar_step.STEP_LAUNCHES)
    with pytest.raises(ValueError, match="controls shape"):
        planar_step.planar_rollout_costs_tak(env, x0, ctrl[:, :3])
    with pytest.raises(ValueError, match="dtype"):
        planar_step.planar_rollout_costs_tak(env, x0.half(), ctrl.half())
    with pytest.raises(ValueError, match="state0_x"):
        planar_step.planar_rollout_costs_tak(env, x0[:9].contiguous(), ctrl)
    with pytest.raises(ValueError, match="state0_x"):
        planar_step.planar_rollout_costs_tak(env, x0.double(), ctrl)
    with pytest.raises(ValueError, match="contiguous"):
        planar_step.planar_rollout_costs_tak(env, x0, ctrl[:, :, ::2])
    with pytest.raises(ValueError, match="states"):
        planar_step.planar_step_states(env, x0[None], torch.zeros((1, 3), device=cuda_device))
    with pytest.raises(ValueError, match="actions"):
        planar_step.planar_step_states(env, x0[None], torch.zeros((1, 6), device=cuda_device,
                                                                  dtype=torch.float64))
    assert (planar_step.LAUNCHES, planar_step.STEP_LAUNCHES) == before
