"""The car rollout kernel module on the CPU: its plain version against the
JAX package's Pallas kernel (interpret mode) and vmap rollout, and the
wrapper's CPU path. The CUDA kernel itself is held against the plain
version on the card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpopis_tpu.kernels import car_rollout as jcr
from mpopis_tpu.models import CarRacingEnv as JCarRacingEnv
from mpopis_tpu.models import MultiCarRacingEnv as JMultiCarRacingEnv
from mpopis_tpu.models import rollout_batch as jrollout_batch

from mpopis_tpu_torch.kernels import car_rollout
from mpopis_tpu_torch.models import CarRacingEnv, rollout_batch


class _ThreeCars(CarRacingEnv):
    """The car environment seen by the kernel as three jointly controlled cars."""

    num_cars = 3


def _controls(seed, k, t, na=2, dtype=np.float32):
    return np.random.default_rng(seed).uniform(-1, 1, size=(t, na, k)).astype(dtype)


@pytest.mark.parametrize("k,t", [(64, 12), (150, 5)])
def test_plain_version_matches_jax_kernel_f32(k, t):
    """Tolerance: rtol 2e-4 / atol 2e-3, the JAX kernel tests' own (the JAX
    kernel computes the same physics through other algebra in float32)."""
    ctrl = _controls(k, k, t)
    jenv = JCarRacingEnv(dtype=jnp.float32)
    want = jcr.car_rollout_costs_tak(
        jenv, jenv.reset().x, jnp.asarray(ctrl), t, interpret=True
    )
    env = CarRacingEnv(dtype=torch.float32, device="cpu")
    got = car_rollout.car_rollout_costs_tak_reference(
        env, env.reset().x, torch.as_tensor(ctrl), t
    )
    assert got.shape == (k,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-3)


def test_plain_version_three_cars_matches_jax_kernel_f32():
    """Three cars, joint pairwise and collision terms: atol 2e-2, as in the
    JAX package's multi-car kernel test."""
    ctrl = _controls(7, 40, 6, na=6)
    jenv = JMultiCarRacingEnv(num_cars=3, dtype=jnp.float32)
    x0 = jenv.reset().x
    want = jcr.car_rollout_costs_tak(jenv, x0, jnp.asarray(ctrl), 6, interpret=True)
    env = _ThreeCars(dtype=torch.float32, device="cpu")
    got = car_rollout.car_rollout_costs_tak_reference(
        env, torch.as_tensor(np.array(x0)), torch.as_tensor(ctrl), 6
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-2)


def test_plain_version_matches_jax_rollout_f64():
    ctrl = _controls(3, 64, 12, dtype=np.float64)
    jenv = JCarRacingEnv(dtype=jnp.float64)
    want, _ = jrollout_batch(jenv, jenv.reset(), jnp.asarray(ctrl.transpose(2, 0, 1)))
    env = CarRacingEnv(dtype=torch.float64, device="cpu")
    got = car_rollout.car_rollout_costs_tak_reference(
        env, env.reset().x, torch.as_tensor(ctrl), 12
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10)
    # and the port's own batched rollout agrees with both
    mine, states = rollout_batch(
        env, env.reset(), torch.as_tensor(ctrl.transpose(2, 0, 1)), log_states=True
    )
    np.testing.assert_allclose(mine.numpy(), np.asarray(want), rtol=1e-10)
    assert states.shape == (64, 12, 8)


def test_wrapper_on_cpu_runs_the_plain_version_without_launching():
    before = car_rollout.LAUNCHES
    env = CarRacingEnv(dtype=torch.float64, device="cpu")
    ctrl = torch.as_tensor(_controls(4, 33, 4, dtype=np.float64))
    got = car_rollout.car_rollout_costs_tak(env, env.reset().x, ctrl, 4)
    want = car_rollout.car_rollout_costs_tak_reference(env, env.reset().x, ctrl, 4)
    assert torch.equal(got, want)
    via_env = env.fused_rollout_costs_tak(env.reset(), ctrl)
    assert torch.equal(via_env, want)
    assert car_rollout.LAUNCHES == before == 0


def test_kernel_params_follow_the_struct_order():
    env = CarRacingEnv(device="cpu")
    vals = list(car_rollout._kernel_params(env))
    p = env.params
    assert len(vals) == 27
    assert vals[:3] == [p.m, p.i_zz, p.h_cm] and vals[17:20] == [p.beta_limit, 0.1, 0.01]
    assert vals[20] == p.l_r + p.l_f and vals[26] == p.c_ar**3
