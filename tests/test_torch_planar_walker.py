"""Walker2d's control steps and rollout costs in the port's plain PyTorch
version against the JAX package's `rollout_batch` over `step_reward` in
float64 on the CPU (HalfCheetah's and Hopper's are in
tests/test_torch_planar_kernel.py; the JAX compile of each model's rollout
takes 30-70 s, so the three sit in two files that test workers run side by
side)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpopis_tpu.models import Walker2dDeviceEnv as JWalker2dDeviceEnv
from mpopis_tpu.models.rollout import rollout_batch as jrollout_batch

from mpopis_tpu_torch.kernels.planar_step import planar_rollout_costs_tak_reference
from mpopis_tpu_torch.models import Walker2dDeviceEnv
from mpopis_tpu_torch.models.base import make_state


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions are thousands of tiny ops: one thread each keeps
    test processes that run side by side from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rtol):
    """rtol against each value, with an absolute floor of rtol × the largest."""
    want = np.asarray(want, dtype=float)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * max(np.max(np.abs(want)), 1e-300))


@pytest.fixture(scope="module")
def walker_rollout():
    """The JAX Walker2d rollout over 3 control steps (K=6), jitted once, from
    the reset state with gym's reset noise (±5e-3): the knee limits are
    active, the feet not yet down. In contact, Walker2d's truncated QP is
    sensitive to rounding: x0·(1 + 1e-15) moves the JAX package's own
    3-step costs by up to 8e-8 (relative) from a lowered start, so contact
    steps are pinned by the substep tests above."""
    k, t = 6, 3
    rng = np.random.default_rng(8)
    controls = rng.uniform(-1.0, 1.0, (k, t, 6))
    x0 = np.concatenate([[0.0, 1.25], np.zeros(7), np.zeros(9)]) + rng.uniform(-5e-3, 5e-3, 18)
    jenv = JWalker2dDeviceEnv(dtype=jnp.float64)
    costs, states = jax.jit(lambda x, c: jrollout_batch(jenv, jenv.reset().replace(x=x), c,
                                                        log_states=True))(
        jnp.asarray(x0), jnp.asarray(controls))
    return x0, controls, np.asarray(costs), np.asarray(states)


def test_walker_control_steps_match_jax(walker_rollout):
    x0, controls, _, states = walker_rollout
    env = Walker2dDeviceEnv(dtype=torch.float64, device="cpu")
    s = make_state(torch.as_tensor(x0).expand(controls.shape[0], -1))
    for t in range(controls.shape[1]):
        s, r = env.step_reward(s, torch.as_tensor(controls[:, t]))
        _close(s.x.numpy(), states[:, t], 1e-10)
        x_prev = x0[0] if t == 0 else states[:, t - 1, 0]
        want_r = 1.0 + (states[:, t, 0] - x_prev) / env.dt - 1e-3 * np.sum(controls[:, t] ** 2, -1)
        # a difference of positions over dt: the state's absolute floor / dt
        np.testing.assert_allclose(r.numpy(), want_r, rtol=1e-10,
                                   atol=2e-10 * np.abs(states[:, t]).max() / env.dt)
    assert s.t == controls.shape[1]


def test_walker_rollout_costs_match_jax(walker_rollout):
    x0, controls, costs, _ = walker_rollout
    env = Walker2dDeviceEnv(dtype=torch.float64, device="cpu")
    got = planar_rollout_costs_tak_reference(
        env, torch.as_tensor(x0), torch.as_tensor(controls.transpose(1, 2, 0)))
    np.testing.assert_allclose(got.numpy(), costs, rtol=1e-10)
