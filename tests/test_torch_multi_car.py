"""The port's MultiCarRacingEnv against the JAX package's on the CPU: the
staggered reset, the joint step, the reward with its pairwise distance and
collision terms, `within_track`, `betas` and `exceed_beta` at 2-4 cars in
float64; the rollout kernel's plain version at 2 and 4 cars against the
JAX Pallas kernel in interpret mode (float32, the JAX multi-car kernel
test's tolerance) and at 3 cars against the JAX vmap rollout (float64);
and the CEMPPI step at 3 cars through the `z=` hook."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpopis_tpu.kernels import car_rollout as jcr
from mpopis_tpu.models import MultiCarRacingEnv as JMultiCarRacingEnv
from mpopis_tpu.models import make_state as jmake_state
from mpopis_tpu.models import rollout_batch as jrollout_batch
from mpopis_tpu.policies import PolicyConfig as JPolicyConfig
from mpopis_tpu.policies import make_policy as jmake_policy

from mpopis_tpu_torch.kernels import car_rollout
from mpopis_tpu_torch.models import MultiCarRacingEnv, make_state
from mpopis_tpu_torch.policies import PolicyConfig, make_policy


def _envs(n, dtype=torch.float64):
    jdtype = jnp.float64 if dtype == torch.float64 else jnp.float32
    return (MultiCarRacingEnv(num_cars=n, dtype=dtype, device="cpu"),
            JMultiCarRacingEnv(num_cars=n, dtype=jdtype))


def _states(n, b=32, seed=0):
    """(b, 8n) joint states: the cars within 40 m of the start, a quarter of
    them within 4 m of each other, some off the track, some sliding past the
    sideslip limit."""
    rng = np.random.default_rng(seed)
    cars = np.zeros((b, n, 8))
    cars[..., 0] = rng.uniform(-40, 40, (b, n))
    cars[..., 1] = rng.uniform(-20, 20, (b, n))
    cars[: b // 4, :, :2] = rng.uniform(-1.5, 1.5, (b // 4, n, 2))  # close pairs
    cars[..., 2] = rng.uniform(0, 2 * np.pi, (b, n))
    cars[..., 3] = rng.uniform(0.5, 20, (b, n))
    cars[..., 4] = rng.uniform(-3, 3, (b, n))
    cars[b // 2 :, :, 4] = rng.uniform(-15, 15, (b - b // 2, n))
    cars[..., 5] = rng.uniform(-1, 1, (b, n))
    cars[..., 6] = rng.uniform(-0.3, 0.3, (b, n))
    cars[..., 7] = rng.uniform(-1, 1, (b, n))
    return cars.reshape(b, 8 * n)


@pytest.mark.parametrize("n", [2, 3, 4])
def test_reset_and_shapes_match_jax(n):
    env, jenv = _envs(n)
    np.testing.assert_array_equal(env.reset().x.numpy(), np.asarray(jenv.reset().x))
    assert (env.state_dim, env.action_dim) == (jenv.state_dim, jenv.action_dim) == (8 * n, 2 * n)
    np.testing.assert_array_equal(env.action_low, jenv.action_low)
    np.testing.assert_array_equal(env.action_high, jenv.action_high)
    assert (env.dt, env.ddt, env.track_name, env.track_width) == (
        jenv.dt, jenv.ddt, jenv.track_name, jenv.track_width)


@pytest.mark.parametrize("n", [2, 3, 4])
def test_step_reward_and_track_queries_match_jax(n):
    env, jenv = _envs(n)
    x = _states(n, seed=n)
    a = np.random.default_rng(10 + n).uniform(-1, 1, (len(x), 2 * n))
    jx2 = jax.vmap(lambda xx, aa: jenv.step(jmake_state(xx), aa).x)(jnp.asarray(x), jnp.asarray(a))
    s2 = env.step(make_state(torch.as_tensor(x)), torch.as_tensor(a))
    np.testing.assert_allclose(s2.x.numpy(), np.asarray(jx2), rtol=1e-12, atol=1e-12)
    for xs in (x, np.array(jx2)):
        js = jax.vmap(jmake_state)(jnp.asarray(xs))
        s = make_state(torch.as_tensor(xs))
        want = np.asarray(jax.vmap(jenv.reward)(js))
        np.testing.assert_allclose(env.reward(s).numpy(), want, rtol=1e-12, atol=1e-9)
        jw, jd = jax.vmap(jenv.within_track)(js)
        w, d = env.within_track(s)
        np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
        np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(env.betas(s).numpy(), np.asarray(jax.vmap(jenv.betas)(js)),
                                   rtol=1e-12, atol=1e-15)
        np.testing.assert_array_equal(env.exceed_beta(s).numpy(),
                                      np.asarray(jax.vmap(jenv.exceed_beta)(js)))
    # the states reach the collision term, the track and the sideslip limit
    s = make_state(torch.as_tensor(x))
    cars = x.reshape(len(x), n, 8)
    gap = np.linalg.norm(cars[:, 0, :2] - cars[:, 1, :2], axis=-1)
    assert (gap <= 4.0).any() and (gap > 4.0).any()
    w, _ = env.within_track(s)
    assert w.any() and (~w).any() and env.exceed_beta(s).any() and (~env.exceed_beta(s)).any()


@pytest.mark.parametrize("n", [2, 4])
def test_plain_rollout_matches_jax_kernel_f32(n):
    """The kernel's plain version against the JAX Pallas kernel (interpret
    mode) from the real reset: rtol 2e-4, atol 2e-2, the JAX multi-car
    kernel test's tolerance."""
    env, jenv = _envs(n, torch.float32)
    ctrl = np.random.default_rng(n).uniform(-1, 1, size=(6, 2 * n, 40)).astype(np.float32)
    want = jcr.car_rollout_costs_tak(jenv, jenv.reset().x, jnp.asarray(ctrl), 6, interpret=True)
    got = car_rollout.car_rollout_costs_tak_reference(env, env.reset().x, torch.as_tensor(ctrl), 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-2)


def test_plain_rollout_and_wrapper_match_jax_rollout_f64():
    """Three cars: the kernel's plain version, and the wrapper on CPU tensors
    (no launch), against the JAX vmap rollout of the same env."""
    env, jenv = _envs(3)
    ctrl = np.random.default_rng(3).uniform(-1, 1, size=(12, 6, 48))
    want, _ = jrollout_batch(jenv, jenv.reset(), jnp.asarray(ctrl.transpose(2, 0, 1)))
    before = car_rollout.LAUNCHES
    got = env.fused_rollout_costs_tak(env.reset(), torch.as_tensor(ctrl))
    assert car_rollout.LAUNCHES == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10)
    via_kt = env.fused_rollout_costs(env.reset(), torch.as_tensor(ctrl.transpose(2, 0, 1)))
    assert torch.equal(via_kt, got)


def test_cemppi_step_at_three_cars_matches_jax():
    """Two chained control steps, 2 AIS iterations of K = 16 rollouts through
    the kernel's plain version (the JAX vmap rollout on its side)."""
    k, h, its = 16, 4, 2
    kw = dict(kind="cemppi", num_samples=k, horizon=h, lam=10.0, opt_its=its, sigma_est="ss")
    env, jenv = _envs(3)
    cov = np.diag([0.0625, 0.1] * 3)
    jpol = jmake_policy(jenv, JPolicyConfig(**kw), cov_mat=cov)
    pol = make_policy(env, PolicyConfig(**kw), cov_mat=cov)
    js, jps = jenv.reset(), jpol.init_state(0)
    s, ps = env.reset(), pol.init_state(0)
    rng = np.random.default_rng(7)
    for _ in range(2):
        z = rng.standard_normal((its, 6 * h, k))
        ja, jps, jinfo = jpol.step(js, jps, z=jnp.asarray(z))
        a, ps, info = pol.step(s, ps, z=torch.as_tensor(z))
        np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(ps.U.numpy(), np.asarray(jps.U), rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(info["costs"].numpy(), np.asarray(jinfo["costs"]), rtol=1e-9)
        js, s = jenv.step(js, ja), env.step(s, a)
    np.testing.assert_allclose(s.x.numpy(), np.asarray(js.x), rtol=1e-9)
