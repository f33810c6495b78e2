"""The port's Reacher against the JAX package in float64 on the CPU: the
copied constants, the constrained accelerations on both sides of the
joint-1 limit, one control step with gym's pre-step reward and the
observation at 1e-12 relative, a T = 5 `rollout_batch` at 1e-9, the
CEMPPI step through the `z=` hook at 1e-9, and the `mujoco --on-device`
CLI."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpopis_tpu.models import make_state as jmake_state
from mpopis_tpu.models import reacher_device as jrd
from mpopis_tpu.models import rollout_batch as jrollout_batch
from mpopis_tpu.policies import PolicyConfig as JPolicyConfig
from mpopis_tpu.policies import make_policy as jmake_policy

from mpopis_tpu_torch.harness.cli import main
from mpopis_tpu_torch.models import ReacherDeviceEnv, make_state, rollout_batch
from mpopis_tpu_torch.models import reacher_device as rd
from mpopis_tpu_torch.policies import PolicyConfig, make_policy


def _close(got, want, rtol):
    """rtol against each value, with an absolute floor of rtol × the largest."""
    want = np.asarray(want, dtype=float)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * max(np.max(np.abs(want)), 1e-300))


def _states(n=24, seed=0):
    """(n, 8) states: q1 ±π, q2 over ±3.2 (past the ±3 limit on both sides),
    rates ±5, the target in ±0.2, the stale angles near q."""
    rng = np.random.default_rng(seed)
    q = np.stack([rng.uniform(-np.pi, np.pi, n), rng.uniform(-3.2, 3.2, n)], axis=1)
    return np.concatenate([q, rng.uniform(-5, 5, (n, 2)), rng.uniform(-0.2, 0.2, (n, 2)),
                           q + rng.uniform(-0.01, 0.01, (n, 2))], axis=1)


def test_constants_match_jax():
    for name in ("_A", "_B", "_I2", "_ARMATURE", "_DAMPING", "_GEAR", "_H", "_FRAME_SKIP",
                 "_LIMIT", "_KC", "_BC", "_L1", "_L2", "_INVWEIGHT1", "_Z"):
        assert getattr(rd, name) == getattr(jrd, name), name
    env, jenv = ReacherDeviceEnv(dtype=torch.float64, device="cpu"), jrd.ReacherDeviceEnv(
        dtype=jnp.float64)
    assert (env.state_dim, env.action_dim, env.dt, env.target) == (
        jenv.state_dim, jenv.action_dim, jenv.dt, jenv.target)
    np.testing.assert_array_equal(env.action_high, jenv.action_high)
    np.testing.assert_array_equal(env.reset().x.numpy(), np.asarray(jenv.reset().x))


def test_qacc_matches_jax_on_both_sides_of_the_limit():
    rng = np.random.default_rng(1)
    n = 200
    q1, q2 = rng.uniform(-3, 3, n), rng.uniform(-3.1, 3.1, n)
    q2[:50] = rng.choice([-1.0, 1.0], 50) * (3.0 + rng.uniform(-0.002, 0.002, 50))
    v1, v2 = rng.uniform(-8, 8, n), rng.uniform(-8, 8, n)
    t1, t2 = rng.uniform(-200, 200, n), rng.uniform(-200, 200, n)
    args = [q1, q2, v1, v2, t1, t2]
    want = np.stack(jrd._qacc(*(jnp.asarray(a) for a in args)), axis=-1)
    got = np.stack([a.numpy() for a in rd._qacc(*(torch.as_tensor(a) for a in args))], axis=-1)
    _close(got, want, 1e-12)
    past = np.abs(q2) > 3.0
    assert past.any() and (~past).any()


def test_step_reward_and_observation_match_jax():
    env, jenv = ReacherDeviceEnv(dtype=torch.float64, device="cpu"), jrd.ReacherDeviceEnv(
        dtype=jnp.float64)
    x = _states()
    a = np.random.default_rng(2).uniform(-1.2, 1.2, (len(x), 2))
    jfn = jax.jit(jax.vmap(lambda xx, aa: jenv.step_reward(jmake_state(xx), aa)))
    js2, jr = jfn(jnp.asarray(x), jnp.asarray(a))
    s2, r = env.step_reward(make_state(torch.as_tensor(x)), torch.as_tensor(a))
    _close(s2.x.numpy(), js2.x, 1e-12)
    _close(r.numpy(), jr, 1e-12)
    jrew = jax.vmap(lambda xx: jenv.reward(jmake_state(xx)))
    jobs = jax.vmap(lambda xx: jenv.observation(jmake_state(xx)))
    _close(env.reward(s2).numpy(), jrew(js2.x), 1e-12)
    _close(env.observation(s2).numpy(), jobs(js2.x), 1e-12)


def test_rollout_batch_matches_jax():
    env, jenv = ReacherDeviceEnv(dtype=torch.float64, device="cpu"), jrd.ReacherDeviceEnv(
        dtype=jnp.float64)
    x0 = _states(n=1, seed=3)[0]
    ctrl = np.random.default_rng(4).uniform(-1.1, 1.1, (12, 5, 2))
    want, wstates = jrollout_batch(jenv, jmake_state(jnp.asarray(x0)), jnp.asarray(ctrl),
                                   log_states=True)
    got, states = rollout_batch(env, make_state(torch.as_tensor(x0)), torch.as_tensor(ctrl),
                                log_states=True)
    _close(got.numpy(), want, 1e-9)
    _close(states.numpy(), wstates, 1e-9)


def test_cemppi_step_matches_jax():
    """Two chained control steps at the JAX test's CEMPPI settings (λ = 0.05,
    Σ = 0.02·I, `mle`), K = 16, H = 4, 2 AIS iterations, the same normals."""
    k, h, its = 16, 4, 2
    kw = dict(kind="cemppi", num_samples=k, horizon=h, lam=0.05, opt_its=its, sigma_est="mle")
    jenv = jrd.ReacherDeviceEnv(dtype=jnp.float64)
    env = ReacherDeviceEnv(dtype=torch.float64, device="cpu")
    jpol = jmake_policy(jenv, JPolicyConfig(**kw), cov_mat=[0.02, 0.02])
    pol = make_policy(env, PolicyConfig(**kw), cov_mat=[0.02, 0.02])
    js, jps = jenv.reset(), jpol.init_state(0)
    s, ps = env.reset(), pol.init_state(0)
    rng = np.random.default_rng(5)
    for _ in range(2):
        z = rng.standard_normal((its, 2 * h, k))
        ja, jps, jinfo = jpol.step(js, jps, z=jnp.asarray(z))
        a, ps, info = pol.step(s, ps, z=torch.as_tensor(z))
        _close(a.numpy(), ja, 1e-9)
        _close(ps.U.numpy(), jps.U, 1e-9)
        _close(info["costs"].numpy(), jinfo["costs"], 1e-9)
        _close(info["weights"].numpy(), jinfo["weights"], 1e-9)
        js, s = jenv.step(js, ja), env.step(s, a)
    _close(s.x.numpy(), js.x, 1e-9)


@pytest.mark.parametrize("steps_per_call", ["1", "3"])
def test_cli_mujoco_on_device_runs_the_reacher(capsys, steps_per_call):
    rc = main(["mujoco", "--on-device", "--env-name", "Reacher-v4", "--device", "cpu",
               "--samples", "8", "--horizon", "3", "--ais-its", "2", "--steps", "4", "--seed",
               "3", "--lam", "0.05", "--ce-sigma-est", "mle", "--f64",
               "--steps-per-call", steps_per_call])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Reacher-v4 (on-device)" in out
    row = next(line for line in out.splitlines() if line.startswith("Trial    1:"))
    assert int(row.split(":")[2]) == 4 and float(row.split(":")[1]) < 0.0
