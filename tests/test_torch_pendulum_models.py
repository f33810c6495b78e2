"""The port's planar builder and its two pendulums against the JAX package in
float64 on the CPU: the copied constants, the mass matrix, bias and
constrained accelerations (`qacc` with `qfrc_constraint`) on both sides of
every limit at 1e-12 relative, one control step with its reward and
observation at 1e-12, a T = 5 `rollout_batch` at 1e-9, the CEMPPI step
through the `z=` hook at 1e-9, and `simulate_mujoco_on_device` on each."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpopis_tpu.models import make_state as jmake_state
from mpopis_tpu.models import pendulum_device as jpd
from mpopis_tpu.models import planar as jplanar
from mpopis_tpu.models import rollout_batch as jrollout_batch
from mpopis_tpu.policies import PolicyConfig as JPolicyConfig
from mpopis_tpu.policies import make_policy as jmake_policy

from mpopis_tpu_torch.harness import simulate
from mpopis_tpu_torch.models import (
    InvertedDoublePendulumDeviceEnv,
    InvertedPendulumDeviceEnv,
    make_state,
    rollout_batch,
)
from mpopis_tpu_torch.models import pendulum_device as pd
from mpopis_tpu_torch.models import planar
from mpopis_tpu_torch.policies import PolicyConfig, make_policy

ENVS = {
    "ip": (InvertedPendulumDeviceEnv, jpd.InvertedPendulumDeviceEnv),
    "idp": (InvertedDoublePendulumDeviceEnv, jpd.InvertedDoublePendulumDeviceEnv),
}
QACC = {"ip": (pd._IP_QACC, jpd._IP_QACC, 2), "idp": (pd._IDP_QACC, jpd._IDP_QACC, 3)}


def _close(got, want, rtol):
    """rtol against each value, with an absolute floor of rtol × the largest."""
    want = np.asarray(want, dtype=float)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * max(np.max(np.abs(want)), 1e-300))


def _limit_states(n_dof, n=240, seed=0):
    """(q, qv, tau): q spread over ±1.8 (past the slide's ±1 and the IP
    hinge's ±π/2 on both sides), a quarter of the rows pinned just inside
    or outside one limit, and a quarter with the first two dofs both past
    theirs."""
    rng = np.random.default_rng(seed)
    q = rng.uniform(-1.8, 1.8, (n, n_dof))
    q[: n // 4, 0] = rng.choice([-1.0, 1.0], n // 4) * (1.0 + rng.uniform(-0.02, 0.02, n // 4))
    q[n // 4 : n // 2, 0] = rng.choice([-1.2, 1.2], n // 4)
    q[n // 4 : n // 2, 1] = rng.choice([-1.7, 1.7], n // 4)
    qv = rng.uniform(-3.0, 3.0, (n, n_dof))
    tau = rng.uniform(-300.0, 300.0, (n, n_dof))
    return q, qv, tau


def test_constants_match_jax():
    for name in ("_G", "_IP_M_CART", "_IP_M_POLE", "_IP_I_POLE", "_IP_COM", "_IP_DAMPING",
                 "_IP_GEAR", "_IP_CTRL", "_IP_H", "_IP_SKIP", "_IP_INVWEIGHT", "_IDP_M_CART",
                 "_IDP_M_POLE", "_IDP_I_POLE", "_IDP_COM_Z", "_IDP_LINK", "_IDP_DAMPING",
                 "_IDP_GEAR", "_IDP_H", "_IDP_SKIP", "_IDP_GX", "_IDP_INVWEIGHT_SLIDE",
                 "_IDP_MARGIN"):
        assert getattr(pd, name) == getattr(jpd, name), name
    for ours, theirs in ENVS.values():
        env, jenv = ours(device="cpu"), theirs(dtype=jnp.float64)
        assert (env.state_dim, env.action_dim, env.dt) == (jenv.state_dim, jenv.action_dim,
                                                           jenv.dt)
        np.testing.assert_array_equal(env.action_low, jenv.action_low)
        np.testing.assert_array_equal(env.action_high, jenv.action_high)
    assert (planar._D0, planar._DMAX, planar._WIDTH, planar._MID, planar._SOLREF_TC) == (
        jplanar._D0, jplanar._DMAX, jplanar._WIDTH, jplanar._MID, jplanar._SOLREF_TC)
    # the timeconst clamp: h = 0.02 doubles the timeconst, h = 0.01 keeps 0.02
    assert planar._kb(pd._IP_H) == jplanar._kb(jpd._IP_H) != planar._kb(pd._IDP_H)


@pytest.mark.parametrize("name,kin,jkin,n_dof", [
    ("ip", pd.IP_KIN, jpd._ip_kin, 2), ("idp", pd.IDP_KIN, jpd._idp_kin, 3),
])
def test_kinematics_table_gives_the_jax_outputs(name, kin, jkin, n_dof):
    q, _, _ = _limit_states(n_dof, n=32, seed=1)
    want = np.stack(jax.vmap(lambda v: jkin(tuple(v)))(jnp.asarray(q)), axis=-1)
    _close(kin(torch.as_tensor(q)).numpy(), want, 1e-14)


@pytest.mark.parametrize("name", ["ip", "idp"])
def test_mass_matrix_matches_jax(name):
    n_dof = QACC[name][2]
    q, _, _ = _limit_states(n_dof, n=32, seed=2)
    jmass = {"ip": jpd._ip_mass, "idp": jpd._idp_mass}[name]
    mass = {"ip": pd._ip_mass, "idp": pd._idp_mass}[name]
    got = mass(torch.as_tensor(q)).numpy()
    for b in range(len(q)):
        m = jmass(tuple(jnp.asarray(q[b])))
        for i in range(n_dof):
            for j in range(i + 1):
                _close(got[b, i, j], m[i][j], 1e-13)
                _close(got[b, j, i], m[i][j], 1e-13)


@pytest.mark.parametrize("name", ["ip", "idp"])
def test_qacc_and_constraint_force_match_jax_on_both_sides_of_every_limit(name):
    ours, theirs, n_dof = QACC[name]
    q, qv, tau = _limit_states(n_dof)
    acc, frc = jax.vmap(lambda a, b, c: theirs(tuple(a), tuple(b), tuple(c)))(
        jnp.asarray(q), jnp.asarray(qv), jnp.asarray(tau))
    got_acc, got_frc = ours(torch.as_tensor(q), torch.as_tensor(qv), torch.as_tensor(tau))
    want_frc = np.stack(frc, axis=-1)
    _close(got_acc.numpy(), np.stack(acc, axis=-1), 1e-12)
    _close(got_frc.numpy(), want_frc, 1e-12)
    # the states reach every branch: no limit, each limit alone, and (IP) both at once
    active = np.abs(want_frc) > 0
    assert active[:, 0].any() and (~active).all(axis=1).any()
    if name == "ip":
        assert active[:, 1].any() and active.all(axis=1).any()
        assert (active[:, 0] & ~active[:, 1]).any() and (active[:, 1] & ~active[:, 0]).any()


def _states(name, n=16, seed=3):
    """(n, state_dim) f64 states: the slide inside and past its limit, poles
    up to ±0.6 rad from upright, rates up to ±2."""
    rng = np.random.default_rng(seed)
    if name == "ip":
        return np.concatenate([rng.uniform(-1.05, 1.05, (n, 1)), rng.uniform(-0.6, 0.6, (n, 1)),
                               rng.uniform(-2, 2, (n, 2))], axis=1)
    q = np.concatenate([rng.uniform(-1.05, 1.05, (n, 1)), rng.uniform(-0.6, 0.6, (n, 2))], axis=1)
    return np.concatenate([q, rng.uniform(-2, 2, (n, 3)), q + rng.uniform(-0.01, 0.01, (n, 3)),
                           rng.uniform(-5, 5, (n, 1))], axis=1)


@pytest.mark.parametrize("name", ["ip", "idp"])
def test_step_reward_and_observation_match_jax(name):
    ours, theirs = ENVS[name]
    env, jenv = ours(dtype=torch.float64, device="cpu"), theirs(dtype=jnp.float64)
    x = _states(name)
    a = np.random.default_rng(4).uniform(-1.2, 1.2, (len(x), 1)) * env.action_high
    jfn = jax.jit(jax.vmap(lambda xx, aa: jenv.step(jmake_state(xx), aa).x))
    want = np.asarray(jfn(jnp.asarray(x), jnp.asarray(a)))
    s2 = env.step(make_state(torch.as_tensor(x)), torch.as_tensor(a))
    _close(s2.x.numpy(), want, 1e-12)
    assert s2.t == 1
    jr = jax.vmap(lambda xx: jenv.reward(jmake_state(xx)))
    jo = jax.vmap(lambda xx: jenv.observation(jmake_state(xx)))
    _close(env.reward(s2).numpy(), np.asarray(jr(jnp.asarray(want))), 1e-12)
    _close(env.observation(s2).numpy(), np.asarray(jo(jnp.asarray(want))), 1e-12)
    np.testing.assert_array_equal(env.reset().x.numpy(), np.asarray(jenv.reset().x))


@pytest.mark.parametrize("name", ["ip", "idp"])
def test_rollout_batch_matches_jax(name):
    ours, theirs = ENVS[name]
    env, jenv = ours(dtype=torch.float64, device="cpu"), theirs(dtype=jnp.float64)
    x0 = _states(name, n=1, seed=5)[0]
    ctrl = np.random.default_rng(6).uniform(-1, 1, (12, 5, 1)) * env.action_high
    want, wstates = jrollout_batch(jenv, jmake_state(jnp.asarray(x0)), jnp.asarray(ctrl),
                                   log_states=True)
    got, states = rollout_batch(env, make_state(torch.as_tensor(x0)), torch.as_tensor(ctrl),
                                log_states=True)
    _close(got.numpy(), np.asarray(want), 1e-9)
    _close(states.numpy(), np.asarray(wstates), 1e-9)


@pytest.mark.parametrize("name", ["ip", "idp"])
def test_cemppi_step_matches_jax(name):
    """Two chained control steps, each with 2 AIS iterations of K = 16
    rollouts through the plain rollout, the same normals z on both sides."""
    ours, theirs = ENVS[name]
    k, h, its = 16, 4, 2
    kw = dict(kind="cemppi", num_samples=k, horizon=h, lam=0.1, opt_its=its, sigma_est="mle")
    jenv, env = theirs(dtype=jnp.float64), ours(dtype=torch.float64, device="cpu")
    jpol = jmake_policy(jenv, JPolicyConfig(**kw), cov_mat=[0.1])
    pol = make_policy(env, PolicyConfig(**kw), cov_mat=[0.1])
    x0 = _states(name, n=1, seed=7)[0]
    js, jps = jmake_state(jnp.asarray(x0)), jpol.init_state(0)
    s, ps = make_state(torch.as_tensor(x0)), pol.init_state(0)
    rng = np.random.default_rng(8)
    for _ in range(2):
        z = rng.standard_normal((its, h, k))
        ja, jps, jinfo = jpol.step(js, jps, z=jnp.asarray(z))
        a, ps, info = pol.step(s, ps, z=torch.as_tensor(z))
        _close(a.numpy(), ja, 1e-9)
        _close(ps.U.numpy(), jps.U, 1e-9)
        _close(info["costs"].numpy(), jinfo["costs"], 1e-9)
        js, s = jenv.step(js, ja), env.step(s, a)
    _close(s.x.numpy(), js.x, 1e-9)


@pytest.mark.parametrize("task", ["InvertedPendulum-v4", "InvertedDoublePendulum-v4"])
def test_simulate_mujoco_on_device_runs_the_pendulum(task):
    m = simulate.simulate_mujoco_on_device(
        task, num_steps=3, num_samples=8, horizon=3, ais_its=2, lam=0.1, ce_sigma_est="mle",
        seed=1, device="cpu", dtype=torch.float64, print_output=False)
    assert m["steps"][0] == 3 and np.isfinite(m["rewards"][0])
    if task == "InvertedPendulum-v4":
        assert m["rewards"][0] == 4.0  # healthy at every one of the 3 + 1 steps
