"""The port's Swimmer model against the JAX package's analytic route in
float64 on the CPU: the copied tables and fluid constants, the fluid force,
one RK4 substep with one and with both joint limits active, and the control
step with its reward and observation."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpopis_tpu.models import swimmer_device as jsd

from mpopis_tpu_torch.models import SwimmerDeviceEnv, swimmer_device as sd
from mpopis_tpu_torch.models.base import make_state
from mpopis_tpu_torch.utils import convert

LIM = float(np.deg2rad(100.0))


def _states(n=8, seed=0):
    """(n, 10) states: positions ±1, velocities ±2 from a numpy seed."""
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(-1, 1, (n, 5)), rng.uniform(-2, 2, (n, 5))], axis=1)


def _close(got, want, rtol):
    """rtol against each value, with an absolute floor of rtol × the largest."""
    want = np.asarray(want, dtype=float)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * max(np.max(np.abs(want)), 1e-300))


def test_tables_and_fluid_constants_match_jax_field_by_field():
    jm = jsd.PC_MODEL
    assert convert.planar_model(dataclasses.asdict(jm)) == sd.PC_MODEL
    ours, theirs = dataclasses.asdict(sd.PC_MODEL), dataclasses.asdict(jm)
    assert list(ours) == list(theirs)
    for name in theirs:
        assert ours[name] == theirs[name], name
    assert sd.PC_MODEL.n_rows == jm.n_rows == 2 and sd.PC_MODEL.chains == jm.chains
    for name in ("_MASS", "_I_MAX", "_I_MIN", "_ARMATURE", "_GEAR", "_H", "_FRAME_SKIP", "_LIMIT",
                 "_RHO", "_VISC", "_S_SHORT", "_S_LONG", "_D_EQ", "_C_VISC_F", "_C_VISC_T",
                 "_C_PAR", "_C_PERP", "_C_ROT", "_INVWEIGHT"):
        assert getattr(sd, name) == getattr(jsd, name), name
    assert sd.FLUID == (jsd._C_VISC_F, jsd._C_PAR, jsd._C_PERP, jsd._C_VISC_T, jsd._C_ROT)
    env, jenv = SwimmerDeviceEnv(device="cpu"), jsd.SwimmerDeviceEnv(dtype=jnp.float64)
    assert (env.FRAME_SKIP, env.dt) == (jsd._FRAME_SKIP, jenv.dt)
    assert (env.state_dim, env.action_dim) == (jenv.state_dim, jenv.action_dim) == (10, 2)
    np.testing.assert_array_equal(env.action_high, jenv.action_high)
    np.testing.assert_array_equal(SwimmerDeviceEnv(dtype=torch.float64, device="cpu").reset()
                                  .x.numpy(), np.asarray(jenv.reset().x))
    # the fixed solver is no field, as in the JAX package
    fields = {f.name for f in dataclasses.fields(SwimmerDeviceEnv)}
    assert not fields & {"solver_outer", "solver_cg"}
    assert (env.solver_outer, env.solver_cg) == sd.SOLVER == (2, 3)


def test_fluid_force_matches_jax():
    """rtol 1e-12 on random states."""
    x = _states(16, seed=1)
    want = jax.jit(jax.vmap(
        lambda v: jnp.stack(jsd._fluid_force_analytic(tuple(v[:5]), tuple(v[5:])))
    ))(jnp.asarray(x))
    got = sd.fluid_force(torch.as_tensor(x[:, :5]), torch.as_tensor(x[:, 5:]))
    _close(got.numpy(), want, 1e-12)


@pytest.mark.parametrize("limits", ["none", "one", "both"])
def test_rk4_substep_matches_jax(limits):
    """One `_rk4_analytic` substep, warm-started from a nonzero λ; rtol 1e-12.
    |q3|, |q4| beyond 100° put the limits' rows in the QP."""
    x = _states(8, seed=2)
    if limits != "none":
        x[:, 3] = np.where(np.arange(8) % 2, 1.05, -1.05) * LIM
    if limits == "both":
        x[:, 4] = np.where(np.arange(8) % 3, -1.1, 1.1) * LIM
    tau = np.random.default_rng(3).uniform(-150, 150, (8, 2))
    lam0 = np.random.default_rng(4).uniform(0, 2, (8, 2))

    def jsub(v, t, lam):
        q, qv, lam = jsd._rk4_analytic(tuple(v[:5]), tuple(v[5:]), t[0], t[1], lam)
        return jnp.stack(q), jnp.stack(qv), lam

    jq, jqv, jlam = jax.jit(jax.vmap(jsub))(jnp.asarray(x), jnp.asarray(tau), jnp.asarray(lam0))
    tau_t = torch.as_tensor(np.concatenate([np.zeros((8, 3)), tau], axis=1))
    q, qv, lam = sd.rk4_analytic(torch.as_tensor(x[:, :5]), torch.as_tensor(x[:, 5:]), tau_t,
                                 torch.as_tensor(lam0))
    _close(q.numpy(), jq, 1e-12)
    _close(qv.numpy(), jqv, 1e-12)
    _close(lam.numpy(), jlam, 1e-12)
    if limits != "none":
        assert np.any(np.asarray(jlam) > 0)


def test_step_reward_and_observation_match_jax():
    """`step` and `step_reward` over 3 control steps, actions beyond ±1 (the
    torque clamps, the reward reads them raw), from states with the limits
    active; rtol 1e-10."""
    x = _states(6, seed=5)
    x[:3, 3] = 1.02 * LIM
    x[3:, 4] = -1.02 * LIM
    acts = np.random.default_rng(6).uniform(-1.3, 1.3, (3, 6, 2))
    jenv = jsd.SwimmerDeviceEnv(dtype=jnp.float64)
    env = SwimmerDeviceEnv(dtype=torch.float64, device="cpu")
    jf = jax.jit(jax.vmap(lambda v, a: jenv.step_reward(jenv.reset().replace(x=v), a)))
    js, s = jnp.asarray(x), make_state(torch.as_tensor(x))
    for t in range(3):
        jnew, jr = jf(js, jnp.asarray(acts[t]))
        s, r = env.step_reward(s, torch.as_tensor(acts[t]))
        js = jnew.x
        _close(s.x.numpy(), js, 1e-10)
        _close(r.numpy(), jr, 1e-10)
    one = make_state(torch.as_tensor(np.array(js[0])))
    jone = jenv.reset().replace(x=js[0])
    np.testing.assert_array_equal(env.observation(one).numpy(), np.asarray(jenv.observation(jone)))
    assert float(env.reward(one)) == float(jenv.reward(jone))
