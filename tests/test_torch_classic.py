"""The port's MountainCar and CartPole against the JAX package in float64 on
the CPU: the step with its per-sample `done` (state-dependent, and the
step limit), the reward that reads it, the seeded random reset's range,
the CEMPPI step through the `z=` hook at 1e-9, the harness's chunked loop
against its per-step loop, and the `mountaincar` / `cartpole` CLI."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpopis_tpu.harness.cli import build_parser as jbuild_parser
from mpopis_tpu.models import CartPoleEnv as JCartPoleEnv
from mpopis_tpu.models import MountainCarEnv as JMountainCarEnv
from mpopis_tpu.models import make_state as jmake_state
from mpopis_tpu.policies import PolicyConfig as JPolicyConfig
from mpopis_tpu.policies import make_policy as jmake_policy

from mpopis_tpu_torch.harness import simulate
from mpopis_tpu_torch.harness.cli import build_parser, main
from mpopis_tpu_torch.models import CartPoleEnv, MountainCarEnv, make_state
from mpopis_tpu_torch.models.base import done_mask
from mpopis_tpu_torch.policies import PolicyConfig, make_policy

ENVS = {"mountaincar": (MountainCarEnv, JMountainCarEnv), "cartpole": (CartPoleEnv, JCartPoleEnv)}


def _states(name, n=64, seed=0):
    rng = np.random.default_rng(seed)
    if name == "mountaincar":  # positions over the whole range, the goal and the wall
        return np.stack([rng.uniform(-1.25, 0.6, n), rng.uniform(-0.07, 0.07, n)], axis=1)
    return rng.uniform(-1, 1, (n, 4)) * np.array([2.6, 2.0, 0.25, 2.0])


def test_fields_match_jax():
    for ours, theirs in ENVS.values():
        jf = {f.name: getattr(theirs(), f.name) for f in dataclasses.fields(theirs)}
        of = {f.name: getattr(ours(device="cpu"), f.name) for f in dataclasses.fields(ours)}
        for name in set(jf) - {"dtype"}:
            assert of[name] == jf[name], name
        assert set(of) - {"device"} == set(jf)
        assert (ours.state_dim, ours.action_dim) == (theirs.state_dim, theirs.action_dim)
        assert ours.random_reset


@pytest.mark.parametrize("name", ["mountaincar", "cartpole"])
@pytest.mark.parametrize("t", [0, 199, 200])
def test_step_done_and_reward_match_jax(name, t):
    ours, theirs = ENVS[name]
    env, jenv = ours(dtype=torch.float64, device="cpu"), theirs(dtype=jnp.float64)
    x = _states(name)
    a = np.random.default_rng(1).uniform(-1, 1, (len(x), 1))
    jfn = jax.vmap(lambda xx, aa: jenv.step(jmake_state(xx, t=t), aa))
    js2 = jfn(jnp.asarray(x), jnp.asarray(a))
    s2 = env.step(make_state(torch.as_tensor(x), t=t), torch.as_tensor(a))
    np.testing.assert_allclose(s2.x.numpy(), np.asarray(js2.x), rtol=1e-12, atol=1e-15)
    np.testing.assert_array_equal(s2.done.numpy(), np.asarray(js2.done))
    assert s2.t == t + 1 and s2.done.shape == (len(x),)
    jr = jax.vmap(jenv.reward)(js2)
    np.testing.assert_allclose(env.reward(s2).numpy(), np.asarray(jr), rtol=1e-12, atol=1e-15)
    # the states reach both values of done (all done past the step limit)
    if t == 0:
        assert s2.done.any() and (~s2.done).any()


@pytest.mark.parametrize("name", ["mountaincar", "cartpole"])
def test_reset_and_its_seeded_random_start(name):
    ours, theirs = ENVS[name]
    env = ours(dtype=torch.float64, device="cpu")
    s = env.reset()
    np.testing.assert_array_equal(s.x.numpy(), np.asarray(theirs(dtype=jnp.float64).reset().x))
    assert s.done is False and not done_mask(s).any()
    a = env.reset(torch.Generator().manual_seed(4)).x.numpy()
    b = env.reset(torch.Generator().manual_seed(4)).x.numpy()
    c = env.reset(torch.Generator().manual_seed(5)).x.numpy()
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    if name == "mountaincar":
        assert -0.6 <= a[0] < -0.4 and a[1] == 0.0
    else:
        assert np.all(np.abs(a) <= 0.05)


@pytest.mark.parametrize("name", ["mountaincar", "cartpole"])
def test_cemppi_step_matches_jax(name):
    """Three chained control steps at the CLI's settings (λ = 0.1, Σ = 1.5,
    `mle`), K = 20, H = 15, 5 AIS iterations, the same normals z."""
    ours, theirs = ENVS[name]
    k, h, its = 20, 15, 5
    kw = dict(kind="cemppi", num_samples=k, horizon=h, lam=0.1, opt_its=its, sigma_est="mle")
    jenv, env = theirs(dtype=jnp.float64), ours(dtype=torch.float64, device="cpu")
    jpol = jmake_policy(jenv, JPolicyConfig(**kw), cov_mat=[1.5])
    pol = make_policy(env, PolicyConfig(**kw), cov_mat=[1.5])
    x0 = _states(name, n=1, seed=2)[0] * 0.1
    js, jps = jmake_state(jnp.asarray(x0)), jpol.init_state(0)
    s, ps = make_state(torch.as_tensor(x0)), pol.init_state(0)
    rng = np.random.default_rng(3)
    for _ in range(3):
        z = rng.standard_normal((its, h, k))
        ja, jps, jinfo = jpol.step(js, jps, z=jnp.asarray(z))
        a, ps, info = pol.step(s, ps, z=torch.as_tensor(z))
        np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(ps.U.numpy(), np.asarray(jps.U), rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(info["costs"].numpy(), np.asarray(jinfo["costs"]), rtol=1e-9)
        js, s = jenv.step(js, ja), env.step(s, a)
    np.testing.assert_allclose(s.x.numpy(), np.asarray(js.x), rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("which,chunk,k,h", [("mountaincar", 7, 16, 10), ("cartpole", 4, 2, 2)])
def test_chunked_loop_matches_per_step(which, chunk, k, h):
    """`steps_per_call` > 1 stacks [reward, done, action] on the device and
    reads them once a chunk; the results equal the per-step loop's, the
    trial's end inside a chunk included (CartPole at K = 2, H = 2 falls
    before 60 steps)."""
    run = {"mountaincar": simulate.simulate_mountaincar,
           "cartpole": simulate.simulate_cartpole}[which]
    kw = dict(num_trials=2, num_steps=60, policy_type="mppi", num_samples=k, horizon=h,
              lam=0.1, cov_mat=[1.5], seed=5, device="cpu", dtype=torch.float64,
              print_output=False)
    s1 = run(steps_per_call=1, **kw)
    sn = run(steps_per_call=chunk, **kw)
    np.testing.assert_allclose(sn["rewards"], s1["rewards"], rtol=1e-12)
    np.testing.assert_array_equal(sn["steps"], s1["steps"])
    if which == "cartpole":
        assert np.all(s1["steps"] < 60)


def test_simulate_mountaincar_reaches_the_goal():
    """The JAX harness test's configuration: at least one of two trials
    earns the +1e5 goal bonus."""
    m = simulate.simulate_mountaincar(num_trials=2, num_steps=200, policy_type="cemppi",
                                      num_samples=20, horizon=15, lam=0.1, cov_mat=[1.5],
                                      ais_its=5, seed=1, device="cpu", dtype=torch.float64,
                                      print_output=False)
    assert m["rewards"].shape == (2,) and m["rewards"].max() > 90000.0


@pytest.mark.parametrize("cmd", ["mountaincar", "cartpole"])
def test_cli_classic_runs_on_cpu(capsys, cmd):
    rc = main([cmd, "--device", "cpu", "--steps", "5", "--seed", "2", "--trials", "2"])
    assert rc == 0
    out = capsys.readouterr().out
    assert {"mountaincar": "MountainCar", "cartpole": "CartPole"}[cmd] in out
    assert "# AIS Iterations:             5" in out and "CE Σ Est Method:              mle" in out
    assert sum(line.startswith("Trial    ") for line in out.splitlines()) == 3
    assert "Trials AVE:" in out


@pytest.mark.parametrize("cmd", ["mountaincar", "cartpole"])
def test_cli_classic_parser_defaults_match_jax(cmd):
    ours = vars(build_parser().parse_args([cmd]))
    theirs = vars(jbuild_parser().parse_args([cmd]))
    assert ours.pop("device") == "cuda"
    assert ours == theirs
    assert (ours["samples"], ours["horizon"], ours["lam"], ours["ais_its"],
            ours["lambda_ais"], ours["ce_sigma_est"]) == (20, 15, 0.1, 5, 0.1, "mle")
