"""The port's CEMPPI control step equals the JAX package's in float64
(rtol 1e-9) with the same injected standard normals `z` (opt_its, cs, K):
action, next U, costs and weights — when the early stop fires at the first
iteration, when it never fires, and over chained control steps."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpopis_tpu.models import CarRacingEnv as JCarRacingEnv
from mpopis_tpu.policies import PolicyConfig as JPolicyConfig
from mpopis_tpu.policies import make_policy as jmake_policy

from mpopis_tpu_torch.models import CarRacingEnv
from mpopis_tpu_torch.policies import POLICY_KINDS, PolicyConfig, make_policy

K, H, ITS = 64, 8, 3
RTOL = 1e-9
COV = np.diag([0.0625, 0.1])


def _pair(sigma_est, elite_stop_tol, kind="cemppi", alpha=1.0):
    kw = dict(kind=kind, num_samples=K, horizon=H, lam=10.0, opt_its=ITS,
              sigma_est=sigma_est, elite_stop_tol=elite_stop_tol, alpha=alpha)
    jenv = JCarRacingEnv(dtype=jnp.float64)
    env = CarRacingEnv(dtype=torch.float64, device="cpu")
    jpol = jmake_policy(jenv, JPolicyConfig(**kw), cov_mat=COV)
    pol = make_policy(env, PolicyConfig(**kw), cov_mat=COV)
    return jenv, jpol, env, pol


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-300)


def _run(sigma_est, elite_stop_tol, n_steps, kind="cemppi", alpha=1.0):
    jenv, jpol, env, pol = _pair(sigma_est, elite_stop_tol, kind, alpha)
    rng = np.random.default_rng(11)
    js, jps = jenv.reset(), jpol.init_state(0)
    s, ps = env.reset(), pol.init_state(0)
    its = []
    for _ in range(n_steps):
        z = rng.standard_normal((ITS, 2 * H, K))
        ja, jps, jinfo = jpol.step(js, jps, z=jnp.asarray(z))
        a, ps, info = pol.step(s, ps, z=torch.as_tensor(z))
        _close(a, ja)
        _close(ps.U, jps.U)
        _close(info["costs"], jinfo["costs"])
        _close(info["weights"], jinfo["weights"])
        its.append(info["ais_its"])
        js = jenv.step(js, ja)
        s = env.step(s, a)
    _close(s.x, js.x)
    return its


@pytest.mark.parametrize("sigma_est", ["ss", "mle"])
def test_cemppi_step_early_stop_at_first_iteration(sigma_est):
    assert _run(sigma_est, elite_stop_tol=1e9, n_steps=1) == [1]


@pytest.mark.parametrize("sigma_est", ["ss", "mle"])
def test_cemppi_step_without_early_stop(sigma_est):
    assert _run(sigma_est, elite_stop_tol=1e-2, n_steps=1) == [ITS]


@pytest.mark.parametrize("sigma_est", ["ss", "mle"])
def test_cemppi_five_chained_steps(sigma_est):
    assert len(_run(sigma_est, elite_stop_tol=1e-2, n_steps=5)) == 5


def test_gmppi_step_matches_jax():
    assert _run("ss", elite_stop_tol=1e-2, n_steps=2, kind="gmppi") == [1, 1]


def test_control_cost_term_matches_jax():
    """α < 1 turns on γ = λ(1−α) and its two forward solves."""
    assert _run("ss", elite_stop_tol=1e-2, n_steps=2, alpha=0.5) == [ITS, ITS]


def test_logging_policy_returns_trajectories_of_the_same_step():
    env = CarRacingEnv(dtype=torch.float64, device="cpu")
    z = torch.as_tensor(np.random.default_rng(2).standard_normal((ITS, 2 * H, K)))
    out = {}
    for log in (False, True):
        cfg = PolicyConfig(num_samples=K, horizon=H, lam=10.0, opt_its=ITS,
                           sigma_est="ss", log=log)
        pol = make_policy(env, cfg, cov_mat=COV)
        out[log] = pol.step(env.reset(), pol.init_state(0), z=z)
    assert out[True][2]["trajectories"].shape == (K, H, 8)
    assert "trajectories" not in out[False][2]
    _close(out[True][0], out[False][0].numpy())
    _close(out[True][1].U, out[False][1].U.numpy())


def test_generator_drives_sampling_reproducibly():
    _, _, env, pol = _pair("ss", 1e-2)
    a1, ps1, _ = pol.step(env.reset(), pol.init_state(4))
    a2, ps2, _ = pol.step(env.reset(), pol.init_state(4))
    assert torch.equal(a1, a2) and torch.equal(ps1.U, ps2.U)
    a3, _, _ = pol.step(env.reset(), ps1)  # the generator has advanced
    assert not torch.equal(a1, a3)


@pytest.mark.parametrize("kind", POLICY_KINDS)
def test_every_kind_builds_and_steps_on_the_cpu(kind):
    env = CarRacingEnv(dtype=torch.float32, device="cpu")
    pol = make_policy(env, PolicyConfig(kind=kind, num_samples=8, horizon=4, opt_its=2),
                      cov_mat=COV)
    a, ps, info = pol.step(env.reset(), pol.init_state(3))
    assert a.shape == (2,) and ps.U.shape == (8,) and info["costs"].shape == (8,)
    assert bool(torch.all(torch.isfinite(a))) and bool(torch.all(torch.isfinite(ps.U)))
    assert 1 <= info["ais_its"] <= 2
