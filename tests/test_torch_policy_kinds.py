"""Every policy kind of the port equals the JAX package's `make_policy(...).step`
on the car in float64, with the same injected standard normals `z` (and,
for PMC, the same resampling uniforms, rebuilt from the JAX key schedule):
action, next U, costs and weights at rtol 1e-9 over two chained control
steps, for 1 and 3 AIS iterations and with the control-cost term on
(α = 0.5). The largest relative difference measured on a CPU was 7.4e-14
(NES; CMA's eigh path 3.7e-14), so 1e-9 leaves room for other LAPACK builds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpopis_tpu.models import CarRacingEnv as JCarRacingEnv
from mpopis_tpu.policies import PolicyConfig as JPolicyConfig
from mpopis_tpu.policies import make_policy as jmake_policy

from mpopis_tpu_torch.models import CarRacingEnv
from mpopis_tpu_torch.policies import POLICY_KINDS, PolicyConfig, make_policy

K, H = 48, 6
RTOL = 1e-9
COV = np.diag([0.0625, 0.1])


def _close(got, want, what):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-300,
                               err_msg=what)


def _pmc_uniforms(key, its):
    """The uniforms JAX's PMC update draws in one control step: the step
    splits its key into (next, loop); each iteration splits the loop key
    into (loop, sample, strategy) and draws K uniforms from the last."""
    _, carry_key = jax.random.split(key)
    out = []
    for _ in range(its):
        carry_key, _, k_strat = jax.random.split(carry_key, 3)
        out.append(np.asarray(jax.random.uniform(k_strat, (K,), dtype=jnp.float64)))
    return torch.as_tensor(np.stack(out))


def _run(kind, its, alpha, n_steps=2, **cfg_kw):
    kw = dict(kind=kind, num_samples=K, horizon=H, lam=10.0, opt_its=its, alpha=alpha,
              sigma_est="ss", **cfg_kw)
    jenv = JCarRacingEnv(dtype=jnp.float64)
    env = CarRacingEnv(dtype=torch.float64, device="cpu")
    jpol = jmake_policy(jenv, JPolicyConfig(**kw), cov_mat=COV)
    pol = make_policy(env, PolicyConfig(**kw), cov_mat=COV)
    rng = np.random.default_rng(5)
    js, jps = jenv.reset(), jpol.init_state(0)
    s, ps = env.reset(), pol.init_state(0)
    infos = []
    for step in range(n_steps):
        shape = (K, H, 2) if kind == "mppi" else (its, 2 * H, K)
        z = rng.standard_normal(shape)
        extra = {}
        if kind == "pmcmppi":
            extra["uniforms"] = _pmc_uniforms(jps.key, its)
        ja, jps_next, jinfo = jpol.step(js, jps, z=jnp.asarray(z))
        a, ps, info = pol.step(s, ps, z=torch.as_tensor(z), **extra)
        for name, got, want in (("action", a, ja), ("U", ps.U, jps_next.U),
                                ("costs", info["costs"], jinfo["costs"]),
                                ("weights", info["weights"], jinfo["weights"])):
            _close(got, want, f"{kind} step {step}: {name}")
        infos.append(info)
        jps = jps_next
        js = jenv.step(js, ja)
        s = env.step(s, a)
    _close(s.x, js.x, f"{kind}: state")
    return infos


@pytest.mark.parametrize("its,alpha", [(1, 1.0), (3, 1.0), (3, 0.5)])
@pytest.mark.parametrize("kind", POLICY_KINDS)
def test_policy_kind_matches_jax(kind, its, alpha):
    infos = _run(kind, its, alpha)
    want_its = 1 if kind in ("mppi", "gmppi") else its
    if kind not in ("cemppi", "cmamppi", "nesmppi"):  # the kinds that can stop early
        assert [info["ais_its"] for info in infos] == [want_its] * 2


@pytest.mark.parametrize("cfg_kw", [
    dict(cma_rank_mu_quirk=False),
    dict(cma_fast_sqrt=True),
    dict(cma_stability_guards=False),
])
def test_cmamppi_variants_match_jax(cfg_kw):
    _run("cmamppi", 3, 1.0, **cfg_kw)
