"""Each AIS strategy's `update` equals the JAX package's, from the same carry
handed across by `utils/convert.ais_carry` (cs=12, K=64, as the JAX fused-
update tests set it up): float64 at rtol 1e-10 on U, chol, the strategy's
extra state and the stop flag, for every kind and the CMA variants — the
quirk and textbook rank-μ forms, Newton–Schulz Σ^−1/2, guards off, and cs=4,
where the quirk's scalar index runs past the elite matrix and is clamped.
With `MPOPIS_FUSED_UPDATE=1` on the CPU the port's fused path (the kernels'
plain versions) equals its unfused path in float32 at the JAX package's
tolerances for the same comparison (U rtol 1e-4 / atol 1e-5, chol and
extra rtol 5e-3 / atol 5e-4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpopis_tpu.policies.config import PolicyConfig as JPolicyConfig
from mpopis_tpu.policies.strategies import AISCarry as JAISCarry
from mpopis_tpu.policies.strategies import make_strategy as jmake_strategy

from mpopis_tpu_torch.policies import PolicyConfig
from mpopis_tpu_torch.policies.strategies import make_strategy
from mpopis_tpu_torch.utils import convert

K = 64


def _setup(cs, seed=4):
    rng = np.random.default_rng(seed)
    e = rng.normal(size=(cs, K))
    costs = rng.normal(size=(K,)) ** 2
    sigma0 = 0.3 * np.eye(cs) + 0.02 * np.ones((cs, cs))
    return e, costs, sigma0


def _jax_update(kind, cs, dtype, **cfg_kw):
    cfg = JPolicyConfig(kind=kind, num_samples=K, horizon=cs // 2, opt_its=3, **cfg_kw)
    strat = jmake_strategy(cfg, cs, dtype)
    e, costs, sigma0 = _setup(cs)
    extra = None
    if kind == "cmamppi":
        extra = strat.make_extra(jnp.asarray(sigma0, dtype))
    elif kind == "nesmppi":
        extra = strat.make_extra(jnp.asarray(0.5 * sigma0, dtype))
    carry = JAISCarry(
        U=jnp.asarray(np.linspace(-0.2, 0.2, cs), dtype),
        chol=jnp.asarray(np.linalg.cholesky(sigma0), dtype),
        E=jnp.asarray(e, dtype), costs=jnp.asarray(costs, dtype), trajs=None,
        done=jnp.asarray(False), key=jax.random.PRNGKey(0), extra=extra,
    )
    new, stop = strat.update(carry, jax.random.PRNGKey(1), carry.U, jnp.asarray(2))
    return carry, new, stop


def _to_numpy(carry):
    d = {name: np.asarray(getattr(carry, name)) for name in ("U", "chol", "E", "costs")}
    d["extra"] = (None if carry.extra is None
                  else {name: np.asarray(v) for name, v in carry.extra.items()})
    return d


def _port_update(kind, cs, jcarry, dtype, **cfg_kw):
    cfg = PolicyConfig(kind=kind, num_samples=K, horizon=cs // 2, opt_its=3, **cfg_kw)
    strat = make_strategy(cfg, cs, dtype)
    carry = convert.ais_carry(_to_numpy(jcarry), dtype=dtype)
    uniforms = torch.as_tensor(
        np.asarray(jax.random.uniform(jax.random.PRNGKey(1), (K,), dtype=jnp.float64)), dtype=dtype)
    return strat.update(carry, None, carry.U, 2, uniforms=uniforms)


def _compare(new, stop, jnew, jstop, rtol, atol=0.0):
    assert (stop is None and not bool(jstop)) or bool(stop) == bool(jstop)
    np.testing.assert_allclose(new.U.numpy(), np.asarray(jnew.U), rtol=rtol, atol=atol)
    np.testing.assert_allclose(new.chol.numpy(), np.asarray(jnew.chol), rtol=rtol, atol=atol)
    assert (new.extra is None) == (jnew.extra is None)
    for name in (jnew.extra or {}):
        np.testing.assert_allclose(new.extra[name].numpy(), np.asarray(jnew.extra[name]),
                                   rtol=rtol, atol=atol, err_msg=name)


@pytest.mark.parametrize("kind,cs,cfg_kw", [
    ("gmppi", 12, {}),
    ("imppi", 12, {}),
    ("muaismppi", 12, {}),
    ("musigmaaismppi", 12, {}),
    ("pmcmppi", 12, {}),
    ("cemppi", 12, dict(sigma_est="lw")),
    ("cmamppi", 12, {}),
    ("cmamppi", 12, dict(cma_rank_mu_quirk=False)),
    ("cmamppi", 12, dict(cma_fast_sqrt=True)),
    ("cmamppi", 12, dict(cma_stability_guards=False)),
    ("cmamppi", 4, {}),  # K = 64 > cs·m_elite = 52: the clamped scalar index
    ("nesmppi", 12, {}),
])
def test_strategy_update_matches_jax(kind, cs, cfg_kw):
    jcarry, jnew, jstop = _jax_update(kind, cs, jnp.float64, **cfg_kw)
    new, stop = _port_update(kind, cs, jcarry, torch.float64, **cfg_kw)
    _compare(new, stop, jnew, jstop, rtol=1e-10, atol=1e-300)


@pytest.mark.parametrize("kind,cfg_kw", [
    ("cemppi", dict(sigma_est="lw")),
    ("musigmaaismppi", {}),
    ("pmcmppi", {}),
    ("cmamppi", dict(cma_fast_sqrt=True)),
])
def test_fused_update_on_cpu_matches_unfused(kind, cfg_kw, monkeypatch):
    jcarry, _, _ = _jax_update(kind, 12, jnp.float32, **cfg_kw)
    out = {}
    for flag in ("1", "0"):
        monkeypatch.setenv("MPOPIS_FUSED_UPDATE", flag)
        out[flag] = _port_update(kind, 12, jcarry, torch.float32, **cfg_kw)
    (a, stop_a), (b, stop_b) = out["1"], out["0"]
    assert (stop_a is None and stop_b is None) or bool(stop_a) == bool(stop_b)
    np.testing.assert_allclose(a.U.numpy(), b.U.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(a.chol.numpy(), b.chol.numpy(), rtol=5e-3, atol=5e-4)
    for name in (a.extra or {}):
        np.testing.assert_allclose(a.extra[name].numpy(), b.extra[name].numpy(),
                                   rtol=5e-3, atol=5e-4, err_msg=name)


def test_fused_cma_on_cpu_matches_jax_fused(monkeypatch):
    """With the switch on in both packages, CMA's fused update (the JAX
    kernel in interpret mode, the port's plain version) agrees in float32
    at the kernel tolerances."""
    monkeypatch.setenv("MPOPIS_FUSED_UPDATE", "1")
    jcarry, jnew, jstop = _jax_update("cmamppi", 12, jnp.float32)
    new, stop = _port_update("cmamppi", 12, jcarry, torch.float32)
    _compare(new, stop, jnew, jstop, rtol=5e-3, atol=5e-4)
