"""The port's ops equal the JAX package's in float64 (rtol 1e-12) on shared
numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpopis_tpu.ops import controls as jcontrols
from mpopis_tpu.ops import covariance as jcov
from mpopis_tpu.ops import weights as jweights

from mpopis_tpu_torch.ops import controls, covariance, weights

RTOL = 1e-12


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


@pytest.mark.parametrize("lam", [1.0, 10.0])
def test_information_theoretic_weights(lam):
    costs = np.random.default_rng(0).normal(50.0, 20.0, size=64)
    got = weights.information_theoretic_weights(_t(costs), lam).numpy()
    want = np.asarray(jweights.information_theoretic_weights(jnp.asarray(costs), lam))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


@pytest.mark.parametrize("quirk", [True, False])
def test_roll_controls(quirk):
    rng = np.random.default_rng(1)
    wc, u0 = rng.normal(size=20), rng.normal(size=20)
    got = controls.roll_controls(_t(wc), _t(u0), 2, quirk).numpy()
    want = np.asarray(jcontrols.roll_controls(jnp.asarray(wc), jnp.asarray(u0), 2, quirk))
    np.testing.assert_array_equal(got, want)
    # horizon 1 replaces U wholesale
    assert controls.roll_controls(_t(wc[:2]), _t(u0[:2]), 2, quirk).tolist() == wc[:2].tolist()


def test_clamp_controls():
    v = np.random.default_rng(2).normal(size=(7, 5, 2)) * 2.0
    lo, hi = np.array([-1.0, -0.5]), np.array([1.0, 0.5])
    got = controls.clamp_controls(_t(v), _t(lo), _t(hi)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jcontrols.clamp_controls(v, lo, hi)))


@pytest.mark.parametrize("method", ["mle", "lw", "ss", "rblw", "oas"])
def test_shrinkage_cov_masked(method):
    rng = np.random.default_rng(3)
    e = rng.normal(size=(20, 64)) * rng.uniform(0.2, 2.0, size=(20, 1))
    mask = np.zeros(64)
    mask[rng.choice(64, size=13, replace=False)] = 1.0
    got = covariance.shrinkage_cov_masked(_t(e), _t(mask), 13, method).numpy()
    want = np.asarray(
        jcov.shrinkage_cov_masked(jnp.asarray(e), jnp.asarray(mask), 13, method)
    )
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-15)


def test_shrinkage_cov_masked_rejects_unknown_method():
    with pytest.raises(ValueError, match="unknown"):
        covariance.shrinkage_cov_masked(_t(np.ones((2, 3))), _t(np.ones(3)), 3, "bogus")
