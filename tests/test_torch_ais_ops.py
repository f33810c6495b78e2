"""The ops the AIS strategies use equal the JAX package's in float64
(rtol 1e-12) on shared numpy inputs: cross-entropy weights, the weighted and
unweighted moments, the five shrinkage estimators over a sample matrix, the
control utilities, and the multinomial resampling, whose indices and counts
from the same uniforms must be exactly equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpopis_tpu.ops import controls as jcontrols
from mpopis_tpu.ops import covariance as jcov
from mpopis_tpu.ops import sampling as jsampling
from mpopis_tpu.ops import weights as jweights

from mpopis_tpu_torch.ops import controls, covariance, sampling, weights

RTOL = 1e-12


def _t(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-14)


@pytest.mark.parametrize("num_elite", [1, 13, 64])
def test_cross_entropy_weights(num_elite):
    costs = np.round(np.random.default_rng(0).normal(5.0, 2.0, size=64), 1)  # with ties
    _close(weights.cross_entropy_weights(_t(costs), num_elite),
           jweights.cross_entropy_weights(jnp.asarray(costs), num_elite))


def test_weighted_and_unweighted_moments():
    rng = np.random.default_rng(1)
    e = rng.normal(size=(12, 64))
    w = rng.exponential(size=64)
    w /= w.sum()
    for got, want in zip(covariance.weighted_mean_and_cov(_t(e), _t(w)),
                         jcov.weighted_mean_and_cov(jnp.asarray(e), jnp.asarray(w))):
        _close(got, want)
    for corrected in (True, False):
        for got, want in zip(covariance.mean_and_cov(_t(e), corrected),
                             jcov.mean_and_cov(jnp.asarray(e), corrected)):
            _close(got, want)


@pytest.mark.parametrize("method", ["mle", "lw", "ss", "rblw", "oas"])
def test_shrinkage_estimators(method):
    x = np.random.default_rng(2).normal(size=(40, 12)) @ np.diag(np.linspace(0.5, 2.0, 12))
    _close(covariance.shrinkage_cov(_t(x), method), jcov.shrinkage_cov(jnp.asarray(x), method))
    np.testing.assert_allclose(covariance.sample_cov(_t(x), corrected=True).numpy(),
                               np.asarray(jcov.sample_cov(jnp.asarray(x), corrected=True)),
                               rtol=RTOL)
    with pytest.raises(ValueError, match="unknown"):
        covariance.shrinkage_cov(_t(x), "bogus")


def test_control_utilities():
    a = np.array([[0.0625, 0.01], [0.01, 0.1]])
    np.testing.assert_array_equal(controls.block_diag_repeat(_t(a), 3).numpy(),
                                  np.asarray(jcontrols.block_diag_repeat(jnp.asarray(a), 3)))
    v = np.array([1.0, 2.0])
    np.testing.assert_array_equal(controls.block_diag_repeat(_t(v), 2).numpy(),
                                  np.asarray(jcontrols.block_diag_repeat(jnp.asarray(v), 2)))
    v = np.arange(10.0)
    np.testing.assert_array_equal(controls.controls_from_flat(_t(v), 5, 2).numpy(),
                                  np.asarray(jcontrols.controls_from_flat(jnp.asarray(v), 5, 2)))
    for got, want in zip(controls.action_bounds_tiled([-1, -2], [1, 2], 3),
                         jcontrols.action_bounds_tiled([-1, -2], [1, 2], 3)):
        np.testing.assert_array_equal(got, want)


def test_mvnormal_samples_and_cholesky_psd():
    rng = np.random.default_rng(3)
    a = rng.normal(size=(6, 6))
    sigma = a @ a.T + np.eye(6)
    _close(sampling.cholesky_psd(_t(sigma), 1e-6),
           jsampling.cholesky_psd(jnp.asarray(sigma), 1e-6))
    z = rng.normal(size=(6, 32))
    chol = np.linalg.cholesky(sigma)
    _close(sampling.mvnormal_samples(_t(chol), 32, z=_t(z)),
           jsampling.mvnormal_samples(None, jnp.asarray(chol), 32, z=jnp.asarray(z)))


@pytest.mark.parametrize("k,seed", [(64, 0), (8192, 1)])
def test_multinomial_resampling_from_the_same_uniforms(k, seed):
    """Indices and counts equal exactly, at K=8192 too (the JAX counts then
    run in 4096-draw tiles)."""
    key = jax.random.PRNGKey(seed)
    w = np.random.default_rng(seed).exponential(size=k) ** 3
    w /= w.sum()
    u = np.asarray(jax.random.uniform(key, (k,), dtype=jnp.float64))
    idx = sampling.multinomial_resample_indices(_t(w), _t(u))
    jidx = jsampling.multinomial_resample_indices(key, jnp.asarray(w), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    counts = sampling.multinomial_resample_counts(_t(w), _t(u))
    jcounts = jsampling.multinomial_resample_counts(key, jnp.asarray(w), k)
    assert counts.dtype == torch.float64
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    assert counts.sum() == k
