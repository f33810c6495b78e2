"""The plain versions of the AIS-update and small-linalg kernels equal the JAX
package's Pallas kernels run in interpret mode on the CPU, at the JAX kernel
tests' shapes (CS=24, K=512 and K=2500, M=40) and tolerances in float32 —
refits rtol 5e-4 / atol 5e-5, CMA rtol 5e-3 / atol 5e-4, Cholesky and
forward solve rtol 5e-5 / atol 5e-6 — and in float64 at rtol 1e-10."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpopis_tpu.kernels.ais_update import cma_update_chol as jcma_update_chol
from mpopis_tpu.kernels.ais_update import masked_refit_chol as jmasked_refit_chol
from mpopis_tpu.kernels.ais_update import weighted_refit_chol as jweighted_refit_chol
from mpopis_tpu.kernels.linalg import _chol_pallas, _fwd_solve_pallas

from mpopis_tpu_torch.kernels import ais_update, linalg
from mpopis_tpu_torch.policies.strategies import CMAStrategy

CS, K, M = 24, 512, 40
DTYPES = {"f32": (np.float32, torch.float32), "f64": (np.float64, torch.float64)}
TOL = {  # (rtol, atol) per kernel family and dtype
    ("refit", "f32"): (5e-4, 5e-5), ("cma", "f32"): (5e-3, 5e-4),
    ("linalg", "f32"): (5e-5, 5e-6),
}


def _tol(family, dt):
    return TOL.get((family, dt), (1e-10, 1e-13))


def _data(seed, k=K):
    rng = np.random.default_rng(seed)
    e = rng.normal(size=(CS, k))
    mask = np.zeros(k)
    mask[rng.choice(k, M, replace=False)] = 1.0
    return e, mask


def _close(got, want, family, dt, what=""):
    rtol, atol = _tol(family, dt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol, err_msg=what)


@pytest.mark.parametrize("dt", ["f32", "f64"])
@pytest.mark.parametrize("method", ["mle", "lw", "ss", "rblw", "oas"])
def test_masked_refit_plain_matches_jax_kernel(method, dt):
    npdt, tdt = DTYPES[dt]
    e, mask = _data(0)
    e, mask = e.astype(npdt), mask.astype(npdt)
    mu = (e @ mask) / M
    want = jmasked_refit_chol(jnp.asarray(e), jnp.asarray(mask), jnp.asarray(mu), M, method,
                              1e-8, interpret=True)
    got = ais_update.masked_refit_chol(torch.as_tensor(e), torch.as_tensor(mask),
                                       torch.as_tensor(mu), M, method, 1e-8)
    assert got.dtype == tdt
    _close(got, want, "refit", dt)


def test_masked_refit_plain_matches_jax_kernel_chunked_and_padded():
    """K=2500: the JAX kernel accumulates two 2048-column chunks, zero-padded."""
    e, mask = _data(1, k=2500)
    e, mask = e.astype(np.float32), mask.astype(np.float32)
    mu = (e @ mask) / M
    want = jmasked_refit_chol(jnp.asarray(e), jnp.asarray(mask), jnp.asarray(mu), M, "ss", 1e-8,
                              interpret=True)
    got = ais_update.masked_refit_chol(torch.as_tensor(e), torch.as_tensor(mask),
                                       torch.as_tensor(mu), M, "ss", 1e-8)
    _close(got, want, "refit", "f32")


@pytest.mark.parametrize("dt", ["f32", "f64"])
@pytest.mark.parametrize("corrected", [False, True])
def test_weighted_refit_plain_matches_jax_kernel(corrected, dt):
    npdt, _ = DTYPES[dt]
    e, _ = _data(2)
    rng = np.random.default_rng(7)
    if corrected:  # PMC: w = counts / K
        w = rng.multinomial(K, np.ones(K) / K) / K
    else:
        w = rng.exponential(size=K)
        w /= w.sum()
    e, w = e.astype(npdt), w.astype(npdt)
    mu = e @ w
    want = jweighted_refit_chol(jnp.asarray(e), jnp.asarray(w), jnp.asarray(mu),
                                corrected=corrected, jitter=1e-8, interpret=True)
    got = ais_update.weighted_refit_chol(torch.as_tensor(e), torch.as_tensor(w),
                                         torch.as_tensor(mu), corrected=corrected, jitter=1e-8)
    _close(got, want, "refit", dt)


def _cma_inputs(seed, npdt):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(CS, CS)) * 0.1
    consts = CMAStrategy.constants(K, CS, 0.8)
    args = dict(
        Sigma=a @ a.T + 0.5 * np.eye(CS), dw=rng.normal(size=CS) * 0.3,
        p_sigma=rng.normal(size=CS) * 0.5, p_Sigma=rng.normal(size=CS) * 0.1,
        svals=rng.normal(size=K), ws=consts["ws"], sigma_s=np.asarray(0.8),
    )
    consts_t = tuple(sorted((name, float(consts[name])) for name in ais_update.CMA_CONSTS))
    return {name: v.astype(npdt) for name, v in args.items()}, consts_t


@pytest.mark.parametrize("dt", ["f32", "f64"])
@pytest.mark.parametrize("guards,update_chol", [(True, True), (False, True), (True, False)])
def test_cma_plain_matches_jax_kernel(dt, guards, update_chol):
    npdt, _ = DTYPES[dt]
    args, consts_t = _cma_inputs(3, npdt)
    want = jcma_update_chol(
        *(jnp.asarray(args[name]) for name in ("Sigma", "dw", "p_sigma", "p_Sigma", "svals",
                                               "ws", "sigma_s")),
        jnp.asarray(2.0, npdt), consts_t, jitter=1e-8, guards=guards, update_chol=update_chol,
        interpret=True,
    )
    got = ais_update.cma_update_chol(
        *(torch.as_tensor(args[name]) for name in ("Sigma", "dw", "p_sigma", "p_Sigma", "svals",
                                                   "ws", "sigma_s")),
        2.0, consts_t, jitter=1e-8, guards=guards, update_chol=update_chol,
    )
    for name, g, w in zip(("chol", "Sigma", "p_sigma", "p_Sigma", "sigma"), got, want):
        _close(g, w, "cma", dt, name)


def _spd(n, npdt, seed=3):
    a = np.random.default_rng(seed).normal(size=(n, n)) * 0.2
    return (a @ a.T + np.eye(n)).astype(npdt)


# the CUDA factor's panel edges (32 columns a panel): a lone column, one
# panel, one and a bit, the car's n = 100 (3 panels and 4 columns), the
# Humanoid's H·nu = 136
PANEL_EDGES = [1, 31, 32, 33, 136]


@pytest.mark.parametrize("dt", ["f32", "f64"])
@pytest.mark.parametrize("n", [4, 100, *PANEL_EDGES])
def test_cholesky_plain_matches_jax_kernel(n, dt):
    spd = _spd(n, DTYPES[dt][0])
    got = linalg.chol_kernel(torch.as_tensor(spd))
    _close(got, _chol_pallas(jnp.asarray(spd), interpret=True), "linalg", dt)
    assert np.all(got.numpy()[np.triu_indices(n, 1)] == 0.0)


def test_cholesky_plain_gives_nans_where_not_positive_definite():
    spd = _spd(6, np.float64)
    spd[3, 3] = -1.0
    got = linalg.chol_kernel(torch.as_tensor(spd)).numpy()
    want = np.asarray(_chol_pallas(jnp.asarray(spd), interpret=True))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[3:, 3]).all() and not np.isnan(got[:, :3]).any()
    np.testing.assert_allclose(got[:, :3], want[:, :3], rtol=1e-12)


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_cholesky_plain_gives_nans_from_a_later_panel(dt):
    """n = 100 with its failing pivot at column 70, inside the third panel:
    the same NaN pattern as the JAX kernel, finite before column 70."""
    spd = _spd(100, DTYPES[dt][0])
    spd[70, 70] = -1.0
    got = linalg.chol_kernel(torch.as_tensor(spd)).numpy()
    want = np.asarray(_chol_pallas(jnp.asarray(spd), interpret=True))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[70:, 70:][np.tril_indices(30)]).all()
    assert not np.isnan(got[:, :70]).any()
    _close(torch.as_tensor(got[:, :70]), want[:, :70], "linalg", dt)


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_forward_solve_plain_matches_jax_kernel(dt):
    npdt, _ = DTYPES[dt]
    l = np.linalg.cholesky(_spd(100, np.float64, seed=4)).astype(npdt)
    b = np.random.default_rng(4).normal(size=(2, 100)).astype(npdt)
    got = linalg.fwd_solve_kernel(torch.as_tensor(l), torch.as_tensor(b))
    _close(got, _fwd_solve_pallas(jnp.asarray(l), jnp.asarray(b), interpret=True), "linalg", dt)


@pytest.mark.parametrize("dt", ["f32", "f64"])
@pytest.mark.parametrize("n", PANEL_EDGES)
def test_forward_solve_plain_matches_jax_kernel_at_panel_edges(n, dt):
    npdt, _ = DTYPES[dt]
    l = np.linalg.cholesky(_spd(n, np.float64, seed=5)).astype(npdt)
    b = np.random.default_rng(5).normal(size=(2, n)).astype(npdt)
    got = linalg.fwd_solve_kernel(torch.as_tensor(l), torch.as_tensor(b))
    _close(got, _fwd_solve_pallas(jnp.asarray(l), jnp.asarray(b), interpret=True), "linalg", dt)


def test_linalg_switch_keeps_the_library_path_on_the_cpu(monkeypatch):
    """MPOPIS_PALLAS_LINALG routes only CUDA float32 tensors to the kernels;
    on the CPU the library runs, as the JAX package's switch is TPU-only."""
    monkeypatch.setenv("MPOPIS_PALLAS_LINALG", "1")
    spd = torch.as_tensor(_spd(8, np.float32))
    assert not linalg._use_kernel(spd)
    before = (linalg.CHOL_LAUNCHES, linalg.SOLVE_LAUNCHES)
    l = linalg.cholesky_lower(spd)
    np.testing.assert_allclose(l.numpy(), torch.linalg.cholesky(spd).numpy(), rtol=0, atol=0)
    linalg.forward_solve(l, torch.ones((2, 8)))
    assert (linalg.CHOL_LAUNCHES, linalg.SOLVE_LAUNCHES) == before
