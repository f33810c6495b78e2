"""The port's Humanoid model against the JAX package in float64 on the CPU:
the com-x track and its reset value, frames, mass matrix, bias and the
smooth force with the joint springs, the capsule–capsule self pairs of the
model's three sphere/capsule types, the 242 constraint rows with floor and self-pair
rows active, the contact force term (`contact_force_ssq`), and one RK4
substep with its snapshot and λ. The copied tables are pinned in
test_torch_import.py.

The JAX functions run eagerly on one state, with no XLA compile: the RK4
substep in its unrolled form (`rk4_mode="unroll"`, the scan form's
arithmetic), ~40 s on this CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpopis_tpu.models import humanoid_device as jhd
from mpopis_tpu.models import spatial_contact as jsc

from mpopis_tpu_torch.models import humanoid_device as hd
from mpopis_tpu_torch.models import spatial_contact as sc

M, JM = hd.MODEL, jhd.MODEL


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions are thousands of tiny ops: one thread each keeps
    test processes that run side by side from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rtol):
    """rtol against each value, with an absolute floor of rtol × the largest."""
    want = np.asarray(want, dtype=float)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * max(np.max(np.abs(want)), 1e-300))


def _floats(v):
    return np.array([float(e) for e in v])


def _state(name, seed=1):
    """(qpos, qvel) numpy: the standing reset or the crouch, with velocities
    from a numpy seed."""
    q = np.array(jhd._QPOS0) if name == "reset" else hd.crouched_qpos(M).numpy()
    return q, np.random.default_rng(seed).uniform(-0.5, 0.5, 23)


def _jax(v):
    return tuple(jnp.asarray(e) for e in v)


def test_com_x_and_its_reset_value_match_jax():
    """The stage-4 com x track at rtol 1e-15, and x[47] of the reset bitwise."""
    assert hd._COM_X0 == jhd._COM_X0
    for name in ("reset", "crouch"):
        q, _ = _state(name)
        np.testing.assert_allclose(float(hd.com_x(torch.as_tensor(q))), float(jhd._com_x(_jax(q))),
                                   rtol=1e-15)


@pytest.mark.parametrize("name", ["reset", "crouch"])
def test_frames_mass_bias_and_springs_match_jax(name):
    """World frames, the mass matrix, the bias and the smooth force, whose
    joint springs pull the crouch's bent hinges back (the first model with
    springs), at 1e-12."""
    q, qv = _state(name)
    tau = np.zeros(23)
    for i, (dof, gear) in enumerate(hd._ACTUATORS):
        tau[dof] = gear * np.random.default_rng(2).uniform(-0.4, 0.4, 17)[i]
    jq, jqv = _jax(q), _jax(qv)
    jfr = jsc.frames(JM, jq)
    fr = sc.frames(M, torch.as_tensor(q))
    for bi in range(len(M.bodies)):
        _close(fr.origin[bi].numpy(), _floats(jfr.origin[bi]), 1e-12)
        _close(fr.rot[bi].numpy().ravel(), _floats(jfr.rot[bi]), 1e-12)
    jm = jsc.mass_entries_analytic(JM, jq, jfr)
    want_m = np.array([[float(jm[max(i, j)][min(i, j)]) for j in range(23)] for i in range(23)])
    _close(sc.mass_entries_analytic(M, torch.as_tensor(q)).numpy(), want_m, 1e-12)
    _close(sc.bias_analytic(M, torch.as_tensor(q), torch.as_tensor(qv)).numpy(),
           _floats(jsc.bias_analytic(JM, jq, jqv, jfr)), 1e-12)
    smooth = sc.qfrc_smooth(M, torch.as_tensor(q), torch.as_tensor(qv), torch.as_tensor(tau))
    _close(smooth.numpy(), _floats(jhd._qfrc_smooth_fn(jq, jqv, _jax(tau), jfr)), 1e-12)
    springs = torch.as_tensor(M.stiffness) * sc.q_of_dof(M, torch.as_tensor(q))
    assert (springs.abs() > 0).sum() == (0 if name == "reset" else 14)


@pytest.mark.parametrize("name", ["reset", "crouch"])
def test_capsule_capsule_matches_jax(name):
    """dist, normal and contact point of the 109 self pairs at 1e-12, over
    the model's three types (sphere–sphere, sphere–capsule, capsule–capsule:
    MuJoCo orders a sphere first, so no pair is capsule–sphere); the crouch
    has 4 pairs inside their margin."""
    types = {(any(p.a1[i] != p.b1[i] for i in range(3)), any(p.a2[i] != p.b2[i] for i in range(3)))
             for p in M.self_pairs}
    assert types == {(False, False), (False, True), (True, True)}
    q, _ = _state(name)
    dist, nvec, cp = sc.capsule_capsule(M, sc.frames(M, torch.as_tensor(q)))
    jfr = jsc.frames(JM, _jax(q))
    for i, pair in enumerate(JM.self_pairs):
        jd, jn, jcp = jsc._capsule_capsule(JM, jfr, pair)
        np.testing.assert_allclose(float(dist[i]), float(jd), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(nvec[i].numpy(), _floats(jn), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(cp[i].numpy(), _floats(jcp), rtol=1e-12, atol=1e-12)
    assert int((dist < 0.002).sum()) == (0 if name == "reset" else 4)


@pytest.mark.parametrize("name", ["reset", "crouch"])
def test_contact_rows_match_jax(name):
    """The 242 rows (17 limits, 29 × 4 pyramid rows, 109 self pairs): J, aref,
    R and the valid rows at 1e-12; in the crouch floor and self-pair rows
    are valid at once."""
    q, qv = _state(name)
    jmat, aref, reg, act = sc.contact_rows(M, torch.as_tensor(q), torch.as_tensor(qv))
    rows = jsc.contact_rows(JM, _jax(q), _jax(qv), jnp.float64(0.0))
    assert len(rows) == jmat.shape[-2] == M.n_rows == 242
    _close(jmat.numpy(), np.array([_floats(j) for j, *_ in rows]), 1e-12)
    _close(aref.numpy(), [float(r[1]) for r in rows], 1e-12)
    _close(reg.numpy(), [float(r[2]) for r in rows], 1e-12)
    assert act.tolist() == [bool(r[3]) for r in rows]
    if name == "crouch":
        assert act[17:133].any() and act[133:].any()


def test_contact_force_ssq_matches_jax():
    """Σ‖cfrc_ext‖² of the same λ (random, ≥ 0, on every row) at the crouch
    and at the reset, at 1e-12; limit rows carry no force."""
    rng = np.random.default_rng(3)
    for name in ("reset", "crouch"):
        q, _ = _state(name)
        lam = rng.uniform(0.0, 5.0, M.n_rows)
        got = sc.contact_force_ssq(M, torch.as_tensor(q), torch.as_tensor(lam))
        want = jsc.contact_force_ssq(JM, _jax(q), _jax(lam))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-12)
        lam[:17] = 1e3
        np.testing.assert_allclose(
            float(sc.contact_force_ssq(M, torch.as_tensor(q), torch.as_tensor(lam))),
            float(got), rtol=1e-15)


def test_rk4_substep_matches_jax():
    """One RK4 substep from the crouch with springs, floor and self-pair rows
    active, warm-started from a nonzero λ: q', q̇', λ and the stage-4
    snapshot at rtol 1e-10."""
    q, qv = _state("crouch")
    rng = np.random.default_rng(4)
    tau = np.zeros(23)
    for dof, gear in hd._ACTUATORS:
        tau[dof] = gear * rng.uniform(-0.4, 0.4)
    lam0 = rng.uniform(0.0, 1e-2, M.n_rows)
    substep = jsc.build_spatial_stepper(JM, rk4_mode="unroll")[0]
    want = substep(_jax(q), _jax(qv), _jax(tau), 3, 6, jnp.asarray(lam0))
    got = sc.rk4_substep(M, torch.as_tensor(q), torch.as_tensor(qv), torch.as_tensor(tau), 3, 6,
                         torch.as_tensor(lam0))
    for g, w in zip(got, want):
        _close(g.numpy(), np.asarray(w, dtype=float) if not isinstance(w, tuple) else _floats(w),
               1e-10)
    assert float(got[2].abs().sum()) > 0.0
