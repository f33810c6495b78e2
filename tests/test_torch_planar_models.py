"""The port's planar-contact models (HalfCheetah, Hopper, Walker2d) against
the JAX package in float64 on the CPU: the copied tables, frames, the
analytic mass matrix and bias, the constraint rows (the port's dense J
against the JAX scalar rows), the box-QP solve and one Euler-implicit or
RK4 substep, from states with contacts inactive, shallow contacts,
Hopper's capsule-capsule pairs, and deep multi-contact drops. The control
steps and rollout costs are in tests/test_torch_planar_kernel.py
(HalfCheetah, Hopper) and tests/test_torch_planar_walker.py (Walker2d).

The JAX QP and substeps run with `jax.disable_jit()`: their scalar graphs
take up to a minute each to compile on the CPU, and op by op they take
seconds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpopis_tpu.models import cheetah_device as jcheetah
from mpopis_tpu.models import hopper_device as jhopper
from mpopis_tpu.models import planar as jplanar
from mpopis_tpu.models import planar_contact as jpc
from mpopis_tpu.models import walker2d_device as jwalker

from mpopis_tpu_torch.models import (
    CheetahDeviceEnv,
    HopperDeviceEnv,
    Walker2dDeviceEnv,
    cheetah_device,
    hopper_device,
    planar_contact as pc,
    walker2d_device,
)
from mpopis_tpu_torch.models.planar import chol_solve, chol_unrolled, impedance
from mpopis_tpu_torch.utils import convert

MODELS = {
    "cheetah": (jcheetah, cheetah_device, CheetahDeviceEnv),
    "hopper": (jhopper, hopper_device, HopperDeviceEnv),
    "walker2d": (jwalker, walker2d_device, Walker2dDeviceEnv),
}

# (model, q, qv): random joints ±0.3 and velocities ±1 from a numpy seed,
# with the root height set; "crumpled" is a folded Hopper whose torso-foot
# and torso-leg capsule pairs touch.
_CRUMPLED = [0.0, 1.25, 0.274, -1.899, -2.493, -0.754]
STATES = {
    "cheetah-free": ("cheetah", 0, 0.3),
    "cheetah-contact": ("cheetah", 0, -0.1),
    "hopper-free": ("hopper", 0, 1.4),
    "hopper-contact": ("hopper", 1, 1.15),
    "hopper-pairs": ("hopper", 2, _CRUMPLED),
    "walker2d-free": ("walker2d", 0, 1.4),
    "walker2d-contact": ("walker2d", 2, 1.2),
}
DEEP = {  # many simultaneous contacts: an ill-conditioned QP
    "cheetah-drop": ("cheetah", 0, -0.35),
    "hopper-deep": ("hopper", 2, 1.1),
    "walker2d-deep": ("walker2d", 3, 1.15),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions are thousands of tiny ops: one thread each keeps
    test processes that run side by side from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state(name, table=STATES):
    model_name, seed, z = table[name]
    jmod, mod, _ = MODELS[model_name]
    n = mod.MODEL.n_dof
    rng = np.random.default_rng(seed)
    q = rng.uniform(-0.3, 0.3, n)
    qv = rng.uniform(-1.0, 1.0, n)
    if isinstance(z, list):
        q[:] = z
    else:
        q[1] = z
    tau = np.concatenate([np.zeros(3), rng.uniform(-1, 1, n - 3) * np.array(mod.MODEL.gear)])
    return jmod.MODEL, mod.MODEL, q, qv, tau


def _j(v):
    return tuple(jnp.float64(x) for x in v)


def _f(seq):
    return np.array([float(x) for x in seq])


def _close(got, want, rtol):
    """rtol against each value, with an absolute floor of rtol × the largest."""
    want = np.asarray(want, dtype=float)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * max(np.max(np.abs(want)), 1e-300))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_tables_match_jax_field_by_field(name):
    jmod, mod, env_cls = MODELS[name]
    jm = jmod.MODEL
    rebuilt = convert.planar_model(dataclasses.asdict(jm))
    assert rebuilt == mod.MODEL
    ours, theirs = dataclasses.asdict(mod.MODEL), dataclasses.asdict(jm)
    assert [f.name for f in dataclasses.fields(mod.MODEL)] == list(theirs)
    for name_ in theirs:
        assert ours[name_] == theirs[name_], name_
    assert mod.MODEL.n_rows == jm.n_rows and mod.MODEL.chains == jm.chains
    for dmax in {lm.solimp[1] for lm in jm.limits} | {c.solimp[1] for c in jm.contacts}:
        assert mod.MODEL.kb(dmax) == jm.kb(dmax)
    env = env_cls(device="cpu")
    assert env.FRAME_SKIP == jmod._FRAME_SKIP
    jenv = getattr(jmod, env_cls.__name__)(dtype=jnp.float64)
    assert env.dt == jenv.dt
    assert (env.state_dim, env.action_dim) == (jenv.state_dim, jenv.action_dim)
    np.testing.assert_array_equal(env.reset().x.numpy(), np.asarray(jenv.reset().x))
    assert (env.solver_outer, env.solver_cg) == (jenv.solver_outer, jenv.solver_cg) == (3, 6)


def test_impedance_and_cholesky_match_jax():
    pos = np.linspace(-0.05, 0.05, 41)
    for solimp in ((0.0, 0.8, 0.01), (0.9, 0.95, 0.001), (0.8, 0.8, 0.01)):
        want = np.asarray(jplanar.impedance(jnp.asarray(pos), *solimp))
        np.testing.assert_allclose(impedance(torch.as_tensor(pos), *solimp).numpy(), want,
                                   rtol=1e-15)
    _, model, q, _, _ = _state("walker2d-contact")
    m = pc.mass_entries_analytic(model, torch.as_tensor(q))
    l_port = chol_unrolled(m)
    l_jax = jplanar.chol_unrolled([[float(m[i, j]) for j in range(i + 1)] for i in range(9)], 9)
    for i in range(9):
        for j in range(i + 1):
            assert abs(float(l_port[i, j]) - float(l_jax[i][j])) <= 1e-13 * abs(float(l_jax[i][i]))
    b = np.arange(1.0, 10.0)
    np.testing.assert_allclose(chol_solve(l_port, torch.as_tensor(b)).numpy(),
                               _f(jplanar.chol_solve_unrolled(l_jax, list(b), 9)), rtol=1e-12)


@pytest.mark.parametrize("name", sorted(STATES) + sorted(DEEP))
def test_frames_mass_bias_rows_match_jax(name):
    jm, model, q, qv, _ = _state(name, STATES if name in STATES else DEEP)
    n = model.n_dof
    tq, tqv = torch.as_tensor(q), torch.as_tensor(qv)
    for got, want in zip(pc.frames(model, tq), jpc.frames(jm, _j(q))):
        _close(_f(got), _f(want), 1e-13)
    m = pc.mass_entries_analytic(model, tq)
    m_jax = jpc.mass_entries_analytic(jm, _j(q))
    for i in range(n):
        np.testing.assert_allclose(m[i, : i + 1].numpy(), _f(m_jax[i]), rtol=1e-13, atol=1e-14)
    assert torch.equal(m, m.T)
    _close(pc.bias_analytic(model, tq, tqv).numpy(), _f(jpc.bias_analytic(jm, _j(q), _j(qv))),
           1e-12)

    zero = jnp.float64(0.0)
    rows = jpc.contact_rows(jm, _j(q), _j(qv), zero)
    jmat, aref, r_reg, active = pc.contact_rows(model, tq, tqv)
    dense = np.array([[0.0 if e is zero else float(e) for e in j] for j, *_ in rows])
    assert jmat.shape == (model.n_rows, n) == dense.shape
    np.testing.assert_array_equal(jmat.numpy() == 0.0, dense == 0.0)  # structural zeros
    _close(jmat.numpy(), dense, 1e-13)
    _close(aref.numpy(), _f(r[1] for r in rows), 1e-12)
    _close(r_reg.numpy(), _f(r[2] for r in rows), 1e-12)
    assert active.tolist() == [bool(r[3]) for r in rows]
    if name == "hopper-pairs":
        assert active[-3:].sum() == 2  # torso-leg and torso-foot touch
    kind = name.split("-")[1]
    n_lim = len(model.limits)
    contact_active = int(active[n_lim:].sum())
    assert (contact_active == 0) == (kind == "free")


def _jax_qp_inputs(jm, q, qv, tau):
    m = jpc.mass_entries_analytic(jm, _j(q))
    l = jplanar.chol_unrolled(m, jm.n_dof)
    _, _, _, smooth_fn, _ = jpc.build_contact_stepper(jm)
    smooth = smooth_fn(_j(q), _j(qv), _j(tau))
    zero = jnp.float64(0.0)
    return jpc.contact_rows(jm, _j(q), _j(qv), zero), zero, l, jplanar.chol_solve_unrolled(
        l, smooth, jm.n_dof)


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("name", ["cheetah-contact", "hopper-pairs", "walker2d-contact"])
def test_solve_qp_matches_jax(name, warm):
    jm, model, q, qv, tau = _state(name)
    lam0 = np.random.default_rng(4).uniform(0.0, 50.0, model.n_rows) if warm else None
    rows, zero, l, a_smooth = _jax_qp_inputs(jm, q, qv, tau)
    with jax.disable_jit():
        qfrc_j, lam_j = jpc.solve_qp(
            rows, zero, l, a_smooth, 3, 6, jm.n_dof,
            lam0=None if lam0 is None else jnp.asarray(lam0), return_lam=True,
        )
    tq, tqv = torch.as_tensor(q), torch.as_tensor(qv)
    l_t = chol_unrolled(pc.mass_entries_analytic(model, tq))
    a_t = chol_solve(l_t, pc.qfrc_smooth(model, tq, tqv, torch.as_tensor(tau)))
    jmat, aref, r_reg, active = pc.contact_rows(model, tq, tqv)
    qfrc, lam = pc.solve_qp(jmat, aref, r_reg, active, l_t, a_t, 3, 6,
                            None if lam0 is None else torch.as_tensor(lam0))
    assert float(lam.max()) > 0.0  # the contacts carry force
    _close(lam.numpy(), np.asarray(lam_j), 1e-12)
    _close(qfrc.numpy(), _f(qfrc_j), 1e-12)


def _substeps(name, table):
    jm, model, q, qv, tau = _state(name, table)
    sub_j, *_ = jpc.build_contact_stepper(jm)
    with jax.disable_jit():
        qj, vj, lj = sub_j(_j(q), _j(qv), _j(tau), 3, 6, None)
    sub_t = pc.build_contact_stepper(model)[0]
    qt, vt, lt = sub_t(torch.as_tensor(q), torch.as_tensor(qv), torch.as_tensor(tau), 3, 6)
    return (qt, vt, lt), (_f(qj), _f(vj), np.asarray(lj))


@pytest.mark.parametrize("name", sorted(STATES))
def test_substep_matches_jax(name):
    """One Euler-implicit (HalfCheetah) or RK4 (Hopper, Walker2d) substep,
    cold-started: rtol 1e-12."""
    got, want = _substeps(name, STATES)
    for g, w in zip(got, want):
        _close(g.numpy(), w, 1e-12)


@pytest.mark.parametrize("name", sorted(DEEP))
def test_substep_matches_jax_deep_contact(name):
    """Deep multi-contact states: 9-13 active rows on 6-9 dofs make the QP
    ill-conditioned, so rounding order alone moves λ far above 1e-12 — the
    JAX package's own jitted and op-by-op substeps differ by 1.1e-10
    (relative, λ) on the HalfCheetah drop. Held at rtol 1e-8."""
    got, want = _substeps(name, DEEP)
    for g, w in zip(got, want):
        _close(g.numpy(), w, 1e-8)
