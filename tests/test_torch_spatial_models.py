"""The port's spatial-contact model (Ant) against the JAX package in float64
on the CPU: the copied tables, frames, the analytic mass matrix and bias,
the constraint rows (the port's dense J against the JAX scalar rows) and
one RK4 substep with its λ, from the reset (ankle limits violated), a
tilted free-flight state, a shallow floor contact and the grounded start
(x[2] = 0.75 − 0.45). The control steps are in
tests/test_torch_spatial_steps.py, the rollout costs and the kernel module
in tests/test_torch_spatial_kernel.py, the CEMPPI step in
tests/test_torch_spatial_policy.py, so that the JAX compiles (~50 s each)
spread over test workers.

The JAX frames, mass, bias and rows run op by op (a second per state);
its substep is jitted once for all states (op by op it takes minutes).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpopis_tpu.models import AntDeviceEnv as JAntDeviceEnv
from mpopis_tpu.models import ant_device as jant
from mpopis_tpu.models import spatial_contact as jsc

from mpopis_tpu_torch.models import AntDeviceEnv, ant_device
from mpopis_tpu_torch.models import spatial_contact as sc
from mpopis_tpu_torch.utils import convert


def ant_states():
    """(name, qpos (15,), qvel (14,)) for the four starts, from numpy seeds."""
    out = []
    for name, seed, z in (("reset", None, 0.75), ("free", 1, 1.5), ("shallow", 2, 0.26),
                          ("grounded", None, 0.75 - 0.45)):
        q, qv = np.zeros(15), np.zeros(14)
        q[2], q[3] = z, 1.0
        if seed is not None:  # tilted, joints within ±0.5, random velocities
            rng = np.random.default_rng(seed)
            axis = rng.normal(size=3)
            axis /= np.linalg.norm(axis)
            th = rng.uniform(0.0, 0.3 if name == "shallow" else 1.0)
            q[3:7] = np.concatenate([[np.cos(th / 2)], np.sin(th / 2) * axis])
            q[7:] = rng.uniform(-0.5, 0.5, 8)
            qv = rng.normal(size=14)
        out.append((name, q, qv))
    return out


STATES = ant_states()
NAMES = [name for name, *_ in STATES]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions are thousands of tiny ops: one thread each keeps
    test processes that run side by side from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _j(v):
    return tuple(jnp.float64(x) for x in v)


def _f(seq):
    return np.array([float(x) for x in seq])


def _close(got, want, rtol=1e-9):
    """rtol against each value, with an absolute floor of rtol × the largest."""
    want = np.asarray(want, dtype=float)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * max(np.max(np.abs(want)), 1e-300))


def test_ant_tables_match_jax_field_by_field():
    jm = jant.MODEL
    rebuilt = convert.spatial_model(dataclasses.asdict(jm))
    assert rebuilt == ant_device.MODEL
    ours, theirs = dataclasses.asdict(ant_device.MODEL), dataclasses.asdict(jm)
    assert [f.name for f in dataclasses.fields(ant_device.MODEL)] == list(theirs)
    for name in theirs:
        assert ours[name] == theirs[name], name
    for cls in (sc.SJoint, sc.SCBody, sc.SCContact, sc.SCPairCylinder, sc.SCPairCapsule,
                sc.SCLimit, sc.SpatialContactModel):
        jcls = getattr(jsc, cls.__name__)
        assert [(f.name, f.default) for f in dataclasses.fields(cls)] == [
            (f.name, f.default) for f in dataclasses.fields(jcls)], cls.__name__
    model = ant_device.MODEL
    assert model.n_rows == jm.n_rows == 108
    assert model.chains == jm.chains
    assert model.dof_joints == tuple((bi, sc.SJoint(**dataclasses.asdict(j)))
                                     for bi, j in jm.dof_joints)
    assert model.kb(0.95) == jm.kb(0.95)
    env, jenv = AntDeviceEnv(device="cpu"), JAntDeviceEnv(dtype=jnp.float64)
    assert (env.FRAME_SKIP, env.dt) == (jant._FRAME_SKIP, jenv.dt)
    assert env.ACTUATORS == jant._ACTUATORS
    assert (env.state_dim, env.action_dim) == (jenv.state_dim, jenv.action_dim) == (30, 8)
    env64 = AntDeviceEnv(dtype=torch.float64, device="cpu")
    np.testing.assert_array_equal(env64.reset().x.numpy(), np.asarray(jenv.reset().x))
    assert (env.solver_outer, env.solver_cg) == (jenv.solver_outer, jenv.solver_cg) == (3, 6)


@pytest.mark.parametrize("name,q,qv", STATES, ids=NAMES)
def test_frames_mass_bias_rows_match_jax(name, q, qv):
    model, jm = ant_device.MODEL, jant.MODEL
    tq, tqv = torch.as_tensor(q), torch.as_tensor(qv)
    fr, jfr = sc.frames(model, tq), jsc.frames(jm, _j(q))
    for bi in range(len(model.bodies)):
        _close(fr.origin[bi].numpy(), _f(jfr.origin[bi]))
        _close(fr.rot[bi].numpy().ravel(), _f(jfr.rot[bi]))
    for d in range(6, 14):  # the hinges' world axes and anchors
        _close(fr.axis[d].numpy(), _f(jfr.jaxis[d]))
        _close(fr.anchor[d].numpy(), _f(jfr.janchor[d]))
    m = sc.mass_entries_analytic(model, tq, fr)
    m_jax = jsc.mass_entries_analytic(jm, _j(q), jfr)
    for i in range(model.n_dof):
        _close(m[i, : i + 1].numpy(), _f(m_jax[i]))
    assert torch.equal(m, m.T)
    _close(sc.bias_analytic(model, tq, tqv, fr).numpy(),
           _f(jsc.bias_analytic(jm, _j(q), _j(qv), jfr)))

    zero = jnp.float64(0.0)
    rows = jsc.contact_rows(jm, _j(q), _j(qv), zero, jfr)
    jmat, aref, r_reg, active = sc.contact_rows(model, tq, tqv, fr)
    dense = np.array([[0.0 if e is zero else float(e) for e in j] for j, *_ in rows])
    assert jmat.shape == (108, 14) == dense.shape
    np.testing.assert_array_equal(jmat.numpy() == 0.0, dense == 0.0)  # structural zeros
    _close(jmat.numpy(), dense)
    _close(aref.numpy(), _f(r[1] for r in rows))
    _close(r_reg.numpy(), _f(r[2] for r in rows))
    assert active.tolist() == [bool(r[3]) for r in rows]
    n_lim, n_con = int(active[:8].sum()), int(active[8:].sum())
    assert (n_lim, n_con) == {"reset": (4, 0), "grounded": (4, 0), "shallow": (n_lim, n_con),
                              "free": (n_lim, 0)}[name]
    if name == "shallow":
        assert n_con > 0  # the torso sphere and a leg end inside the margin


@pytest.fixture(scope="module")
def jax_substep():
    """One RK4 substep of the four states in the JAX package, jitted once:
    cold-started, torques from a numpy seed."""
    q = np.stack([s[1] for s in STATES])
    qv = np.stack([s[2] for s in STATES])
    tau = np.zeros((len(STATES), 14))
    tau[:, 6:] = np.random.default_rng(5).uniform(-150.0, 150.0, (len(STATES), 8))

    def sub(qq, vv, tt):
        return jant._rk4_substep(tuple(qq[i] for i in range(15)), tuple(vv[i] for i in range(14)),
                                 tuple(tt[i] for i in range(14)), 3, 6, None)

    qj, vj, lj, q4j = jax.jit(jax.vmap(sub))(jnp.asarray(q), jnp.asarray(qv), jnp.asarray(tau))
    return q, qv, tau, [np.stack([np.asarray(c) for c in part], -1) for part in (qj, vj, q4j)] + [
        np.asarray(lj)]


@pytest.mark.parametrize("i", range(len(STATES)), ids=NAMES)
def test_rk4_substep_matches_jax(jax_substep, i):
    """q′, q̇′, the stage-4 qpos and λ of one substep: rtol 1e-9 (the QP's
    iterates differ by rounding)."""
    q, qv, tau, (qj, vj, q4j, lj) = jax_substep
    qt, vt, lt, q4t = sc.rk4_substep(ant_device.MODEL, torch.as_tensor(q[i]),
                                     torch.as_tensor(qv[i]), torch.as_tensor(tau[i]), 3, 6)
    _close(qt.numpy(), qj[i])
    _close(vt.numpy(), vj[i])
    _close(q4t.numpy(), q4j[i])
    _close(lt.numpy(), lj[i])
    assert float(lt.max()) > 0.0  # the limit rows carry force
    np.testing.assert_allclose(np.linalg.norm(qt.numpy()[3:7]), 1.0, rtol=1e-15)


def test_observation_and_reward_match_jax():
    env, jenv = AntDeviceEnv(dtype=torch.float64, device="cpu"), JAntDeviceEnv(dtype=jnp.float64)
    x = np.concatenate([STATES[1][1], STATES[1][2], [0.3]])
    s, js = env.reset().replace(x=torch.as_tensor(x)), jenv.reset().replace(x=jnp.asarray(x))
    np.testing.assert_array_equal(env.observation(s).numpy(), np.asarray(jenv.observation(js)))
    assert float(env.reward(s)) == float(jenv.reward(js))
