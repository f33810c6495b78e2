"""The port's Pusher model against the JAX package in float64 on the CPU:
the copied tables, the capsule–cylinder contact (witness point, distance,
normal) on the object's side, cap and rim, the constraint rows with the
condim-1 floor rows and the pair rows active, one Euler-implicit substep
with its snapshot, and the control step and reward with the stale-xpos
semantics over 3 control steps.

The JAX substep runs jitted once per module (~20 s to compile on this CPU)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpopis_tpu.models import pusher_device as jpd
from mpopis_tpu.models import spatial_contact as jsc

from mpopis_tpu_torch.models import PusherDeviceEnv, pusher_device as pd
from mpopis_tpu_torch.models import spatial_contact as sc
from mpopis_tpu_torch.models.base import make_state
from mpopis_tpu_torch.utils import convert


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


def pusher_state(z_tip, dx, seed=0):
    """`touching_state` with small random velocities from a numpy seed."""
    rng = np.random.default_rng(seed)
    qv = np.concatenate([rng.uniform(-0.3, 0.3, 7), rng.uniform(-0.1, 0.1, 4)])
    return pd.touching_state(z_tip, dx, qv).numpy()


# (z of the capsule axis, horizontal offset of the cylinder axis): the side
# wall at mid-height 1 mm inside the capsule radius, the cap from above, the
# rim diagonally, and the arm pressed into the table beside the object
R1, R2, TOP = 0.02, 0.05, -0.275 + 0.05
STARTS = {
    "side": (-0.275, R2 + R1 - 0.001),
    "cap": (TOP + R1 - 0.001, 0.0),
    "rim": (TOP + 0.7 * R1, R2 + 0.7 * R1),
    "floor": (-0.325 + R1 - 0.002, R2 + R1 - 0.002),
}


def test_tables_match_jax_field_by_field():
    jm = jpd.MODEL
    assert convert.spatial_model(dataclasses.asdict(jm)) == pd.MODEL
    ours, theirs = dataclasses.asdict(pd.MODEL), dataclasses.asdict(jm)
    assert list(ours) == list(theirs)
    for name in theirs:
        assert ours[name] == theirs[name], name
    assert pd.MODEL.n_rows == jm.n_rows == 20
    assert pd.MODEL.chains == jm.chains and pd.MODEL.dof_joints == tuple(
        (bi, sc.SJoint(**dataclasses.asdict(j))) for bi, j in jm.dof_joints)
    assert pd.MODEL.kb(0.95) == jm.kb(0.95)
    assert pd._XPOS0 == jpd._XPOS0 and (pd._B_TIPS, pd._B_OBJ, pd._B_GOAL) == (9, 10, 11)
    assert pd._ACTUATORS == jpd._ACTUATORS
    env, jenv = PusherDeviceEnv(device="cpu"), jpd.PusherDeviceEnv(dtype=jnp.float64)
    assert (env.FRAME_SKIP, env.dt) == (jpd._FRAME_SKIP, jenv.dt)
    assert (env.state_dim, env.action_dim) == (jenv.state_dim, jenv.action_dim) == (31, 7)
    np.testing.assert_array_equal(env.action_high, jenv.action_high)
    env64 = PusherDeviceEnv(dtype=torch.float64, device="cpu")
    np.testing.assert_array_equal(env64.reset().x.numpy(), np.asarray(jenv.reset().x))
    assert (env.solver_outer, env.solver_cg) == (jenv.solver_outer, jenv.solver_cg) == (3, 6)
    # the xpos of qpos0 is the FK of qpos0
    np.testing.assert_allclose(pd.xpos9(torch.zeros(11, dtype=torch.float64)).numpy(),
                               pd._XPOS0, atol=1e-12)


@pytest.mark.parametrize("name", sorted(STARTS))
def test_capsule_cylinder_matches_jax(name):
    """dist, normal and contact point of the 3 pairs at 1e-12, and the region
    the start was built for."""
    x = pusher_state(*STARTS[name])
    q = torch.as_tensor(x[:11])
    dist, nvec, cp = sc.capsule_cylinder(pd.MODEL, sc.frames(pd.MODEL, q))
    jfr = jsc.frames(jpd.MODEL, tuple(jnp.asarray(v) for v in x[:11]))
    for i, pair in enumerate(jpd.MODEL.pairs):
        jd, jn, jcp = jsc._capsule_cylinder(jpd.MODEL, jfr, pair)
        np.testing.assert_allclose(float(dist[i]), float(jd), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(nvec[i].numpy(), np.array([float(v) for v in jn]),
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(cp[i].numpy(), np.array([float(v) for v in jcp]),
                                   rtol=1e-12, atol=1e-12)
    n0 = nvec[0].numpy()
    assert float(dist[0]) < pd.MODEL.pairs[0].margin
    if name == "side":
        assert abs(n0[2]) < 1e-9
    elif name == "cap":
        assert abs(n0[2]) > 1 - 1e-9
    elif name == "rim":
        assert min(abs(n0[0]), abs(n0[2])) > 0.1


@pytest.mark.parametrize("name", ["side", "floor"])
def test_contact_rows_match_jax(name):
    """J, aref, R and the valid rows at 1e-12, the condim-1 floor rows and the
    pair rows active."""
    x = pusher_state(*STARTS[name])
    q, qv = x[:11], x[11:22]
    jmat, aref, reg, act = sc.contact_rows(pd.MODEL, torch.as_tensor(q), torch.as_tensor(qv))
    zero = jnp.float64(0.0)
    rows = jsc.contact_rows(jpd.MODEL, tuple(jnp.asarray(v) for v in q),
                            tuple(jnp.asarray(v) for v in qv), zero)
    assert len(rows) == jmat.shape[-2] == 20
    want_j = np.array([[float(e) for e in j] for j, *_ in rows])
    _close(jmat.numpy(), want_j, 1e-12)
    _close(aref.numpy(), [float(r[1]) for r in rows], 1e-12)
    _close(reg.numpy(), [float(r[2]) for r in rows], 1e-12)
    assert act.tolist() == [bool(r[3]) for r in rows]
    assert act[17:].any()  # a pair row
    if name == "floor":
        assert act[11:17].any()  # a condim-1 floor row


@pytest.fixture(scope="module")
def jax_euler():
    substep = jsc.build_spatial_stepper(jpd.MODEL)[0]

    def one(x, tau, lam):
        q, qv, lam, q_snap = substep(tuple(x[:11]), tuple(x[11:22]), tuple(tau), 3, 6, lam)
        return jnp.stack(q), jnp.stack(qv), lam, jnp.stack(q_snap)

    return jax.jit(jax.vmap(one))


def test_euler_substep_matches_jax(jax_euler):
    """One Euler-implicit substep from each start, warm-started from a nonzero
    λ, its pre-integration snapshot included; rtol 1e-10."""
    x = np.stack([pusher_state(*STARTS[name], seed=i) for i, name in enumerate(sorted(STARTS))])
    tau = np.concatenate([np.random.default_rng(7).uniform(-2, 2, (len(x), 7)),
                          np.zeros((len(x), 4))], axis=1)
    lam0 = np.random.default_rng(8).uniform(0, 1e-3, (len(x), 20))
    want = jax_euler(jnp.asarray(x), jnp.asarray(tau), jnp.asarray(lam0))
    got = sc.euler_implicit_substep(pd.MODEL, torch.as_tensor(x[:, :11]),
                                    torch.as_tensor(x[:, 11:22]), torch.as_tensor(tau), 3, 6,
                                    torch.as_tensor(lam0))
    for g, w in zip(got, want):
        _close(g.numpy(), w, 1e-10)
    np.testing.assert_array_equal(got[3].numpy(), x[:, :11])


def test_step_reward_and_observation_match_jax():
    """`step` and `step_reward` over 3 control steps from the contact starts,
    actions beyond ±2 (the torque clamps, the reward reads them raw): the
    reward reads the pre-step xpos snapshot the state carries; rtol 1e-9."""
    x = np.stack([pusher_state(*STARTS[name], seed=i) for i, name in enumerate(sorted(STARTS))])
    acts = np.random.default_rng(9).uniform(-2.5, 2.5, (3, len(x), 7))
    jenv = jpd.PusherDeviceEnv(dtype=jnp.float64)
    env = PusherDeviceEnv(dtype=torch.float64, device="cpu")
    jf = jax.jit(jax.vmap(lambda v, a: jenv.step_reward(jenv.reset().replace(x=v), a)))
    js, s = jnp.asarray(x), make_state(torch.as_tensor(x))
    for t in range(3):
        jnew, jr = jf(js, jnp.asarray(acts[t]))
        s, r = env.step_reward(s, torch.as_tensor(acts[t]))
        js = jnew.x
        _close(s.x.numpy(), js, 1e-9)
        _close(r.numpy(), jr, 1e-9)
    one = make_state(torch.as_tensor(np.array(js[0])))
    jone = jenv.reset().replace(x=js[0])
    np.testing.assert_array_equal(env.observation(one).numpy(), np.asarray(jenv.observation(jone)))
    np.testing.assert_allclose(float(env.reward(one)), float(jenv.reward(jone)), rtol=1e-15)
