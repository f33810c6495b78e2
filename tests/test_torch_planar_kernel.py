"""The planar-contact rollout kernel module on the CPU: the plain version and
the env's control step against the JAX package's `rollout_batch` over
`step_reward` (the oracle of the JAX kernel's own tests) in float64, the
wrappers' CPU path, the model packing the CUDA kernel reads, and the
kernel's device code (csrc/planar_dynamics.cuh at its HalfCheetah, Hopper and
Walker2d builds, one lane a sample) built for the host with g++ against the
plain version and the JAX costs. The CUDA kernel itself is held against the
plain version on the card by tests/test_torch_cuda.py and chip_smoke.py.

HalfCheetah and Hopper are here; Walker2d's control steps are in
tests/test_torch_planar_walker.py, so that the JAX compiles (30-70 s each)
spread over test workers.
"""

import dataclasses
import shutil
import struct
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpopis_tpu.models import CheetahDeviceEnv as JCheetahDeviceEnv
from mpopis_tpu.models import HopperDeviceEnv as JHopperDeviceEnv
from mpopis_tpu.models.rollout import rollout_batch as jrollout_batch

from mpopis_tpu_torch.kernels import planar_step
from mpopis_tpu_torch.kernels.build import CSRC_DIR
from mpopis_tpu_torch.models import CheetahDeviceEnv, HopperDeviceEnv, Walker2dDeviceEnv
from mpopis_tpu_torch.models.base import make_state

ENVS = {"cheetah": CheetahDeviceEnv, "hopper": HopperDeviceEnv, "walker2d": Walker2dDeviceEnv}
K, T = 6, 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions are thousands of tiny ops: one thread each keeps
    test processes that run side by side from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _start(name, seed, z=None):
    """(x0, controls (K, T, na)): joints ±0.2 and velocities ±0.5 from a numpy
    seed, the root lowered so that contacts and joint limits are active (or
    at height z)."""
    env = ENVS[name](dtype=torch.float64, device="cpu")
    n = env.MODEL.n_dof
    rng = np.random.default_rng(seed)
    q = np.asarray(env.INIT_QPOS) + rng.uniform(-0.2, 0.2, n)
    q[0] = 0.0
    q[1] = {"cheetah": -0.1, "hopper": 1.18, "walker2d": 1.17}[name] if z is None else z
    qv = rng.uniform(-0.5, 0.5, n)
    controls = rng.uniform(-1.0, 1.0, (K, T, env.action_dim))
    return np.concatenate([q, qv]), controls


@pytest.fixture(scope="module", params=["cheetah", "hopper"])
def jax_rollout(request):
    """The JAX rollout (costs and states) of one model, jitted once."""
    name = request.param
    x0, controls = _start(name, {"cheetah": 21, "hopper": 22}[name])
    jenv = {"cheetah": JCheetahDeviceEnv, "hopper": JHopperDeviceEnv}[name](dtype=jnp.float64)
    costs, states = jax.jit(lambda x, c: jrollout_batch(jenv, jenv.reset().replace(x=x), c,
                                                        log_states=True))(
        jnp.asarray(x0), jnp.asarray(controls))
    return name, x0, controls, np.asarray(costs), np.asarray(states)


def test_control_steps_match_jax(jax_rollout):
    """`step_reward` over 3 control steps from a contact state: rtol 1e-10,
    with an absolute floor of 1e-10 × the largest state entry."""
    name, x0, controls, _, states = jax_rollout
    env = ENVS[name](dtype=torch.float64, device="cpu")
    n = env.MODEL.n_dof
    assert bool(planar_step.first_substep_active_rows(env, torch.as_tensor(x0))[1] > 0)
    s = make_state(torch.as_tensor(x0).expand(K, -1))
    for t in range(T):
        s, r = env.step_reward(s, torch.as_tensor(controls[:, t]))
        np.testing.assert_allclose(s.x.numpy(), states[:, t], rtol=1e-10,
                                   atol=1e-10 * np.abs(states[:, t]).max())
        x_prev = x0[0] if t == 0 else states[:, t - 1, 0]
        want_r = (env.HEALTHY + (states[:, t, 0] - x_prev) / env.dt
                  - env.CTRL_W * np.sum(controls[:, t] ** 2, -1))
        # the reward is a difference of positions over dt: the state's
        # absolute tolerance carries over, divided by dt
        np.testing.assert_allclose(r.numpy(), want_r, rtol=1e-10,
                                   atol=2e-10 * np.abs(states[:, t]).max() / env.dt)
    assert s.t == T and s.x.shape == (K, 2 * n)


def test_plain_rollout_costs_match_jax(jax_rollout):
    name, x0, controls, costs, _ = jax_rollout
    env = ENVS[name](dtype=torch.float64, device="cpu")
    got = planar_step.planar_rollout_costs_tak_reference(
        env, torch.as_tensor(x0), torch.as_tensor(controls.transpose(1, 2, 0)))
    assert got.shape == (K,) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), costs, rtol=1e-10)


@pytest.mark.parametrize("name", sorted(ENVS))
def test_wrappers_on_cpu_run_the_plain_versions_without_launching(name):
    env = ENVS[name](dtype=torch.float64, device="cpu")
    x0 = env.reset().x
    # beyond ±1, so that both paths clamp the torques
    ctrl_tak = torch.as_tensor(np.random.default_rng(5).uniform(-1.2, 1.2, (T, env.action_dim, K)))
    launches, step_launches = planar_step.LAUNCHES, planar_step.STEP_LAUNCHES
    want = planar_step.planar_rollout_costs_tak_reference(env, x0, ctrl_tak)
    assert torch.equal(planar_step.planar_rollout_costs_tak(env, x0, ctrl_tak), want)
    assert torch.equal(env.fused_rollout_costs_tak(make_state(x0), ctrl_tak), want)
    assert torch.equal(env.fused_rollout_costs(make_state(x0), ctrl_tak.permute(2, 0, 1)), want)
    xs = x0.expand(K, -1)
    acts = ctrl_tak[0].T
    plain = env.plain_step(make_state(xs), acts).x
    assert torch.equal(planar_step.planar_step_states(env, xs, acts), plain)
    assert torch.equal(env.step(make_state(xs), acts).x, plain)
    assert (planar_step.LAUNCHES, planar_step.STEP_LAUNCHES) == (launches, step_launches)


@pytest.mark.parametrize("name", sorted(ENVS))
def test_kernel_model_packing_follows_the_layout(name):
    """The flat int and double arrays hold what `make_model` in
    csrc/planar_rollout.cu reads, in its order and counts."""
    env = ENVS[name]()
    model = env.MODEL
    ints, dbl = planar_step.kernel_model(model, env.FRAME_SKIP, 3, 6, float(env.HEALTHY),
                                         float(env.CTRL_W))
    n, nb, na = model.n_dof, len(model.bodies), len(model.gear)
    nc, nl, npair = len(model.contacts), len(model.limits), len(model.pairs)
    assert list(ints)[:10] == [n, nb, nc, nl, npair, int(model.integrator == "rk4"),
                               env.FRAME_SKIP, 3, 6, na]
    assert len(ints) == 10 + 2 * nb + nc + nl + 4 * npair
    assert len(dbl) == 9 + 4 * n + na + 9 * nb + 8 * nl + 12 * nc + 17 * npair
    h = model.timestep
    assert list(dbl)[:9] == [*model.root_offset, model.gravity, h, 0.5 * h, h / 6.0,
                             env.HEALTHY, env.CTRL_W, 1.0 / (h * env.FRAME_SKIP)]
    chains = model.chains
    for b in range(nb):  # parent, then the bit mask of the root-ward chain
        assert ints[10 + 2 * b] == model.bodies[b].parent
        assert ints[11 + 2 * b] == sum(1 << c for c in chains[b])
    pair_ints = list(ints)[10 + 2 * nb + nc + nl:]
    for i, p in enumerate(model.pairs):  # the symmetric difference of the chains
        b1, b2, plus, minus = pair_ints[4 * i: 4 * i + 4]
        assert (b1, b2) == (p.body1, p.body2)
        assert plus & minus == 0
        assert plus | minus == sum(1 << c for c in set(chains[b1]) ^ set(chains[b2]))


def test_kernel_model_rejects_what_the_kernel_cannot_take():
    model = HopperDeviceEnv.MODEL
    swapped = dataclasses.replace(model, bodies=(model.bodies[0], dataclasses.replace(
        model.bodies[1], dof=4), *model.bodies[2:]))
    with pytest.raises(ValueError, match="hinge dof"):
        planar_step.kernel_model(swapped, 4, 3, 6, 1.0, 1e-3)
    too_many = dataclasses.replace(model, contacts=model.contacts * 3)
    with pytest.raises(ValueError, match="too many"):
        planar_step.kernel_model(too_many, 4, 3, 6, 1.0, 1e-3)


def test_first_substep_active_rows_counts_limits_and_contacts():
    env = CheetahDeviceEnv(dtype=torch.float64, device="cpu")
    x = env.reset().x.clone()
    assert planar_step.first_substep_active_rows(env, x) == (0, 0)
    x[1] = -0.35
    n_lim, n_con = planar_step.first_substep_active_rows(env, x)
    assert n_lim == 0 and n_con > 0 and n_con % 3 == 0


# -- the kernel's device code built for the host, one lane a sample -------------
# start -> (model, seed, x[1] or None for `_start`'s): contacts and limits; a
# deep drop with 45 rows valid in the first substep, past the 32 of the
# dense operator; 33 and 32 rows, the first past the dense path and its last
# (with 32 and 0 mod 4 valid rows its 16-byte reads have no remainder); the
# body 2 m up, no row valid.
HOST_STARTS = {
    "cheetah": ("cheetah", 21, None),
    "hopper": ("hopper", 22, None),
    "walker2d": ("walker2d", 23, None),
    "cheetah_deep": ("cheetah", 21, -0.7),
    "walker2d_33": ("walker2d", 22, 0.26),
    "walker2d_32": ("walker2d", 25, 0.26),
    "cheetah_air": ("cheetah", 21, 2.0),
}
HOST_ROWS = {"cheetah_deep": 45, "walker2d_33": 33, "walker2d_32": 32, "cheetah_air": 0}
NUDGED = ("walker2d", "cheetah_deep", "walker2d_33", "walker2d_32")  # held by the nudge rule


@pytest.fixture(scope="module")
def host_check(tmp_path_factory):
    """tests/planar_host_check.cpp built with g++ against the kernels' device
    code (all four builds); skips where there is no g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel's device code for the host")
    exe = tmp_path_factory.mktemp("host") / "planar_host_check"
    src = Path(__file__).with_name("planar_host_check.cpp")
    subprocess.run([gxx, "-O1", "-std=c++17", f"-I{CSRC_DIR}", "-o", str(exe), str(src)],
                   check=True, capture_output=True, timeout=300)
    return exe


def _run_host(exe, env, mode, x, actions, k, horizon, tag):
    ints, dbl = planar_step._env_model(env)
    data = struct.pack("3i", int(env.dtype == torch.float64), len(ints), len(dbl))
    data += np.asarray(list(ints), np.int32).tobytes() + np.asarray(list(dbl)).tobytes()
    data += struct.pack("3i", mode, k, horizon)
    data += np.asarray(x, np.float64).tobytes() + np.asarray(actions, np.float64).tobytes()
    path = Path(f"{exe}.{tag}.in")
    path.write_bytes(data)
    out = subprocess.run([str(exe), str(path)], capture_output=True, text=True, check=True,
                         timeout=300).stdout
    return np.array([[float(v) for v in line.split()] for line in out.strip().splitlines()])


def _hold(got, want, runs, rtol, atol):
    """Each sample (a row) within rtol, plus atol over its largest entry, of
    its largest entry, or (the nudge rule) within 10x the most the plain
    version moves under the nudged inputs of `runs`."""
    scale = np.abs(want).max(-1)
    err = np.abs(got - want).max(-1) / scale
    own = np.max([np.abs(r - want).max(-1) / scale for r in runs], axis=0)
    bad = (err > rtol + atol / scale) & (err > 10 * own)
    assert not bad.any(), f"samples {np.flatnonzero(bad)}: {err[bad]} (own spreads {own[bad]})"


# dtype -> (rtol, atol, the relative nudge of the plain version's inputs)
HOST_TOL = {torch.float64: (1e-10, 0.0, 1e-15), torch.float32: (2e-4, 2e-3, 1e-6)}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("start", sorted(HOST_STARTS))
def test_kernel_code_built_for_the_host_matches_the_plain_version(host_check, start, dtype):
    """Both entries of the build the model picks, compiled for the CPU: costs
    of (T, na, K) controls and one control step of 4 states around the start.
    f64 at rtol 1e-10, f32 at the JAX kernel tests' rtol 2e-4 / atol 2e-3;
    Walker2d and the deep starts (NUDGED) by the nudge rule, their contact
    QPs turning rounding into other iterates (from the deep drop the plain
    version's own costs move by up to 2.2e-10 in f64 and 2.1e-2 in f32 under
    a nudge of the controls, sample 3 of 6)."""
    name, seed, z = HOST_STARTS[start]
    rtol, atol, e = HOST_TOL[dtype]
    env = ENVS[name](dtype=dtype, device="cpu")
    x0, controls = _start(name, seed, z)
    x = torch.as_tensor(x0, dtype=dtype)
    rows = sum(planar_step.first_substep_active_rows(env, x))
    assert rows == HOST_ROWS[start] if start in HOST_ROWS else rows > 0
    ctrl = torch.as_tensor(controls.transpose(1, 2, 0).copy(), dtype=dtype)
    ref = planar_step.planar_rollout_costs_tak_reference
    want = ref(env, x, ctrl).double().numpy()
    tag = f"{start}.{str(dtype)[6:]}"
    got = _run_host(host_check, env, 0, x.double().numpy(), ctrl.double().numpy(), K, T, tag)
    rng = np.random.default_rng(seed)
    xs = x + torch.as_tensor(rng.uniform(-0.05, 0.05, (4, x.numel())), dtype=dtype)
    acts = torch.as_tensor(rng.uniform(-1.2, 1.2, (4, env.action_dim)), dtype=dtype)

    def step(xs, acts):
        return env.plain_step(make_state(xs), acts).x.double().numpy()

    want_s = step(xs, acts)
    got_s = _run_host(host_check, env, 1, xs.double().numpy(), acts.double().numpy(), 4, 1, tag)
    atol_s = atol * np.abs(want_s).max()
    if start not in NUDGED:
        np.testing.assert_allclose(got[:, 0], want, rtol=rtol, atol=atol)
        np.testing.assert_allclose(got_s, want_s, rtol=rtol, atol=max(atol_s, rtol * np.abs(
            want_s).max()))
        return
    runs = [ref(env, x, ctrl * (1 + e)), ref(env, x, ctrl * (1 - e)), ref(env, x * (1 + e), ctrl)]
    _hold(got[:, 0:1], want[:, None], [r.double().numpy()[:, None] for r in runs], rtol, atol)
    runs_s = [step(xs, acts * (1 + e)), step(xs, acts * (1 - e)), step(xs * (1 + e), acts)]
    _hold(got_s, want_s, runs_s, rtol, atol_s)


def test_kernel_code_built_for_the_host_matches_jax(jax_rollout, host_check):
    """The f64 host build's costs against the JAX package's from the contact
    start of `jax_rollout` (HalfCheetah and Hopper): rtol 1e-10."""
    name, x0, controls, costs, _ = jax_rollout
    env = ENVS[name](dtype=torch.float64, device="cpu")
    got = _run_host(host_check, env, 0, x0, controls.transpose(1, 2, 0), K, T, f"jax.{name}")
    np.testing.assert_allclose(got[:, 0], costs, rtol=1e-10)
