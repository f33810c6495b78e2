"""The Pusher's branches of the spatial rollout kernel module and its path on
the CPU: the plain rollout costs against the JAX package's `rollout_batch`
over `step_reward` (the oracle of its Pallas kernel's own tests) in float64,
the wrappers' CPU path, the packed model of the Pusher's build, the kernel's
device code (csrc/spatial_dynamics.cuh, the Pusher's build) built for the
host with g++ against the plain version, the CEMPPI step against the JAX
package's with the same injected normals, and `simulate_mujoco_on_device`
and the CLI on Pusher-v4. The CUDA kernel itself is held against the plain
version on the card by tests/test_torch_cuda.py and chip_smoke.py.

The JAX step and rollout run jitted, each compiled once per module (~20-40 s
each on this CPU)."""

import glob
import shutil
import struct
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpopis_tpu.models import pusher_device as jpd
from mpopis_tpu.models.rollout import rollout_batch as jrollout_batch
from mpopis_tpu.policies import PolicyConfig as JPolicyConfig
from mpopis_tpu.policies import make_policy as jmake_policy

from mpopis_tpu_torch.harness import simulate
from mpopis_tpu_torch.harness.cli import main
from mpopis_tpu_torch.kernels import spatial_step
from mpopis_tpu_torch.kernels.build import CSRC_DIR
from mpopis_tpu_torch.models import PusherDeviceEnv, pusher_device as pd
from mpopis_tpu_torch.models.base import make_state
from mpopis_tpu_torch.policies import PolicyConfig, make_policy

K, T = 4, 3
COV = 0.25 * np.eye(7)
SIM = dict(num_trials=1, num_steps=3, num_samples=6, horizon=2, ais_its=2, lam=0.1,
           ce_sigma_est="mle", seed=2, device="cpu", dtype=torch.float64)
# the reset, a fingertip against the object's side, the arm pressed into the
# table beside it (condim-1 floor rows and a pair row in the first substep)
STARTS = {"reset": None, "side": (-0.275, 0.069), "floor": (-0.307, 0.068)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions are thousands of tiny ops: one thread each keeps
    test processes that run side by side from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _start(name, dtype=torch.float64):
    env = PusherDeviceEnv(dtype=dtype, device="cpu")
    if STARTS[name] is None:
        return env, env.reset().x
    qv = np.random.default_rng(4).uniform(-0.3, 0.3, 11)
    return env, pd.touching_state(*STARTS[name], qv).to(dtype)


def test_first_substep_active_rows_counts_limits_contacts_and_pairs():
    """At the reset nothing touches (joints at limit bounds 0 are not past
    them); the side start has a pair row; the floor start floor rows too."""
    got = {name: spatial_step.first_substep_active_rows(*_start(name)) for name in STARTS}
    assert got["reset"] == (0, 0, 0)
    assert got["side"][1] >= 1 and got["side"][2] == 0
    x = _start("floor")[1]
    active = spatial_step.contact_rows(pd.MODEL, x[:11], x[11:22])[3]
    assert active[11:17].any() and active[17:].any()


@pytest.fixture(scope="module")
def jax_rollout():
    """The JAX rollout costs (K,) of one set of controls (K, T, 7) beyond ±2
    (the torques clamp), jitted once and run from each start."""
    controls = np.random.default_rng(21).uniform(-2.4, 2.4, (K, T, 7))
    jenv = jpd.PusherDeviceEnv(dtype=jnp.float64)
    f = jax.jit(lambda x, c: jrollout_batch(jenv, jenv.reset().replace(x=x), c)[0])
    costs = {name: np.asarray(f(jnp.asarray(_start(name)[1].numpy()), jnp.asarray(controls)))
             for name in STARTS}
    return controls, costs


@pytest.mark.parametrize("name", sorted(STARTS))
def test_plain_rollout_costs_match_jax(jax_rollout, name):
    """rtol 1e-9."""
    controls, costs = jax_rollout
    env, x = _start(name)
    got = spatial_step.spatial_rollout_costs_tak_reference(
        env, x, torch.as_tensor(controls.transpose(1, 2, 0)))
    assert got.shape == (K,) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), costs[name], rtol=1e-9)


def test_wrappers_on_cpu_run_the_plain_versions_without_launching():
    env, x0 = _start("side")
    ctrl_tak = torch.as_tensor(np.random.default_rng(5).uniform(-2.4, 2.4, (2, 7, 3)))
    launches, step_launches = spatial_step.LAUNCHES, spatial_step.STEP_LAUNCHES
    want = spatial_step.spatial_rollout_costs_tak_reference(env, x0, ctrl_tak)
    assert torch.equal(spatial_step.spatial_rollout_costs_tak(env, x0, ctrl_tak), want)
    assert torch.equal(env.fused_rollout_costs_tak(make_state(x0), ctrl_tak), want)
    xs = x0.expand(3, -1)
    acts = ctrl_tak[0].T
    plain = env.plain_step(make_state(xs), acts).x
    assert torch.equal(spatial_step.spatial_step_states(env, xs, acts), plain)
    assert torch.equal(env.step(make_state(xs), acts).x, plain)
    assert (spatial_step.LAUNCHES, spatial_step.STEP_LAUNCHES) == (launches, step_launches)


def test_kernel_model_packing_follows_the_layout():
    """The Pusher's build: the feature mask, the carry bodies, condim-1
    contacts, slide joints, the ±2 action clip, h·damping and the pairs."""
    env = PusherDeviceEnv(device="cpu")
    ints, dbl = spatial_step._env_model(env)
    ints, dbl = list(ints), list(dbl)
    nb, nj, nc, nl, na, npair = 12, 11, 6, 11, 7, 3
    feats = spatial_step.select_build(pd.MODEL, "pusher")
    assert feats == 31 == spatial_step.model_features(pd.MODEL, "pusher")
    assert (11, 11, feats) == spatial_step.PUSHER_BUILD
    assert ints[:16] == [11, 11, nb, nj, nc, nl, na, npair, 0, 5, 3, 6, feats, 9, 10, 11]
    assert len(ints) == 16 + 4 * nb + 4 * nj + 3 * nc + 2 * nl + na + 2 * npair
    assert len(dbl) == 20 + 3 * 11 + 22 * nb + 24 * nj + 16 * nc + 9 * nl + na + 19 * npair
    h = pd.MODEL.timestep
    assert dbl[:8] == [0.0, -0.325, h, 0.5 * h, 0.0, 0.0, 0.1, 2.0]
    assert dbl[20:23] == [1.0, 0.04, h * 1.0]  # dof 0: damping, armature, h·damping
    joints = ints[16 + 4 * nb: 16 + 4 * nb + 4 * nj]
    assert joints[4 * 7: 4 * 9] == [10, 2, 7, 7, 10, 2, 8, 8]  # the object's two slides
    contacts = ints[16 + 4 * nb + 4 * nj: 16 + 4 * nb + 4 * nj + 3 * nc]
    assert contacts[:3] == [8, 1, 1]  # body, has_axis, condim 1
    assert ints[-2 * npair:] == [8, 10] * 3
    p = pd.MODEL.pairs[0]
    bw = pd.MODEL.body_invweight0[8] + pd.MODEL.body_invweight0[10]
    assert dbl[-19 * npair: -19 * npair + 14] == [*p.a1, *p.b1, *p.center2, 0.02, 0.05, 0.05,
                                                  0.004, bw]


@pytest.fixture(scope="module")
def host_check(tmp_path_factory):
    """tests/spatial_host_check.cpp built with g++ against the kernel's device
    code; skips where there is no g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel's device code for the host")
    exe = tmp_path_factory.mktemp("host") / "spatial_host_check"
    src = Path(__file__).with_name("spatial_host_check.cpp")
    subprocess.run([gxx, "-O1", "-std=c++17", f"-I{CSRC_DIR}", "-o", str(exe), str(src)],
                   check=True, capture_output=True, timeout=300)
    return exe


def _run_host(exe, env, mode, x, actions, k, horizon):
    ints, dbl = spatial_step._env_model(env)
    data = struct.pack("3i", int(env.dtype == torch.float64), len(ints), len(dbl))
    data += np.asarray(list(ints), np.int32).tobytes() + np.asarray(list(dbl)).tobytes()
    data += struct.pack("4i", mode, k, horizon, env.action_dim)
    data += np.asarray(x, np.float64).tobytes() + np.asarray(actions, np.float64).tobytes()
    path = Path(str(exe) + ".pusher.in")
    path.write_bytes(data)
    out = subprocess.run([str(exe), str(path)], capture_output=True, text=True, check=True,
                         timeout=300).stdout
    return np.array([[float(v) for v in line.split()] for line in out.strip().splitlines()])


@pytest.mark.parametrize("dtype,rtol,atol", [
    (torch.float64, 1e-9, 0.0),  # the kernel's f64 bound
    (torch.float32, 2e-4, 2e-3),  # the JAX kernel tests' f32 tolerance
])
@pytest.mark.parametrize("name", sorted(STARTS))
def test_kernel_code_built_for_the_host_matches_the_plain_version(host_check, name, dtype, rtol,
                                                                   atol):
    """The kernel's per-sample function (both entries) compiled for the CPU:
    costs of (T, na, K) controls and one control step of K states, carry
    included."""
    env, x = _start(name, dtype)
    rng = np.random.default_rng(31)
    ctrl = torch.as_tensor(rng.uniform(-2.4, 2.4, (2, 7, K)), dtype=dtype)
    want = spatial_step.spatial_rollout_costs_tak_reference(env, x, ctrl)
    got = _run_host(host_check, env, 0, x.double().numpy(), ctrl.double().numpy(), K, 2)[:, 0]
    np.testing.assert_allclose(got, want.double().numpy(), rtol=rtol, atol=atol)

    dq = np.concatenate([rng.uniform(-0.02, 0.02, (K, 22)), np.zeros((K, 9))], axis=1)
    xs = x + torch.as_tensor(dq, dtype=dtype)
    acts = torch.as_tensor(rng.uniform(-2.4, 2.4, (K, 7)), dtype=dtype)
    want = env.plain_step(make_state(xs), acts).x.double().numpy()
    got = _run_host(host_check, env, 1, xs.double().numpy(), acts.double().numpy(), K, 1)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=max(atol, rtol) * np.abs(want).max())


def test_cemppi_step_matches_jax():
    """Two chained CEMPPI control steps (2 AIS iterations, K=8, H=3) with the
    same injected normals, the env step between them; rtol 1e-9."""
    kw = dict(kind="cemppi", num_samples=8, horizon=3, lam=0.1, opt_its=2, sigma_est="mle")
    jenv = jpd.PusherDeviceEnv(dtype=jnp.float64)
    env = PusherDeviceEnv(dtype=torch.float64, device="cpu")
    jpol = jmake_policy(jenv, JPolicyConfig(**kw), cov_mat=COV)
    pol = make_policy(env, PolicyConfig(**kw), cov_mat=COV)
    rng = np.random.default_rng(13)
    js, jps = jenv.reset(), jpol.init_state(0)
    s, ps = env.reset(), pol.init_state(0)
    jstep = jax.jit(jenv.step)
    for _ in range(2):
        z = rng.standard_normal((2, 7 * 3, 8))
        ja, jps, jinfo = jpol.step(js, jps, z=jnp.asarray(z))
        a, ps, info = pol.step(s, ps, z=torch.as_tensor(z))
        for got, want in ((a, ja), (ps.U, jps.U), (info["costs"], jinfo["costs"]),
                          (info["weights"], jinfo["weights"])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9, atol=1e-300)
        js = jstep(js, ja)
        s = env.step(s, a)
    np.testing.assert_allclose(s.x.numpy(), np.asarray(js.x), rtol=1e-10, atol=1e-12)


def test_harness_run_replays_to_its_reward_in_jax(tmp_path):
    """A small float64 Pusher-v4 trial on the CPU: the executed actions,
    written as CSV, replay through the JAX package's step_reward to the trial
    reward."""
    m = simulate.simulate_mujoco_on_device(
        "Pusher-v4", steps_per_call=1, output_acts_file=True, acts_dir=str(tmp_path),
        print_output=False, solver_iters=(3, 6), **SIM)
    (csv,) = glob.glob(str(tmp_path / "*.csv"))
    acts = np.loadtxt(csv, delimiter=",", ndmin=2)
    assert acts.shape == (SIM["num_steps"] + 1, 7) and np.all(np.abs(acts) <= 2.0)
    jenv = jpd.PusherDeviceEnv(dtype=jnp.float64)
    step_reward = jax.jit(jenv.step_reward)
    s, total = jenv.reset(), 0.0
    for a in acts:
        s, r = step_reward(s, jnp.asarray(a))
        total += float(r)
    np.testing.assert_allclose(m["rewards"][0], total, rtol=1e-9)


def test_cli_runs_the_pusher_on_the_cpu(capsys):
    rc = main(["mujoco", "--on-device", "--env-name", "Pusher-v4", "--device", "cpu",
               "--samples", "4", "--horizon", "2", "--ais-its", "1", "--steps", "2", "--seed", "3",
               "--solver-iters", "3,6"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Pusher-v4 (on-device)" in out
    row = next(line for line in out.splitlines() if line.startswith("Trial    1:"))
    assert int(row.split(":")[2]) == 2
