"""The Swimmer's rollout kernel module and its path on the CPU: the plain
rollout costs against the JAX package's `rollout_batch` over `step_reward`
(the oracle of its Pallas kernel's own tests) in float64, the wrappers' CPU
path, the packed model the CUDA kernel reads, the kernel's device code
(csrc/planar_dynamics.cuh at 5 dofs with the fluid force) built for the host
with g++ against the plain version, the CEMPPI step against the JAX
package's with the same injected normals, and `simulate_mujoco_on_device`
and the CLI on Swimmer-v4. The CUDA kernel itself is held against the plain
version on the card by tests/test_torch_cuda.py and chip_smoke.py."""

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

from mpopis_tpu.models import swimmer_device as jsd
from mpopis_tpu.models.rollout import rollout_batch as jrollout_batch
from mpopis_tpu.policies import PolicyConfig as JPolicyConfig
from mpopis_tpu.policies import make_policy as jmake_policy

from mpopis_tpu_torch.harness import simulate
from mpopis_tpu_torch.harness.cli import main
from mpopis_tpu_torch.kernels import planar_step
from mpopis_tpu_torch.kernels.build import CSRC_DIR
from mpopis_tpu_torch.models import CheetahDeviceEnv, SwimmerDeviceEnv
from mpopis_tpu_torch.models.base import make_state
from mpopis_tpu_torch.policies import PolicyConfig, make_policy

K, T = 6, 3
LIM = float(np.deg2rad(100.0))
COV = 0.25 * np.eye(2)
SIM = dict(num_trials=1, num_steps=4, num_samples=8, horizon=3, ais_its=2, lam=0.1,
           ce_sigma_est="mle", seed=2, device="cpu", dtype=torch.float64)


def _starts():
    """x0 of each start: the reset, and a swimming state with both motor
    joints past their ±100° limits."""
    limits = np.array([0.1, -0.2, 0.3, 1.03 * LIM, -1.04 * LIM, 0.5, -0.4, 1.0, 2.0, -1.5])
    return {"reset": np.zeros(10), "limits": limits}


def _env(dtype=torch.float64):
    return SwimmerDeviceEnv(dtype=dtype, device="cpu")


@pytest.fixture(scope="module")
def jax_rollout():
    """The JAX rollout costs (K,) of one set of controls (K, T, 2) beyond ±1
    (the torques clamp), jitted once and run from each start."""
    controls = np.random.default_rng(21).uniform(-1.3, 1.3, (K, T, 2))
    jenv = jsd.SwimmerDeviceEnv(dtype=jnp.float64)
    f = jax.jit(lambda x, c: jrollout_batch(jenv, jenv.reset().replace(x=x), c)[0])
    costs = {name: np.asarray(f(jnp.asarray(x), jnp.asarray(controls)))
             for name, x in _starts().items()}
    return controls, costs


@pytest.mark.parametrize("name", sorted(_starts()))
def test_plain_rollout_costs_match_jax(jax_rollout, name):
    """rtol 1e-9."""
    controls, costs = jax_rollout
    got = planar_step.swimmer_rollout_costs_tak_reference(
        _env(), torch.as_tensor(_starts()[name]), torch.as_tensor(controls.transpose(1, 2, 0)))
    assert got.shape == (K,) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), costs[name], rtol=1e-9)


def test_wrappers_on_cpu_run_the_plain_versions_without_launching():
    env = _env()
    x0 = torch.as_tensor(_starts()["limits"])
    ctrl_tak = torch.as_tensor(np.random.default_rng(5).uniform(-1.2, 1.2, (2, 2, 3)))
    counts = (planar_step.SWIMMER_LAUNCHES, planar_step.SWIMMER_STEP_LAUNCHES,
              planar_step.LAUNCHES, planar_step.STEP_LAUNCHES)
    want = planar_step.swimmer_rollout_costs_tak_reference(env, x0, ctrl_tak)
    assert torch.equal(planar_step.swimmer_rollout_costs_tak(env, x0, ctrl_tak), want)
    assert torch.equal(env.fused_rollout_costs_tak(make_state(x0), ctrl_tak), want)
    assert torch.equal(env.fused_rollout_costs(make_state(x0), ctrl_tak.permute(2, 0, 1)), want)
    xs = x0.expand(3, -1)
    acts = ctrl_tak[0].T
    plain = env.plain_step(make_state(xs), acts).x
    assert torch.equal(planar_step.swimmer_step_states(env, xs, acts), plain)
    assert torch.equal(env.step(make_state(xs), acts).x, plain)
    assert (planar_step.SWIMMER_LAUNCHES, planar_step.SWIMMER_STEP_LAUNCHES,
            planar_step.LAUNCHES, planar_step.STEP_LAUNCHES) == counts


def test_kernel_model_packing_follows_the_layout():
    """The planar kernel's packed model (make_model in csrc/planar_dynamics.cuh)
    with the 5 fluid coefficients last and the fixed (2, 3) solver."""
    env = _env()
    ints, dbl = planar_step._env_model(env)
    ints, dbl = list(ints), list(dbl)
    assert ints[:10] == [5, 3, 0, 2, 0, 1, 4, 2, 3, 2]  # dofs, bodies, contacts, limits, ...
    assert len(ints) == 10 + 2 * 3 + 0 + 2
    assert ints[-2:] == [3, 4]  # the limits' dofs
    assert len(dbl) == 9 + 4 * 5 + 2 + 9 * 3 + 8 * 2 + 5
    assert dbl[-5:] == list(env.FLUID)
    assert dbl[6:9] == [0.0, 1e-4, 1.0 / (0.01 * 4)]  # healthy, ctrl_w, 1/dt
    with pytest.raises(ValueError, match="5 dofs"):  # the contact kernel has no 5-dof build
        planar_step.kernel_model(env.MODEL, 4, 2, 3, 0.0, 1e-4)
    with pytest.raises(ValueError, match="fluid"):  # the fluid kernel has no 9-dof build
        planar_step.kernel_model(CheetahDeviceEnv.MODEL, 5, 3, 6, 0.0, 0.1, env.FLUID)


@pytest.fixture(scope="module")
def host_check(tmp_path_factory):
    """tests/planar_host_check.cpp built with g++ against the kernel's device
    code; skips where there is no g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel's device code for the host")
    exe = tmp_path_factory.mktemp("host") / "planar_host_check"
    src = Path(__file__).with_name("planar_host_check.cpp")
    subprocess.run([gxx, "-O1", "-std=c++17", f"-I{CSRC_DIR}", "-o", str(exe), str(src)],
                   check=True, capture_output=True, timeout=300)
    return exe


def _run_host(exe, env, mode, x, actions, k, horizon):
    ints, dbl = planar_step._env_model(env)
    data = struct.pack("3i", int(env.dtype == torch.float64), len(ints), len(dbl))
    data += np.asarray(list(ints), np.int32).tobytes() + np.asarray(list(dbl)).tobytes()
    data += struct.pack("3i", mode, k, horizon)
    data += np.asarray(x, np.float64).tobytes() + np.asarray(actions, np.float64).tobytes()
    path = Path(str(exe) + ".in")
    path.write_bytes(data)
    out = subprocess.run([str(exe), str(path)], capture_output=True, text=True, check=True,
                         timeout=300).stdout
    return np.array([[float(v) for v in line.split()] for line in out.strip().splitlines()])


@pytest.mark.parametrize("dtype,rtol,atol", [
    (torch.float64, 1e-9, 0.0),  # the kernel's f64 bound
    (torch.float32, 2e-4, 2e-3),  # the JAX kernel tests' f32 tolerance
])
@pytest.mark.parametrize("name", sorted(_starts()))
def test_kernel_code_built_for_the_host_matches_the_plain_version(host_check, name, dtype, rtol,
                                                                   atol):
    """The kernel's per-sample function (both entries) compiled for the CPU:
    costs of (T, 2, K) controls and one control step of K states."""
    env = _env(dtype)
    x = torch.as_tensor(_starts()[name], dtype=dtype)
    rng = np.random.default_rng(31)
    ctrl = torch.as_tensor(rng.uniform(-1.2, 1.2, (3, 2, 8)), dtype=dtype)
    want = planar_step.swimmer_rollout_costs_tak_reference(env, x, ctrl)
    got = _run_host(host_check, env, 0, x.double().numpy(), ctrl.double().numpy(), 8, 3)[:, 0]
    np.testing.assert_allclose(got, want.double().numpy(), rtol=rtol, atol=atol)

    xs = x + torch.as_tensor(rng.uniform(-0.05, 0.05, (8, 10)), dtype=dtype)
    acts = torch.as_tensor(rng.uniform(-1.2, 1.2, (8, 2)), dtype=dtype)
    want = env.plain_step(make_state(xs), acts).x.double().numpy()
    got = _run_host(host_check, env, 1, xs.double().numpy(), acts.double().numpy(), 8, 1)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=max(atol, rtol) * np.abs(want).max())


def test_cemppi_step_matches_jax():
    """Two chained CEMPPI control steps (2 AIS iterations, K=16, H=4) with the
    same injected normals, the env step between them; rtol 1e-9."""
    kw = dict(kind="cemppi", num_samples=16, horizon=4, lam=0.1, opt_its=2, sigma_est="mle")
    jenv = jsd.SwimmerDeviceEnv(dtype=jnp.float64)
    env = _env()
    jpol = jmake_policy(jenv, JPolicyConfig(**kw), cov_mat=COV)
    pol = make_policy(env, PolicyConfig(**kw), cov_mat=COV)
    rng = np.random.default_rng(13)
    js, jps = jenv.reset(), jpol.init_state(0)
    s, ps = env.reset(), pol.init_state(0)
    jstep = jax.jit(jenv.step)
    for _ in range(2):
        z = rng.standard_normal((2, 2 * 4, 16))
        ja, jps, jinfo = jpol.step(js, jps, z=jnp.asarray(z))
        a, ps, info = pol.step(s, ps, z=torch.as_tensor(z))
        for got, want in ((a, ja), (ps.U, jps.U), (info["costs"], jinfo["costs"]),
                          (info["weights"], jinfo["weights"])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9, atol=1e-300)
        js = jstep(js, ja)
        s = env.step(s, a)
    np.testing.assert_allclose(s.x.numpy(), np.asarray(js.x), rtol=1e-10, atol=1e-12)


def test_harness_run_replays_to_its_reward_in_jax(tmp_path):
    """A small float64 Swimmer-v4 trial on the CPU: the executed actions,
    written as CSV, replay through the JAX package's step_reward to the trial
    reward."""
    m = simulate.simulate_mujoco_on_device(
        "Swimmer-v4", steps_per_call=1, output_acts_file=True, acts_dir=str(tmp_path),
        print_output=False, **SIM)
    (csv,) = glob.glob(str(tmp_path / "*.csv"))
    acts = np.loadtxt(csv, delimiter=",", ndmin=2)
    assert acts.shape == (SIM["num_steps"] + 1, 2)
    jenv = jsd.SwimmerDeviceEnv(dtype=jnp.float64)
    step_reward = jax.jit(jenv.step_reward)
    s, total = jenv.reset(), 0.0
    for a in acts:
        s, r = step_reward(s, jnp.asarray(a))
        total += float(r)
    np.testing.assert_allclose(m["rewards"][0], total, rtol=1e-9)
    assert m["steps"][0] == SIM["num_steps"]


def test_cli_runs_the_swimmer_on_the_cpu(capsys):
    rc = main(["mujoco", "--on-device", "--env-name", "Swimmer-v4", "--device", "cpu",
               "--samples", "4", "--horizon", "2", "--ais-its", "1", "--steps", "2", "--seed", "3"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Swimmer-v4 (on-device)" in out
    row = next(line for line in out.splitlines() if line.startswith("Trial    1:"))
    assert int(row.split(":")[2]) == 2
