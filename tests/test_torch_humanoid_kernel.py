"""The Humanoid's build of the spatial rollout kernel module and its path on
the CPU, in float64 against the JAX package: the control step with its
reward and com-x carry (an action beyond ±0.4 pins the clipped control
cost), `reset` and `reward(state)`, the plain rollout costs, the CEMPPI step
with the same injected normals; the wrappers' CPU path, the packed model of
the Humanoid build, the kernel's device code (csrc/spatial_dynamics.cuh, the
Humanoid build) built for the host with g++ against the plain version, and
`simulate_mujoco_on_device` and the CLI on Humanoid-v4. The CUDA kernel
itself is held against the plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py.

The JAX step_reward is jitted once per module (`fast_jit`, 2-3 min on this
CPU with a cold compilation cache) and runs on single states: the JAX
rollout costs are that step run sample by sample (an XLA:CPU compile of
the vmapped 242-row rollout takes many minutes)."""

import shutil
import struct
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpopis_tpu.models import humanoid_device as jhd
from mpopis_tpu.policies import PolicyConfig as JPolicyConfig
from mpopis_tpu.policies import make_policy as jmake_policy
from mpopis_tpu.utils.fastjit import fast_jit

from mpopis_tpu_torch.harness.cli import main
from mpopis_tpu_torch.kernels import spatial_step
from mpopis_tpu_torch.kernels.build import CSRC_DIR
from mpopis_tpu_torch.models import HumanoidDeviceEnv, HumanoidStandupDeviceEnv, humanoid_device as hd
from mpopis_tpu_torch.models.base import make_state
from mpopis_tpu_torch.policies import PolicyConfig, make_policy

K, T = 3, 2
COV = 0.25 * np.eye(17)


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


def humanoid_state(name, dtype=torch.float64):
    """The standing reset, the crouch (floor and self-pair rows active) with
    velocities from a numpy seed and its com x as the carry, or (`pressed`)
    the Standup's supine reset 2 cm into the floor, where more rows are valid
    (82) than a warp has lanes."""
    env = HumanoidDeviceEnv(dtype=dtype, device="cpu")
    if name == "reset":
        return env, env.reset().x
    if name == "pressed":
        x = HumanoidStandupDeviceEnv(dtype=dtype, device="cpu").reset().x.clone()
        x[2] -= 0.02
        x[-1] = hd.com_x(x[:24].double()).to(dtype)
        return env, x
    q = hd.crouched_qpos()
    qv = torch.as_tensor(np.random.default_rng(4).uniform(-0.3, 0.3, 23))
    return env, torch.cat([q, qv, hd.com_x(q)[None]]).to(dtype)


@pytest.fixture(scope="module")
def jax_env():
    """The JAX env (f64, solver (3, 6)) and its step_reward, compiled once."""
    jenv = jhd.HumanoidDeviceEnv(dtype=jnp.float64)
    return jenv, fast_jit(jenv.step_reward)


def _jax_costs(jenv, step_reward, x, controls):
    """The JAX rollout costs Σ_t −reward_t of controls (K, T, na) from the
    state x, one sample at a time."""
    costs = []
    for c in np.asarray(controls):
        s, rews = jenv.reset().replace(x=jnp.asarray(x)), []
        for u in c:
            s, r = step_reward(s, jnp.asarray(u))
            rews.append(float(r))
        costs.append(-np.sum(rews))
    return np.asarray(costs)


def test_step_reward_and_carry_match_jax(jax_env):
    """`step_reward` over 2 control steps from the reset and the crouch,
    actions up to ±0.6 (the torque and the control cost read them clipped
    to ±0.4): the new state with its stage-4 com x and the reward at rtol
    1e-9; `reset`, `reward(state)` and `observation` as the JAX env's."""
    jenv, step_reward = jax_env
    env = HumanoidDeviceEnv(dtype=torch.float64, device="cpu")
    np.testing.assert_array_equal(env.reset().x.numpy(), np.asarray(jenv.reset().x))
    acts = np.random.default_rng(9).uniform(-0.6, 0.6, (2, 2, 17))
    for i, name in enumerate(("reset", "crouch")):
        _, x = humanoid_state(name)
        js, s = jenv.reset().replace(x=jnp.asarray(x.numpy())), make_state(x)
        for a in acts[i]:
            js, jr = step_reward(js, jnp.asarray(a))
            s, r = env.step_reward(s, torch.as_tensor(a))
            _close(s.x.numpy(), np.asarray(js.x), 1e-9)
            np.testing.assert_allclose(float(r), float(jr), rtol=1e-9)
        same = js.replace(x=jnp.asarray(s.x.numpy()))  # the port's state in the JAX env
        np.testing.assert_allclose(float(env.reward(s)), float(jenv.reward(same)), rtol=1e-15)
        np.testing.assert_array_equal(env.observation(s).numpy(),
                                      np.asarray(jenv.observation(same)))
    clipped = np.clip(acts[1, -1], -0.4, 0.4)
    assert np.sum(clipped**2) < np.sum(acts[1, -1] ** 2)


def test_plain_rollout_costs_match_jax(jax_env):
    """The plain rollout costs (K=3, T=2) from the crouch at rtol 1e-9."""
    jenv, step_reward = jax_env
    env, x = humanoid_state("crouch")
    controls = np.random.default_rng(21).uniform(-0.4, 0.4, (K, T, 17))
    got = spatial_step.spatial_rollout_costs_tak_reference(
        env, x, torch.as_tensor(controls.transpose(1, 2, 0)))
    assert got.shape == (K,) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), _jax_costs(jenv, step_reward, x.numpy(), controls),
                               rtol=1e-9)


def cemppi_step_against_jax(jenv_cls, env, lam, costs=None):
    """One CEMPPI control step (2 AIS iterations, K=4, H=2, `mle`) from the
    reset of `env` (f64, CPU) and of the JAX package's `jenv_cls` with the
    same injected normals, the JAX policy scoring its candidates through a
    host callback (so that it runs eagerly, with no vmapped rollout to
    compile): `costs(x, controls_tak)` in numpy, by default the port's
    plain rollout costs (the dynamics pinned by the step and rollout
    tests). The action, the plan, the costs and the weights at rtol 1e-9,
    or within 10× the JAX step's own spread under z·(1 + 1e-15) where a
    contact switch turns rounding into other iterates (the nudge rule)."""
    if costs is None:
        def costs(x, c):
            return spatial_step.spatial_rollout_costs_tak_reference(
                env, torch.as_tensor(x), torch.as_tensor(c)).numpy()

    class HostCosts(jenv_cls):
        @property
        def supports_fused_rollout(self):
            return True

        def fused_rollout_costs_tak(self, state, controls_tak):
            def host(x, c):
                return np.asarray(costs(np.array(x), np.array(c)), dtype=np.float64)

            return jax.pure_callback(
                host, jax.ShapeDtypeStruct(controls_tak.shape[2:], controls_tak.dtype),
                state.x, controls_tak)

    kw = dict(kind="cemppi", num_samples=4, horizon=2, lam=lam, opt_its=2, sigma_est="mle")
    jenv = HostCosts(dtype=jnp.float64)
    jpol = jmake_policy(jenv, JPolicyConfig(**kw), cov_mat=COV, jit=False)
    pol = make_policy(env, PolicyConfig(**kw), cov_mat=COV)
    z = np.random.default_rng(13).standard_normal((2, 17 * 2, 4))

    def jax_step(zz):
        a, ps, info = jpol.step(jenv.reset(), jpol.init_state(0), z=jnp.asarray(zz))
        return [np.asarray(v) for v in (a, ps.U, info["costs"], info["weights"])]

    a, ps, info = pol.step(env.reset(), pol.init_state(0), z=torch.as_tensor(z))
    got = [v.numpy() for v in (a, ps.U, info["costs"], info["weights"])]
    want = jax_step(z)
    errs = [np.max(np.abs(g - w)) / np.max(np.abs(w)) for g, w in zip(got, want)]
    if max(errs) > 1e-9:
        own = [np.max(np.abs(n - w)) / np.max(np.abs(w))
               for n, w in zip(jax_step(z * (1 + 1e-15)), want)]
        assert all(e <= 10 * o for e, o in zip(errs, own)), (errs, own)


def test_cemppi_step_matches_jax():
    """The Humanoid's CEMPPI step (λ=1.0) against the JAX package's."""
    cemppi_step_against_jax(jhd.HumanoidDeviceEnv, HumanoidDeviceEnv(dtype=torch.float64,
                                                                     device="cpu"), 1.0)


def test_first_substep_active_rows_counts_floor_and_self_rows():
    """Standing at the reset the two knees sit past their −2° upper limits
    and nothing touches; the crouch has 4 floor rows (one contact) and 4
    self-pair rows."""
    assert spatial_step.first_substep_active_rows(*humanoid_state("reset")) == (2, 0, 0)
    assert spatial_step.first_substep_active_rows(*humanoid_state("crouch")) == (0, 4, 4)


def test_wrappers_on_cpu_run_the_plain_versions_without_launching():
    env, x0 = humanoid_state("crouch")
    ctrl_tak = torch.as_tensor(np.random.default_rng(5).uniform(-0.4, 0.4, (1, 17, 2)))
    launches, step_launches = spatial_step.LAUNCHES, spatial_step.STEP_LAUNCHES
    want = spatial_step.spatial_rollout_costs_tak_reference(env, x0, ctrl_tak)
    assert torch.equal(spatial_step.spatial_rollout_costs_tak(env, x0, ctrl_tak), want)
    assert torch.equal(env.fused_rollout_costs_tak(make_state(x0), ctrl_tak), want)
    xs = x0.expand(2, -1)
    acts = ctrl_tak[0].T
    plain = env.plain_step(make_state(xs), acts).x
    assert torch.equal(spatial_step.spatial_step_states(env, xs, acts), plain)
    assert torch.equal(env.step(make_state(xs), acts).x, plain)
    assert (spatial_step.LAUNCHES, spatial_step.STEP_LAUNCHES) == (launches, step_launches)


def test_kernel_model_packing_follows_the_layout():
    """The Humanoid's build: self pairs, joint springs and the com-x track;
    the self pairs' ints and doubles and the springs after them."""
    env = HumanoidDeviceEnv(device="cpu")
    model = env.MODEL
    ints, dbl = spatial_step._env_model(env)
    ints, dbl = list(ints), list(dbl)
    nb, nj, nc, nl, na, ns = 13, 18, 29, 17, 17, 109
    feats = spatial_step.select_build(model, "locomotion", "com_x")
    assert feats == spatial_step.SELF_PAIRS | spatial_step.SPRINGS | spatial_step.COM_X == 224
    assert (23, 24, feats) == spatial_step.HUMANOID_BUILD
    assert ints[:16] == [23, 24, nb, nj, nc, nl, na, 0, ns, 5, 3, 6, feats, -1, -1, -1]
    assert len(ints) == 16 + 4 * nb + 4 * nj + 3 * nc + 2 * nl + na + 4 * ns
    assert len(dbl) == (20 + 3 * 23 + 22 * nb + 24 * nj + 16 * nc + 9 * nl + na + 26 * ns
                        + 2 * 23)
    h = model.timestep
    assert dbl[:8] == [9.81, 0.0, h, 0.5 * h, 5.0, 1.25 * (1.0 / (h * 5)), 0.1, 0.4]
    # the first pair: torso1 (capsule) against butt (capsule); the 4th: right
    # foot (a sphere) against torso1
    assert ints[-4 * ns:][:4] == [0, 2, 1, 1] and ints[-4 * ns:][12:16] == [5, 0, 0, 1]
    p = model.self_pairs[0]
    d1 = tuple(b - a for a, b in zip(p.a1, p.b1))
    la = sum(c * c for c in d1)
    first = dbl[-26 * ns - 46: -26 * ns - 46 + 26]
    assert first[:6] == [*p.a1, *d1] and first[12] == la * la and first[15] == 1.0 / la
    assert first[17:21] == [p.r1, p.r2, p.margin,
                            model.body_invweight0[0] + model.body_invweight0[2]]
    springs = dbl[-46:]
    assert springs[0::2] == list(model.stiffness) and springs[1::2] == list(model.springref)


@pytest.fixture(scope="module")
def host_check(tmp_path_factory):
    """tests/spatial_host_check.cpp built with g++ (the Humanoid build only)
    against the kernel's device code; skips where there is no g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel's device code for the host")
    exe = tmp_path_factory.mktemp("host") / "spatial_host_check"
    src = Path(__file__).with_name("spatial_host_check.cpp")
    subprocess.run([gxx, "-O1", "-std=c++17", "-DHOST_BUILDS=2", f"-I{CSRC_DIR}", "-o", str(exe),
                    str(src)], check=True, capture_output=True, timeout=300)
    return exe


def run_host(exe, env, mode, x, actions, k, horizon):
    """The host build's costs (mode 0) or new states (mode 1), one row per
    sample."""
    ints, dbl = spatial_step._env_model(env)
    data = struct.pack("3i", int(env.dtype == torch.float64), len(ints), len(dbl))
    data += np.asarray(list(ints), np.int32).tobytes() + np.asarray(list(dbl)).tobytes()
    data += struct.pack("4i", mode, k, horizon, env.action_dim)
    data += np.asarray(x, np.float64).tobytes() + np.asarray(actions, np.float64).tobytes()
    path = Path(f"{exe}.{type(env).__name__}.in")
    path.write_bytes(data)
    out = subprocess.run([str(exe), str(path)], capture_output=True, text=True, check=True,
                         timeout=300).stdout
    return np.array([[float(v) for v in line.split()] for line in out.strip().splitlines()])


@pytest.mark.parametrize("dtype,rtol,atol", [
    (torch.float64, 1e-9, 0.0),  # the kernel's f64 bound
    (torch.float32, 2e-4, 2e-3),  # the JAX kernel tests' f32 tolerance
])
@pytest.mark.parametrize("name", ["reset", "crouch"])
def test_kernel_code_built_for_the_host_matches_the_plain_version(host_check, name, dtype, rtol,
                                                                   atol):
    """The kernel's per-sample function (both entries) compiled for the CPU:
    costs of (T, na, K) controls and one control step of K states, the
    com-x carry included."""
    env, x = humanoid_state(name, dtype)
    rng = np.random.default_rng(31)
    ctrl = torch.as_tensor(rng.uniform(-0.4, 0.4, (T, 17, K)), dtype=dtype)
    want = spatial_step.spatial_rollout_costs_tak_reference(env, x, ctrl)
    got = run_host(host_check, env, 0, x.double().numpy(), ctrl.double().numpy(), K, T)[:, 0]
    np.testing.assert_allclose(got, want.double().numpy(), rtol=rtol, atol=atol)

    dq = np.concatenate([rng.uniform(-0.02, 0.02, (K, 47)), np.zeros((K, 1))], axis=1)
    xs = x + torch.as_tensor(dq, dtype=dtype)
    acts = torch.as_tensor(rng.uniform(-0.6, 0.6, (K, 17)), dtype=dtype)
    want = env.plain_step(make_state(xs), acts).x.double().numpy()
    got = run_host(host_check, env, 1, xs.double().numpy(), acts.double().numpy(), K, 1)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=max(atol, rtol) * np.abs(want).max())


def test_kernel_code_built_for_the_host_wraps_rows_over_the_lanes(host_check):
    """From the pressed supine pose (82 valid rows, more than the 32 of the
    dense QP operator, so the QP applies W^T W v), f64 costs and one control
    step against the plain version: within 1e-9, or within 10x the plain
    version's own spread under controls·(1 + 1e-15) (the nudge rule; eighty
    floor rows turn rounding into other QP iterates)."""
    env, x = humanoid_state("pressed")
    rng = np.random.default_rng(31)
    ctrl = torch.as_tensor(rng.uniform(-0.4, 0.4, (T, 17, K)), dtype=torch.float64)
    ref = spatial_step.spatial_rollout_costs_tak_reference
    want = ref(env, x, ctrl).numpy()
    own = np.abs(ref(env, x, ctrl * (1 + 1e-15)).numpy() / want - 1).max()
    got = run_host(host_check, env, 0, x.numpy(), ctrl.numpy(), K, T)[:, 0]
    assert np.abs(got / want - 1).max() <= max(1e-9, 10 * own)

    acts = torch.as_tensor(rng.uniform(-0.6, 0.6, (K, 17)), dtype=torch.float64)
    xs = x.expand(K, -1).clone()
    want = env.plain_step(make_state(xs), acts).x.numpy()
    scale = np.abs(want).max()
    own = np.abs(env.plain_step(make_state(xs), acts * (1 + 1e-15)).x.numpy() - want).max()
    got = run_host(host_check, env, 1, xs.numpy(), acts.numpy(), K, 1)
    assert np.abs(got - want).max() / scale <= max(1e-9, 10 * own / scale)


def test_cli_runs_the_humanoid_on_the_cpu(capsys):
    rc = main(["mujoco", "--on-device", "--env-name", "Humanoid-v4", "--device", "cpu",
               "--samples", "2", "--horizon", "1", "--ais-its", "1", "--steps", "1", "--seed", "3",
               "--steps-per-call", "1"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Humanoid-v4 (on-device)" in out
    row = next(line for line in out.splitlines() if line.startswith("Trial    1:"))
    assert int(row.split(":")[2]) == 1
