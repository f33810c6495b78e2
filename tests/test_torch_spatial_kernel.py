"""The spatial-contact rollout kernel module on the CPU: the plain version
against the JAX package's `rollout_batch` over `step_reward` (the oracle of
the JAX kernel's own tests) in float64, the wrappers' CPU path, the model
packing the CUDA kernel reads, and the kernel's device code
(csrc/spatial_dynamics.cuh) built for the host with g++ against the plain
version. The CUDA kernel itself is held against the plain version on the
card by tests/test_torch_cuda.py and chip_smoke.py.
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

from mpopis_tpu.models import AntDeviceEnv as JAntDeviceEnv
from mpopis_tpu.models.rollout import rollout_batch as jrollout_batch

from mpopis_tpu_torch.kernels import spatial_step
from mpopis_tpu_torch.kernels.build import CSRC_DIR
from mpopis_tpu_torch.models import AntDeviceEnv
from mpopis_tpu_torch.models import spatial_contact as sc
from mpopis_tpu_torch.models.base import make_state

K, T = 4, 3
STARTS = {"reset": 0.75, "shallow": 0.26, "grounded": 0.75 - 0.45}  # x[2], joints at 0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions are thousands of tiny ops: one thread each keeps
    test processes that run side by side from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _start(name, dtype=torch.float64):
    env = AntDeviceEnv(dtype=dtype, device="cpu")
    x = env.reset().x.clone()
    x[2] = STARTS[name]
    return env, x


@pytest.fixture(scope="module")
def jax_rollout():
    """The JAX rollout costs (K,) of one set of controls (K, T, 8), beyond ±1
    so that the torques clamp, jitted once and run from each start."""
    controls = np.random.default_rng(21).uniform(-1.2, 1.2, (K, T, 8))
    jenv = JAntDeviceEnv(dtype=jnp.float64)
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
    env, x0 = _start("shallow")
    ctrl_tak = torch.as_tensor(np.random.default_rng(5).uniform(-1.2, 1.2, (2, 8, 3)))
    launches, step_launches = spatial_step.LAUNCHES, spatial_step.STEP_LAUNCHES
    want = spatial_step.spatial_rollout_costs_tak_reference(env, x0, ctrl_tak)
    assert torch.equal(spatial_step.spatial_rollout_costs_tak(env, x0, ctrl_tak), want)
    assert torch.equal(env.fused_rollout_costs_tak(make_state(x0), ctrl_tak), want)
    assert torch.equal(env.fused_rollout_costs(make_state(x0), ctrl_tak.permute(2, 0, 1)), want)
    xs = x0.expand(3, -1)
    acts = ctrl_tak[0].T
    plain = env.plain_step(make_state(xs), acts).x
    assert torch.equal(spatial_step.spatial_step_states(env, xs, acts), plain)
    assert torch.equal(env.step(make_state(xs), acts).x, plain)
    assert (spatial_step.LAUNCHES, spatial_step.STEP_LAUNCHES) == (launches, step_launches)


def test_kernel_model_packing_follows_the_layout():
    """The flat int and double arrays hold what `make_model` in
    csrc/spatial_dynamics.cuh reads, in its order and counts."""
    env = AntDeviceEnv(device="cpu")
    model = env.MODEL
    ints, dbl = spatial_step._env_model(env)
    ints, dbl = list(ints), list(dbl)
    nb, nj, nc, nl, na = 13, 9, 25, 8, 8
    # the header ends with Ant's build's feature mask (none) and no carry bodies
    assert ints[:16] == [14, 15, nb, nj, nc, nl, na, 0, 0, 5, 3, 6, 0, -1, -1, -1]
    assert len(ints) == 16 + 4 * nb + 4 * nj + 3 * nc + 2 * nl + na
    assert len(dbl) == 20 + 3 * 14 + 22 * nb + 24 * nj + 16 * nc + 9 * nl + na
    h = model.timestep
    assert dbl[:8] == [9.81, 0.0, h, 0.5 * h, 1.0, 1.0 / (h * 5), 0.5, 1.0]
    assert dbl[8:20] == [0.0, 0.5 * h, 0.5 * h, h, 0.0, 0.25 * h, 0.25 * h, 0.5 * h,
                         1 / 6, 1 / 3, 1 / 3, 1 / 6]
    assert dbl[20 + 3 * 6: 20 + 3 * 7] == [1.0, 1.0, h * 1.0]  # dof 6: damping, armature, h·d
    body = ints[16: 16 + 4 * nb]
    assert body[:4] == [-1, 0, 1, 0b111111]  # the torso: its free joint's 6 dofs
    # aux_1 (body 2) hangs on front_left_leg (no joint); its hinge, joint 1, is dof 6
    assert body[8:12] == [1, 1, 1, 0b1111111]
    joints = ints[16 + 4 * nb: 16 + 4 * nb + 4 * nj]
    assert joints[:4] == [0, 0, 0, 0] and joints[4:8] == [2, 1, 6, 7]
    contacts = ints[16 + 4 * nb + 4 * nj: 16 + 4 * nb + 4 * nj + 3 * nc]
    assert contacts[:6] == [0, 0, 3, 1, 1, 3]  # body, has_axis, condim
    assert ints[-na:] == [dof for dof, _ in env.ACTUATORS]
    assert dbl[-na:] == [gear for _, gear in env.ACTUATORS]


def test_kernel_model_rejects_what_the_kernel_cannot_take():
    """Ant's (14, 15) build takes none of the other builds' branches (Euler,
    slide joints, condim-1 contacts, joint springs, self pairs) or reward
    families."""
    model = AntDeviceEnv.MODEL
    args = (5, 3, 6, AntDeviceEnv.ACTUATORS, 1.0, 1.0, 0.5)
    with pytest.raises(ValueError, match="euler_implicit"):
        spatial_step.kernel_model(dataclasses.replace(model, integrator="euler_implicit"), *args)
    with pytest.raises(ValueError, match="dofs"):
        spatial_step.kernel_model(dataclasses.replace(model, n_q=16), *args)
    with pytest.raises(ValueError, match="too many"):
        spatial_step.kernel_model(dataclasses.replace(model, contacts=model.contacts * 2), *args)
    with pytest.raises(ValueError, match="slide"):
        bodies = list(model.bodies)
        bodies[2] = dataclasses.replace(
            bodies[2], joints=(dataclasses.replace(bodies[2].joints[0], kind="slide"),))
        spatial_step.kernel_model(dataclasses.replace(model, bodies=tuple(bodies)), *args)
    with pytest.raises(ValueError, match="condim-1"):
        contacts = (dataclasses.replace(model.contacts[0], condim=1),) + model.contacts[1:]
        spatial_step.kernel_model(dataclasses.replace(model, contacts=contacts), *args)
    with pytest.raises(ValueError, match="springs"):
        stiffness = (0.0,) * 6 + (1.0,) + model.stiffness[7:]
        spatial_step.kernel_model(dataclasses.replace(model, stiffness=stiffness), *args)
    with pytest.raises(ValueError, match="self-collision"):
        pair = sc.SCPairCapsule(1, (0.0,) * 3, (0.1, 0.0, 0.0), 0.08, 4, (0.0,) * 3,
                                (0.1, 0.0, 0.0), 0.08, 0.0, (0.9, 0.95, 0.001))
        spatial_step.kernel_model(dataclasses.replace(model, self_pairs=(pair,)), *args)
    with pytest.raises(ValueError, match="pusher reward family"):
        spatial_step.kernel_model(model, *args, family="pusher")
    with pytest.raises(ValueError, match="standup"):
        spatial_step.kernel_model(model, *args, family="standup")


def test_first_substep_active_rows_counts_limits_and_contacts():
    """At the reset the 4 ankle limits are violated; at x[2] = 0.26 the torso
    sphere is inside the contact margin; at the grounded start (0.30) it is
    not yet."""
    for name, want in (("reset", (4, 0, 0)), ("shallow", (4, 4, 0)), ("grounded", (4, 0, 0))):
        env, x = _start(name)
        assert spatial_step.first_substep_active_rows(env, x) == want, name


@pytest.fixture(scope="module")
def host_check(tmp_path_factory):
    """tests/spatial_host_check.cpp built with g++ against the kernel's
    device code; skips where there is no g++."""
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
    path = Path(str(exe) + ".in")
    path.write_bytes(data)
    out = subprocess.run([str(exe), str(path)], capture_output=True, text=True, check=True,
                         timeout=300).stdout
    return np.array([[float(v) for v in line.split()] for line in out.strip().splitlines()])


@pytest.mark.parametrize("dtype,rtol,atol", [
    (torch.float64, 1e-9, 0.0),  # the kernel's f64 bound
    (torch.float32, 2e-4, 2e-3),  # the JAX kernel tests' f32 tolerance
])
@pytest.mark.parametrize("name", ["reset", "shallow", "grounded"])
def test_kernel_code_built_for_the_host_matches_the_plain_version(host_check, name, dtype,
                                                                   rtol, atol):
    """The kernel's per-sample loop (both entries) compiled for the CPU: costs
    of (T, na, K) controls and one control step of K states."""
    env, x = _start(name, dtype)
    rng = np.random.default_rng(31)
    ctrl = torch.as_tensor(rng.uniform(-1.2, 1.2, (2, 8, K)), dtype=dtype)
    want = spatial_step.spatial_rollout_costs_tak_reference(env, x, ctrl)
    got = _run_host(host_check, env, 0, x.double().numpy(), ctrl.double().numpy(), K, 2)[:, 0]
    np.testing.assert_allclose(got, want.double().numpy(), rtol=rtol, atol=atol)

    xs = x + torch.as_tensor(rng.uniform(-0.05, 0.05, (K, 30)), dtype=dtype)
    acts = torch.as_tensor(rng.uniform(-1.2, 1.2, (K, 8)), dtype=dtype)
    want = env.plain_step(make_state(xs), acts).x.double().numpy()
    got = _run_host(host_check, env, 1, xs.double().numpy(), acts.double().numpy(), K, 1)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=max(atol, rtol) * np.abs(want).max())
