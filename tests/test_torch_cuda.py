"""The CUDA kernels (car rollout at 1-4 cars, the multi-car harness's
chunked loop, planar-contact, Swimmer and spatial-contact
rollouts and control steps, the AIS-update refits and CMA tail, Cholesky and
forward solve) against their plain PyTorch versions, on the card.

Marked `cuda`; without a card every test skips. This file imports neither
jax nor the JAX package, so it runs on a machine without jax:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from mpopis_tpu_torch.kernels import ais_update, car_rollout, linalg, planar_step, spatial_step
from mpopis_tpu_torch.models import (
    AntDeviceEnv,
    CarRacingEnv,
    CheetahDeviceEnv,
    HopperDeviceEnv,
    HumanoidDeviceEnv,
    HumanoidStandupDeviceEnv,
    MultiCarRacingEnv,
    PusherDeviceEnv,
    SwimmerDeviceEnv,
    Walker2dDeviceEnv,
    humanoid_device,
    make_state,
    pusher_device,
)
from mpopis_tpu_torch.policies import PolicyConfig, make_policy
from mpopis_tpu_torch.policies.strategies import CMAStrategy

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _controls(seed, k, t, dtype, device):
    ctrl = np.random.default_rng(seed).uniform(-1, 1, size=(t, 2, k))
    return torch.as_tensor(ctrl, dtype=dtype, device=device)


@pytest.mark.parametrize("dtype,rtol,atol", [
    (torch.float32, 2e-4, 2e-3),  # the JAX kernel tests' float32 tolerance
    (torch.float64, 1e-9, 0.0),  # same algebra as the plain version
])
def test_kernel_matches_plain_version(cuda_device, dtype, rtol, atol):
    env = CarRacingEnv(dtype=dtype, device=cuda_device)
    x0 = env.reset().x
    for k, t in ((64, 12), (150, 5)):
        ctrl = _controls(k, k, t, dtype, cuda_device)
        before = car_rollout.LAUNCHES
        got = car_rollout.car_rollout_costs_tak(env, x0, ctrl, t)
        assert car_rollout.LAUNCHES == before + 1
        want = car_rollout.car_rollout_costs_tak_reference(env, x0, ctrl, t)
        torch.cuda.synchronize()
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=rtol, atol=atol)


def test_wrapper_rejects_bad_inputs(cuda_device):
    env = CarRacingEnv(device=cuda_device)
    x0 = env.reset().x
    ctrl = torch.zeros((5, 2, 8), device=cuda_device)
    with pytest.raises(ValueError, match="shape"):
        car_rollout.car_rollout_costs_tak(env, x0, ctrl, 4)
    with pytest.raises(ValueError, match="dtype"):
        car_rollout.car_rollout_costs_tak(env, x0, ctrl.half(), 5)
    with pytest.raises(ValueError, match="state0_x"):
        car_rollout.car_rollout_costs_tak(env, make_state(torch.zeros(8)).x, ctrl, 5)
    with pytest.raises(ValueError, match="contiguous"):
        car_rollout.car_rollout_costs_tak(env, x0, ctrl.transpose(0, 2)[:5], 5)


def _car_env(num_cars, dtype, device):
    if num_cars == 1:
        return CarRacingEnv(dtype=dtype, device=device)
    return MultiCarRacingEnv(num_cars=num_cars, dtype=dtype, device=device)


def _car_start(num_cars, device, dtype):
    """The reset's car, the others 5 m apart along x."""
    x = np.zeros(8 * num_cars)
    for c in range(num_cars):
        x[8 * c : 8 * c + 4] = (5.0 * c, 0.0, np.pi / 2, 10.0)
    return torch.as_tensor(x, dtype=dtype, device=device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("num_cars", [1, 2, 3, 4])
def test_car_kernel_car_counts_and_partial_blocks(cuda_device, num_cars, dtype):
    """Every car count, at K = 1 and at K not a multiple of the block's 32
    samples (33, 97), T = 6: float32 at the JAX kernel tests' rtol 2e-4 /
    atol 2e-3 (atol 2e-2 with several cars, as the JAX multi-car test),
    float64 sample by sample at 1e-9 or within 10x the plain version's own
    spread (_hold_f64)."""
    env = _car_env(num_cars, dtype, cuda_device)
    x0 = _car_start(num_cars, cuda_device, dtype)

    def ref(e, x, u):
        return car_rollout.car_rollout_costs_tak_reference(e, x, u, u.shape[0])

    for k in (1, 33, 97):
        ctrl = torch.as_tensor(
            np.random.default_rng(k + num_cars).uniform(-1, 1, size=(6, 2 * num_cars, k)),
            dtype=dtype, device=cuda_device)
        before = car_rollout.LAUNCHES
        got = car_rollout.car_rollout_costs_tak(env, x0, ctrl, 6)
        assert car_rollout.LAUNCHES == before + 1
        torch.cuda.synchronize()
        assert got.shape == (k,)
        if dtype == torch.float32:
            np.testing.assert_allclose(got.cpu().numpy(), ref(env, x0, ctrl).cpu().numpy(),
                                       rtol=2e-4, atol=2e-3 if num_cars == 1 else 2e-2)
        else:
            _hold_f64(env, x0, ctrl, got, ref=ref)


@pytest.mark.parametrize("num_cars", [2, 3, 4])
def test_car_kernel_from_the_multi_car_reset(cuda_device, num_cars):
    """Kernel 1's N-car build through MultiCarRacingEnv from its staggered
    reset (the pairs 5 m apart, the collision term near), K = 300, T = 20:
    float32 at the JAX multi-car tolerance, float64 sample by sample."""
    for dtype in (torch.float32, torch.float64):
        env = MultiCarRacingEnv(num_cars=num_cars, dtype=dtype, device=cuda_device)
        s0 = env.reset()
        ctrl = torch.as_tensor(
            np.random.default_rng(num_cars).uniform(-1, 1, size=(300, 20, 2 * num_cars)),
            dtype=dtype, device=cuda_device)
        before = car_rollout.LAUNCHES
        got = env.fused_rollout_costs(s0, ctrl)
        assert car_rollout.LAUNCHES == before + 1
        want = env.fused_rollout_costs(make_state(s0.x.cpu()), ctrl.cpu())
        torch.cuda.synchronize()
        assert car_rollout.LAUNCHES == before + 1
        if dtype == torch.float32:
            np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=2e-4, atol=2e-2)
        else:
            def ref(e, x, u):
                return car_rollout.car_rollout_costs_tak_reference(e, x, u, u.shape[0])

            _hold_f64(env, s0.x, ctrl.permute(1, 2, 0).contiguous(), got, ref=ref)


def test_chunked_car_loop_on_the_card(cuda_device):
    """The car harness at f64 on the card, 10 control steps a call against
    one, K = 150, 3 cars: every rollout launches the kernel, and the two
    loops keep the same metrics."""
    from mpopis_tpu_torch.harness.simulate import simulate_car_racing

    kw = dict(num_trials=1, num_steps=23, num_cars=3, num_samples=150, horizon=20, ais_its=3,
              seed=2, dtype=torch.float64, device=cuda_device, print_output=False)
    runs = []
    for chunk in (1, 10):
        before = car_rollout.LAUNCHES
        m = simulate_car_racing(steps_per_call=chunk, **kw)
        assert car_rollout.LAUNCHES - before == m["ais_iterations"][0]
        runs.append(m)
    for key in ("rewards", "steps", "lap_times", "mean_vs", "max_vs", "beta_violations",
                "track_violations", "crash_violations"):
        np.testing.assert_allclose(runs[1][key], runs[0][key], rtol=1e-9, err_msg=key)


PLANAR = {"cheetah": CheetahDeviceEnv, "hopper": HopperDeviceEnv, "walker2d": Walker2dDeviceEnv}
LOWERED = {"cheetah": -0.35, "hopper": 1.15, "walker2d": 1.17}  # x[1]: contacts fire at once


@pytest.mark.parametrize("name", sorted(PLANAR))
@pytest.mark.parametrize("dtype,rtol,atol", [
    (torch.float32, 2e-4, 2e-4),  # the JAX kernel tests' float32 tolerance from reset
    (torch.float64, 1e-9, 0.0),  # from reset no contact switches: the algebra agrees
])
def test_planar_kernel_matches_plain_version(cuda_device, name, dtype, rtol, atol):
    env = PLANAR[name](dtype=dtype, device=cuda_device)
    x0 = env.reset().x
    ctrl = torch.as_tensor(np.random.default_rng(64).uniform(-1, 1, (3, env.action_dim, 64)),
                           dtype=dtype, device=cuda_device)
    before = planar_step.LAUNCHES
    got = env.fused_rollout_costs_tak(make_state(x0), ctrl)
    assert planar_step.LAUNCHES == before + 1
    want = planar_step.planar_rollout_costs_tak_reference(env, x0, ctrl)
    assert planar_step.LAUNCHES == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", sorted(PLANAR))
def test_planar_kernel_matches_plain_version_in_contact(cuda_device, name):
    """The JAX package's contact kernel test (K=5, T=4, controls from seed 7,
    solver (2, 6), rtol 2e-4 / atol 2e-3), from a lowered start."""
    env = PLANAR[name](dtype=torch.float32, device=cuda_device, solver_outer=2, solver_cg=6)
    x0 = env.reset().x.clone()
    x0[1] = LOWERED[name]
    assert planar_step.first_substep_active_rows(env, x0)[1] > 0
    ctrl = torch.as_tensor(np.random.default_rng(7).uniform(-1, 1, (5, 4, env.action_dim)),
                           dtype=torch.float32, device=cuda_device).permute(1, 2, 0).contiguous()
    got = planar_step.planar_rollout_costs_tak(env, x0, ctrl)
    want = planar_step.planar_rollout_costs_tak_reference(env, x0, ctrl)
    assert bool(torch.all(torch.isfinite(got)))
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=2e-4, atol=2e-3)


@pytest.mark.parametrize("name", sorted(PLANAR))
def test_planar_step_kernel_matches_plain_step(cuda_device, name):
    env = PLANAR[name](dtype=torch.float64, device=cuda_device)
    rng = np.random.default_rng(3)
    xs = env.reset().x + torch.as_tensor(rng.uniform(-0.01, 0.01, (32, env.state_dim)),
                                         device=cuda_device)
    acts = torch.as_tensor(rng.uniform(-1, 1, (32, env.action_dim)), device=cuda_device)
    before = planar_step.STEP_LAUNCHES
    got = env.step(make_state(xs), acts)
    assert planar_step.STEP_LAUNCHES == before + 1 and got.t == 1
    want = env.plain_step(make_state(xs), acts).x
    assert planar_step.STEP_LAUNCHES == before + 1
    np.testing.assert_allclose(got.x.cpu().numpy(), want.cpu().numpy(), rtol=1e-9, atol=1e-12)


def test_planar_wrappers_reject_bad_inputs(cuda_device):
    env = CheetahDeviceEnv(device=cuda_device)
    x0 = env.reset().x
    ctrl = torch.zeros((4, 6, 8), device=cuda_device)
    before = (planar_step.LAUNCHES, planar_step.STEP_LAUNCHES)
    with pytest.raises(ValueError, match="controls shape"):
        planar_step.planar_rollout_costs_tak(env, x0, ctrl[:, :3])
    with pytest.raises(ValueError, match="dtype"):
        planar_step.planar_rollout_costs_tak(env, x0.half(), ctrl.half())
    with pytest.raises(ValueError, match="state0_x"):
        planar_step.planar_rollout_costs_tak(env, x0[:9].contiguous(), ctrl)
    with pytest.raises(ValueError, match="state0_x"):
        planar_step.planar_rollout_costs_tak(env, x0.double(), ctrl)
    with pytest.raises(ValueError, match="contiguous"):
        planar_step.planar_rollout_costs_tak(env, x0, ctrl[:, :, ::2])
    with pytest.raises(ValueError, match="states"):
        planar_step.planar_step_states(env, x0[None], torch.zeros((1, 3), device=cuda_device))
    with pytest.raises(ValueError, match="actions"):
        planar_step.planar_step_states(env, x0[None], torch.zeros((1, 6), device=cuda_device,
                                                                  dtype=torch.float64))
    assert (planar_step.LAUNCHES, planar_step.STEP_LAUNCHES) == before


# -- the spatial-contact kernel (Ant) -------------------------------------------
ANT_STARTS = {"reset": 0.75, "grounded": 0.75 - 0.45}  # x[2], joints at 0


def _ant(dtype, device, start):
    env = AntDeviceEnv(dtype=dtype, device=device)
    x = env.reset().x.clone()
    x[2] = ANT_STARTS[start]
    return env, x


@pytest.mark.parametrize("start", sorted(ANT_STARTS))
@pytest.mark.parametrize("dtype,rtol,atol", [
    (torch.float32, 2e-4, 2e-3),  # the JAX kernel tests' float32 tolerance
    (torch.float64, 1e-9, 0.0),  # measured ≤ 3.7e-10 from the grounded start
])
def test_spatial_kernel_matches_plain_version(cuda_device, start, dtype, rtol, atol):
    env, x0 = _ant(dtype, cuda_device, start)
    ctrl = torch.as_tensor(np.random.default_rng(64).uniform(-1, 1, (3, 8, 64)), dtype=dtype,
                           device=cuda_device)
    before = spatial_step.LAUNCHES
    got = env.fused_rollout_costs_tak(make_state(x0), ctrl)
    assert spatial_step.LAUNCHES == before + 1
    want = spatial_step.spatial_rollout_costs_tak_reference(env, x0, ctrl)
    assert spatial_step.LAUNCHES == before + 1
    assert bool(torch.all(torch.isfinite(got)))
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype,start,bound", [
    (torch.float64, "grounded", 1e-9),
    (torch.float32, "reset", 2e-4),
])
def test_spatial_step_kernel_matches_plain_step(cuda_device, dtype, start, bound):
    """Per state, max |kernel − plain| ≤ bound × max |plain|."""
    env, x0 = _ant(dtype, cuda_device, start)
    rng = np.random.default_rng(3)
    xs = x0 + torch.as_tensor(rng.uniform(-0.01, 0.01, (32, 30)), dtype=dtype, device=cuda_device)
    acts = torch.as_tensor(rng.uniform(-1, 1, (32, 8)), dtype=dtype, device=cuda_device)
    before = spatial_step.STEP_LAUNCHES
    got = env.step(make_state(xs), acts)
    assert spatial_step.STEP_LAUNCHES == before + 1 and got.t == 1
    want = env.plain_step(make_state(xs), acts).x
    assert spatial_step.STEP_LAUNCHES == before + 1
    err = (got.x - want).abs().amax(-1) / want.abs().amax(-1)
    assert float(err.max()) <= bound


def test_spatial_policy_step_launches_the_kernels(cuda_device):
    """A CEMPPI step on the card rolls out once per AIS iteration on the
    rollout kernel; the env step launches the step kernel once."""
    env = AntDeviceEnv(device=cuda_device)
    cfg = PolicyConfig(kind="cemppi", num_samples=64, horizon=4, lam=1.0, opt_its=2,
                       sigma_est="mle")
    pol = make_policy(env, cfg, cov_mat=0.25 * np.eye(8))
    before = (spatial_step.LAUNCHES, spatial_step.STEP_LAUNCHES)
    a, _, info = pol.step(env.reset(), pol.init_state(1))
    torch.cuda.synchronize()
    assert (spatial_step.LAUNCHES, spatial_step.STEP_LAUNCHES) == (before[0] + info["ais_its"],
                                                                   before[1])
    s, r = env.step_reward(env.reset(), a)
    assert spatial_step.STEP_LAUNCHES == before[1] + 1
    assert bool(torch.isfinite(r)) and s.x.device.type == "cuda"


def test_spatial_cpu_state_never_reaches_the_kernel(cuda_device):
    """An env on the card given CPU tensors runs the plain versions."""
    env = AntDeviceEnv(dtype=torch.float64, device=cuda_device)
    x0 = env.reset().x.cpu()
    ctrl = torch.as_tensor(np.random.default_rng(2).uniform(-1, 1, (2, 8, 3)))
    before = (spatial_step.LAUNCHES, spatial_step.STEP_LAUNCHES)
    got = env.fused_rollout_costs_tak(make_state(x0), ctrl)
    s = env.step(make_state(x0.expand(3, -1)), ctrl[0].T)
    assert got.device.type == "cpu" and s.x.device.type == "cpu"
    assert (spatial_step.LAUNCHES, spatial_step.STEP_LAUNCHES) == before


def test_spatial_wrappers_reject_bad_inputs(cuda_device):
    env = AntDeviceEnv(device=cuda_device)
    x0 = env.reset().x
    ctrl = torch.zeros((4, 8, 16), device=cuda_device)
    before = (spatial_step.LAUNCHES, spatial_step.STEP_LAUNCHES)
    with pytest.raises(ValueError, match="controls shape"):
        spatial_step.spatial_rollout_costs_tak(env, x0, ctrl[:, :6])
    with pytest.raises(ValueError, match="dtype"):
        spatial_step.spatial_rollout_costs_tak(env, x0.half(), ctrl.half())
    with pytest.raises(ValueError, match="state0_x"):
        spatial_step.spatial_rollout_costs_tak(env, x0[:29].contiguous(), ctrl)
    with pytest.raises(ValueError, match="state0_x"):
        spatial_step.spatial_rollout_costs_tak(env, x0.double(), ctrl)
    with pytest.raises(ValueError, match="contiguous"):
        spatial_step.spatial_rollout_costs_tak(env, x0, ctrl[:, :, ::2])
    with pytest.raises(ValueError, match="states"):
        spatial_step.spatial_step_states(env, x0[None], torch.zeros((1, 6), device=cuda_device))
    with pytest.raises(ValueError, match="actions"):
        spatial_step.spatial_step_states(env, x0[None], torch.zeros((1, 8), device=cuda_device,
                                                                     dtype=torch.float64))
    assert (spatial_step.LAUNCHES, spatial_step.STEP_LAUNCHES) == before


# -- the Swimmer's kernel ---------------------------------------------------------
LIM = float(np.deg2rad(100.0))
SWIMMER_STARTS = {"reset": [0.0] * 10,  # and both motor joints past their ±100° limits
                  "limits": [0.1, -0.2, 0.3, 1.03 * LIM, -1.04 * LIM, 0.5, -0.4, 1.0, 2.0, -1.5]}


@pytest.mark.parametrize("start", sorted(SWIMMER_STARTS))
@pytest.mark.parametrize("dtype,rtol,atol", [
    (torch.float32, 2e-4, 2e-3),  # the JAX kernel tests' float32 tolerance
    (torch.float64, 1e-9, 0.0),  # the algebra agrees (2 limit rows, no contact switch)
])
def test_swimmer_kernel_matches_plain_version(cuda_device, start, dtype, rtol, atol):
    env = SwimmerDeviceEnv(dtype=dtype, device=cuda_device)
    x0 = torch.tensor(SWIMMER_STARTS[start], dtype=dtype, device=cuda_device)
    ctrl = torch.as_tensor(np.random.default_rng(64).uniform(-1, 1, (5, 2, 64)), dtype=dtype,
                           device=cuda_device)
    before = planar_step.SWIMMER_LAUNCHES
    got = env.fused_rollout_costs_tak(make_state(x0), ctrl)
    assert planar_step.SWIMMER_LAUNCHES == before + 1
    want = planar_step.swimmer_rollout_costs_tak_reference(env, x0, ctrl)
    assert planar_step.SWIMMER_LAUNCHES == before + 1
    assert bool(torch.all(torch.isfinite(got)))
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype,bound", [(torch.float64, 1e-9), (torch.float32, 2e-4)])
def test_swimmer_step_kernel_matches_plain_step(cuda_device, dtype, bound):
    """Per state, max |kernel − plain| ≤ bound × max |plain|."""
    env = SwimmerDeviceEnv(dtype=dtype, device=cuda_device)
    rng = np.random.default_rng(3)
    x0 = torch.tensor(SWIMMER_STARTS["limits"], dtype=dtype, device=cuda_device)
    xs = x0 + torch.as_tensor(rng.uniform(-0.05, 0.05, (32, 10)), dtype=dtype, device=cuda_device)
    acts = torch.as_tensor(rng.uniform(-1.2, 1.2, (32, 2)), dtype=dtype, device=cuda_device)
    before = planar_step.SWIMMER_STEP_LAUNCHES
    got = env.step(make_state(xs), acts)
    assert planar_step.SWIMMER_STEP_LAUNCHES == before + 1 and got.t == 1
    want = env.plain_step(make_state(xs), acts).x
    err = (got.x - want).abs().amax(-1) / want.abs().amax(-1)
    assert float(err.max()) <= bound


def test_swimmer_wrappers_reject_bad_inputs(cuda_device):
    env = SwimmerDeviceEnv(device=cuda_device)
    x0 = env.reset().x
    ctrl = torch.zeros((4, 2, 8), device=cuda_device)
    before = (planar_step.SWIMMER_LAUNCHES, planar_step.SWIMMER_STEP_LAUNCHES,
              planar_step.LAUNCHES, planar_step.STEP_LAUNCHES)
    with pytest.raises(ValueError, match="controls shape"):
        planar_step.swimmer_rollout_costs_tak(env, x0, torch.zeros((4, 3, 8), device=cuda_device))
    with pytest.raises(ValueError, match="state0_x"):
        planar_step.swimmer_rollout_costs_tak(env, x0[:9].contiguous(), ctrl)
    with pytest.raises(ValueError, match="states"):
        planar_step.swimmer_step_states(env, x0[None], torch.zeros((1, 3), device=cuda_device))
    with pytest.raises(ValueError, match="does not run on the planar kernel"):
        planar_step.planar_rollout_costs_tak(env, x0, ctrl)
    cheetah = CheetahDeviceEnv(device=cuda_device)
    with pytest.raises(ValueError, match="does not run on the swimmer kernel"):
        planar_step.swimmer_rollout_costs_tak(cheetah, cheetah.reset().x,
                                              torch.zeros((4, 6, 8), device=cuda_device))
    assert (planar_step.SWIMMER_LAUNCHES, planar_step.SWIMMER_STEP_LAUNCHES,
            planar_step.LAUNCHES, planar_step.STEP_LAUNCHES) == before


# -- the spatial-contact kernel's Pusher build ------------------------------------
PUSHER_STARTS = {"reset": None, "side": (-0.275, 0.069), "floor": (-0.307, 0.068)}


def _pusher(dtype, device, start):
    env = PusherDeviceEnv(dtype=dtype, device=device)
    if PUSHER_STARTS[start] is None:
        return env, env.reset().x
    qv = np.random.default_rng(4).uniform(-0.3, 0.3, 11)
    return env, pusher_device.touching_state(*PUSHER_STARTS[start], qv).to(device, dtype)


@pytest.mark.parametrize("start", sorted(PUSHER_STARTS))
@pytest.mark.parametrize("dtype,rtol,atol", [
    (torch.float32, 2e-4, 2e-3),  # the JAX kernel tests' float32 tolerance
    (torch.float64, 1e-9, 0.0),
])
def test_pusher_kernel_matches_plain_version(cuda_device, start, dtype, rtol, atol):
    env, x0 = _pusher(dtype, cuda_device, start)
    ctrl = torch.as_tensor(np.random.default_rng(64).uniform(-2, 2, (3, 7, 64)), dtype=dtype,
                           device=cuda_device)
    before = spatial_step.LAUNCHES
    got = env.fused_rollout_costs_tak(make_state(x0), ctrl)
    assert spatial_step.LAUNCHES == before + 1
    want = spatial_step.spatial_rollout_costs_tak_reference(env, x0, ctrl)
    assert bool(torch.all(torch.isfinite(got)))
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype,bound", [(torch.float64, 1e-9), (torch.float32, 2e-4)])
def test_pusher_step_kernel_matches_plain_step(cuda_device, dtype, bound):
    """Per state, max |kernel − plain| ≤ bound × max |plain|, the xpos carry
    included."""
    env, x0 = _pusher(dtype, cuda_device, "side")
    rng = np.random.default_rng(3)
    dx = np.concatenate([rng.uniform(-0.01, 0.01, (32, 22)), np.zeros((32, 9))], axis=1)
    xs = x0 + torch.as_tensor(dx, dtype=dtype, device=cuda_device)
    acts = torch.as_tensor(rng.uniform(-2.4, 2.4, (32, 7)), dtype=dtype, device=cuda_device)
    before = spatial_step.STEP_LAUNCHES
    got = env.step(make_state(xs), acts)
    assert spatial_step.STEP_LAUNCHES == before + 1 and got.t == 1
    want = env.plain_step(make_state(xs), acts).x
    err = (got.x - want).abs().amax(-1) / want.abs().amax(-1)
    assert float(err.max()) <= bound


# -- the spatial-contact kernel's Humanoid and Standup builds ---------------------
HUMANOIDS = {"humanoid": HumanoidDeviceEnv, "standup": HumanoidStandupDeviceEnv}


def _humanoid(which, dtype, device, start):
    """The reset (the Humanoid standing, the Standup supine) or the crouch
    (floor and self-pair rows active) with velocities from a numpy seed."""
    env = HUMANOIDS[which](dtype=dtype, device=device)
    if start == "reset":
        return env, env.reset().x
    q = humanoid_device.crouched_qpos(env.MODEL)
    qv = torch.as_tensor(np.random.default_rng(4).uniform(-0.3, 0.3, 23))
    carry = humanoid_device.com_x(q)[None] if which == "humanoid" else torch.zeros(1).double()
    return env, torch.cat([q, qv, carry]).to(device, dtype)


@pytest.mark.parametrize("start", ["reset", "crouch"])
@pytest.mark.parametrize("which", sorted(HUMANOIDS))
@pytest.mark.parametrize("dtype,rtol,atol", [
    (torch.float32, 2e-4, 2e-3),  # the JAX kernel tests' float32 tolerance
    (torch.float64, 1e-9, 0.0),
])
def test_humanoid_kernel_matches_plain_version(cuda_device, which, start, dtype, rtol, atol):
    """f64 under the nudge rule: to 1e-9, or to 10× the plain version's own
    spread under controls·(1 + 1e-15) where the QP switches contacts (the
    supine Standup lies on a dozen floor and self-pair rows)."""
    env, x0 = _humanoid(which, dtype, cuda_device, start)
    ctrl = torch.as_tensor(np.random.default_rng(64).uniform(-0.4, 0.4, (2, 17, 32)),
                           dtype=dtype, device=cuda_device)
    before = spatial_step.LAUNCHES
    got = env.fused_rollout_costs_tak(make_state(x0), ctrl)
    assert spatial_step.LAUNCHES == before + 1
    want = spatial_step.spatial_rollout_costs_tak_reference(env, x0, ctrl)
    assert bool(torch.all(torch.isfinite(got)))
    if dtype == torch.float64:
        nudged = spatial_step.spatial_rollout_costs_tak_reference(env, x0, ctrl * (1 + 1e-15))
        rtol = max(rtol, 10 * float(((nudged - want) / want).abs().max()))
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=rtol, atol=atol)


@pytest.mark.parametrize("which", sorted(HUMANOIDS))
@pytest.mark.parametrize("dtype,bound", [(torch.float64, 1e-9), (torch.float32, 2e-4)])
def test_humanoid_step_kernel_matches_plain_step(cuda_device, which, dtype, bound):
    """Per state around the crouch, |kernel − plain| / max |plain|: the median
    within the bound, the carry (com x or Σ‖cfrc_ext‖²) included."""
    env, x0 = _humanoid(which, dtype, cuda_device, "crouch")
    rng = np.random.default_rng(3)
    dx = np.concatenate([rng.uniform(-0.01, 0.01, (32, 47)), np.zeros((32, 1))], axis=1)
    xs = x0 + torch.as_tensor(dx, dtype=dtype, device=cuda_device)
    acts = torch.as_tensor(rng.uniform(-0.5, 0.5, (32, 17)), dtype=dtype, device=cuda_device)
    before = spatial_step.STEP_LAUNCHES
    got = env.step(make_state(xs), acts)
    assert spatial_step.STEP_LAUNCHES == before + 1 and got.t == 1
    want = env.plain_step(make_state(xs), acts).x
    err = (got.x - want).abs().amax(-1) / want.abs().amax(-1)
    assert bool(torch.all(torch.isfinite(got.x))) and float(err.median()) <= bound


@pytest.mark.parametrize("which", sorted(HUMANOIDS))
def test_humanoid_policy_step_launches_the_kernels(cuda_device, which):
    """A CEMPPI step rolls out once per AIS iteration on the build; the env
    step launches the step kernel once."""
    env = HUMANOIDS[which](device=cuda_device)
    cfg = PolicyConfig(kind="cemppi", num_samples=64, horizon=2, lam=1.0, opt_its=2,
                       sigma_est="mle")
    pol = make_policy(env, cfg, cov_mat=0.25 * np.eye(17))
    before = (spatial_step.LAUNCHES, spatial_step.STEP_LAUNCHES)
    a, _, info = pol.step(env.reset(), pol.init_state(1))
    torch.cuda.synchronize()
    assert (spatial_step.LAUNCHES, spatial_step.STEP_LAUNCHES) == (before[0] + info["ais_its"],
                                                                   before[1])
    s, r = env.step_reward(env.reset(), a)
    assert spatial_step.STEP_LAUNCHES == before[1] + 1
    assert bool(torch.isfinite(r)) and s.x.device.type == "cuda"


def test_spatial_wrappers_refuse_what_no_build_takes(cuda_device):
    """Self pairs and joint springs in a build without them: refused before
    any launch."""
    import dataclasses

    from mpopis_tpu_torch.models import spatial_contact as sc

    class SpringyPusher(PusherDeviceEnv):
        MODEL = dataclasses.replace(PusherDeviceEnv.MODEL, stiffness=(1.0,) + (0.0,) * 10)

    pair = sc.SCPairCapsule(8, (0.0,) * 3, (0.1, 0.0, 0.0), 0.02, 4, (0.0,) * 3,
                            (0.1, 0.0, 0.0), 0.02, 0.0, (0.9, 0.95, 0.001))

    class SelfPairAnt(AntDeviceEnv):
        MODEL = dataclasses.replace(AntDeviceEnv.MODEL, self_pairs=(pair,))

    before = (spatial_step.LAUNCHES, spatial_step.STEP_LAUNCHES)
    for cls, match in ((SpringyPusher, "springs"), (SelfPairAnt, "self-collision")):
        env = cls(device=cuda_device)
        x0 = torch.zeros(env.state_dim, device=cuda_device)
        ctrl = torch.zeros((2, env.action_dim, 8), device=cuda_device)
        with pytest.raises(ValueError, match=match):
            spatial_step.spatial_rollout_costs_tak(env, x0, ctrl)
        with pytest.raises(ValueError, match=match):
            spatial_step.spatial_step_states(env, x0[None], ctrl[0, :, :1].T.contiguous())
    assert (spatial_step.LAUNCHES, spatial_step.STEP_LAUNCHES) == before


# -- kernel 4's warp per sample: partial blocks, empty QPs, rows over the lanes --
def _hold_f64(env, x0, ctrl, got, bound=1e-9, ref=spatial_step.spatial_rollout_costs_tak_reference,
              pool=False):
    """Every sample: |kernel − plain| / |plain| within `bound`, or within 10×
    that sample's own spread, the most the plain version's cost moves under
    controls·(1 ± 1e-15), x0·(1 + 1e-15) or on the CPU (another association
    of its sums); with `pool`, within 10× the largest own spread of any
    sample of the batch. Over two control steps through contact switches no single
    nudge stands for a new association: on the pressed pose the plain
    version on the CPU lies up to 1.5e-7 from itself on the card where
    controls·(1 + 1e-15) moves it by 1e-9 (scripts/spatial_f64_spread.py).
    A fault in a grid the samples do not fill (a wrong sample index, a stray
    write, a stale slot) hits a few samples, so no sample is left out. `ref`
    is the plain version of the kernel that gave `got`."""
    want = ref(env, x0, ctrl)
    err = ((got - want) / want).abs()
    assert bool(torch.all(torch.isfinite(got))), "non-finite costs"
    far = (err > bound).nonzero().flatten()
    if len(far) == 0:
        return
    idx = torch.arange(err.numel(), device=err.device) if pool else far
    runs = [ref(env, x0, ctrl * (1 + 1e-15)), ref(env, x0, ctrl * (1 - 1e-15)),
            ref(env, x0 * (1 + 1e-15), ctrl)]
    own = torch.stack([((r[idx] - want[idx]) / want[idx]).abs() for r in runs]).amax(0)
    cars = {"num_cars": env.num_cars} if isinstance(env, MultiCarRacingEnv) else {}
    cpu = ref(type(env)(dtype=torch.float64, device="cpu", **cars), x0.cpu(),
              ctrl[..., idx].cpu())
    own = torch.maximum(own, ((cpu.to(want.device) - want[idx]) / want[idx]).abs())
    if pool:
        own = own.amax().expand(far.numel())
    bad = err[far] > 10 * own
    assert not bool(bad.any()), (
        f"samples {far[bad].tolist()}: errors {err[far][bad].tolist()}, "
        f"own spreads {own[bad].tolist()}")


def _supine_pressed(which, device):
    """The Standup's supine reset pressed 2 cm into the floor, with the
    build's carry: 82 rows valid in the first substep on the Humanoid's
    model, 36 on the Standup's, more than a warp's 32 lanes, so that the
    rows wrap over the lanes."""
    env = HUMANOIDS[which](dtype=torch.float64, device=device)
    x = HumanoidStandupDeviceEnv(dtype=torch.float64, device=device).reset().x.clone()
    x[2] -= 0.02
    if which == "humanoid":
        x[-1] = humanoid_device.com_x(x[:24].cpu())
    return env, x


@pytest.mark.parametrize("k", [1, 33, 1023])
@pytest.mark.parametrize("which", ["ant", "humanoid"])
def test_spatial_kernel_partial_warp_counts_match_plain_version(cuda_device, which, k):
    """K = 1, 33 and 1023: a block or a grid that the samples do not fill."""
    if which == "ant":
        env, x0 = _ant(torch.float64, cuda_device, "grounded")
        hi = 1.0
    else:
        env, x0 = _humanoid("humanoid", torch.float64, cuda_device, "crouch")
        hi = 0.4
    ctrl = torch.as_tensor(np.random.default_rng(k).uniform(-hi, hi, (2, env.action_dim, k)),
                           dtype=torch.float64, device=cuda_device)
    before = spatial_step.LAUNCHES
    got = spatial_step.spatial_rollout_costs_tak(env, x0, ctrl)
    assert spatial_step.LAUNCHES == before + 1 and got.shape == (k,)
    _hold_f64(env, x0, ctrl, got)


def test_spatial_kernel_sample_with_no_valid_row(cuda_device):
    """Ant 2 m above the floor with every joint inside its range: no limit or
    contact row is valid, so the QP is skipped on every lane."""
    env, x0 = _ant(torch.float64, cuda_device, "reset")
    x0[2] = 2.0
    for lm in env.MODEL.limits:
        x0[lm.dof + 1] = 0.5 * (lm.lo + lm.hi)  # a hinge's qpos follows its dof by one
    assert spatial_step.first_substep_active_rows(env, x0) == (0, 0, 0)
    ctrl = torch.zeros((1, 8, 5), dtype=torch.float64, device=cuda_device)
    _hold_f64(env, x0, ctrl, spatial_step.spatial_rollout_costs_tak(env, x0, ctrl))


@pytest.mark.parametrize("which", sorted(HUMANOIDS))
def test_humanoid_kernel_rows_wrap_over_the_lanes(cuda_device, which):
    env, x0 = _supine_pressed(which, cuda_device)
    assert sum(spatial_step.first_substep_active_rows(env, x0)) > 32
    ctrl = torch.as_tensor(np.random.default_rng(8).uniform(-0.4, 0.4, (2, 17, 64)),
                           dtype=torch.float64, device=cuda_device)
    _hold_f64(env, x0, ctrl, spatial_step.spatial_rollout_costs_tak(env, x0, ctrl))


@pytest.mark.parametrize("which", sorted(HUMANOIDS))
def test_humanoid_step_kernel_batch_of_three(cuda_device, which):
    """The step entry for 3 states (the crouch, the pressed supine pose and
    the reset): per state within 1e-9 of the plain step, or the nudge rule."""
    states = [_humanoid(which, torch.float64, cuda_device, start)[1] for start in ("crouch",
                                                                                    "reset")]
    env, pressed = _supine_pressed(which, cuda_device)
    xs = torch.stack([states[0], pressed, states[1]])
    acts = torch.as_tensor(np.random.default_rng(3).uniform(-0.5, 0.5, (3, 17)),
                           dtype=torch.float64, device=cuda_device)
    before = spatial_step.STEP_LAUNCHES
    got = spatial_step.spatial_step_states(env, xs, acts)
    assert spatial_step.STEP_LAUNCHES == before + 1
    want = env.plain_step(make_state(xs), acts).x
    err = (got - want).abs().amax(-1) / want.abs().amax(-1)
    own = (env.plain_step(make_state(xs), acts * (1 + 1e-15)).x - want).abs().amax(-1)
    bound = torch.clamp(10 * own / want.abs().amax(-1), min=1e-9)
    assert bool(torch.all(torch.isfinite(got))) and bool(torch.all(err <= bound))


# -- kernels 2 and 3's groups of lanes: partial blocks, empty and wide QPs ------
PLANAR_BUILDS = {"cheetah": CheetahDeviceEnv, "hopper": HopperDeviceEnv,
                 "walker2d": Walker2dDeviceEnv, "swimmer": SwimmerDeviceEnv}
# x[1] of the contact builds' starts past LOWERED: 45 (HalfCheetah) and 39
# (Walker2d) rows valid in the first substep, more than the dense QP's 32;
# and 2 m up, no row valid
DEEP = {"cheetah": -0.7, "walker2d": 0.2}
# Walker2d's rollouts are held against the batch's largest own spread (pool):
# from its lowered and deep starts its truncated QP turns the kernel's own
# rounding into other iterates for single samples. 1 to 3 of 33-64 samples
# lie beyond 10× their own spread on this kernel and on the thread-per-sample
# kernel it replaces alike; sample 16 of K = 33 moves 1.5e-7 to 7.9e-7 where
# nudges move it 8e-9, and agrees once the kernel is built without FMA
# contraction, which moves sample 13 of the deep drop by 1.8e-3 instead
# (scripts/planar_f64_spread.py). A grid fault moves costs by percent.


def _planar(which, dtype, device, start):
    """(env, x0) of a planar build at a start: the reset, `lowered` (LOWERED;
    the Swimmer's joints past their limits), `deep` (DEEP) or `air` (no row
    valid: 2 m up; the Swimmer's reset)."""
    env = PLANAR_BUILDS[which](dtype=dtype, device=device)
    x = env.reset().x.clone()
    if which == "swimmer":
        if start == "lowered":
            x = torch.tensor(SWIMMER_STARTS["limits"], dtype=dtype, device=device)
    elif start != "reset":
        x[1] = {"lowered": LOWERED.get(which), "deep": DEEP.get(which), "air": 2.0}[start]
    return env, x


def _planar_rollout(env):
    return (planar_step.swimmer_rollout_costs_tak if getattr(env, "FLUID", ())
            else planar_step.planar_rollout_costs_tak)


def _hold_step_f64(env, xs, acts, got, bound=1e-9):
    """Per state: max |kernel − plain| / max |plain| within `bound`, or within
    10× the most the plain step moves under actions·(1 ± 1e-15), states·(1 +
    1e-15) or on the CPU."""
    def plain(x, a):
        return env.plain_step(make_state(x), a).x

    want = plain(xs, acts)
    scale = want.abs().amax(-1)
    err = (got - want).abs().amax(-1) / scale
    cpu = type(env)(dtype=torch.float64, device="cpu").plain_step(make_state(xs.cpu()),
                                                                  acts.cpu()).x
    runs = [plain(xs, acts * (1 + 1e-15)), plain(xs, acts * (1 - 1e-15)),
            plain(xs * (1 + 1e-15), acts), cpu.to(want.device)]
    own = torch.stack([(r - want).abs().amax(-1) / scale for r in runs]).amax(0)
    assert bool(torch.all(torch.isfinite(got))), "non-finite states"
    bad = (err > bound) & (err > 10 * own)
    assert not bool(bad.any()), f"states {bad.nonzero().flatten().tolist()}: {err[bad].tolist()}"


@pytest.mark.parametrize("k_case", ["1", "33", "block-1"])
@pytest.mark.parametrize("which", sorted(PLANAR_BUILDS))
def test_planar_kernels_partial_group_and_block_counts(cuda_device, which, k_case):
    """K = 1, 33 and 64 blocks less one sample: groups, blocks and a grid that
    the samples do not fill. f64 from the lowered start, every sample within
    1e-9 or the nudge rule (Walker2d's pooled, see DEEP); f32 from the reset
    at the JAX kernel tests' rtol 2e-4 / atol 2e-3."""
    env, x0 = _planar(which, torch.float64, cuda_device, "lowered")
    lanes, warps = planar_step.launch_shape(env, torch.float64)
    k = {"1": 1, "33": 33, "block-1": 64 * (32 * warps // lanes) - 1}[k_case]
    ctrl = torch.as_tensor(np.random.default_rng(k).uniform(-1, 1, (2, env.action_dim, k)),
                           dtype=torch.float64, device=cuda_device)
    rollout = _planar_rollout(env)
    ref = planar_step.planar_rollout_costs_tak_reference
    got = rollout(env, x0, ctrl)
    assert got.shape == (k,)
    _hold_f64(env, x0, ctrl, got, ref=ref, pool=which == "walker2d")
    env32, x32 = _planar(which, torch.float32, cuda_device, "reset")
    got32 = rollout(env32, x32, ctrl.float())
    np.testing.assert_allclose(got32.cpu().numpy(), ref(env32, x32, ctrl.float()).cpu().numpy(),
                               rtol=2e-4, atol=2e-3)


@pytest.mark.parametrize("which", sorted(PLANAR_BUILDS))
def test_planar_step_kernels_sample_with_no_valid_row_beside_samples_with_rows(cuda_device,
                                                                              which):
    """The step entry on 8 states, every other one with no valid row (2 m up;
    the Swimmer's reset) beside ones with rows (lowered; its limits): the
    groups of one warp (the Swimmer's) skip and run their QPs apart."""
    env, air = _planar(which, torch.float64, cuda_device, "air")
    _, low = _planar(which, torch.float64, cuda_device, "lowered")
    xs = torch.stack([air, low] * 4)
    assert sum(planar_step.first_substep_active_rows(env, air)) == 0
    assert sum(planar_step.first_substep_active_rows(env, low)) > 0
    acts = torch.as_tensor(np.random.default_rng(4).uniform(-1, 1, (8, env.action_dim)),
                           device=cuda_device)
    _hold_step_f64(env, xs, acts, env.step(make_state(xs), acts).x)


@pytest.mark.parametrize("which", sorted(DEEP))
def test_planar_kernel_beyond_the_dense_qp(cuda_device, which):
    """More than 32 valid rows: the QP applies W^T (W v), not the dense A."""
    env, x0 = _planar(which, torch.float64, cuda_device, "deep")
    assert sum(planar_step.first_substep_active_rows(env, x0)) > 32
    ctrl = torch.as_tensor(np.random.default_rng(9).uniform(-1, 1, (2, env.action_dim, 64)),
                           dtype=torch.float64, device=cuda_device)
    _hold_f64(env, x0, ctrl, planar_step.planar_rollout_costs_tak(env, x0, ctrl),
              ref=planar_step.planar_rollout_costs_tak_reference, pool=which == "walker2d")


@pytest.mark.parametrize("which", sorted(PLANAR_BUILDS))
def test_planar_step_kernels_batch_of_three(cuda_device, which):
    """The step entry for 3 states (the reset, the lowered start, the deep
    one or 2 m up; the Swimmer's reset, limits and reset): per state within
    1e-9 of the plain step, or the nudge rule."""
    starts = ("reset", "lowered", "deep" if which in DEEP else "air")
    xs = torch.stack([_planar(which, torch.float64, cuda_device, s)[1] for s in starts])
    env = PLANAR_BUILDS[which](dtype=torch.float64, device=cuda_device)
    acts = torch.as_tensor(np.random.default_rng(3).uniform(-1.2, 1.2, (3, env.action_dim)),
                           device=cuda_device)
    counter = "SWIMMER_STEP_LAUNCHES" if which == "swimmer" else "STEP_LAUNCHES"
    before = getattr(planar_step, counter)
    got = env.step(make_state(xs), acts).x
    assert getattr(planar_step, counter) == before + 1
    _hold_step_f64(env, xs, acts, got)


# -- AIS updates and small linear algebra --------------------------------------
# float32 at the JAX kernel tests' tolerances (refits and Cholesky rtol 5e-4 /
# atol 5e-5, CMA rtol 5e-3 / atol 5e-4, forward solve rtol 5e-5 / atol 5e-6);
# float64 at rtol 1e-9.
AIS_TOL = {"refit": (5e-4, 5e-5), "cma": (5e-3, 5e-4), "solve": (5e-5, 5e-6)}


def _tol(family, dtype):
    return AIS_TOL[family] if dtype == torch.float32 else (1e-9, 1e-12)


def _ais_close(got, want, family, dtype):
    rtol, atol = _tol(family, dtype)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=rtol, atol=atol)


def _refit_data(device, dtype, cs=100, k=8192, m=1638, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    e = torch.randn((cs, k), generator=g, dtype=torch.float64) * 0.3
    mask = torch.zeros(k, dtype=torch.float64)
    mask[torch.randperm(k, generator=g)[:m]] = 1.0
    w = torch.rand(k, generator=g, dtype=torch.float64) ** 4
    w /= w.sum()
    return (t.to(device=device, dtype=dtype) for t in (e, mask, w))


def _pmc_counts(w, seed=0):
    """PMC's resampling weights: multinomial counts over the K columns / K,
    zero for the columns no draw fell on."""
    k = w.shape[0]
    g = torch.Generator(device="cpu").manual_seed(seed)
    draws = torch.multinomial(w.double().cpu(), k, replacement=True, generator=g)
    return (torch.bincount(draws, minlength=k).double() / k).to(device=w.device, dtype=w.dtype)


# (n, K, m): the bench's n = 100, K = 8192, m = 1638; a tile's n = 4 at the
# CLI's K = 150 with a warp less one of elites; n = 33 (a panel and one row)
# at K = 8193 (a ragged ballot word); the humanoids' n = 136 (float64 in
# global memory); every column elite at K = 8193 and at K = 150; n = 200,
# past the 144 rows a gather holds in flight and in global memory in both
# dtypes
REFIT_SHAPES = [(100, 8192, 1638), (4, 150, 31), (33, 8193, 1638), (136, 8192, 1638),
                (100, 8193, 8193), (136, 150, 150), (200, 2048, 400)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("method", ["mle", "lw", "ss", "rblw", "oas"])
@pytest.mark.parametrize("n,k,m", REFIT_SHAPES)
def test_masked_refit_kernel_matches_plain_version(cuda_device, dtype, method, n, k, m):
    e, mask, _ = _refit_data(cuda_device, dtype, n, k, m, seed=n + m)
    mu = (e @ mask) / m
    before = ais_update.MASKED_LAUNCHES
    got = ais_update.masked_refit_chol(e, mask, mu, m, method, 1e-8)
    assert ais_update.MASKED_LAUNCHES == before + 1
    want = ais_update.masked_refit_chol_reference(e, mask, mu, m, method, 1e-8)
    _ais_close(got, want, "refit", dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("corrected", [False, True])
@pytest.mark.parametrize("weights", ["w4", "pmc_counts"])
@pytest.mark.parametrize("n,k", [(100, 8192), (4, 150), (33, 8193), (136, 8192), (200, 2048)])
def test_weighted_refit_kernel_matches_plain_version(cuda_device, dtype, corrected, weights, n, k):
    """μΣ-AIS's weights (every column counts) and PMC's counts / K (about a
    third of the columns zero), each in both forms."""
    e, _, w = _refit_data(cuda_device, dtype, n, k, 1, seed=n + k)
    if weights == "pmc_counts":
        w = _pmc_counts(w, seed=n)
        assert 0 < int((w != 0).sum()) < k
    mu = e @ w
    before = ais_update.WEIGHTED_LAUNCHES
    got = ais_update.weighted_refit_chol(e, w, mu, corrected, 1e-8)
    assert ais_update.WEIGHTED_LAUNCHES == before + 1
    _ais_close(got, ais_update.weighted_refit_chol_reference(e, w, mu, corrected, 1e-8),
               "refit", dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m", [1, 31])
def test_masked_mle_refit_rank_deficient_matches_plain_version(cuda_device, dtype, m):
    """m < n elites: the `mle` estimate has rank m - 1, and only the jitter
    (1e-8 plus 100 eps of the mean diagonal) keeps it positive definite. The
    factor is finite, and L Lᵀ matches the plain version's at the refit
    tolerance; in float32 the trailing columns of L are square roots of
    pivots about 100 eps of the diagonal, which the order of the sums moves,
    so L itself is held only in float64."""
    n, k = 100, 8192
    e, mask, _ = _refit_data(cuda_device, dtype, n, k, m, seed=m)
    mu = (e @ mask) / m
    got = ais_update.masked_refit_chol(e, mask, mu, m, "mle", 1e-8)
    want = ais_update.masked_refit_chol_reference(e, mask, mu, m, "mle", 1e-8)
    assert bool(torch.isfinite(got).all())
    _ais_close(got @ got.T, want @ want.T, "refit", dtype)
    if dtype == torch.float64:
        _ais_close(got, want, "refit", dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["mle", "lw", "ss", "weighted"])
def test_refit_kernel_not_positive_definite_gives_the_plain_nans(cuda_device, dtype, case):
    """An estimate whose pivot 70 of 100 fails: the masked refits with row 70
    of the elite columns at the mean and a jitter of -1e-3, the weighted one
    with a weight of -1 on a column that is 10 in row 70 and 0 elsewhere.
    NaN where the plain version has NaN (on and below the diagonal from
    column 70), the columns before it at the refit tolerance."""
    n, k, m, piv = 100, 8192, 1638, 70
    e, mask, w = _refit_data(cuda_device, dtype, n, k, m, seed=piv)
    if case == "weighted":
        e[:, 5] = 0.0
        e[piv, 5] = 10.0
        w[5] = -1.0
        mu = torch.zeros(n, device=cuda_device, dtype=dtype)
        got = ais_update.weighted_refit_chol(e, w, mu, False, 1e-8)
        want = ais_update.weighted_refit_chol_reference(e, w, mu, False, 1e-8)
    else:
        e[piv, mask != 0] = 0.0
        mu = (e @ mask) / m
        got = ais_update.masked_refit_chol(e, mask, mu, m, case, -1e-3)
        want = ais_update.masked_refit_chol_reference(e, mask, mu, m, case, -1e-3)
    torch.cuda.synchronize()
    low = torch.tril(torch.ones((n, n), dtype=torch.bool, device=cuda_device))
    assert bool(torch.isnan(want[piv:, piv:][low[piv:, piv:]]).all())
    assert not bool(torch.isnan(want[:, :piv]).any())
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    _ais_close(got[:, :piv], want[:, :piv], "refit", dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [100, 136])
def test_refit_kernel_repeats_bit_for_bit(cuda_device, dtype, n):
    """Two calls on the same inputs give the same bits: the blocks' partial
    moments are summed in rank order, with no atomics (n = 136 in float64
    through global memory)."""
    e, mask, w = _refit_data(cuda_device, dtype, n, 8192, 1638, seed=n)
    mu_m, mu_w = (e @ mask) / 1638, e @ w
    for run in (lambda: ais_update.masked_refit_chol(e, mask, mu_m, 1638, "ss", 1e-8),
                lambda: ais_update.weighted_refit_chol(e, w, mu_w, True, 1e-8)):
        first, second = run(), run()
        torch.cuda.synchronize()
        assert torch.equal(first, second)


def test_refit_layout_per_size(cuda_device):
    """The library's layout: a cluster of 16 blocks; partials and factor in
    shared memory at the car's n = 100 (both dtypes) and the humanoids' 136
    in float32, in global memory at 136 in float64 and at 200."""
    assert ais_update.refit_layout(100, 8192, torch.float32) == (16, "shared")
    assert ais_update.refit_layout(100, 8192, torch.float64) == (16, "shared")
    assert ais_update.refit_layout(136, 8192, torch.float32) == (16, "shared")
    assert ais_update.refit_layout(136, 8192, torch.float64) == (16, "global")
    assert ais_update.refit_layout(200, 2048, torch.float32) == (16, "global")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("update_chol", [True, False])
def test_cma_kernel_matches_plain_version(cuda_device, dtype, update_chol):
    n, k = 100, 8192
    g = torch.Generator(device="cpu").manual_seed(3)
    a = torch.randn((n, n), generator=g, dtype=torch.float64) * 0.05
    consts = CMAStrategy.constants(k, n, 0.8)
    args = [a @ a.T + 0.3 * torch.eye(n, dtype=torch.float64),
            torch.randn(n, generator=g, dtype=torch.float64) * 0.3,
            torch.randn(n, generator=g, dtype=torch.float64) * 0.5,
            torch.randn(n, generator=g, dtype=torch.float64) * 0.1,
            torch.randn(k, generator=g, dtype=torch.float64),
            torch.as_tensor(consts["ws"]), torch.tensor(0.8, dtype=torch.float64)]
    args = [t.to(device=cuda_device, dtype=dtype) for t in args]
    consts_t = tuple(sorted((name, float(consts[name])) for name in ais_update.CMA_CONSTS))
    before = ais_update.CMA_LAUNCHES
    got = ais_update.cma_update_chol(*args, 3.0, consts_t, 1e-8, update_chol=update_chol)
    assert ais_update.CMA_LAUNCHES == before + 1
    want = ais_update.cma_update_chol_reference(*args, 3.0, consts_t, 1e-8,
                                                update_chol=update_chol)
    for g_, w_ in zip(got, want):
        _ais_close(g_, w_, "cma", dtype)


def _cma_args(n, k, device, dtype, seed=3):
    g = torch.Generator(device="cpu").manual_seed(seed)
    a = torch.randn((n, n), generator=g, dtype=torch.float64) * 0.05
    consts = CMAStrategy.constants(k, n, 0.8)
    args = [a @ a.T + 0.3 * torch.eye(n, dtype=torch.float64),
            torch.randn(n, generator=g, dtype=torch.float64) * 0.3,
            torch.randn(n, generator=g, dtype=torch.float64) * 0.5,
            torch.randn(n, generator=g, dtype=torch.float64) * 0.1,
            torch.randn(k, generator=g, dtype=torch.float64),
            torch.as_tensor(consts["ws"]), torch.tensor(0.8, dtype=torch.float64)]
    consts_t = tuple(sorted((name, float(consts[name])) for name in ais_update.CMA_CONSTS))
    return [t.to(device=device, dtype=dtype) for t in args], consts_t


def _cma_largest_cluster_n(dtype):
    """The largest n that the CMA kernel's cluster holds in shared memory
    (the kernel runs n + 1 on one block from global memory)."""
    n = 64
    while ais_update.cma_cluster_size(n + 1, dtype) > 0:
        n += 1
    assert ais_update.cma_cluster_size(n, dtype) > 0
    return n


@pytest.mark.parametrize("update_chol", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 31, 33, 100, 136, "largest", "largest+1"])
def test_cma_kernel_sizes_match_plain_version(cuda_device, n, dtype, update_chol):
    """The CMA kernel at the panel edges (31, 33), the car's n = 100, the
    Humanoid's 136, and the largest n whose bands and staging fit the
    cluster's shared memory and the next n (one block from global memory):
    float32 at the JAX kernel tests' tolerance, float64 at 1e-9 relative."""
    if isinstance(n, str):
        n = _cma_largest_cluster_n(dtype) + (n == "largest+1")
    k = 2048
    args, consts_t = _cma_args(n, k, cuda_device, dtype, seed=n)
    before = ais_update.CMA_LAUNCHES
    got = ais_update.cma_update_chol(*args, 3.0, consts_t, 1e-8, update_chol=update_chol)
    assert ais_update.CMA_LAUNCHES == before + 1
    want = ais_update.cma_update_chol_reference(*args, 3.0, consts_t, 1e-8,
                                                update_chol=update_chol)
    for g_, w_ in zip(got, want):
        assert bool(torch.all(torch.isfinite(g_)))
        _ais_close(g_, w_, "cma", dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [4, 100, 600, 1, 31, 32, 33, 136, 1024])
def test_cholesky_and_forward_solve_kernels_match_plain_versions(cuda_device, dtype, n):
    g = torch.Generator(device="cpu").manual_seed(n)
    a = torch.randn((n, n), generator=g, dtype=torch.float64) * 0.2
    spd = (a @ a.T + torch.eye(n, dtype=torch.float64)).to(device=cuda_device, dtype=dtype)
    before = linalg.CHOL_LAUNCHES
    l = linalg.chol_kernel(spd)
    assert linalg.CHOL_LAUNCHES == before + 1
    _ais_close(l, linalg.chol_reference(spd), "refit", dtype)
    assert bool(torch.all(torch.triu(l, 1) == 0))
    b = torch.randn((2, n), generator=g, dtype=torch.float64).to(device=cuda_device, dtype=dtype)
    before = linalg.SOLVE_LAUNCHES
    y = linalg.fwd_solve_kernel(l, b)
    assert linalg.SOLVE_LAUNCHES == before + 1
    _ais_close(y, linalg.fwd_solve_reference(l, b), "solve", dtype)


def test_cholesky_kernel_gives_nans_where_not_positive_definite(cuda_device):
    spd = torch.eye(6, dtype=torch.float64, device=cuda_device)
    spd[3, 3] = -1.0
    l = linalg.chol_kernel(spd)
    assert bool(torch.isnan(l[3:, 3]).all()) and not bool(torch.isnan(l[:, :3]).any())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cholesky_kernel_gives_nans_from_a_later_panel(cuda_device, dtype):
    """n = 100 with pivot 70 failing, inside the third panel of 32 columns:
    the plain version's NaN pattern, finite and equal before column 70."""
    g = torch.Generator(device="cpu").manual_seed(70)
    a = torch.randn((100, 100), generator=g, dtype=torch.float64) * 0.2
    spd = (a @ a.T + torch.eye(100, dtype=torch.float64)).to(device=cuda_device, dtype=dtype)
    spd[70, 70] = -1.0
    l, want = linalg.chol_kernel(spd), linalg.chol_reference(spd)
    assert bool(torch.equal(torch.isnan(l), torch.isnan(want)))
    low = torch.tril(torch.ones((30, 30), dtype=torch.bool, device=cuda_device))
    assert bool(torch.isnan(l[70:, 70:][low]).all())
    assert not bool(torch.isnan(l[:, :70]).any())
    _ais_close(l[:, :70], want[:, :70], "refit", dtype)


@pytest.mark.parametrize("dtype,n,lda", [
    (torch.float32, 136, 140),  # 136 floats are 34 units of 16 bytes: padded to 35
    (torch.float32, 31, 36),
    (torch.float32, 100, 100),  # 25 units: no padding needed
    (torch.float32, 240, 240),  # padded rows would not fit: unpadded in shared memory
    (torch.float64, 100, 102),
    (torch.float64, 170, 170),
    (torch.float32, 241, 241),  # in device memory
])
def test_cholesky_kernel_row_stride(cuda_device, dtype, n, lda):
    """The staged matrix's row stride: an odd number of 16-byte units where the
    padded rows fit a block's shared memory, else n; the factor agrees with
    the plain version at each."""
    assert linalg.chol_lda(n, dtype) == lda
    g = torch.Generator(device="cpu").manual_seed(lda)
    a = torch.randn((n, n), generator=g, dtype=torch.float64) * 0.2
    spd = (a @ a.T + torch.eye(n, dtype=torch.float64)).to(device=cuda_device, dtype=dtype)
    _ais_close(linalg.chol_kernel(spd), linalg.chol_reference(spd), "refit", dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,nrhs", [(33, 1), (33, 16), (1024, 5), (1024, 16)])
def test_forward_solve_kernel_takes_up_to_max_rhs(cuda_device, dtype, n, nrhs):
    assert linalg.fwd_solve_fits(n, nrhs, dtype)
    g = torch.Generator(device="cpu").manual_seed(nrhs)
    a = torch.randn((n, n), generator=g, dtype=torch.float64) * 0.2
    l = torch.linalg.cholesky(a @ a.T + torch.eye(n, dtype=torch.float64))
    b = torch.randn((nrhs, n), generator=g, dtype=torch.float64)
    l, b = (t.to(device=cuda_device, dtype=dtype).contiguous() for t in (l, b))
    _ais_close(linalg.fwd_solve_kernel(l, b), linalg.fwd_solve_reference(l, b), "solve", dtype)


def test_ais_wrappers_reject_bad_inputs(cuda_device):
    e = torch.zeros((8, 64), device=cuda_device)
    w = torch.zeros(64, device=cuda_device)
    mu = torch.zeros(8, device=cuda_device)
    before = (ais_update.MASKED_LAUNCHES, ais_update.WEIGHTED_LAUNCHES, ais_update.CMA_LAUNCHES,
              linalg.CHOL_LAUNCHES, linalg.SOLVE_LAUNCHES)
    with pytest.raises(ValueError, match="dtype"):
        ais_update.masked_refit_chol(e.half(), w.half(), mu.half(), 4)
    with pytest.raises(ValueError, match="mu shape"):
        ais_update.masked_refit_chol(e, w, mu[:4].contiguous(), 4)
    with pytest.raises(ValueError, match="contiguous"):
        ais_update.weighted_refit_chol(e.T.contiguous().T, w, mu)
    with pytest.raises(ValueError, match="want torch.float32"):
        ais_update.weighted_refit_chol(e, w.double(), mu)
    with pytest.raises(ValueError, match="on cuda"):
        ais_update.weighted_refit_chol(e, w.cpu(), mu)
    with pytest.raises(ValueError, match="unknown sigma_est"):
        ais_update.masked_refit_chol(e, w, mu, 4, "bogus")
    sig = torch.eye(8, device=cuda_device)
    with pytest.raises(ValueError, match="dw shape"):
        ais_update.cma_update_chol(sig, mu[:3], mu, mu, w, w, torch.tensor(1.0, device=cuda_device),
                                   1.0, (), 1e-8)
    with pytest.raises(ValueError, match="shape"):
        linalg.chol_kernel(torch.zeros((3, 4), device=cuda_device))
    with pytest.raises(ValueError, match="contiguous"):
        linalg.chol_kernel(torch.zeros((8, 8), device=cuda_device).T[::2, ::2])
    with pytest.raises(ValueError, match="b shape"):
        linalg.fwd_solve_kernel(sig, torch.zeros((2, 7), device=cuda_device))
    with pytest.raises(ValueError, match="b is"):
        linalg.fwd_solve_kernel(sig, torch.zeros((2, 8), device=cuda_device, dtype=torch.float64))
    with pytest.raises(ValueError, match="too many"):
        linalg.fwd_solve_kernel(sig, torch.zeros((linalg.MAX_RHS + 1, 8), device=cuda_device))
    assert (ais_update.MASKED_LAUNCHES, ais_update.WEIGHTED_LAUNCHES, ais_update.CMA_LAUNCHES,
            linalg.CHOL_LAUNCHES, linalg.SOLVE_LAUNCHES) == before


@pytest.mark.parametrize("kind,env_var,counters", [
    ("cemppi", "MPOPIS_FUSED_UPDATE", ("MASKED_LAUNCHES",)),
    ("musigmaaismppi", "MPOPIS_FUSED_UPDATE", ("WEIGHTED_LAUNCHES",)),
    ("pmcmppi", "MPOPIS_FUSED_UPDATE", ("WEIGHTED_LAUNCHES",)),
    ("cmamppi", "MPOPIS_FUSED_UPDATE", ("CMA_LAUNCHES",)),
    ("cemppi", "MPOPIS_PALLAS_LINALG", ("CHOL_LAUNCHES", "SOLVE_LAUNCHES")),
])
def test_switches_route_the_policy_step_through_the_kernels(cuda_device, monkeypatch, kind,
                                                            env_var, counters):
    """With a switch on, a float32 policy step on the card launches the kernel
    once per AIS iteration: the plain version is not used."""
    monkeypatch.setenv(env_var, "1")
    env = CarRacingEnv(device=cuda_device)
    cfg = PolicyConfig(kind=kind, num_samples=256, horizon=10, lam=10.0, opt_its=3, alpha=0.9,
                       elite_stop_tol=0.0)
    pol = make_policy(env, cfg, cov_mat=np.diag([0.0625, 0.1]))
    mods = [ais_update if hasattr(ais_update, c) else linalg for c in counters]
    before = [getattr(m, c) for m, c in zip(mods, counters)]
    _, _, info = pol.step(env.reset(), pol.init_state(1))
    torch.cuda.synchronize()
    assert info["ais_its"] == 3
    assert [getattr(m, c) - b for m, c, b in zip(mods, counters, before)] == [3] * len(counters)
