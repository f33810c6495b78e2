"""Ant's control step on the CPU against the JAX package in float64: one
`step_reward` from the four starts of tests/test_torch_spatial_models.py,
a short `simulate_mujoco_on_device("Ant-v4")` run (per-step and chunked
loops, its action CSV replayed through the JAX package's `step_reward`)
and the `mujoco --on-device --env-name Ant-v4` CLI."""

import glob

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpopis_tpu.models import AntDeviceEnv as JAntDeviceEnv

from mpopis_tpu_torch.harness import simulate
from mpopis_tpu_torch.harness.cli import main
from mpopis_tpu_torch.models import AntDeviceEnv
from mpopis_tpu_torch.models.base import make_state
from test_torch_spatial_models import NAMES, STATES

SIM = dict(num_trials=1, num_steps=2, num_samples=4, horizon=2, ais_its=2, lam=1.0,
           ce_sigma_est="mle", seed=2, device="cpu", dtype=torch.float64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions are thousands of tiny ops: one thread each keeps
    test processes that run side by side from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_step_reward():
    """The JAX package's `step_reward` over a batch of 4 states, jitted once:
    (x (4, 30), actions (4, 8)) -> (x' (4, 30), r (4,))."""
    jenv = JAntDeviceEnv(dtype=jnp.float64)

    def one(x, a):
        s, r = jenv.step_reward(jenv.reset().replace(x=x), a)
        return s.x, r

    f = jax.jit(jax.vmap(one))

    def run(x, a):
        xn, r = f(jnp.asarray(x), jnp.asarray(a))
        return np.asarray(xn), np.asarray(r)

    return run


@pytest.mark.parametrize("i", range(len(STATES)), ids=NAMES)
def test_control_step_and_reward_match_jax(jax_step_reward, i):
    """One control step (5 RK4 substeps, λ chained and reset) and its reward,
    actions beyond ±1 so that the torques clamp and the control cost reads
    them as given: rtol 1e-9."""
    x = np.stack([np.concatenate([q, qv, [q[0]]]) for _, q, qv in STATES])
    acts = np.random.default_rng(9).uniform(-1.2, 1.2, (len(STATES), 8))
    want_x, want_r = jax_step_reward(x, acts)
    env = AntDeviceEnv(dtype=torch.float64, device="cpu")
    s, r = env.step_reward(make_state(torch.as_tensor(x[i])), torch.as_tensor(acts[i]))
    np.testing.assert_allclose(s.x.numpy(), want_x[i], rtol=1e-9,
                               atol=1e-9 * np.abs(want_x[i]).max())
    np.testing.assert_allclose(float(r), want_r[i], rtol=1e-9)
    assert s.t == 1


@pytest.fixture(scope="module")
def trial(tmp_path_factory):
    """One f64 Ant trial on the CPU, per-step and chunked, with the executed
    actions written as CSV."""
    out = tmp_path_factory.mktemp("acts")
    per_step = simulate.simulate_mujoco_on_device(
        "Ant-v4", steps_per_call=1, output_acts_file=True, acts_dir=str(out),
        print_output=False, **SIM)
    (csv,) = glob.glob(str(out / "*.csv"))
    chunked = simulate.simulate_mujoco_on_device(
        "Ant-v4", steps_per_call=3, print_output=False, **SIM)
    return per_step, chunked, np.loadtxt(csv, delimiter=",", ndmin=2)


def test_chunked_and_per_step_loops_agree(trial):
    per_step, chunked, _ = trial
    assert per_step["rewards"][0] == chunked["rewards"][0]
    assert per_step["steps"][0] == chunked["steps"][0] == SIM["num_steps"]
    n_policy_steps = SIM["num_steps"] + 1
    assert n_policy_steps <= per_step["ais_iterations"][0] <= SIM["ais_its"] * n_policy_steps


def test_action_csv_replays_to_the_trial_reward_in_jax(trial, jax_step_reward):
    """The CSV holds num_steps + 1 rows; stepping the JAX package's env
    through them gives the trial reward (rtol 1e-9)."""
    per_step, _, acts = trial
    assert acts.shape == (SIM["num_steps"] + 1, 8)
    assert np.all(np.abs(acts) <= 1.0)
    x = np.tile(np.asarray(JAntDeviceEnv(dtype=jnp.float64).reset().x), (4, 1))
    total = 0.0
    for a in acts:
        x, r = jax_step_reward(x, np.tile(a, (4, 1)))
        total += float(r[0])
    np.testing.assert_allclose(per_step["rewards"][0], total, rtol=1e-9)


def test_cli_mujoco_on_device_ant_prints_banner_and_table(capsys):
    """The README's CPU command, one control step per host read-back (the
    chunked loop is the trial fixture's)."""
    rc = main(["mujoco", "--on-device", "--env-name", "Ant-v4", "--device", "cpu", "--samples",
               "4", "--horizon", "2", "--ais-its", "1", "--steps", "2", "--seed", "1",
               "--steps-per-call", "1"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Ant-v4 (on-device)" in out
    row = next(line for line in out.splitlines() if line.startswith("Trial    1:"))
    assert int(row.split(":")[2]) == 2
    for r in ("AVE", "STD", "MED", "L95", "U95", "MIN", "MAX"):
        assert f"Trials {r}:" in out
