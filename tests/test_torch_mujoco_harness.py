"""The on-device MuJoCo path of the port on the CPU: the CEMPPI step on
HalfCheetah against the JAX package's with the same injected normals `z`
(rtol 1e-9, float64), `simulate_mujoco_on_device` (chunked and per-step
loops, the action CSV replayed through the JAX package's
`CheetahDeviceEnv.step_reward`, the errors it raises) and the `mujoco
--on-device` CLI."""

import glob

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpopis_tpu.harness.cli import build_parser as jbuild_parser
from mpopis_tpu.models import CheetahDeviceEnv as JCheetahDeviceEnv
from mpopis_tpu.policies import PolicyConfig as JPolicyConfig
from mpopis_tpu.policies import make_policy as jmake_policy

from mpopis_tpu_torch.harness import simulate
from mpopis_tpu_torch.harness.cli import build_parser, main
from mpopis_tpu_torch.models import CheetahDeviceEnv
from mpopis_tpu_torch.policies import PolicyConfig, make_policy

K, H, ITS = 16, 4, 2
COV = 0.25 * np.eye(6)
SIM = dict(num_trials=1, num_steps=4, num_samples=8, horizon=3, ais_its=2, lam=0.1,
           ce_sigma_est="mle", seed=2, device="cpu", dtype=torch.float64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions are thousands of tiny ops: one thread each keeps
    test processes that run side by side from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rtol=1e-9):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=1e-300)


def test_cemppi_step_on_cheetah_matches_jax():
    """Two chained control steps, each with 2 AIS iterations whose K rollouts
    go through the plain rollout (the JAX package's vmap rollout on its
    side), the env step between them."""
    kw = dict(kind="cemppi", num_samples=K, horizon=H, lam=0.1, opt_its=ITS, sigma_est="mle")
    jenv = JCheetahDeviceEnv(dtype=jnp.float64)
    env = CheetahDeviceEnv(dtype=torch.float64, device="cpu")
    jpol = jmake_policy(jenv, JPolicyConfig(**kw), cov_mat=COV)
    pol = make_policy(env, PolicyConfig(**kw), cov_mat=COV)
    rng = np.random.default_rng(13)
    js, jps = jenv.reset(), jpol.init_state(0)
    s, ps = env.reset(), pol.init_state(0)
    jstep = jax.jit(jenv.step)
    for _ in range(2):
        z = rng.standard_normal((ITS, 6 * H, K))
        ja, jps, jinfo = jpol.step(js, jps, z=jnp.asarray(z))
        a, ps, info = pol.step(s, ps, z=torch.as_tensor(z))
        assert info["ais_its"] in (1, ITS)
        _close(a, ja)
        _close(ps.U, jps.U)
        _close(info["costs"], jinfo["costs"])
        _close(info["weights"], jinfo["weights"])
        js = jstep(js, ja)
        s = env.step(s, a)
    _close(s.x, js.x, rtol=1e-10)


@pytest.fixture(scope="module")
def trial(tmp_path_factory):
    """One f64 HalfCheetah trial on the CPU, per-step and chunked, with the
    executed actions written as CSV."""
    out = tmp_path_factory.mktemp("acts")
    per_step = simulate.simulate_mujoco_on_device(
        "HalfCheetah-v4", steps_per_call=1, output_acts_file=True, acts_dir=str(out),
        print_output=False, **SIM)
    (csv,) = glob.glob(str(out / "*.csv"))
    chunked = simulate.simulate_mujoco_on_device(
        "HalfCheetah-v4", steps_per_call=3, print_output=False, **SIM)
    return per_step, chunked, np.loadtxt(csv, delimiter=",", ndmin=2)


def test_chunked_and_per_step_loops_agree(trial):
    per_step, chunked, _ = trial
    assert per_step["rewards"][0] == chunked["rewards"][0]
    assert per_step["steps"][0] == chunked["steps"][0] == SIM["num_steps"]
    for m in (per_step, chunked):
        assert set(m) >= {"rewards", "steps", "rewards_per_step", "exec_times",
                          "control_steps_per_s", "ais_iterations"}
    # one rollout call per AIS iteration over num_steps + 1 policy steps; the
    # chunk of 3 runs 6 steps for 5 kept, so it counts at least as many
    n_policy_steps = SIM["num_steps"] + 1
    assert n_policy_steps <= per_step["ais_iterations"][0] <= SIM["ais_its"] * n_policy_steps
    assert chunked["ais_iterations"][0] >= per_step["ais_iterations"][0]


def test_action_csv_replays_to_the_trial_reward_in_jax(trial):
    """The CSV holds num_steps + 1 rows (the loop bound `cnt <= num_steps`);
    stepping the JAX package's env through them gives the trial reward."""
    per_step, _, acts = trial
    assert acts.shape == (SIM["num_steps"] + 1, 6)
    assert np.all(np.abs(acts) <= 1.0)
    jenv = JCheetahDeviceEnv(dtype=jnp.float64)
    step_reward = jax.jit(jenv.step_reward)
    s, total = jenv.reset(), 0.0
    for a in acts:
        s, r = step_reward(s, jnp.asarray(a))
        total += float(r)
    np.testing.assert_allclose(per_step["rewards"][0], total, rtol=1e-9)


@pytest.mark.parametrize("task,kw,exc,match", [
    ("Cheetah-v9", {}, ValueError, "no on-device dynamics"),
    ("Reacher-v4", {"solver_iters": (3, 6)}, ValueError, "no contact solver"),
    ("Swimmer-v4", {"solver_iters": (3, 6)}, ValueError, "no contact solver"),
])
def test_simulate_mujoco_on_device_rejects(task, kw, exc, match):
    with pytest.raises(exc, match=match):
        simulate.simulate_mujoco_on_device(task, device="cpu", print_output=False, **kw)


def test_solver_iters_reach_the_env(monkeypatch):
    seen = {}

    def fake(env, sim_type, **kwargs):
        seen.update(env=env, sim_type=sim_type, kwargs=kwargs)
        return {}

    monkeypatch.setattr(simulate, "_simulate_simple", fake)
    simulate.simulate_mujoco_on_device("Hopper-v4", solver_iters=(6, 40), device="cpu")
    env = seen["env"]
    assert (env.solver_outer, env.solver_cg) == (6, 40)
    assert seen["sim_type"] == "Hopper-v4 (on-device)"
    assert seen["kwargs"]["u0"] == (0.0,) * 3 and seen["kwargs"]["cov_mat"] == (0.25,) * 3


def test_cli_mujoco_on_device_prints_banner_and_table(capsys):
    rc = main([
        "mujoco", "--on-device", "--env-name", "Walker2d-v4", "--device", "cpu", "--samples",
        "4", "--horizon", "2", "--ais-its", "1", "--steps", "2", "--seed", "3",
        "--solver-iters", "2,3", "--steps-per-call", "2",
    ])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Walker2d-v4 (on-device)" in out
    row = next(line for line in out.splitlines() if line.startswith("Trial    1:"))
    assert int(row.split(":")[2]) == 2
    for r in ("AVE", "STD", "MED", "L95", "U95", "MIN", "MAX"):
        assert f"Trials {r}:" in out


def test_cli_on_device_help_names_every_ported_task(capsys, monkeypatch):
    """The `--on-device` help lists PORTED_MUJOCO_TASKS: all 11 on-device tasks."""
    monkeypatch.setenv("COLUMNS", "1000")  # no line breaks inside a task name
    with pytest.raises(SystemExit) as exit_info:
        main(["mujoco", "--help"])
    assert exit_info.value.code == 0
    line = next(ln for ln in capsys.readouterr().out.splitlines()
                if ln.strip().startswith("--on-device"))
    assert len(simulate.PORTED_MUJOCO_TASKS) == 11
    assert set(simulate.PORTED_MUJOCO_TASKS) == set(simulate.ON_DEVICE_MUJOCO_TASKS)
    for task in simulate.PORTED_MUJOCO_TASKS:
        assert task in line
    assert "Humanoid-v4" in line and "HumanoidStandup-v4" in line and "Reacher-v4" in line


def test_cli_mujoco_parser_defaults_match_jax():
    ours = vars(build_parser().parse_args(["mujoco"]))
    theirs = vars(jbuild_parser().parse_args(["mujoco"]))
    assert ours.pop("device") == "cuda"
    # `mujoco --on-device` takes the gif and plot flags that the JAX package's
    # simulate_mujoco_on_device takes as arguments; both are off by default
    assert ours.pop("save_gif") is False and ours.pop("plot_traj") is False
    assert ours == theirs
