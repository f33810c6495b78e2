"""The port's checkpoints and phase timers on the CPU: a run resumed from a
checkpoint continues bit for bit (the generator's state travels with it),
the .npz keeps the JAX package's keys, and PhaseTimer, timed and trace
work."""

import json
import os

import numpy as np
import pytest
import torch

from mpopis_tpu.utils import save_checkpoint as jsave_checkpoint
from mpopis_tpu.utils.profiling import PhaseTimer as JPhaseTimer

from mpopis_tpu_torch.models import CarRacingEnv, MountainCarEnv
from mpopis_tpu_torch.policies import PolicyConfig, make_policy
from mpopis_tpu_torch.utils import PhaseTimer, load_checkpoint, save_checkpoint, timed, trace


def _steps(pol, env, s, ps, n):
    acts = []
    for _ in range(n):
        a, ps, _ = pol.step(s, ps)
        s = env.step(s, a)
        acts.append(a.numpy())
    return np.stack(acts), s, ps


@pytest.mark.parametrize("task", ["car", "mountaincar"])
def test_checkpoint_resume_bitexact(task, tmp_path):
    """3 steps, a checkpoint, 3 more: the resumed run equals the uninterrupted
    one bit for bit. The car's `done` is a Python bool, MountainCar's a bool
    tensor; each comes back as it went."""
    if task == "car":
        env = CarRacingEnv(dtype=torch.float64, device="cpu")
        cfg = PolicyConfig(kind="cemppi", num_samples=32, horizon=8, lam=10.0, opt_its=2,
                           sigma_est="ss")
        pol = make_policy(env, cfg, cov_mat=np.diag([0.0625, 0.1]))
        s = env.reset()
    else:
        env = MountainCarEnv(dtype=torch.float64, device="cpu")
        cfg = PolicyConfig(kind="cemppi", num_samples=32, horizon=8, lam=0.1, opt_its=2)
        pol = make_policy(env, cfg, cov_mat=[1.5])
        s = env.reset(torch.Generator().manual_seed(4))
    _, s, ps = _steps(pol, env, s, pol.init_state(3), 3)
    path = save_checkpoint(str(tmp_path / "ck"), ps, s, step=3, laps=np.arange(2))
    assert path.endswith(".npz")
    direct, s_d, _ = _steps(pol, env, s, ps, 3)

    ps_r, s_r, step, extras = load_checkpoint(path, dtype=torch.float64, device="cpu")
    assert step == 3 and list(extras) == ["laps"]
    np.testing.assert_array_equal(extras["laps"], np.arange(2))
    assert type(s_r.done) is type(s.done) and s_r.t == s.t
    if task == "mountaincar":
        assert s_r.done.dtype == torch.bool and s_r.done.shape == s.done.shape
    resumed, s_e, _ = _steps(pol, env, s_r, ps_r, 3)
    np.testing.assert_array_equal(resumed, direct)
    np.testing.assert_array_equal(s_e.x.numpy(), s_d.x.numpy())


def test_checkpoint_keeps_the_jax_keys(tmp_path):
    """The JAX package's keys, with the generator's state and device in
    place of the JAX key."""
    import jax.numpy as jnp

    from mpopis_tpu.models.base import EnvState as JEnvState
    from mpopis_tpu.policies.config import init_policy_state as jinit

    from mpopis_tpu_torch.models.base import EnvState
    from mpopis_tpu_torch.policies.config import init_policy_state

    ours = np.load(save_checkpoint(
        str(tmp_path / "ours"), init_policy_state(torch.zeros(4, dtype=torch.float64), 1),
        EnvState(x=torch.ones(3, dtype=torch.float64), t=2), step=5, note=1.0))
    theirs = np.load(jsave_checkpoint(
        str(tmp_path / "theirs"), jinit(jnp.zeros(4), 1),
        JEnvState(x=jnp.ones(3), t=jnp.asarray(2), done=jnp.asarray(False)), step=5, note=1.0))
    assert set(theirs.files) - {"key"} <= set(ours.files)
    assert set(ours.files) - set(theirs.files) == {
        "generator_state", "generator_device", "env_done_is_tensor"}
    for k in ("U", "step", "env_x", "env_t", "env_done", "extra_note"):
        np.testing.assert_array_equal(ours[k], theirs[k])
    assert str(ours["generator_device"]) == "cpu"


def test_checkpoint_refuses_another_device_type(tmp_path):
    from mpopis_tpu_torch.policies.config import init_policy_state

    path = save_checkpoint(str(tmp_path / "ck"),
                           init_policy_state(torch.zeros(2, dtype=torch.float64), 1))
    with pytest.raises(ValueError, match="device='cpu'"):
        load_checkpoint(path, device="cuda")
    ps, env_state, step, extras = load_checkpoint(path, device="cpu")
    assert env_state is None and step == 0 and extras == {}
    assert ps.U.dtype == torch.float64  # dtype=None keeps the saved one


def test_phase_timer_matches_the_jax_report_format():
    timer = PhaseTimer()
    for name in ("rollout", "update", "rollout"):
        with timer.phase(name):
            torch.ones(100).sum()
    assert timer.counts == {"rollout": 2, "update": 1}
    lines = timer.report().splitlines()
    assert len(lines) == 2
    jt = JPhaseTimer()
    jt.totals, jt.counts = timer.totals, timer.counts
    assert jt.report() == timer.report()
    with pytest.raises(RuntimeError):
        with timer.phase("raises"):
            raise RuntimeError("inside")
    assert timer.counts["raises"] == 1  # a phase that raises still counts


def test_timed_returns_seconds_a_call():
    calls = []

    def fn(a, b):
        calls.append(1)
        return {"out": (a @ b, [a])}

    a = torch.ones(8, 8)
    sec = timed(fn, a, a, iters=5, warmup=2)
    assert len(calls) == 7 and 0.0 < sec < 1.0


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = str(tmp_path / "trace")
    with trace(log_dir) as d:
        assert d == log_dir
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


def test_chip_smoke_resume_run_on_the_cpu():
    """chip_smoke's checkpoint path (phase 46) at a small size on the CPU: the
    resumed actions equal the uninterrupted run's."""
    import chip_smoke

    cfg = dict(kind="cemppi", num_samples=16, horizon=5, lam=10.0, opt_its=2, sigma_est="ss")
    direct, resumed, counts, report, step_ms = chip_smoke.resume_run(
        "cpu", cfg, 2, dtype=torch.float64)
    assert direct.shape == (4, 2)
    np.testing.assert_array_equal(resumed, direct)
    assert not any(counts.values())  # the CPU runs the plain versions
    assert "policy step" in report and "env step" in report and step_ms > 0.0


@pytest.mark.parametrize("kind", ["cemppi", "mppi"])
def test_chip_smoke_host_policy_run_on_the_cpu(kind):
    """chip_smoke's host-driver check over its numpy stand-in: the same
    normals give the same actions run after run, and the controller moves
    the point masses toward their target."""
    import chip_smoke

    a = chip_smoke.host_policy_run("cpu", kind, 16, 5, 2, 4)
    b = chip_smoke.host_policy_run("cpu", kind, 16, 5, 2, 4)
    assert a.shape == (4, 6)
    np.testing.assert_array_equal(a, b)
    target = chip_smoke.HostStub(1).target
    x = 0.1 * np.sum(a, axis=0)  # the masses after the 4 executed actions, from 0
    assert np.sum((x - target) ** 2) < np.sum(target ** 2)  # nearer than at the start
