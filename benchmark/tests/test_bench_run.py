"""A whole run of the harness on the CPU at a tiny size, past the look for a
card: sound, it comes out correct; with the timed path broken underneath,
not; and the control (the reference in TF32 in the program's place) fails
the committed limits."""

import json
import sys

import pytest
import torch

from benchmark import check, control, run, spec

CELL = "halfcheetah.cemppi.k2048-h15"


def _tiny(name=CELL):
    cell = spec.resolve(spec.load_spec(), name)
    # K = 128 keeps the CE refit's 26 elites above the 18 dimensions of the
    # plan, as the cell's 410 are above its 90
    # trials of 40 steps, long enough for the cheetah to run, so that a cost
    # or a state left wrong is as far off as in the cell; every env step of
    # them checked, so that a fault in one step of four lands on checked ones
    # as it does among the cell's 128
    cell.traffic.update(num_samples=128, horizon=3, ais_its=2, trial_steps=40, warmup_steps=1)
    cell.check.update(policy_steps=3, env_steps=40, columns=8, within_steps=40)
    return cell


def _run(capsys, seed=2147483777):
    rc = run.main(["--workload", CELL, "--seed", str(seed), "--seconds", "1.5", "--trace", "0"],
                  device="cpu", cell=_tiny())
    assert rc == 0
    out = capsys.readouterr()
    result = json.loads(out.out.strip().splitlines()[-1])
    assert list(result)[-1] == "checks"
    assert out.err.strip().splitlines()[-1].startswith("check ")
    return result


def test_a_sound_run_is_correct(capsys):
    result = _run(capsys)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {"control_steps_per_s", "control_step_ms_p95", "setup_s"}


def _env_step_unchanged(monkeypatch):
    from mpopis_tpu_torch.models.planar_contact import PlanarContactEnv

    monkeypatch.setattr(PlanarContactEnv, "step", lambda self, state, action: state)


def _plan_not_rolled(monkeypatch):
    from mpopis_tpu_torch.policies import driver

    monkeypatch.setattr(driver, "roll_controls", lambda wc, u0, a, quirk=True: wc)


def _half_the_batch(monkeypatch):
    from mpopis_tpu_torch.policies import driver

    orig = driver.information_theoretic_weights

    def half(costs, lam):
        k = costs.shape[0] // 2
        return torch.cat([orig(costs[:k], lam), torch.zeros_like(costs[k:])])

    monkeypatch.setattr(driver, "information_theoretic_weights", half)


def _costs_altered(monkeypatch):
    from mpopis_tpu_torch.kernels import planar_step

    orig = planar_step.planar_rollout_costs_tak_reference
    monkeypatch.setattr(planar_step, "planar_rollout_costs_tak_reference",
                        lambda env, x, c: orig(env, x, c) * 1.01)


def _second_half_of_k_zero(monkeypatch):
    from mpopis_tpu_torch.kernels import planar_step

    orig = planar_step.planar_rollout_costs_tak_reference

    def half(env, x, c):
        costs = orig(env, x, c)
        k = costs.shape[0] // 2
        return torch.cat([costs[:k], torch.zeros_like(costs[k:])])

    monkeypatch.setattr(planar_step, "planar_rollout_costs_tak_reference", half)


def _env_step_wrong_one_in_four(monkeypatch):
    from mpopis_tpu_torch.models.planar_contact import PlanarContactEnv

    orig = PlanarContactEnv.step
    calls = []

    def step(self, state, action):
        calls.append(None)
        return state if len(calls) % 4 == 0 else orig(self, state, action)

    monkeypatch.setattr(PlanarContactEnv, "step", step)


def _action_altered(monkeypatch):
    from mpopis_tpu_torch.policies import driver

    orig = driver.clamp_controls
    monkeypatch.setattr(driver, "clamp_controls", lambda v, lo, hi: orig(v * 0.999, lo, hi))


@pytest.mark.parametrize("fault", [_env_step_unchanged, _plan_not_rolled, _half_the_batch,
                                   _costs_altered, _second_half_of_k_zero,
                                   _env_step_wrong_one_in_four, _action_altered])
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch, capsys):
    fault(monkeypatch)
    result = _run(capsys)
    assert not result["correct"], result["checks"]


def test_the_control_fails_the_committed_limits():
    rows = control.readings(_tiny(), [2147483790, 2147483791, 2147483792], "cpu", tf32=True,
                            out=lambda line: None)
    limits = spec.resolve(spec.load_spec(), CELL).check["limits"]
    for row in [r for r in rows if r["side"] in ("program", "control")]:
        ok = check.judge(row, limits)[0]
        assert ok == (row["side"] == "program"), row


def test_a_forbidden_module_loaded_after_the_window_stops_the_result(tmp_path, monkeypatch,
                                                                      capsys):
    """A metric's reader that loads a stand-in for JAX once the window has
    closed: the run prints no result."""
    import shutil

    shutil.copytree(spec.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (tmp_path / "standin_jax.py").write_text("")
    (tmp_path / "benchmark" / "metrics" / "control_steps_per_s.py").write_text(
        "import standin_jax  # noqa: F401\n\n\ndef read(run):\n    return 1.0\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.setattr(run, "FORBIDDEN", run.FORBIDDEN | {"standin_jax"})
    cell = _tiny()
    cell.bench_dir = tmp_path / "benchmark"
    try:
        with pytest.raises(SystemExit) as exc:
            run.main(["--workload", CELL, "--seed", "2147483801", "--seconds", "0.5",
                      "--trace", "0"], device="cpu", cell=cell)
    finally:
        sys.modules.pop("standin_jax", None)
    assert exc.value.code != 0
    out = capsys.readouterr()
    assert "{" not in out.out
    assert "standin_jax" in out.err
