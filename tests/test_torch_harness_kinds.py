"""The harness runs every policy kind on the CPU: `python -m mpopis_tpu_torch
car --policy <kind>` for CMA, PMC and plain MPPI prints the kind's banner
rows (the JAX banner's, character for character), one trial row and the
summary table; `simulate_car_racing` counts one rollout per AIS iteration;
and `mujoco --on-device --policy cmamppi` runs on HalfCheetah."""

import numpy as np
import pytest
import torch

from mpopis_tpu.harness import simulate as jsimulate

from mpopis_tpu_torch.harness import simulate
from mpopis_tpu_torch.harness.cli import main

_BANNER_ROWS = {
    "cmamppi": ("# AIS Iterations:", "CMA Step Factor (σ):", "CMA Elite Perc Thres:"),
    "pmcmppi": ("# AIS Iterations:", "λ_ais (ais inverse temp):"),
    "mppi": (),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many tiny ops: one thread keeps test processes that run side by side
    from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("kind", sorted(_BANNER_ROWS))
def test_cli_car_runs_every_kind_on_cpu(kind, capsys):
    rc = main(["car", "--device", "cpu", "--policy", kind, "--samples", "16", "--horizon", "5",
               "--ais-its", "2", "--steps", "4", "--seed", "3"])
    assert rc == 0
    out = capsys.readouterr().out
    args = (True, "cr", kind, 1, 4, 16, 5, 10.0, 1.0, 2, 20.0, 0.8, "ss", 0.75, 0.8, 3)
    jsimulate._banner(*args, extra=[("Num Cars:", 1), ("Max Num Laps:", 2)])
    banner = capsys.readouterr().out
    assert out.startswith(banner)
    for label in _BANNER_ROWS[kind]:
        assert label in banner
    assert ("# AIS Iterations:" in banner) == (kind != "mppi")
    rows = [line for line in out.splitlines() if line.startswith("Trial    1:")]
    assert len(rows) == 1 and int(rows[0].split(":")[2]) == 4
    for r in ("AVE", "STD", "MED", "L95", "U95", "MIN", "MAX"):
        assert f"Trials {r}:" in out


@pytest.mark.parametrize("kind,per_step", [
    ("mppi", (1, 1)), ("gmppi", (1, 1)), ("imppi", (2, 2)), ("muaismppi", (2, 2)),
    ("musigmaaismppi", (2, 2)), ("pmcmppi", (2, 2)), ("cemppi", (1, 2)), ("cmamppi", (1, 2)),
    ("nesmppi", (1, 2)),
])
def test_simulate_car_racing_counts_rollouts_of_every_kind(kind, per_step):
    m = simulate.simulate_car_racing(
        policy_type=kind, num_trials=1, num_steps=2, num_samples=8, horizon=4, ais_its=2,
        seed=1, print_output=False, device="cpu", dtype=torch.float64, steps_per_call=1,
    )
    assert np.isfinite(m["rewards"][0]) and m["steps"][0] == 2
    # 3 policy steps one at a time (the JAX loop bound), 1-2 rollouts each
    lo, hi = per_step
    assert 3 * lo <= m["ais_iterations"][0] <= 3 * hi


def test_cli_mujoco_on_device_cmamppi_on_cheetah(capsys):
    rc = main(["mujoco", "--on-device", "--env-name", "HalfCheetah-v4", "--device", "cpu",
               "--policy", "cmamppi", "--samples", "8", "--horizon", "3", "--ais-its", "2",
               "--steps", "3", "--seed", "1", "--lam", "0.1"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Policy Type:                  cmamppi" in out
    assert "CMA Step Factor (σ):" in out
    row = next(line for line in out.splitlines() if line.startswith("Trial    1:"))
    assert int(row.split(":")[2]) == 3 and np.isfinite(float(row.split(":")[1]))
