"""The port's CLI and car-racing harness on the CPU: `python -m
mpopis_tpu_torch car` prints the banner, the trial row and the summary
table, and the summary table is the JAX harness's, character for character."""

import numpy as np
import pytest
import torch

from mpopis_tpu.harness import simulate as jsimulate

from mpopis_tpu_torch.harness import simulate
from mpopis_tpu_torch.harness.cli import build_parser, main


def test_cli_car_runs_on_cpu(capsys):
    rc = main([
        "car", "--device", "cpu", "--samples", "16", "--horizon", "5",
        "--ais-its", "2", "--steps", "5",
    ])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Sim Type:                     cr" in out
    assert "CE Σ Est Method:              ss" in out
    header = next(line for line in out.splitlines() if line.startswith("Trial    #:"))
    assert "lap 1" in header and "lap 2" in header and "Ex Time" in header
    row = next(line for line in out.splitlines() if line.startswith("Trial    1:"))
    assert int(row.split(":")[2]) == 5  # control steps counted as the JAX harness does
    for r in ("AVE", "STD", "MED", "L95", "U95", "MIN", "MAX"):
        assert f"Trials {r}:" in out


def test_summary_table_matches_jax(capsys):
    rng = np.random.default_rng(5)
    order = ["rewards", "steps", "lap1_times", "track_violations", "exec_times"]
    metrics = {name: rng.normal(100.0, 30.0, size=6) for name in order}
    simulate._summary_table(True, metrics, order)
    got = capsys.readouterr().out
    jsimulate._summary_table(True, metrics, order)
    want = capsys.readouterr().out
    assert got == want and got.count("\n") == 7


def test_banner_matches_jax(capsys):
    args = (True, "cr", "cemppi", 2, 100, 8192, 50, 10.0, 1.0, 10, 20.0, 0.8,
            "ss", 0.75, 0.8, 7)
    extra = [("Num Cars:", 1), ("Max Num Laps:", 2)]
    simulate._banner(*args, extra=extra)
    got = capsys.readouterr().out
    jsimulate._banner(*args, extra=extra)
    assert got == capsys.readouterr().out


def test_simulate_seeds_trials_and_counts_rollouts():
    kw = dict(num_trials=2, num_steps=3, num_samples=8, horizon=4, ais_its=2,
              seed=3, print_output=False, device="cpu", dtype=torch.float64)
    m1 = simulate.simulate_car_racing(**kw)
    m2 = simulate.simulate_car_racing(**kw)
    np.testing.assert_array_equal(m1["rewards"], m2["rewards"])
    assert m1["rewards"][0] != m1["rewards"][1]  # trial k is seeded seed + k
    assert list(m1["steps"]) == [3, 3]
    # one rollout call per AIS iteration; the default chunk of 10 control
    # steps runs 10 policy steps per trial for the 3 + 1 kept
    assert all(10 <= n <= 20 for n in m1["ais_iterations"])


def test_cli_parser_defaults_match_jax():
    from mpopis_tpu.harness.cli import build_parser as jbuild_parser

    ours = vars(build_parser().parse_args(["car"]))
    theirs = vars(jbuild_parser().parse_args(["car"]))
    assert ours.pop("device") == "cuda"
    assert ours == theirs


@pytest.mark.parametrize("argv", [["car", "--sharded"]])
def test_unported_paths_exit(argv):
    with pytest.raises(SystemExit, match="not yet ported"):
        main(argv)
