"""The port's car harness against the JAX package's on the CPU in float64,
with the same fixed-action stub policy patched into both packages'
`get_policy` (the policies themselves draw from different generators):

- one car with additive state noise (numpy `default_rng(seed + k)`, x, y,
  ψ and the velocity rotated by dψ): the noise moves the stopped car back
  and forth over the start line, so laps and sideslip violations count;
- two cars steered off the track: track and collision violations.

Every metric but the times equals the JAX harness's. The port's chunked
loop (`steps_per_call` 4) equals its per-step loop with a real policy,
state noise forces one step a call, and the multi-car race runs from the
CLI with its collision column.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpopis_tpu.harness import simulate as jsimulate

from mpopis_tpu_torch.harness import simulate
from mpopis_tpu_torch.harness.cli import main

KEYS = ("rewards", "steps", "lap_times", "mean_vs", "max_vs", "mean_betas", "max_betas",
        "beta_violations", "track_violations", "crash_violations")


class _Stub:
    """A policy that plays `acts[i]` at its i-th step (the last one after)."""

    def __init__(self, env, acts, jax_side):
        self.env, self.jax_side = env, jax_side
        self.acts = jnp.asarray(acts) if jax_side else env.tensor(acts)

    def init_state(self, seed):
        return jnp.asarray(0) if self.jax_side else 0

    def step(self, s, ps):
        n = self.acts.shape[0]
        i = jnp.minimum(ps, n - 1) if self.jax_side else min(ps, n - 1)
        return self.acts[i], ps + 1, {"ais_its": 1}


def _run_both(monkeypatch, acts, num_cars, **kw):
    monkeypatch.setattr(jsimulate, "get_policy",
                        lambda pt, env, *a, **k: _Stub(env, acts, jax_side=True))
    monkeypatch.setattr(simulate, "get_policy",
                        lambda pt, env, *a, **k: _Stub(env, acts, jax_side=False))
    common = dict(num_cars=num_cars, print_output=False, **kw)
    want = jsimulate.simulate_car_racing(dtype=jnp.float64, steps_per_call=1, **common)
    got = simulate.simulate_car_racing(dtype=torch.float64, device="cpu", **common)
    return got, want


def test_state_noise_laps_and_violations_match_jax(monkeypatch):
    acts = [[0.3, 0.5]] * 3 + [[0.0, -1.0]] * 200  # brake to a stop near the line
    got, want = _run_both(monkeypatch, acts, 1, num_trials=2, num_steps=100, seed=3,
                          state_x_sigma=0.1, state_y_sigma=2.0, state_psi_sigma=0.1)
    for key in KEYS:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-9, err_msg=key)
    assert np.all(got["lap_times"][1] > 0)  # both trials end on their second lap
    assert np.all(got["beta_violations"] > 0)


def test_two_cars_track_and_collision_violations_match_jax(monkeypatch):
    acts = [[1.0, 0.2, 0.8, 0.2]] * 60
    got, want = _run_both(monkeypatch, acts, 2, num_trials=1, num_steps=40, seed=4)
    for key in KEYS:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-9, err_msg=key)
    assert got["track_violations"][0] > 10 and got["crash_violations"][0] > 0


def test_chunked_loop_matches_per_step():
    """Chunks of 4 against one step a call, K = 16 CEMPPI: the stop falls
    inside a chunk (13 steps), whose overshoot is discarded."""
    kw = dict(num_trials=2, num_steps=13, policy_type="cemppi", num_samples=16, horizon=8,
              ais_its=2, seed=2, laps=2, dtype=torch.float64, device="cpu", print_output=False)
    m1 = simulate.simulate_car_racing(steps_per_call=1, **kw)
    m4 = simulate.simulate_car_racing(steps_per_call=4, **kw)
    for key in KEYS:
        np.testing.assert_allclose(m4[key], m1[key], rtol=1e-12, err_msg=key)
    assert list(m1["steps"]) == [13, 13]
    # 14 policy steps a trial one at a time, 16 in chunks of 4
    assert np.all(m4["ais_iterations"] > m1["ais_iterations"])


def test_noise_forces_one_step_a_call():
    with pytest.warns(UserWarning, match="steps_per_call=10 ignored"):
        m = simulate.simulate_car_racing(num_steps=3, num_samples=8, horizon=4, ais_its=1,
                                         seed=1, state_x_sigma=0.1, steps_per_call=10,
                                         device="cpu", print_output=False)
    assert m["steps"][0] == 3 and m["ais_iterations"][0] == 4


def test_cli_multi_car_race_prints_the_collision_column(capsys):
    rc = main(["car", "--device", "cpu", "--cars", "3", "--policy", "cmamppi", "--samples",
               "16", "--horizon", "4", "--ais-its", "2", "--steps", "3", "--seed", "3"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Sim Type:                     mcr" in out and "Num Cars:                     3" in out
    header = next(line for line in out.splitlines() if line.startswith("Trial    #:"))
    assert header.index("T Viol") < header.index("C Viol") < header.index("Ex Time")
    row = next(line for line in out.splitlines() if line.startswith("Trial    1:"))
    assert int(row.split(":")[2]) == 3 and len(row.split(":")) == len(header.split(":"))
