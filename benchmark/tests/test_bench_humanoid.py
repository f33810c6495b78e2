"""The configuration `humanoid-v4` and the cells of its PR: the frozen plain
reference of the Humanoid against the port's own plain path, float64 on the
CPU at tiny sizes (the env step and reward, from reset-plus-noise starts and
from the crouch where floor and self-collision rows are active together; the
rollout costs; the CEMPPI step); the `ss` CE step of the upstream K=100
HalfCheetah recipe; and both new cells found from their files."""

import copy
import json

import pytest
import torch

from benchmark import loop, run, spec

HUMANOID = "humanoid.cemppi.k1024-h8"
CHEETAH_K100 = "halfcheetah.cemppi.k100-h50"
LIMITS = {"action_gap", "plan_gap", "cost_gap_geomean", "state_gap_geomean"}
# the K=100 cheetah's costs also by their lowest tenth: its 250-substep
# rollouts leave the geometric mean of f32's gaps too near the control's
CELL_LIMITS = {HUMANOID: LIMITS, CHEETAH_K100: LIMITS | {"cost_gap_q10"}}


def _f64(name):
    cell = spec.resolve(spec.load_spec(), name)
    cfg = copy.deepcopy(cell.config)
    cfg["dtype"] = "float64"
    module = cell.reference_module()
    return cell, cfg, module, loop.build_env(cfg, module, "cpu")


@pytest.fixture(scope="module")
def humanoid():
    return _f64(HUMANOID)


def _noisy(env, gen):
    """A reset state moved a little."""
    x = env.reset().x.clone()
    return x + 0.02 * torch.randn(x.shape, generator=gen, dtype=x.dtype)


def _crouched(gen):
    """The crouch, its lowest floor candidate inside the floor and 4 self
    pairs touching, with random joint velocities."""
    from mpopis_tpu_torch.models import humanoid_device

    q = humanoid_device.crouched_qpos()
    qv = 0.3 * torch.randn(23, generator=gen, dtype=torch.float64)
    return torch.cat([q, qv, humanoid_device.com_x(q)[None]])


def test_the_reset_equals_the_ports(humanoid):
    cell, cfg, module, env = humanoid
    assert torch.equal(module.task(cfg).reset_x(torch.float64, "cpu"), env.reset().x)


@pytest.mark.parametrize("start", ["reset_noise", "crouch"])
def test_humanoid_step_and_reward_equal_the_ports_plain_step(humanoid, start):
    from mpopis_tpu_torch.models.base import make_state

    cell, cfg, module, env = humanoid
    task = module.task(cfg)
    gen = torch.Generator().manual_seed(11)
    make = (lambda: _noisy(env, gen)) if start == "reset_noise" else (lambda: _crouched(gen))
    x = torch.stack([make() for _ in range(2)])
    # past the ctrlrange of ±0.4, so that the clip of the torque and of the
    # control cost both act
    a = (torch.rand((2, env.action_dim), generator=gen, dtype=torch.float64) * 2 - 1) * 0.44
    port, port_r = env.plain_step_reward(make_state(x), a)
    ref = task.step(x, a)
    assert torch.equal(ref, port.x)
    assert torch.equal(task.reward(x, ref, a), port_r)


def test_humanoid_rollout_costs_equal_the_ports_plain_rollout(humanoid):
    cell, cfg, module, env = humanoid
    task = module.task(cfg)
    gen = torch.Generator().manual_seed(12)
    x0 = _crouched(gen)
    k, h = 5, 2
    ctrl = (torch.rand((h, env.action_dim, k), generator=gen, dtype=torch.float64) * 2 - 1) * 0.44
    port = env.fused_rollout_costs_tak(env.reset().replace(x=x0), ctrl)
    ref = task.rollout_costs(x0.expand(k, -1), ctrl.permute(2, 0, 1))
    torch.testing.assert_close(ref, port, rtol=1e-12, atol=1e-12)


def _ce_step(env, cell, cfg, module, traffic, start):
    """(the port's action, next plan and AIS iterations; the reference's run)
    of one CEMPPI step from `start`, the reference given the port's normals
    and the costs the port's rollouts returned."""
    costs = []
    orig = env.fused_rollout_costs_tak

    def recording(state, ctrl):
        costs.append(orig(state, ctrl))
        return costs[-1]

    object.__setattr__(env, "fused_rollout_costs_tak", recording)
    try:
        pol = loop.build_policy(env, cfg, traffic)
        ce = module.policy_step(cfg, traffic, env.action_dim)
        gen = torch.Generator().manual_seed(5)
        s = env.reset().replace(x=start)
        ps = pol.init_state(7)
        ps = ps.__class__(U=0.1 * torch.randn(ce.cs, generator=gen, dtype=torch.float64),
                          generator=ps.generator)
        z = torch.randn((ce.opt_its, ce.cs, ce.num_samples), generator=gen,
                        dtype=torch.float64)
        act, ps2, info = pol.step(s, ps, z=z)
    finally:
        object.__delattr__(env, "fused_rollout_costs_tak")
    low, high = env.control_bounds
    its = info["ais_its"]
    out = ce.run(ps.U, list(z[:its]), costs, low, high, torch.zeros(ce.cs, dtype=torch.float64),
                 torch.float64)
    assert len(costs) == its
    # the reference's stop flags say where the port stopped
    assert not any(out["stops"][:its - 1])
    assert its == ce.opt_its or out["stops"][its - 1]
    return act, ps2.U, its, out, ce


def test_humanoid_ce_step_equals_the_ports_policy_step(humanoid):
    cell, cfg, module, env = humanoid
    traffic = dict(cell.traffic, num_samples=12, horizon=2, ais_its=2)
    gen = torch.Generator().manual_seed(13)
    act, u_next, its, out, ce = _ce_step(env, cell, cfg, module, traffic, _crouched(gen))
    assert (ce.num_samples, ce.horizon, ce.opt_its, ce.sigma_est) == (12, 2, 2, "mle")
    assert torch.equal(out["action"], act)
    assert torch.equal(out["u_next"], u_next)


def test_k100_ss_ce_step_equals_the_ports_policy_step():
    """The upstream recipe's update: the `ss` shrinkage refit over five AIS
    iterations (K = 40 keeps the refit's 8 elites below the plan's 18
    dimensions, as the cell's 20 are below its 300: the shrinkage target
    carries the rank)."""
    cell, cfg, module, env = _f64(CHEETAH_K100)
    assert (cell.traffic["num_samples"], cell.traffic["horizon"], cell.traffic["ais_its"],
            cell.traffic["sigma_est"]) == (100, 50, 5, "ss")
    traffic = dict(cell.traffic, num_samples=40, horizon=3)
    gen = torch.Generator().manual_seed(14)
    act, u_next, its, out, ce = _ce_step(env, cell, cfg, module, traffic, _noisy(env, gen))
    assert (ce.opt_its, ce.sigma_est, ce.m_elite) == (5, "ss", 8)
    torch.testing.assert_close(out["action"], act, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(out["u_next"], u_next, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", [HUMANOID, CHEETAH_K100])
def test_the_new_cells_resolve_and_carry_their_limits(name):
    bench = spec.load_spec()
    assert spec.problems(bench) == []
    cell = spec.resolve(bench, name)
    assert cell.chips == 1
    assert set(cell.check["limits"]) == CELL_LIMITS[name]
    for number in CELL_LIMITS[name]:
        reading = cell.check["readings"][number]
        # each limit above the program's largest reading and below the
        # control's smallest
        assert reading["program_max"] < cell.check["limits"][number] < reading["control_min"]
    assert [m["name"] for m in cell.end_to_end] == ["control_steps_per_s", "control_step_ms_p95",
                                                     "setup_s"]
    # every per-layer metric without a list of cells applies, and the
    # rollout's roofline share, which lists them
    assert {m["name"] for m in cell.per_layer} == {m["name"] for m in bench["per_layer"]
                                                   if "workloads" not in m
                                                   or name in m["workloads"]}
    assert "rollout_roofline_pct" in {m["name"] for m in cell.per_layer}


def test_the_humanoid_configuration_is_the_ports(humanoid):
    cell, cfg, module, env = humanoid
    assert module.MODEL.n_rows == cfg["qp_rows"] == 242
    assert len(module.MODEL.self_pairs) == 109
    entry = next(c for c in spec.load_spec()["configs"] if c["name"] == "humanoid-v4")
    assert set(entry["reduced"]) == set(cfg["changed_from_source"])


def test_the_k100_cell_runs_correct_at_a_tiny_size(capsys):
    """The upstream recipe's cell through the harness on the CPU, its `ss`
    refit and five iterations kept (K = 128, H = 3)."""
    cell = spec.resolve(spec.load_spec(), CHEETAH_K100)
    cell.traffic.update(num_samples=128, horizon=3, trial_steps=20, warmup_steps=1)
    cell.check.update(policy_steps=2, env_steps=8, columns=8, within_steps=12)
    assert run.main(["--workload", CHEETAH_K100, "--seed", "2147483823", "--seconds", "1",
                     "--trace", "0"], device="cpu", cell=cell) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["failed"] == 0
