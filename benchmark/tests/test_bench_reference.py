"""The benchmark's frozen plain reference against the port's own plain path,
float64 on the CPU at tiny sizes, for both configurations: the env step and
reward, the rollout costs, and the CEMPPI control step."""

import copy

import pytest
import torch

from benchmark import loop, spec

CELLS = ("halfcheetah.cemppi.k2048-h15", "ant.cemppi.k1024-h10")


def _cell(name):
    cell = spec.resolve(spec.load_spec(), name)
    cfg = copy.deepcopy(cell.config)
    cfg["dtype"] = "float64"
    return cell, cfg


def _start(env, gen):
    """A reset state moved a little, so that contacts and limits engage."""
    x = env.reset().x.clone()
    return x + 0.02 * torch.randn(x.shape, generator=gen, dtype=x.dtype)


@pytest.mark.parametrize("name", CELLS)
def test_step_and_reward_equal_the_ports_plain_step(name):
    from mpopis_tpu_torch.models.base import make_state

    cell, cfg = _cell(name)
    module = cell.reference_module()
    env = loop.build_env(cfg, module, "cpu")
    task = module.task(cfg)
    gen = torch.Generator().manual_seed(3)
    x = torch.stack([_start(env, gen) for _ in range(3)])
    a = torch.rand((3, env.action_dim), generator=gen, dtype=torch.float64) * 2.2 - 1.1
    port, port_r = env.plain_step_reward(make_state(x), a)
    ref = task.step(x, a)
    assert torch.equal(ref, port.x)
    assert torch.equal(task.reward(x, ref, a), port_r)


@pytest.mark.parametrize("name", CELLS)
def test_rollout_costs_equal_the_ports_plain_rollout(name):
    cell, cfg = _cell(name)
    module = cell.reference_module()
    env = loop.build_env(cfg, module, "cpu")
    task = module.task(cfg)
    gen = torch.Generator().manual_seed(4)
    x0 = _start(env, gen)
    k, h = 5, 2
    ctrl = torch.rand((h, env.action_dim, k), generator=gen, dtype=torch.float64) * 2 - 1
    port = env.fused_rollout_costs_tak(env.reset().replace(x=x0), ctrl)
    ref = task.rollout_costs(x0.expand(k, -1), ctrl.permute(2, 0, 1))
    torch.testing.assert_close(ref, port, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", CELLS)
def test_ce_step_equals_the_ports_policy_step(name):
    cell, cfg = _cell(name)
    traffic = dict(cell.traffic, num_samples=12, horizon=2, ais_its=2)
    module = cell.reference_module()
    env = loop.build_env(cfg, module, "cpu")
    costs = []
    orig = env.fused_rollout_costs_tak

    def recording(state, ctrl):
        costs.append(orig(state, ctrl))
        return costs[-1]

    object.__setattr__(env, "fused_rollout_costs_tak", recording)
    pol = loop.build_policy(env, cfg, traffic)
    ce = module.policy_step(cfg, traffic, env.action_dim)
    assert (ce.num_samples, ce.horizon, ce.opt_its) == (12, 2, 2)
    assert ce.jitter_eps == torch.finfo(torch.float64).eps
    gen = torch.Generator().manual_seed(5)
    s = env.reset().replace(x=_start(env, gen))
    ps = pol.init_state(7)
    ps = ps.__class__(U=0.3 * torch.randn(ce.cs, generator=gen, dtype=torch.float64),
                      generator=ps.generator)
    z = torch.randn((2, ce.cs, 12), generator=gen, dtype=torch.float64)
    act, ps2, info = pol.step(s, ps, z=z)
    low, high = env.control_bounds
    out = ce.run(ps.U, list(z[:info["ais_its"]]), costs, low, high,
                 torch.zeros(ce.cs, dtype=torch.float64), torch.float64)
    torch.testing.assert_close(out["action"], act, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(out["u_next"], ps2.U, rtol=1e-12, atol=1e-12)
    assert len(costs) == info["ais_its"]
    assert not any(out["stops"][:-1])
