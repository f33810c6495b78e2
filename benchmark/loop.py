"""Set-up and the measured window: one closed-loop MPC controller.

The window calls the program as its own harness does (`harness/simulate.py`,
`_simulate_simple`'s per-step loop): `pol.step(s, ps)`, then the env's
`step_reward(s, act)`, then one host read of the action and the reward,
as a controller sends each action to its plant. Trials run back to back,
each from `env.reset()` and `pol.init_state(trial seed)`, and end at the
traffic's trial length or at the env's done flag.

Every run does the same work in another order: the traffic fixes a pool of
trial seeds (`trial_seed` + 0 .. `trials` - 1), about as many trials as the
window holds, and `--seed` only permutes them (then the checked steps and
columns). The closed loop's trajectory, and with it the contact work of each
step, follows from the trial's seed, so seeds that each drew their own
trials would measure different work.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import time

import numpy as np
import torch

from benchmark.check import EnvRecord, PolicyRecord

# a step that the window did not reach, but the comparison sampled, is run
# after the window closes, untimed, for at most this long
CATCH_UP_S = 120.0


def _span(name: str, on: bool):
    return torch.profiler.record_function(name) if on else contextlib.nullcontext()


def build_env(config: dict, module, device: str):
    """The program's env as the configuration states it (`module` is the
    configuration's, `spec.Cell.reference_module`); its facts checked
    against the file, so the file holds the configuration as it is run."""
    path, cls = config["env"].split(":")
    env_cls = getattr(importlib.import_module(path), cls)
    env = env_cls(dtype=getattr(torch, config["dtype"]), device=device,
                  **module.env_kwargs(config))
    for key, value in module.facts(env).items():
        if config[key] != value:
            raise ValueError(f"configuration {config['name']}: {key} {config[key]!r}, "
                             f"the program's {value!r}")
    return env


def build_policy(env, config: dict, traffic: dict):
    """The policy through the program's own factory, as its CLI builds it."""
    from mpopis_tpu_torch.harness.factory import get_policy

    return get_policy(
        config["policy"], env, traffic["num_samples"], traffic["horizon"], traffic["lam"],
        config["alpha"], [0.0] * env.action_dim, [traffic["cov"]] * env.action_dim,
        ais_its=traffic["ais_its"], ce_elite_threshold=config["ce_elite_threshold"],
        ce_sigma_est=traffic["sigma_est"],
    )


def trial_order(seed: int, traffic: dict) -> list[int]:
    """The pool's trial seeds in the order that `seed` gives them."""
    rng = np.random.default_rng([int(seed), 0x7121A1])
    return [traffic["trial_seed"] + int(i) for i in rng.permutation(traffic["trials"])]


def draw_checks(seed: int, check: dict, num_samples: int, opt_its: int) -> dict:
    """The steps and columns the comparison looks at, drawn from the seed:
    policy steps and env steps among the first `within_steps` control steps,
    and per policy step and AIS iteration the checked columns."""
    rng = np.random.default_rng([int(seed), 0x5EED])
    within = check["within_steps"]
    policy = sorted(int(i) for i in rng.choice(within, check["policy_steps"], replace=False))
    env = sorted(int(i) for i in rng.choice(within, check["env_steps"], replace=False))
    columns = {i: [sorted(int(c) for c in rng.choice(num_samples, check["columns"],
                                                     replace=False))
                   for _ in range(opt_its)] for i in policy}
    return {"policy": set(policy), "env": set(env), "columns": columns}


@dataclasses.dataclass
class Window:
    """What the window did."""

    steps: int = 0
    seconds: float = 0.0
    step_ms: list = dataclasses.field(default_factory=list)
    ais_its: list = dataclasses.field(default_factory=list)
    trials: int = 0
    policy_records: list = dataclasses.field(default_factory=list)
    env_records: list = dataclasses.field(default_factory=list)
    record_steps: list = dataclasses.field(default_factory=list)
    caught_up: int = 0  # steps run after the window to reach sampled ones
    failed: int = 0  # window steps whose action or reward is not finite
    prof: object = None


class ClosedLoop:
    """The env, the policy and the loop that drives them."""

    def __init__(self, cell, seed: int, device: str):
        self.config, self.traffic, self.seed = cell.config, cell.traffic, int(seed)
        self.env = build_env(cell.config, cell.reference_module(), device)
        self.pol = build_policy(self.env, cell.config, cell.traffic)
        self.trace = False
        self._calls = None  # the rollout calls of a recorded step
        orig = self.env.fused_rollout_costs_tak

        def rollout(state, controls_tak):
            with _span("bench.rollout", self.trace):
                costs = orig(state, controls_tak)
            if self._calls is not None:
                self._calls.append(costs)
            return costs

        # on the instance, so the driver's calls go through the span
        object.__setattr__(self.env, "fused_rollout_costs_tak", rollout)

    def _step(self, s, ps):
        with _span("bench.control_step", self.trace):
            with _span("bench.policy_step", self.trace):
                act, ps2, info = self.pol.step(s, ps)
            s2, r = self.env.step_reward(s, act)
            parts = [act.reshape(-1), r.reshape(1).to(act.dtype)]
            if isinstance(s2.done, torch.Tensor):
                parts.append(s2.done.reshape(1).to(act.dtype))
            host = torch.cat(parts).cpu()  # the one host read of the step
        done = bool(host[-1]) if isinstance(s2.done, torch.Tensor) else bool(s2.done)
        return act, r, s2, ps2, info, host, done

    def warm_up(self):
        """The cell's own shapes, from a trial of its own seed."""
        s, ps = self.env.reset(), self.pol.init_state(self.seed)
        for _ in range(self.traffic["warmup_steps"]):
            _, _, s, ps, _, _, done = self._step(s, ps)
            if done:
                s = self.env.reset()
        if torch.device(self.env.device).type == "cuda":
            torch.cuda.synchronize()

    def run(self, seconds: float, checks: dict, trace_at: tuple | None = None) -> Window:
        """Measure for `seconds`. `trace_at` (first step, steps) opens a
        torch.profiler over that stretch of the window's steps."""
        w = Window()
        trial_steps = self.traffic["trial_steps"]
        order = trial_order(self.seed, self.traffic)
        last_check = max(checks["policy"] | checks["env"])
        s = ps = None
        j, draws, done = trial_steps, 0, False
        gc.collect()  # the set-up's garbage; the collector runs on, as in the users' loop
        t_start = time.perf_counter()
        t_goal = t_start + seconds
        t_end = t_start
        gstep = 0
        while True:
            now = time.perf_counter()
            timed = now < t_goal
            if not timed and (gstep > last_check or now > t_goal + CATCH_UP_S):
                break
            if j >= trial_steps or done:
                trial_seed = order[w.trials % len(order)]
                w.trials += 1
                s, ps = self.env.reset(), self.pol.init_state(trial_seed)
                j, draws, done = 0, 0, False
            if trace_at is not None and timed and gstep == trace_at[0]:
                w.prof = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
                w.prof.start()
                self.trace = True
            rec = None
            if gstep in checks["policy"]:
                rec = PolicyRecord(trial_seed=trial_seed, draws_before=draws, x=s.x, u=ps.U,
                                   costs=[])
                self._calls = rec.costs
            t0 = time.perf_counter()
            act, r, s2, ps2, info, host, done = self._step(s, ps)
            t1 = time.perf_counter()
            self._calls = None
            if self.trace and gstep + 1 == trace_at[0] + trace_at[1]:
                w.prof.stop()
                self.trace = False
            if timed:
                w.steps += 1
                w.step_ms.append((t1 - t0) * 1e3)
                w.ais_its.append(int(info["ais_its"]))
                w.failed += int(not bool(torch.isfinite(host).all()))
                t_end = t1
            else:
                w.caught_up += 1
            if rec is not None:
                rec.its, rec.action, rec.u_next = int(info["ais_its"]), act, ps2.U
                w.policy_records.append(rec)
                w.record_steps.append(gstep)
            if gstep in checks["env"]:
                w.env_records.append(EnvRecord(x=s.x, action=act, x_next=s2.x, reward=r))
            draws += int(info["ais_its"])
            s, ps = s2, ps2
            j += 1
            gstep += 1
        if self.trace:  # the window closed inside the traced stretch
            w.prof.stop()
            self.trace = False
        w.seconds = t_end - t_start
        return w
