"""The comparison that decides `correct`.

The window records, at a sample of its control steps drawn from the seed,
what the timed path was given and what it produced: the state and plan
handed to the policy step, the costs that each rollout call returned, the
action, the next plan, and the env step's next state and reward. Once the
window has closed and the program's memory peak has been read, the plain
reference (the configuration's `task` and `policy_step`, float64) works
each of those steps out again from the same inputs:

- each AIS iteration's candidates from the plan, its own covariance factor
  and the iteration's standard normals, which it draws itself from the
  trial's seed; a sample of their columns rolled out through the plain
  dynamics, against the program's costs of the same columns;
- the policy's update (for CEMPPI the elite mask, mean shift, covariance
  and factor), the early-stop test, the importance weights, the action and
  the next plan, from the program's costs of each iteration (an f32 cost
  next to the elite threshold swaps sides under rounding, so the reference
  follows the program's selection; the costs themselves are checked by
  the columns);
- the env step's next state and reward from the state and the program's
  action, at a larger sample of steps.

The columns' and the env steps' gaps are held by quantiles, which the
chaotic few (a contact that closes at one precision and not the other) do
not move, and by their geometric means, which a wrong answer in any share
of them moves.

The control puts the same reference, in float32 with TF32 matrix products,
in the program's place (`outputs_reference(..., tf32=True)`).
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class PolicyRecord:
    """One checked control step: its inputs and the program's outputs."""

    trial_seed: int
    draws_before: int  # (cs, K) normals the trial's generator gave before this step
    x: torch.Tensor
    u: torch.Tensor
    costs: list  # (K,) per rollout call, in order
    its: int = 0
    action: torch.Tensor | None = None
    u_next: torch.Tensor | None = None


@dataclasses.dataclass
class EnvRecord:
    """One checked env step: the state, the program's action, next state
    and reward."""

    x: torch.Tensor
    action: torch.Tensor
    x_next: torch.Tensor
    reward: torch.Tensor


@dataclasses.dataclass
class Outputs:
    """What one side produced at the checked steps."""

    actions: list
    plans: list
    costs: torch.Tensor  # the checked columns' costs, all records and iterations
    next_states: torch.Tensor | None
    rewards: torch.Tensor | None
    stops: list | None = None  # per policy record, the stop flag after each iteration


def reference_for(cell, env):
    """(policy step, task, (low, high, U0)) of the cell's plain reference,
    from its configuration's module; the bounds and U0 on the CPU."""
    module = cell.reference_module()
    policy = module.policy_step(cell.config, cell.traffic, env.action_dim)
    low, high = env.control_bounds
    return policy, module.task(cell.config), (low.cpu(), high.cpu(), torch.zeros(policy.cs))


def normals(records: list, cs: int, k: int, device) -> dict:
    """{(trial_seed, draw): (cs, K) float32 normals}, drawn as the policy's
    generator draws them: a generator on the device seeded with the trial's
    seed, one (cs, K) draw an AIS iteration."""
    want: dict[int, set] = {}
    for r in records:
        want.setdefault(r.trial_seed, set()).update(range(r.draws_before,
                                                          r.draws_before + r.its))
    out = {}
    for trial_seed, draws in want.items():
        gen = torch.Generator(device=device)
        gen.manual_seed(int(trial_seed))
        for d in range(max(draws) + 1):
            z = torch.randn((cs, k), generator=gen, dtype=torch.float32, device=device)
            if d in draws:
                out[(trial_seed, d)] = z
    return out


def outputs_program(policy_records, env_records, columns) -> Outputs:
    costs = [rec.costs[n][torch.as_tensor(col, device=rec.costs[n].device)]
             for rec, cols in zip(policy_records, columns) for n, col in enumerate(cols)]
    return Outputs(
        actions=[r.action for r in policy_records],
        plans=[r.u_next for r in policy_records],
        costs=torch.cat(costs) if costs else torch.zeros(0),
        next_states=torch.stack([r.x_next for r in env_records]) if env_records else None,
        rewards=torch.stack([r.reward.reshape(()) for r in env_records]) if env_records else None,
    )


def outputs_reference(policy, task, policy_records, env_records, columns, bounds, z,
                      device, dtype=torch.float64, tf32: bool = False,
                      tally=None) -> Outputs:
    """The reference's outputs from the same inputs, in `dtype`; `tf32`
    rounds its matrix products to TF32 (the control). `policy` and `task`
    from `reference_for`; `bounds` is (low, high, u0); `z` from `normals`.
    `tally`, a context manager, wraps the checked rollouts (the
    configuration's `rollout_work`)."""
    cast = {"dtype": dtype, "device": device}
    low, high, u0 = (b.to(**cast) for b in bounds)
    actions, plans, stops, x0s, ctrls = [], [], [], [], []
    for rec, cols in zip(policy_records, columns):
        zs = [z[(rec.trial_seed, rec.draws_before + n)].to(**cast) for n in range(rec.its)]
        run = policy.run(rec.u.to(**cast), zs, [c.to(**cast) for c in rec.costs], low, high,
                         u0, dtype, tf32=tf32)
        actions.append(run["action"])
        plans.append(run["u_next"])
        stops.append(run["stops"])
        for n, col in enumerate(cols):
            v = run["candidates"][n][:, torch.as_tensor(col, device=device)]
            ctrls.append(v.T.reshape(len(col), policy.horizon, policy.action_dim))
            x0s.append(rec.x.to(**cast).expand(len(col), -1))
    with task.tf32_products(device) if tf32 else contextlib.nullcontext():
        costs = torch.zeros(0, **cast)
        if ctrls:
            if tally is None:
                costs = task.rollout_costs(torch.cat(x0s), torch.cat(ctrls))
            else:
                with tally:
                    costs = task.rollout_costs(torch.cat(x0s), torch.cat(ctrls))
        nxt = rew = None
        if env_records:
            xs = torch.stack([r.x.to(**cast) for r in env_records])
            acts = torch.stack([r.action.to(**cast) for r in env_records])
            nxt = task.step(xs, acts)
            rew = task.reward(xs, nxt, acts)
    return Outputs(actions, plans, costs, nxt, rew, stops)


def rel_gap(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """|got - want| / max(|want|, 1): relative where the value is large,
    absolute where it is near zero."""
    got, want = got.double(), want.double().to(got.device)
    return torch.abs(got - want) / torch.clamp(torch.abs(want), min=1.0)


def _max_gap(got: list, want: list) -> float:
    gaps = [float(torch.max(torch.abs(g.double() - w.double().to(g.device))))
            for g, w in zip(got, want)]
    return max(gaps) if gaps else float("nan")


# a gap below this counts as this in a geometric mean (f64 round-off of a
# quantity of order 1)
GAP_FLOOR = 1e-12


def _quantiles(name: str, values) -> dict:
    """{name_q10, name_q25, name_median, name_geomean} of the values, NaN
    where none. The geometric mean moves with every value: a wrong answer in
    a share p of them, at a gap g, multiplies it by about (g / typical)^p,
    where a quantile below 1 - p does not move at all."""
    if len(values) == 0:
        return {f"{name}_{q}": float("nan") for q in ("q10", "q25", "median", "geomean")}
    v = np.asarray(values, dtype=np.float64)
    qs = np.quantile(v, [0.1, 0.25, 0.5])
    return {f"{name}_q10": float(qs[0]), f"{name}_q25": float(qs[1]),
            f"{name}_median": float(qs[2]),
            f"{name}_geomean": float(np.exp(np.mean(np.log(np.maximum(v, GAP_FLOOR)))))}


def compare(got: Outputs, want: Outputs, its: list, opt_its: int) -> dict:
    """Every number the comparison can hold, from one side's outputs and the
    float64 reference's; a cell's checks file says which it holds and to
    what limit. `its` are the program's AIS iterations at each checked step:
    `stop_mismatches` counts where the reference's stop flags disagree."""
    mismatches = 0
    for n_its, flags in zip(its, want.stops):
        mismatches += sum(bool(f) for f in flags[:n_its - 1])
        if n_its < opt_its and not flags[n_its - 1]:
            mismatches += 1
    out = {"stop_mismatches": float(mismatches),
           "action_gap": _max_gap(got.actions, want.actions),
           "plan_gap": _max_gap(got.plans, want.plans)}
    out.update(_quantiles("cost_gap", rel_gap(got.costs, want.costs).cpu().numpy()
                          if len(want.costs) else []))
    states = rewards = []
    if want.next_states is not None:
        states = torch.max(rel_gap(got.next_states, want.next_states), dim=-1).values.cpu()
        rewards = rel_gap(got.rewards, want.rewards).cpu()
    out.update(_quantiles("state_gap", np.asarray(states)))
    out.update(_quantiles("reward_gap", np.asarray(rewards)))
    return out


def judge(numbers: dict, limits: dict) -> tuple[bool, list[str], dict]:
    """(correct, one line per number, {name: {value, limit}}): each number
    that `limits` names at or under its limit; a number that is NaN (nothing
    was compared) fails."""
    ok, lines, shown = True, [], {}
    for name in limits:
        value, limit = float(numbers[name]), float(limits[name])
        good = bool(np.isfinite(value) and value <= limit)
        ok &= good
        lines.append(f"check {name}: {value!r} limit {limit!r} {'ok' if good else 'FAILED'}")
        shown[name] = {"value": value, "limit": limit}
    return ok, lines, shown
