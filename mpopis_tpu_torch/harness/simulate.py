"""Experiment drivers: config banner, per-trial seeded runs, the
AVE/STD/MED/L95/U95/MIN/MAX summary table.

Counterpart of `mpopis_tpu/harness/simulate.py`:
- `simulate_car_racing` for one car. The MPC loop runs one control step
  per iteration — policy step, env step, reward — and brings the packed
  per-step telemetry to the host in one transfer; the step counting, lap
  detection and violation accounting follow the JAX harness exactly, and so
  do the printed rows.
- `simulate_mujoco_on_device` for HalfCheetah, Hopper, Walker2d and Ant,
  through `_simulate_simple` (the chunked loop, the action CSV).
"""

from __future__ import annotations

import os
import time
import warnings

import numpy as np
import torch

from mpopis_tpu_torch.harness.factory import get_policy
from mpopis_tpu_torch.harness.stats import SUMMARY_ROWS, summary_value
from mpopis_tpu_torch.models import (
    AntDeviceEnv,
    CarRacingEnv,
    CheetahDeviceEnv,
    HopperDeviceEnv,
    HumanoidDeviceEnv,
    HumanoidStandupDeviceEnv,
    PusherDeviceEnv,
    SwimmerDeviceEnv,
    Walker2dDeviceEnv,
)
from mpopis_tpu_torch.policies.config import canonical_kind

_AIS_KINDS = {"imppi", "cemppi", "cmamppi", "muaismppi", "musigmaaismppi", "pmcmppi", "nesmppi"}
_LAMBDA_AIS_KINDS = {"muaismppi", "musigmaaismppi", "pmcmppi"}


def _print(enabled: bool, fmt: str, *args) -> None:
    if enabled:
        print(fmt % args if args else fmt, flush=True)


def _banner(
    enabled,
    sim_type,
    policy_type,
    num_trials,
    num_steps,
    num_samples,
    horizon,
    lam,
    alpha,
    ais_its,
    lambda_ais,
    ce_elite_threshold,
    ce_sigma_est,
    cma_sigma,
    cma_elite_threshold,
    seed,
    extra=(),
):
    kind = canonical_kind(policy_type)
    _print(enabled, "")
    _print(enabled, "%-30s%s", "Sim Type:", sim_type)
    for label, value in extra:
        _print(enabled, "%-30s%s", label, value)
    _print(enabled, "%-30s%d", "Num Trails:", num_trials)
    _print(enabled, "%-30s%d", "Num Steps:", num_steps)
    _print(enabled, "%-30s%s", "Policy Type:", policy_type)
    _print(enabled, "%-30s%d", "Num samples", num_samples)
    _print(enabled, "%-30s%d", "Horizon", horizon)
    _print(enabled, "%-30s%.2f", "λ (inverse temp):", lam)
    _print(enabled, "%-30s%.2f", "α (control cost param):", alpha)
    if kind in _AIS_KINDS:
        _print(enabled, "%-30s%d", "# AIS Iterations:", ais_its)
        if kind in _LAMBDA_AIS_KINDS:
            _print(enabled, "%-30s%.2f", "λ_ais (ais inverse temp):", lambda_ais)
        elif kind == "cemppi":
            _print(enabled, "%-30s%.2f", "CE Elite Threshold:", ce_elite_threshold)
            _print(enabled, "%-30s%s", "CE Σ Est Method:", ce_sigma_est)
        elif kind == "cmamppi":
            _print(enabled, "%-30s%.2f", "CMA Step Factor (σ):", cma_sigma)
            _print(enabled, "%-30s%.2f", "CMA Elite Perc Thres:", cma_elite_threshold)
    _print(enabled, "%-30s%d", "Seed:", seed)
    _print(enabled, "")


def _summary_table(enabled, metrics: dict, order: list[str]):
    """Print AVE/STD/MED/L95/U95/MIN/MAX rows over trials for each metric."""
    for row in SUMMARY_ROWS:
        vals = " : ".join(
            f"{summary_value(row, metrics[name]):12.2f}" for name in order
        )
        _print(enabled, "Trials %3s: %s", row, vals)


def _default_seed() -> int:
    return int(np.random.randint(1, 10**10))


def _resolve_chunk(steps_per_call, needs_host_every_step: bool) -> int:
    """Control steps per host read-back. Policy logging needs the host every
    control step, so it forces 1, even over an explicit request."""
    if needs_host_every_step:
        if steps_per_call is not None and steps_per_call > 1:
            warnings.warn(
                f"steps_per_call={steps_per_call} ignored: logging needs the host every "
                "control step; using 1",
                stacklevel=3,
            )
        return 1
    return 10 if steps_per_call is None else max(int(steps_per_call), 1)


def _simulate_simple(
    env,
    sim_type: str,
    *,
    num_trials=1,
    num_steps=200,
    policy_type="cemppi",
    num_samples=20,
    horizon=15,
    lam=0.1,
    alpha=1.0,
    u0=(0.0,),
    cov_mat=(1.5,),
    ais_its=5,
    lambda_ais=0.1,
    ce_elite_threshold=0.8,
    ce_sigma_est="mle",
    cma_sigma=0.75,
    cma_elite_threshold=0.8,
    seed=None,
    log_runs=True,
    pol_log=False,
    plot_traj=False,
    save_gif=False,
    print_output=True,
    steps_per_call=None,
    output_acts_file=False,
    acts_dir="acts",
):
    """The MPC loop of the JAX package's `_simulate_simple`: policy step, env
    step and reward per control step, `num_steps + 1` steps (the JAX loop
    bound `cnt <= num_steps`), reported as `cnt − 1`. With `steps_per_call`
    > 1 (default 10) the [reward, done, action…] rows of a chunk stay on the
    device and reach the host in one copy; steps past the end of the trial
    inside a chunk are discarded, so both paths give the same rewards."""
    for flag, what in ((plot_traj, "plot_traj"), (save_gif, "save_gif")):
        if flag:
            raise NotImplementedError(f"{sim_type}: {what} is not yet ported")
    if seed is None:
        seed = _default_seed()
    chunk = _resolve_chunk(steps_per_call, needs_host_every_step=pol_log)
    _banner(
        print_output, sim_type, policy_type, num_trials, num_steps, num_samples,
        horizon, lam, alpha, ais_its, lambda_ais, ce_elite_threshold,
        ce_sigma_est, cma_sigma, cma_elite_threshold, seed,
    )
    _print(print_output, "Trial    #: %12s : %7s: %12s : %7s", "Reward", "Steps", "Reward/Step",
           "Ex Time")
    pol = get_policy(
        policy_type, env, num_samples, horizon, lam, alpha, list(u0), list(cov_mat),
        pol_log, ais_its, lambda_ais, ce_elite_threshold, ce_sigma_est, cma_sigma,
        cma_elite_threshold,
    )

    def run_chunk(s, ps):
        """`chunk` control steps; the rows stack on the device."""
        rows, its = [], 0
        for _ in range(chunk):
            act, ps, info = pol.step(s, ps)
            s2, r = env.step_reward(s, act)
            its += info["ais_its"]
            rows.append(torch.cat([
                torch.stack([r.to(env.dtype), r.new_tensor(float(s2.done), dtype=env.dtype)]),
                act.to(env.dtype),
            ]))
            s = s2
        return s, ps, torch.stack(rows), its

    rews = np.zeros(num_trials)
    steps = np.zeros(num_trials)
    exec_times = np.zeros(num_trials)
    ais_iterations = np.zeros(num_trials)
    for k in range(1, num_trials + 1):
        ps = pol.init_state(seed + k)
        s = env.reset()
        t0 = time.perf_counter()
        rew, cnt, done, its = 0.0, 0, False, 0
        acts: list[np.ndarray] = []
        while not done and cnt <= num_steps:
            if chunk > 1:
                s, ps, rows_d, n_its = run_chunk(s, ps)
                its += n_its
                for row in rows_d.cpu().numpy():
                    if done or cnt > num_steps:
                        break
                    cnt += 1
                    rew += float(row[0])
                    done = bool(row[1])
                    if output_acts_file:
                        acts.append(row[2:].astype(np.float64))
                continue
            act, ps, info = pol.step(s, ps)
            s, r_step = env.step_reward(s, act)
            its += info["ais_its"]
            rew += float(r_step)
            cnt += 1
            done = bool(s.done)
            if output_acts_file:
                acts.append(act.cpu().numpy().astype(np.float64))
        dt = time.perf_counter() - t0
        rews[k - 1] = rew
        steps[k - 1] = cnt - 1
        exec_times[k - 1] = dt
        ais_iterations[k - 1] = its
        if output_acts_file and acts:
            # executed actions at 20 decimals, the reference's write_acts_to_file format
            os.makedirs(acts_dir, exist_ok=True)
            fname = os.path.join(
                acts_dir,
                f"{sim_type.replace(' ', '')}_{policy_type}_{num_steps}"
                f"_{num_trials}_{seed}_{horizon}_{num_samples}_{ais_its}"
                f"trial-{k}.csv",
            )
            with open(fname, "w") as f:
                for a in acts:
                    f.write(",".join(f"{v:.20f}" for v in a) + "\n")
            _print(print_output, "Wrote acts...%s", fname)
        if log_runs:
            _print(
                print_output, "Trial %4d: %12.2f : %7d: %12.2f : %7.2f",
                k, rew, cnt - 1, rew / max(cnt - 1, 1), dt,
            )

    metrics = {
        "rewards": rews,
        "steps": steps,
        "rewards_per_step": rews / np.maximum(steps, 1),
        "exec_times": exec_times,
        "control_steps_per_s": steps / np.maximum(exec_times, 1e-9),
        "ais_iterations": ais_iterations,
    }
    _print(print_output, "-----------------------------------")
    _summary_table(print_output, metrics, ["rewards", "steps", "rewards_per_step", "exec_times"])
    return metrics


ON_DEVICE_MUJOCO_TASKS = (
    "Ant-v4",
    "Humanoid-v4",
    "HumanoidStandup-v4",
    "Pusher-v4",
    "Reacher-v4",
    "Swimmer-v4",
    "InvertedPendulum-v4",
    "InvertedDoublePendulum-v4",
    "HalfCheetah-v4",
    "Hopper-v4",
    "Walker2d-v4",
)
# the tasks whose on-device dynamics hold a contact QP (`solver_iters` applies)
CONTACT_SOLVER_TASKS = ("Ant-v4", "Humanoid-v4", "HumanoidStandup-v4", "Pusher-v4",
                        "HalfCheetah-v4", "Hopper-v4", "Walker2d-v4")
PORTED_MUJOCO_TASKS = {
    "Ant-v4": AntDeviceEnv,
    "HalfCheetah-v4": CheetahDeviceEnv,
    "Hopper-v4": HopperDeviceEnv,
    "Humanoid-v4": HumanoidDeviceEnv,
    "HumanoidStandup-v4": HumanoidStandupDeviceEnv,
    "Pusher-v4": PusherDeviceEnv,
    "Swimmer-v4": SwimmerDeviceEnv,
    "Walker2d-v4": Walker2dDeviceEnv,
}


def simulate_mujoco_on_device(task: str, **kwargs):
    """A MuJoCo task with on-device dynamics: the K×T rollouts of each
    control step run on the card (for the planar- and spatial-contact
    families, one kernel launch per AIS iteration). Counterpart of the JAX
    package's `simulate_mujoco_on_device`; ported for the tasks of
    PORTED_MUJOCO_TASKS. `solver_iters=(outer, cg)` sets the contact QP's fixed
    iteration counts (default (3, 6)); `dtype` and `device` (default cuda)
    place the run. Returns the metrics dict, `ais_iterations` and
    `control_steps_per_s` included."""
    if task not in ON_DEVICE_MUJOCO_TASKS:
        raise ValueError(
            f"no on-device dynamics for {task!r}; options {ON_DEVICE_MUJOCO_TASKS} "
            "(the host engine supports all 11 tasks: python -m mpopis_tpu mujoco)"
        )
    solver_iters = kwargs.pop("solver_iters", None)
    if solver_iters is not None and task not in CONTACT_SOLVER_TASKS:
        raise ValueError(f"{task!r} has no contact solver (solver_iters)")
    if task not in PORTED_MUJOCO_TASKS:
        raise NotImplementedError(f"simulate_mujoco_on_device({task!r}): not yet ported")
    cls = PORTED_MUJOCO_TASKS[task]
    dtype = kwargs.pop("dtype", torch.float32)
    device = kwargs.pop("device", "cuda")
    env_kwargs = {}
    if solver_iters is not None:
        env_kwargs = {"solver_outer": solver_iters[0], "solver_cg": solver_iters[1]}
    env = cls(dtype=dtype, device=device, **env_kwargs)
    kwargs.setdefault("u0", (0.0,) * env.action_dim)
    kwargs.setdefault("cov_mat", (0.25,) * env.action_dim)
    return _simulate_simple(env, f"{task} (on-device)", **kwargs)


def simulate_car_racing(
    *,
    num_trials=1,
    num_steps=200,
    num_cars=1,
    policy_type="cemppi",
    laps=2,
    num_samples=150,
    horizon=50,
    lam=10.0,
    alpha=1.0,
    u0=None,
    cov_mat=None,
    ais_its=10,
    lambda_ais=20.0,
    ce_elite_threshold=0.8,
    ce_sigma_est="ss",
    cma_sigma=0.75,
    cma_elite_threshold=0.8,
    state_x_sigma=0.0,
    state_y_sigma=0.0,
    state_psi_sigma=0.0,
    seed=None,
    log_runs=True,
    pol_log=False,
    plot_traj=False,
    save_gif=False,
    track="curve",
    print_output=True,
    dtype=torch.float32,
    device="cuda",
):
    """Race `num_trials` trials of up to `num_steps` control steps; trial k
    is seeded with seed + k. Returns the metrics dict (one entry per trial
    in each array), including `ais_iterations`, the rollout calls made."""
    for flag, what in (
        (num_cars != 1, "num_cars > 1"),
        (save_gif, "save_gif"),
        (plot_traj, "plot_traj"),
        (bool(state_x_sigma or state_y_sigma or state_psi_sigma), "state noise"),
    ):
        if flag:
            raise NotImplementedError(f"simulate_car_racing: {what} is not yet ported")
    if seed is None:
        seed = _default_seed()
    if u0 is None:
        u0 = [0.0, 0.0]
    if cov_mat is None:
        cov_mat = np.diag([0.0625, 0.1])

    _banner(
        print_output, "cr", policy_type, num_trials, num_steps, num_samples,
        horizon, lam, alpha, ais_its, lambda_ais, ce_elite_threshold,
        ce_sigma_est, cma_sigma, cma_elite_threshold, seed,
        extra=[("Num Cars:", num_cars), ("Max Num Laps:", laps)],
    )

    env = CarRacingEnv(dtype=dtype, device=device, track_name=track)
    pol = get_policy(
        policy_type, env, num_samples, horizon, lam, alpha, u0, cov_mat,
        pol_log, ais_its, lambda_ais, ce_elite_threshold, ce_sigma_est,
        cma_sigma, cma_elite_threshold,
    )

    def stats_vec(s, rew):
        """Per-step bookkeeping packed into one tensor, so the host pays a
        single transfer per control step: [rew, within, d, curr_y, v, β]."""
        x = s.x
        within, _ = env.within_track(s)
        return torch.stack([
            rew,
            within.to(rew.dtype),
            torch.sqrt(x[0] ** 2 + x[1] ** 2),
            x[1],
            torch.sqrt(x[3] ** 2 + x[4] ** 2),
            torch.abs(torch.atan2(x[4], x[3])),
        ])

    header = f"Trial    #: {'Reward':>12} : {'Steps':>7}: {'Reward/Step':>12}"
    for ii in range(1, laps + 1):
        header += f" : {'lap ':>6}{ii}"
    header += f" : {'Mean V':>7} : {'Max V':>7} : {'Mean β':>7} : {'Max β':>7}"
    header += f" : {'β Viol':>7} : {'T Viol':>7}"
    header += f" : {'Ex Time':>7}"
    _print(print_output, header)

    n_t = num_trials
    rews = np.zeros(n_t)
    steps = np.zeros(n_t)
    lap_ts = np.zeros((laps, n_t))
    mean_vs = np.zeros(n_t)
    max_vs = np.zeros(n_t)
    mean_bs = np.zeros(n_t)
    max_bs = np.zeros(n_t)
    b_viols = np.zeros(n_t)
    t_viols = np.zeros(n_t)
    c_viols = np.zeros(n_t)
    exec_times = np.zeros(n_t)
    ais_iterations = np.zeros(n_t)

    for k in range(1, n_t + 1):
        ps = pol.init_state(seed + k)
        s = env.reset()
        t0 = time.perf_counter()

        lap_time = np.zeros(laps, dtype=int)
        v_log, b_log = [], []
        rew, cnt, lap, prev_y = 0.0, 0, 0, 0.0
        trk_viol, b_viol, crash_viol, its = 0, 0, 0, 0
        done = False

        while not done and cnt <= num_steps:
            act, ps, info = pol.step(s, ps)
            s = env.step(s, act)
            its += info["ais_its"]
            stats = stats_vec(s, env.reward(s)).cpu().numpy()

            cnt += 1
            step_rew = float(stats[0])
            rew += step_rew
            within_t = bool(stats[1] != 0.0)
            d = float(stats[2])
            curr_y = float(stats[3])
            v_log.append(float(stats[4]))
            b_log.append(float(stats[5]))

            # violation accounting
            if step_rew < -4000:
                ex_b = bool(stats[5] > env.params.beta_limit)
                if ex_b:
                    b_viol += 1
                if not within_t:
                    trk_viol += 1
                temp_rew = step_rew + ex_b * 5000 + (not within_t) * 1000000
                if temp_rew < -10500:
                    crash_viol += 1

            # lap detection on curve.csv
            if prev_y < 0.0 <= curr_y and d <= 15.0:
                lap += 1
                if lap <= laps:
                    lap_time[lap - 1] = cnt
            if lap >= laps or trk_viol > 10 or b_viol > 50:
                done = True
            prev_y = curr_y

        dt_s = time.perf_counter() - t0
        rews[k - 1] = rew
        steps[k - 1] = cnt - 1
        exec_times[k - 1] = dt_s
        lap_ts[:, k - 1] = lap_time
        mean_vs[k - 1] = np.mean(v_log)
        max_vs[k - 1] = np.max(v_log)
        mean_bs[k - 1] = np.mean(b_log)
        max_bs[k - 1] = np.max(b_log)
        b_viols[k - 1] = b_viol
        t_viols[k - 1] = trk_viol
        c_viols[k - 1] = crash_viol
        ais_iterations[k - 1] = its

        if log_runs:
            row = f"Trial {k:4d}: {rew:12.2f} : {cnt - 1:7d}: {rew / max(cnt - 1, 1):12.2f}"
            for ii in range(laps):
                row += f" : {lap_time[ii]:7d}"
            row += f" : {np.mean(v_log):7.2f} : {np.max(v_log):7.2f}"
            row += f" : {np.mean(b_log):7.2f} : {np.max(b_log):7.2f}"
            row += f" : {b_viol:7d} : {trk_viol:7d}"
            row += f" : {dt_s:7.2f}"
            _print(print_output, row)

    metrics = {
        "rewards": rews,
        "steps": steps,
        "rewards_per_step": rews / np.maximum(steps, 1),
        "mean_vs": mean_vs,
        "max_vs": max_vs,
        "mean_betas": mean_bs,
        "max_betas": max_bs,
        "beta_violations": b_viols,
        "track_violations": t_viols,
        "crash_violations": c_viols,
        "exec_times": exec_times,
        "lap_times": lap_ts,
        "control_steps_per_s": steps / np.maximum(exec_times, 1e-9),
        "ais_iterations": ais_iterations,
    }
    _print(print_output, "-----------------------------------")
    order = ["rewards", "steps", "rewards_per_step"]
    for ii in range(laps):
        metrics[f"lap{ii + 1}_times"] = lap_ts[ii]
        order.append(f"lap{ii + 1}_times")
    order += ["mean_vs", "max_vs", "mean_betas", "max_betas",
              "beta_violations", "track_violations", "exec_times"]
    _summary_table(print_output, metrics, order)
    return metrics
