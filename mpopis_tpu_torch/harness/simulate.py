"""Experiment drivers: config banner, per-trial seeded runs, the
AVE/STD/MED/L95/U95/MIN/MAX summary table.

Counterpart of `mpopis_tpu/harness/simulate.py`:
- `simulate_car_racing` for 1..4 cars (`num_cars` > 1 is the multi-car
  race, `mcr`). The MPC loop runs `steps_per_call` control steps (default
  10) per host read: the packed per-step telemetry rows of a chunk stack
  on the device and reach the host in one copy, and steps past the stop
  inside a chunk are discarded. Gif frames, trajectory plots, additive state
  noise (one car) and policy logging need the host every step and force one
  step a call. The step counting, lap detection and violation accounting
  follow the JAX harness exactly, and so do the printed rows.
- `simulate_mountaincar`, `simulate_cartpole` and `simulate_mujoco_on_device`
  (all 11 on-device MuJoCo tasks), through `_simulate_simple` (the same
  chunked loop, the action CSV).
`save_gif` writes a 10 fps gif of one frame a control step and `plot_traj`
draws the K sampled rollouts of each step (`harness/plotting.py`, imported
only then, as are matplotlib and imageio). Every trial shows a progress
line while it runs, on a terminal only.
"""

from __future__ import annotations

import os
import sys
import time
import warnings

import numpy as np
import torch

from mpopis_tpu_torch.harness.factory import get_policy
from mpopis_tpu_torch.harness.stats import SUMMARY_ROWS, summary_value
from mpopis_tpu_torch.models import (
    AntDeviceEnv,
    CarRacingEnv,
    CartPoleEnv,
    CheetahDeviceEnv,
    HopperDeviceEnv,
    HumanoidDeviceEnv,
    HumanoidStandupDeviceEnv,
    InvertedDoublePendulumDeviceEnv,
    InvertedPendulumDeviceEnv,
    MountainCarEnv,
    MultiCarRacingEnv,
    PusherDeviceEnv,
    ReacherDeviceEnv,
    SwimmerDeviceEnv,
    Walker2dDeviceEnv,
)
from mpopis_tpu_torch.models.base import done_mask
from mpopis_tpu_torch.policies.config import canonical_kind

_AIS_KINDS = {"imppi", "cemppi", "cmamppi", "muaismppi", "musigmaaismppi", "pmcmppi", "nesmppi"}
_LAMBDA_AIS_KINDS = {"muaismppi", "musigmaaismppi", "pmcmppi"}


def _print(enabled: bool, fmt: str, *args) -> None:
    if enabled:
        print(fmt % args if args else fmt, flush=True)


class _Progress:
    """Per-trial progress line (bar, step count, rate, ETA), redrawn in
    place at most ~10 times a second and erased at the end, only when
    printing is on and stdout is a terminal, so piped output stays clean."""

    def __init__(self, enabled: bool, trial: int, num_trials: int, total_steps: int):
        self.on = bool(enabled and sys.stdout.isatty() and total_steps > 0)
        self.trial = trial
        self.num_trials = num_trials
        self.total = total_steps
        self.t0 = time.perf_counter()
        self._last = 0.0

    def update(self, step: int) -> None:
        if not self.on:
            return
        now = time.perf_counter()
        if now - self._last < 0.1 and step < self.total:
            return
        self._last = now
        frac = min(step / self.total, 1.0)
        filled = int(frac * 20)
        rate = step / max(now - self.t0, 1e-9)
        eta = (self.total - step) / max(rate, 1e-9)
        sys.stdout.write(
            f"\rTrial {self.trial}/{self.num_trials} "
            f"[{'#' * filled}{'.' * (20 - filled)}] "
            f"{step}/{self.total} steps  {rate:5.1f}/s  ETA {eta:4.0f}s\x1b[K"
        )
        sys.stdout.flush()

    def finish(self) -> None:
        if self.on:
            sys.stdout.write("\r\x1b[K")
            sys.stdout.flush()


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
    """Control steps per host read-back. Gif rendering, trajectory plots,
    state noise and policy logging need the host every control step, so they
    force 1, even over an explicit request."""
    if needs_host_every_step:
        if steps_per_call is not None and steps_per_call > 1:
            warnings.warn(
                f"steps_per_call={steps_per_call} ignored: gif/plot/noise/logging need the "
                "host every control step; using 1",
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
    plot_traj_perc=1.0,
    save_gif=False,
    gif_name=None,
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
    inside a chunk are discarded, so both paths give the same rewards.

    `save_gif` draws one frame a control step: the MountainCar or CartPole
    scene, or for a MuJoCo task (which needs `plot_traj`; without it the gif
    is dropped with a warning) the K sampled rollouts over the executed
    trail. The gif is `gif_name` (default from the configuration) at 10 fps."""
    if seed is None:
        seed = _default_seed()
    if save_gif and sim_type not in ("MountainCar", "CartPole") and not plot_traj:
        warnings.warn(
            f"save_gif for {sim_type} needs plot_traj=True (sampled-trajectory overlays); "
            "disabling",
            stacklevel=2,
        )
        save_gif = False
    pol_log = pol_log or plot_traj
    chunk = _resolve_chunk(steps_per_call, needs_host_every_step=save_gif or pol_log)
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
        """`chunk` control steps; the rows, `done` included, stack on the
        device."""
        rows, its = [], 0
        for _ in range(chunk):
            act, ps, info = pol.step(s, ps)
            s2, r = env.step_reward(s, act)
            its += info["ais_its"]
            rows.append(torch.cat([
                torch.stack([r.to(env.dtype), done_mask(s2).to(env.dtype)]),
                act.to(env.dtype),
            ]))
            s = s2
        return s, ps, torch.stack(rows), its

    frames = [] if save_gif else None
    rews = np.zeros(num_trials)
    steps = np.zeros(num_trials)
    exec_times = np.zeros(num_trials)
    ais_iterations = np.zeros(num_trials)
    for k in range(1, num_trials + 1):
        ps = pol.init_state(seed + k)
        # a seeded random start where the task draws one (MountainCar, CartPole)
        s = env.reset(torch.Generator().manual_seed(seed + k)) if env.random_reset else env.reset()
        t0 = time.perf_counter()
        rew, cnt, done, its = 0.0, 0, False, 0
        acts: list[np.ndarray] = []
        trail: list[np.ndarray] = []  # executed states (plot_traj)
        prog = _Progress(print_output, k, num_trials, num_steps)
        while not done and cnt <= num_steps:
            prog.update(cnt)
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
            if plot_traj:
                trail.append(s.x.cpu().numpy())
            s, r_step = env.step_reward(s, act)
            its += info["ais_its"]
            rew += float(r_step)
            cnt += 1
            done = bool(s.done)
            if output_acts_file:
                acts.append(act.cpu().numpy().astype(np.float64))
            if frames is not None:
                from mpopis_tpu_torch.harness import plotting

                if plot_traj and "trajectories" in info:
                    # the sampled rollouts over the executed trail
                    fig = plotting.render_mujoco_trajectories(
                        sim_type.replace(" (on-device)", ""), trail + [s.x.cpu().numpy()],
                        info["trajectories"], info["weights"], plot_traj_perc,
                    )
                else:
                    render = {
                        "MountainCar": plotting.render_mountaincar,
                        "CartPole": plotting.render_cartpole,
                    }[sim_type]
                    fig = render(env, s)
                frames.append(plotting.figure_to_array(fig))
                plotting.close(fig)
        prog.finish()
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
    if frames:
        from mpopis_tpu_torch.harness import plotting

        if gif_name is None:
            gif_name = f"{sim_type}-{num_samples}-{horizon}-{lam}-{num_trials}.gif"
        plotting.save_gif(frames, gif_name, fps=10)
        _print(print_output, "Saved gif...%s", gif_name)
    return metrics


def simulate_mountaincar(**kwargs):
    """The reference's MountainCar example: `_simulate_simple` on
    `MountainCarEnv`, each trial from a random start seeded with seed + k.
    `dtype` and `device` (default cuda) place the run."""
    env = MountainCarEnv(dtype=kwargs.pop("dtype", torch.float32),
                         device=kwargs.pop("device", "cuda"))
    return _simulate_simple(env, "MountainCar", **kwargs)


def simulate_cartpole(**kwargs):
    """The reference's CartPole example: `_simulate_simple` on
    `CartPoleEnv`, each trial from a random start seeded with seed + k."""
    env = CartPoleEnv(dtype=kwargs.pop("dtype", torch.float32),
                      device=kwargs.pop("device", "cuda"))
    return _simulate_simple(env, "CartPole", **kwargs)


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
    "InvertedDoublePendulum-v4": InvertedDoublePendulumDeviceEnv,
    "InvertedPendulum-v4": InvertedPendulumDeviceEnv,
    "Pusher-v4": PusherDeviceEnv,
    "Reacher-v4": ReacherDeviceEnv,
    "Swimmer-v4": SwimmerDeviceEnv,
    "Walker2d-v4": Walker2dDeviceEnv,
}


def simulate_mujoco_on_device(task: str, **kwargs):
    """A MuJoCo task with on-device dynamics: the K×T rollouts of each
    control step run on the card (for the planar- and spatial-contact
    families, one kernel launch per AIS iteration; for the contact-free
    Reacher and pendulums, the plain batched rollout). Counterpart of the
    JAX package's `simulate_mujoco_on_device`, for all 11 tasks of
    ON_DEVICE_MUJOCO_TASKS. `solver_iters=(outer, cg)` sets the contact
    QP's fixed iteration counts (default (3, 6)); `dtype` and `device`
    (default cuda) place the run. Returns the metrics dict,
    `ais_iterations` and `control_steps_per_s` included."""
    if task not in PORTED_MUJOCO_TASKS:
        raise ValueError(
            f"no on-device dynamics for {task!r}; options {ON_DEVICE_MUJOCO_TASKS} "
            "(the host engine supports all 11 tasks: python -m mpopis_tpu_torch mujoco)"
        )
    solver_iters = kwargs.pop("solver_iters", None)
    if solver_iters is not None and task not in CONTACT_SOLVER_TASKS:
        raise ValueError(f"{task!r} has no contact solver (solver_iters)")
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
    plot_traj_perc=1.0,
    text_with_plot=True,
    text_on_plot_xy=(80.0, -60.0),
    save_gif=False,
    gif_name=None,
    track="curve",
    print_output=True,
    dtype=torch.float32,
    device="cuda",
    steps_per_call=None,
):
    """Race `num_trials` trials of up to `num_steps` control steps with
    `num_cars` cars (1..4 on the rollout kernel); trial k is seeded with
    seed + k, its state noise (one car only) drawn from numpy's
    `default_rng(seed + k)` in the JAX harness's order. Returns the metrics
    dict (one entry per trial in each array), including `ais_iterations`,
    the rollout calls made. `save_gif` writes a 10 fps gif of one frame a
    control step (the track, the cars and, with `text_with_plot`, car 1's
    telemetry); `plot_traj` draws the K sampled rollouts into each frame."""
    if seed is None:
        seed = _default_seed()
    sim_type = "mcr" if num_cars > 1 else "cr"
    if u0 is None:
        u0 = [0.0, 0.0] * num_cars
    if cov_mat is None:
        cov_mat = np.diag([0.0625, 0.1] * num_cars)
    if plot_traj:
        pol_log = True

    _banner(
        print_output, sim_type, policy_type, num_trials, num_steps, num_samples,
        horizon, lam, alpha, ais_its, lambda_ais, ce_elite_threshold,
        ce_sigma_est, cma_sigma, cma_elite_threshold, seed,
        extra=[("Num Cars:", num_cars), ("Max Num Laps:", laps)],
    )

    if num_cars > 1:
        env = MultiCarRacingEnv(num_cars=num_cars, dtype=dtype, device=device, track_name=track)
    else:
        env = CarRacingEnv(dtype=dtype, device=device, track_name=track)
    pol = get_policy(
        policy_type, env, num_samples, horizon, lam, alpha, u0, cov_mat,
        pol_log, ais_its, lambda_ais, ce_elite_threshold, ce_sigma_est,
        cma_sigma, cma_elite_threshold,
    )
    has_noise = sim_type == "cr" and bool(state_x_sigma or state_y_sigma or state_psi_sigma)
    chunk = _resolve_chunk(steps_per_call, needs_host_every_step=save_gif or has_noise or pol_log)
    frames = [] if save_gif else None

    def draw(s, info):
        """One frame of the stepped state (before any state noise)."""
        from mpopis_tpu_torch.harness import plotting

        fig = plotting.render_frame(
            env, s, info if plot_traj else None, plot_traj_perc,
            text_output=text_with_plot, text_xy=text_on_plot_xy,
        )
        if frames is not None:
            frames.append(plotting.figure_to_array(fig))
        plotting.close(fig)

    def stats_vec(s, rew):
        """Per-step bookkeeping packed into one tensor, so the host pays a
        single transfer per read: [rew, within, d, curr_y, vs(N), betas(N)]."""
        cars = s.x.reshape(num_cars, 8)
        within, _ = env.within_track(s)
        head = torch.stack([
            rew,
            within.to(rew.dtype),
            torch.min(torch.sqrt(cars[:, 0] ** 2 + cars[:, 1] ** 2)),
            torch.min(cars[:, 1]),
        ])
        vs = torch.sqrt(cars[:, 3] ** 2 + cars[:, 4] ** 2)
        betas = torch.abs(torch.atan2(cars[:, 4], cars[:, 3]))
        return torch.cat([head, vs, betas])

    def add_noise(s, rng):
        """Additive state noise for one car: x, y, ψ, then the velocity
        rotated by dψ, on the host in the state's dtype."""
        x = s.x.cpu().numpy().copy()
        x[0] += state_x_sigma * rng.standard_normal()
        x[1] += state_y_sigma * rng.standard_normal()
        dpsi = state_psi_sigma * rng.standard_normal()
        x[2] += dpsi
        rot = np.array([[np.cos(dpsi), np.sin(dpsi)], [-np.sin(dpsi), np.cos(dpsi)]])
        x[3:5] = rot @ x[3:5]
        return s.replace(x=env.tensor(x))

    def run_chunk(s, ps, rng):
        """`chunk` control steps (1 with a gif, plots or noise); the telemetry
        rows stack on the device and come back in one copy."""
        rows, its = [], 0
        for _ in range(chunk):
            act, ps, info = pol.step(s, ps)
            s = env.step(s, act)
            its += info["ais_its"]
            rew = env.reward(s)
            if frames is not None or plot_traj:
                draw(s, info)
            if has_noise:
                s = add_noise(s, rng)
            rows.append(stats_vec(s, rew))
        return s, ps, torch.stack(rows).cpu().numpy(), its

    header = f"Trial    #: {'Reward':>12} : {'Steps':>7}: {'Reward/Step':>12}"
    for ii in range(1, laps + 1):
        header += f" : {'lap ':>6}{ii}"
    header += f" : {'Mean V':>7} : {'Max V':>7} : {'Mean β':>7} : {'Max β':>7}"
    header += f" : {'β Viol':>7} : {'T Viol':>7}"
    if sim_type == "mcr":
        header += f" : {'C Viol':>7}"
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
        noise_rng = np.random.default_rng(seed + k)
        t0 = time.perf_counter()

        lap_time = np.zeros(laps, dtype=int)
        v_mean_log, v_max_log, b_mean_log, b_max_log = [], [], [], []
        rew, cnt, lap, prev_y = 0.0, 0, 0, 0.0
        trk_viol, b_viol, crash_viol, its = 0, 0, 0, 0
        done = False

        prog = _Progress(print_output, k, n_t, num_steps)
        while not done and cnt <= num_steps:
            prog.update(cnt)
            s, ps, stats_block, n_its = run_chunk(s, ps, noise_rng)
            its += n_its
            for stats in stats_block:
                if done or cnt > num_steps:
                    break  # steps run past the stop are discarded
                cnt += 1
                step_rew = float(stats[0])
                rew += step_rew
                within_t = bool(stats[1] != 0.0)
                d = float(stats[2])
                curr_y = float(stats[3])
                vs = stats[4 : 4 + num_cars]
                bs = stats[4 + num_cars :]
                v_mean_log.append(float(np.mean(vs)))
                v_max_log.append(float(np.max(vs)))
                b_mean_log.append(float(np.mean(bs)))
                b_max_log.append(float(np.max(bs)))

                # violation accounting
                if step_rew < -4000:
                    ex_b = bool(np.max(bs) > env.params.beta_limit)
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

        prog.finish()
        dt_s = time.perf_counter() - t0
        rews[k - 1] = rew
        steps[k - 1] = cnt - 1
        exec_times[k - 1] = dt_s
        lap_ts[:, k - 1] = lap_time
        mean_vs[k - 1] = np.mean(v_mean_log)
        max_vs[k - 1] = np.max(v_max_log)
        mean_bs[k - 1] = np.mean(b_mean_log)
        max_bs[k - 1] = np.max(b_max_log)
        b_viols[k - 1] = b_viol
        t_viols[k - 1] = trk_viol
        c_viols[k - 1] = crash_viol
        ais_iterations[k - 1] = its

        if log_runs:
            row = f"Trial {k:4d}: {rew:12.2f} : {cnt - 1:7d}: {rew / max(cnt - 1, 1):12.2f}"
            for ii in range(laps):
                row += f" : {lap_time[ii]:7d}"
            row += f" : {np.mean(v_mean_log):7.2f} : {np.max(v_max_log):7.2f}"
            row += f" : {np.mean(b_mean_log):7.2f} : {np.max(b_max_log):7.2f}"
            row += f" : {b_viol:7d} : {trk_viol:7d}"
            if sim_type == "mcr":
                row += f" : {crash_viol:7d}"
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
              "beta_violations", "track_violations"]
    if sim_type == "mcr":
        order.append("crash_violations")
    order.append("exec_times")
    _summary_table(print_output, metrics, order)

    if frames:
        from mpopis_tpu_torch.harness import plotting

        if gif_name is None:
            gif_name = (
                f"{sim_type}-{num_cars}-{canonical_kind(policy_type)}-{num_samples}-"
                f"{horizon}-{lam}-{alpha}-{ais_its}-{num_trials}-{laps}.gif"
            )
        plotting.save_gif(frames, gif_name, fps=10)
        _print(print_output, "Saved gif...%s", gif_name)
    return metrics
