"""MuJoCo experiment driver on the host engine.

Counterpart of `mpopis_tpu/harness/simulate_mujoco.py` (the reference's
simulate_envpool_env, examples/envpool_example.jl): the per-trial banner,
text-file run logs, the action CSV for the gymnasium replay check and the
trial summary table. The K rollouts step the host engine
(`models/mujoco_host.py`); the policy math runs on `device`
(`policies/host_driver.py`).
"""

from __future__ import annotations

import os
import time

import numpy as np

from mpopis_tpu_torch.harness.simulate import _Progress, _banner, _print, _summary_table
from mpopis_tpu_torch.models.mujoco_host import MujocoBatchedEnv
from mpopis_tpu_torch.policies.config import PolicyConfig
from mpopis_tpu_torch.policies.host_driver import make_host_policy


def simulate_mujoco(
    env_name: str = "HalfCheetah-v4",
    *,
    frame_skip: int = 5,
    num_trials: int = 1,
    num_steps: int = 200,
    policy_type: str = "cemppi",
    num_samples: int = 150,
    horizon: int = 50,
    lam: float = 1.0,
    alpha: float = 1.0,
    u0=None,
    cov_mat=None,
    ais_its: int = 10,
    lambda_ais: float = 20.0,
    ce_elite_threshold: float = 0.8,
    ce_sigma_est: str = "ss",
    cma_sigma: float = 0.75,
    cma_elite_threshold: float = 0.8,
    seed: int | None = None,
    log_runs: bool = False,
    output_acts_file: bool = False,
    acts_dir: str = "acts",
    log_dir: str = "logs",
    native: bool = True,
    print_output: bool = True,
    device="cuda",
):
    """Ref: envpool_example.jl:1-269. The defaults are the reference's
    simulate_envpool_env's; its README baseline run is
    simulate_mujoco("HalfCheetah-v4", frame_skip=5, num_steps=50,
    num_trials=2, num_samples=100, horizon=50, ais_its=5, seed=1,
    cov_mat=0.25*np.eye(6)). `device` (default cuda) runs the policy math;
    the environments step on the host. Returns the metrics dict,
    `control_steps_per_s` included."""
    if seed is None:
        seed = int(np.random.randint(1, 10**10))

    probe = MujocoBatchedEnv(env_name, num_envs=1, frame_skip=frame_skip, native=native)
    as_ = probe.action_dim
    probe.close()
    if u0 is None:
        u0 = np.zeros(as_)
    if cov_mat is None:
        cov_mat = 0.25 * np.eye(as_)

    fname = (
        f"{env_name}_{frame_skip}_{policy_type}_{num_steps}_{num_trials}"
        f"_{seed}_{horizon}_{lam}_{alpha}_{np.asarray(u0).ravel()[0]}"
        f"_{np.asarray(cov_mat).ravel()[0]}_{num_samples}_{ais_its}"
    )
    _banner(
        print_output, env_name, policy_type, num_trials, num_steps, num_samples,
        horizon, lam, alpha, ais_its, lambda_ais, ce_elite_threshold,
        ce_sigma_est, cma_sigma, cma_elite_threshold, seed,
        extra=[("Frame Skip:", frame_skip)],
    )
    _print(print_output, "Trial    #: %12s : %7s: %12s : %7s",
           "Reward", "Steps", "Reward/Step", "Ex Time")

    log_path = None
    if log_runs:
        os.makedirs(log_dir, exist_ok=True)
        log_path = os.path.join(log_dir, fname + ".txt")
        with open(log_path, "w") as f:
            f.write(f"{env_name} {policy_type} K={num_samples} H={horizon} seed={seed}\n")

    rews = np.zeros(num_trials)
    steps = np.zeros(num_trials)
    exec_times = np.zeros(num_trials)

    for k in range(1, num_trials + 1):
        env = MujocoBatchedEnv(
            env_name, num_envs=num_samples, frame_skip=frame_skip, native=native
        )
        cfg = PolicyConfig(
            kind=policy_type,
            num_samples=num_samples,
            horizon=horizon,
            lam=lam,
            alpha=alpha,
            opt_its=ais_its,
            lambda_ais=lambda_ais,
            ce_elite_threshold=ce_elite_threshold,
            sigma_est=str(ce_sigma_est).lstrip(":"),
            cma_sigma=cma_sigma,
            cma_elite_threshold=cma_elite_threshold,
        )
        pol = make_host_policy(env, cfg, u0=u0, cov_mat=cov_mat, device=device)
        ps = pol.init_state(seed + k)

        t0 = time.perf_counter()
        rew, cnt = 0.0, 0
        prog = _Progress(print_output, k, num_trials, num_steps)
        while cnt <= num_steps:
            prog.update(cnt)
            act, ps, _ = pol.step(ps)
            env.step(act)  # broadcast + record (ref envpool_env.jl:136-151)
            cnt += 1
            rew += float(env.rews[0])
        prog.finish()
        dt = time.perf_counter() - t0

        rews[k - 1] = rew
        steps[k - 1] = cnt - 1
        exec_times[k - 1] = dt
        row = (
            f"Trial {k:4d}: {rew:12.2f} : {cnt - 1:7d}: "
            f"{rew / max(cnt - 1, 1):12.2f} : {dt:7.2f}"
        )
        _print(print_output, row)
        if log_path:
            with open(log_path, "a") as f:
                f.write(row + "\n")
        if output_acts_file:
            os.makedirs(acts_dir, exist_ok=True)
            env.write_acts_to_file(os.path.join(acts_dir, fname + f"trial-{k}"))
        env.close()

    metrics = {
        "rewards": rews,
        "steps": steps,
        "rewards_per_step": rews / np.maximum(steps, 1),
        "exec_times": exec_times,
        "control_steps_per_s": steps / np.maximum(exec_times, 1e-9),
    }
    _print(print_output, "-----------------------------------")
    _summary_table(print_output, metrics,
                   ["rewards", "steps", "rewards_per_step", "exec_times"])
    if log_path:
        with open(log_path, "a") as f:
            for name in ("rewards", "steps", "rewards_per_step", "exec_times"):
                f.write(f"{name}: {metrics[name].tolist()}\n")
    return metrics
