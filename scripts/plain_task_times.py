"""Control-step and env-step times, and device operations, of the tasks whose
rollouts are plain PyTorch on the card: the Reacher, the two inverted
pendulums, MountainCar and CartPole (none has a hand-written kernel).

For each task, at chip_smoke.py's configuration (CEMPPI `mle`, float32):
the median host time (synchronised) of a control step (policy step and env
step) over `--steps` steps after two of warm-up, the median of the env
step alone, and the device operations (kernels and copies) of one policy
step and one env step, counted from a torch.profiler trace of the device.

    python scripts/plain_task_times.py
    python scripts/plain_task_times.py --tasks Reacher-v4 --steps 10

Needs a CUDA card; prints one line per task and a JSON line last.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from mpopis_tpu_torch.harness.simulate import PORTED_MUJOCO_TASKS  # noqa: E402
from mpopis_tpu_torch.models import CartPoleEnv, MountainCarEnv  # noqa: E402
from mpopis_tpu_torch.policies import PolicyConfig, make_policy  # noqa: E402

# task: (K, H, AIS iterations, λ, Σ per action), as chip_smoke.py runs them
CONFIGS = {
    "Reacher-v4": (8192, 15, 3, 0.05, 0.02),
    "InvertedDoublePendulum-v4": (32, 15, 2, 0.1, 0.1),
    "InvertedPendulum-v4": (32, 15, 2, 0.1, 0.1),
    "MountainCar": (20, 15, 5, 0.1, 1.5),
    "CartPole": (20, 15, 5, 0.1, 1.5),
}


def _device_ops(fn) -> int | None:
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = sum(e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA)
    return n or None


def _median_ms(fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def measure(task: str, steps: int) -> dict:
    k, horizon, its, lam, sigma = CONFIGS[task]
    cls = {"MountainCar": MountainCarEnv, "CartPole": CartPoleEnv}.get(task)
    env = (cls or PORTED_MUJOCO_TASKS[task])(dtype=torch.float32, device="cuda")
    cfg = PolicyConfig(kind="cemppi", num_samples=k, horizon=horizon, lam=lam, opt_its=its,
                       sigma_est="mle")
    pol = make_policy(env, cfg, cov_mat=[sigma] * env.action_dim)
    box = {"s": env.reset(), "ps": pol.init_state(1), "a": None}

    def control_step():
        box["a"], box["ps"], _ = pol.step(box["s"], box["ps"])
        box["s"] = env.step(box["s"], box["a"])

    for _ in range(2):
        control_step()
    step_ms = _median_ms(control_step, steps)
    env_ms = _median_ms(lambda: env.step(box["s"], box["a"]), steps)
    return {
        "task": task, "K": k, "H": horizon, "its": its,
        "control_step_ms": step_ms, "env_step_ms": env_ms,
        "policy_step_device_ops": _device_ops(lambda: pol.step(box["s"], box["ps"])),
        "env_step_device_ops": _device_ops(lambda: env.step(box["s"], box["a"])),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tasks", default=",".join(CONFIGS),
                    help=f"comma-separated, of {','.join(CONFIGS)}")
    ap.add_argument("--steps", type=int, default=5, help="timed control steps per task")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("plain_task_times: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    rows = []
    for task in args.tasks.split(","):
        r = measure(task.strip(), args.steps)
        rows.append(r)
        print(f"{r['task']} K={r['K']} H={r['H']} {r['its']} its: control step "
              f"{r['control_step_ms']:.3f} ms, env step {r['env_step_ms']:.3f} ms (medians, host "
              f"clock, synchronised); device operations: policy step "
              f"{r['policy_step_device_ops']}, env step {r['env_step_device_ops']} ({card})")
    print(json.dumps({"card": card, "tasks": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
