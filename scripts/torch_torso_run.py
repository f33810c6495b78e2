"""The torso's height along a 50-step closed-loop run of the PyTorch port's
on-device Humanoid-v4, beside a zero-action run from the same reset.

    python scripts/torch_torso_run.py --f64            # the kernel path on the card
    python scripts/torch_torso_run.py --device cpu --f64 --samples 64
                                                       # the plain PyTorch path

It runs `simulate_mujoco_on_device("Humanoid-v4")` at the JAX bench's
configuration (CEMPPI, H=8, 2 AIS iterations, `mle`, λ=1.0, Σ=0.25·I₁₇,
contact solver (3, 6), seed 1; K from `--samples`), replays the executed
actions through the env's step to read the torso's height, and prints it
every 5 steps with the zero action's, then the reward per step of both
runs. On the CPU every rollout and step is the plain PyTorch version; on a
CUDA device they are the spatial kernel's."""

import argparse
import os
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mpopis_tpu_torch.harness.simulate import simulate_mujoco_on_device  # noqa: E402
from mpopis_tpu_torch.models import HumanoidDeviceEnv  # noqa: E402

STEPS = 50


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--f64", action="store_true", help="float64 (default float32)")
    ap.add_argument("--samples", type=int, default=1024)
    args = ap.parse_args(argv)
    torch.set_num_threads(min(4, torch.get_num_threads()))
    dtype = torch.float64 if args.f64 else torch.float32

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as acts_dir:
        m = simulate_mujoco_on_device(
            "Humanoid-v4", num_trials=1, num_steps=STEPS, num_samples=args.samples, horizon=8,
            lam=1.0, ais_its=2, ce_sigma_est="mle", seed=1, device=args.device, dtype=dtype,
            output_acts_file=True, acts_dir=acts_dir, print_output=False,
        )
        (csv,) = [os.path.join(acts_dir, f) for f in os.listdir(acts_dir)]
        acts = np.loadtxt(csv, delimiter=",", ndmin=2)[:STEPS]
    run_s = time.perf_counter() - t0

    env = HumanoidDeviceEnv(dtype=dtype, device=args.device)
    s = s0 = env.reset()
    zero = torch.zeros(env.action_dim, dtype=dtype, device=args.device)
    zero_reward = 0.0
    print(f"Humanoid-v4 K={args.samples} H=8 2 its, {str(dtype)[6:]} on {args.device}: "
          f"{len(acts)} steps in {run_s:.1f} s")
    print(f"step {0:3d}: torso z {float(s.x[2]):.4f}, zero action {float(s0.x[2]):.4f}")
    for i, a in enumerate(acts, 1):
        s = env.step(s, torch.as_tensor(a, dtype=dtype, device=args.device))
        s0, r0 = env.step_reward(s0, zero)
        zero_reward += float(r0)
        if i % 5 == 0 or i == len(acts):
            print(f"step {i:3d}: torso z {float(s.x[2]):.4f}, zero action {float(s0.x[2]):.4f}")
    print(f"reward per step {float(m['rewards_per_step'][0]):.4f}, zero action "
          f"{zero_reward / len(acts):.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
