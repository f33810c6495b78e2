"""Time the spatial-contact rollout kernel (csrc/spatial_rollout.cu) against
the number of samples K, one warp each, on the card.

For each build it runs the f32 rollout at the main path's T from the start
that chip_smoke.py times, at K = 1 (one sample alone), 132 (one an SM), 264,
528 (four an SM, one a scheduler), 792, 924, 1024 (the main path's) and
2048, and prints the CUDA-event time of each (the mean of two launches after
one warm-up): how the time of a sample grows with the samples that share an
SM.

    python scripts/spatial_k_scan.py                 # all four builds
    python scripts/spatial_k_scan.py --only humanoid
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from spatial_phase_times import BUILDS, start_state  # noqa: E402

from mpopis_tpu_torch.kernels import spatial_step  # noqa: E402

KS = (1, 132, 264, 528, 792, 924, 1024, 2048)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=",".join(BUILDS), help="builds, comma-separated")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("spatial_k_scan: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    for which in args.only.split(","):
        cls, _, horizon, _, _, start, hi, seed = BUILDS[which]
        env = cls(dtype=torch.float32, device="cuda")
        x = start_state(which, env, start).contiguous()
        times = []
        for k in KS:
            ctrl = torch.as_tensor(
                np.random.default_rng(seed).uniform(-hi, hi, (horizon, env.action_dim, k)),
                dtype=torch.float32, device="cuda")
            spatial_step.spatial_rollout_costs_tak(env, x, ctrl)
            torch.cuda.synchronize()
            t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(2):
                spatial_step.spatial_rollout_costs_tak(env, x, ctrl)
            t1.record()
            torch.cuda.synchronize()
            times.append(f"K={k} {t0.elapsed_time(t1) / 2:.3f}")
        print(f"{which} f32 T={horizon} from {start}, ms: " + ", ".join(times), flush=True)


if __name__ == "__main__":
    main()
