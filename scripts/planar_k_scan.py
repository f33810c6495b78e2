"""Time the planar rollout kernels (csrc/planar_rollout.cu, csrc/swimmer_rollout.cu)
against the number of samples K and the lanes a sample, on the card.

For each build it runs the f32 rollout at the main path's T from the start
that chip_smoke.py times (the reset, chip_smoke's timed controls), at K = 1
(one sample alone), 132 (one an SM), 264, 528, the main path's K and twice
that, and prints the CUDA-event time of each (the mean of two launches
after one warm-up). `--lanes 4,8,16,32` builds one copy of the kernels per
width with PLANAR_LANES set, which gives every build that many lanes a
sample: the scan that chooses each build's width. Without it the kernels
run at their own widths.

    python scripts/planar_k_scan.py                          # all four builds
    python scripts/planar_k_scan.py --lanes 4,8,16,32 --only swimmer
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from planar_phase_times import (  # noqa: E402
    BUILDS,
    build_all,
    card,
    controls,
    lanes,
    launcher,
    ptxas,
    start_state,
)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=",".join(BUILDS), help="builds, comma-separated")
    ap.add_argument("--lanes", default="", help="widths to scan, comma-separated (default: "
                    "the builds' own)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("planar_k_scan: needs a CUDA card")
    print(card())
    which_all = args.only.split(",")
    kernels = sorted({BUILDS[w][1] for w in which_all})
    widths = [int(w) for w in args.lanes.split(",") if w] or [0]
    jobs = [(kernel, f"lanes{w}", (f"PLANAR_LANES={w}",) if w else (), False)
            for w in widths for kernel in kernels]
    libs = dict(zip([(job[0], job[1]) for job in jobs], build_all(jobs)))
    for (kernel, tag), (_, log) in libs.items():
        for line in ptxas(log):
            print(f"  ptxas ({kernel}, {tag}):", line)
    for which in which_all:
        cls, kernel, k_main, horizon = BUILDS[which][:4]
        env = cls(dtype=torch.float32, device="cuda")
        x = start_state(which, env, "reset")
        for w in widths:
            lib = libs[(kernel, f"lanes{w}")][0]
            times = []
            for k in (1, 132, 264, 528, k_main, 2 * k_main):
                ctrl = controls(which, env, k)
                costs = torch.empty(k, dtype=torch.float32, device="cuda")
                launch = launcher(lib, kernel, env, x, ctrl, costs)
                launch()
                torch.cuda.synchronize()
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
                for _ in range(2):
                    launch()
                t1.record()
                torch.cuda.synchronize()
                times.append(f"K={k} {t0.elapsed_time(t1) / 2:.3f}")
            n_lanes, warps = lanes(lib, kernel, env)
            print(f"{which} f32 T={horizon} from reset, W={n_lanes} ({warps} warps a block), ms: "
                  + ", ".join(times), flush=True)


if __name__ == "__main__":
    main()
