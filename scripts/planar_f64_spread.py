"""Per-sample f64 agreement of the planar rollout kernels
(csrc/planar_rollout.cu, csrc/swimmer_rollout.cu) with their plain PyTorch
version, beside the plain version's own spreads on the same inputs.

For each case it prints, over the samples, the kernel's relative error
|kernel - plain| / |plain| and the plain version's own spread: the most it
moves under controls * (1 +- 1e-15), x0 * (1 + 1e-15) and on the CPU (another
association of the same sums). Then the samples that break the rule of
tests/test_torch_cuda.py's `_hold_f64`, err <= max(1e-9, 10 * own), each with
its spread, and how many break its pooled form (own: the largest spread of
any sample of the case), which the tests apply to Walker2d. The cases are
the card tests' (2 control steps from the lowered start at K = 33 and 63,
from the deep drop at K = 64), so that the kernel and the one it replaces
can be run on the same inputs: the script uses no interface of the package
beyond the wrappers' entries. `--no-fma` builds the kernels with
-fmad=false (no multiply-add contracted into an FMA), to see which samples
follow the kernel's rounding.

    python scripts/planar_f64_spread.py
    python scripts/planar_f64_spread.py --no-fma --only walker2d
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from mpopis_tpu_torch.kernels import build, planar_step  # noqa: E402
from mpopis_tpu_torch.models import (  # noqa: E402
    CheetahDeviceEnv,
    HopperDeviceEnv,
    SwimmerDeviceEnv,
    Walker2dDeviceEnv,
)

ENVS = {"cheetah": CheetahDeviceEnv, "hopper": HopperDeviceEnv, "walker2d": Walker2dDeviceEnv,
        "swimmer": SwimmerDeviceEnv}
# x[1] of the lowered (tests/test_torch_cuda.py's LOWERED) and deep (DEEP) starts
Z = {"lowered": {"cheetah": -0.35, "hopper": 1.15, "walker2d": 1.17},
     "deep": {"cheetah": -0.7, "walker2d": 0.2}}
_LIM = float(np.deg2rad(100.0))
SWIMMER_LIMITS = (0.1, -0.2, 0.3, 1.03 * _LIM, -1.04 * _LIM, 0.5, -0.4, 1.0, 2.0, -1.5)
CASES = [(which, start, k) for which in ENVS for start, k in (("lowered", 33), ("lowered", 63))]
CASES += [("cheetah", "deep", 64), ("walker2d", "deep", 64)]


def case(which: str, start: str, k: int):
    env = ENVS[which](dtype=torch.float64, device="cuda")
    x = env.reset().x.clone()
    if which == "swimmer":
        x = torch.tensor(SWIMMER_LIMITS, dtype=torch.float64, device="cuda")
    else:
        x[1] = Z[start][which]
    ctrl = np.random.default_rng(k).uniform(-1.0, 1.0, (2, env.action_dim, k))
    return env, x, torch.as_tensor(ctrl, dtype=torch.float64, device="cuda")


def rel(a: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    return ((a.double().cpu() - want) / want).abs()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=",".join(ENVS), help="builds, comma-separated")
    ap.add_argument("--no-fma", action="store_true", help="build with -fmad=false")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("planar_f64_spread: needs a CUDA card")
    if args.no_fma:
        build.NVCC_FLAGS = build.NVCC_FLAGS + ("-fmad=false",)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    ref = planar_step.planar_rollout_costs_tak_reference
    for which, start, k in CASES:
        if which not in args.only.split(","):
            continue
        env, x0, ctrl = case(which, start, k)
        kern = (planar_step.swimmer_rollout_costs_tak if which == "swimmer"
                else planar_step.planar_rollout_costs_tak)
        want = ref(env, x0, ctrl).cpu()
        err = rel(kern(env, x0, ctrl), want)
        cpu_env = type(env)(dtype=torch.float64, device="cpu")
        own = torch.stack([rel(ref(env, x0, ctrl * (1 + 1e-15)), want),
                           rel(ref(env, x0, ctrl * (1 - 1e-15)), want),
                           rel(ref(env, x0 * (1 + 1e-15), ctrl), want),
                           rel(ref(cpu_env, x0.cpu(), ctrl.cpu()), want)]).amax(0)
        bad = (err > torch.clamp(10 * own, min=1e-9)).nonzero().flatten().tolist()
        pooled = int((err > torch.clamp(10 * own.max(), min=1e-9)).sum())
        print(f"{which} {start} K={k} T=2: kernel err median {float(err.median()):.3e} max "
              f"{float(err.max()):.3e}; plain's own spread median {float(own.median()):.3e} max "
              f"{float(own.max()):.3e}; {len(bad)} of {k} samples break the rule, {pooled} its "
              f"pooled form")
        for i in bad:
            print(f"  sample {i}: err {float(err[i]):.3e}, own {float(own[i]):.3e}")


if __name__ == "__main__":
    main()
