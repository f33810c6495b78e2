"""Per-sample f64 agreement of the spatial-contact rollout kernel
(csrc/spatial_rollout.cu) with its plain PyTorch version, beside the plain
version's own spreads on the same inputs.

For each case it prints, over the samples, the kernel's relative error
|kernel - plain| / |plain| and three spreads of the plain version itself:
under controls * (1 + 1e-15) (the nudge rule of tests/test_torch_cuda.py),
the largest under controls * (1 +- 1e-15) and x0 * (1 + 1e-15), and between
the plain version on the card and on the CPU (another association of the
same sums). Then the samples that break the nudge rule
err <= max(1e-9, 10 * own), each with its spreads. The cases are those of
the card tests for partial warp counts and for rows that wrap over the
lanes.

    python scripts/spatial_f64_spread.py
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from mpopis_tpu_torch.kernels import spatial_step  # noqa: E402
from mpopis_tpu_torch.models import (  # noqa: E402
    AntDeviceEnv,
    HumanoidDeviceEnv,
    HumanoidStandupDeviceEnv,
    humanoid_device,
)


def ant_case(k: int):
    env = AntDeviceEnv(dtype=torch.float64, device="cuda")
    x = env.reset().x.clone()
    x[2] = 0.75 - 0.45  # the grounded start
    ctrl = np.random.default_rng(k).uniform(-1.0, 1.0, (2, env.action_dim, k))
    return env, x, ctrl


def pressed_case(which: str):
    """The Standup's supine reset pressed 2 cm into the floor: more valid rows
    than a warp has lanes."""
    cls = HumanoidDeviceEnv if which == "humanoid" else HumanoidStandupDeviceEnv
    env = cls(dtype=torch.float64, device="cuda")
    x = HumanoidStandupDeviceEnv(dtype=torch.float64, device="cuda").reset().x.clone()
    x[2] -= 0.02
    if which == "humanoid":
        x[-1] = humanoid_device.com_x(x[:24].cpu())
    return env, x, np.random.default_rng(8).uniform(-0.4, 0.4, (2, 17, 64))


CASES = {
    "ant grounded K=33": lambda: ant_case(33),
    "ant grounded K=1023": lambda: ant_case(1023),
    "humanoid pressed K=64": lambda: pressed_case("humanoid"),
    "standup pressed K=64": lambda: pressed_case("standup"),
}


def rel(a: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    return ((a.double().cpu() - want) / want).abs()


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("spatial_f64_spread: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    ref = spatial_step.spatial_rollout_costs_tak_reference
    for label, make in CASES.items():
        env, x0, ctrl_np = make()
        ctrl = torch.as_tensor(ctrl_np, dtype=torch.float64, device="cuda")
        want = ref(env, x0, ctrl).cpu()
        err = rel(spatial_step.spatial_rollout_costs_tak(env, x0, ctrl), want)
        nudge = rel(ref(env, x0, ctrl * (1 + 1e-15)), want)
        others = torch.stack([nudge, rel(ref(env, x0, ctrl * (1 - 1e-15)), want),
                              rel(ref(env, x0 * (1 + 1e-15), ctrl), want)]).amax(0)
        cpu_env = type(env)(dtype=torch.float64, device="cpu")
        cpu = rel(ref(cpu_env, x0.cpu(), ctrl.cpu()), want)
        bad = (err > torch.clamp(10 * nudge, min=1e-9)).nonzero().flatten().tolist()
        print(f"{label}: kernel err median {float(err.median()):.3e} max {float(err.max()):.3e}; "
              f"plain nudge median {float(nudge.median()):.3e} max {float(nudge.max()):.3e}; "
              f"plain 3 nudges max {float(others.max()):.3e}; plain card vs CPU median "
              f"{float(cpu.median()):.3e} max {float(cpu.max()):.3e}; "
              f"{len(bad)} of {len(err)} samples break the nudge rule")
        for i in bad:
            print(f"  sample {i}: err {float(err[i]):.3e}, nudge {float(nudge[i]):.3e}, "
                  f"3 nudges {float(others[i]):.3e}, card vs CPU {float(cpu[i]):.3e}")


if __name__ == "__main__":
    main()
