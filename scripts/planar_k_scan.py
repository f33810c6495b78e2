"""Time the planar rollout kernels (csrc/planar_rollout.cu, csrc/swimmer_rollout.cu)
against the number of samples K and the lanes a sample, on the card; or,
with --source, hold other copies of the kernels against the tree's, bit for
bit, and time them in turns.

Without --source, for each build it runs the f32 rollout at the main path's
T from the start that chip_smoke.py times (the reset, chip_smoke's timed
controls), at K = 1 (one sample alone), 132 (one an SM), 264, 528, the main
path's K and twice that, and prints the CUDA-event time of each (the mean
of two launches after one warm-up). `--lanes 4,8,16,32` builds one copy of
the kernels per width with PLANAR_LANES set, which gives every build that
many lanes a sample: the scan that chooses each build's width. Without it
the kernels run at their own widths.

With --source, it builds each given copy of the kernels (a directory
holding its planar_rollout.cu, swimmer_rollout.cu and their headers, as a
parent's csrc unpacked under a directory that .gitignore lists) beside the
tree's, each with a query of the builds' occupancy appended. For each build
it prints, per copy and f32 and f64, the lanes a sample, the warps a block,
the warps resident on an SM, the workspace bytes a sample and the registers
and local bytes a thread, and each copy's ptxas lines (registers and spill
bytes per entry). Then, f32 and f64, from chip_smoke's start, the dropped
start, a deep one past the QP's 32 dense rows (HalfCheetah, Walker2d) and
the state that --steps control steps of the main path's CEMPPI reach, it
runs every copy's rollout at the main path's K and T and its step entry on
K states near that state, and prints the largest difference of the costs
and of the states against the tree's (0: bit-equal). Last it
times the f32 rollouts at the main path's K and T (from the main-path state)
and the one-state step entry, copies in turns (first to last, then last to
first), and prints each copy's median and range. `cheetah_k100` is the
HalfCheetah at the upstream recipe's K = 100, T = 50.

    python scripts/planar_k_scan.py                          # all five builds
    python scripts/planar_k_scan.py --lanes 4,8,16,32 --only swimmer
    python scripts/planar_k_scan.py --source _export/parent/mpopis_tpu_torch/csrc

The copies are built under mpopis_tpu_torch/_build/phase_times/ with the
flags of kernels/build.py; the kernels themselves are not changed.
"""

from __future__ import annotations

import argparse
import ctypes
import sys
from pathlib import Path

import numpy as np
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
    main_path_state,
    ptxas,
    start_state,
)
from spatial_k_scan import largest_difference, timed  # noqa: E402

from mpopis_tpu_torch.kernels import build, planar_step  # noqa: E402

# The occupancy query appended to each copy: for the build of (n_dof, rk4) and
# f64, out = [lanes a sample, warps a block, resident warps an SM, workspace
# bytes a sample, registers a thread, local bytes a thread].
_OCCUPANCY_OF = """
template <typename MT, typename T, int N, bool FLUID, bool EULER, int R, int W>
static int k_scan_occupancy_of(int* out) {
  using B = planar::Build<MT, T, N, FLUID, EULER, R, W>;
  const auto kern = planar::rollout_kernel<MT, T, N, FLUID, EULER, R, W>;
  const int warps = B::warps();
  int blocks = 0;
  cudaFuncAttributes attr;
  if (warps < 1 ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, 32 * warps,
                                                    (32 / W) * warps * B::kWork) != cudaSuccess ||
      cudaFuncGetAttributes(&attr, kern) != cudaSuccess)
    return 1;
  out[0] = W;
  out[1] = warps;
  out[2] = blocks * warps;
  out[3] = B::kWork;
  out[4] = attr.numRegs;
  out[5] = static_cast<int>(attr.localSizeBytes);
  return 0;
}
"""
OCCUPANCY = {
    "planar": _OCCUPANCY_OF + """
template <typename T>
static int k_scan_occupancy_t(int n_dof, int rk4, int* out) {
  using planar::Model;
  if (n_dof == 9 && !rk4)
    return k_scan_occupancy_of<Model<T>, T, 9, false, true, planar::kCheetahRows, kCheetahLanes>(out);
  if (n_dof == 9 && rk4)
    return k_scan_occupancy_of<Model<T>, T, 9, false, false, planar::kWalkerRows, kWalkerLanes>(out);
  if (n_dof == 6 && rk4)
    return k_scan_occupancy_of<Model<T>, T, 6, false, false, planar::kHopperRows, kHopperLanes>(out);
  return 1;
}
extern "C" int k_scan_occupancy(int n_dof, int rk4, int f64, int* out) {
  return f64 ? k_scan_occupancy_t<double>(n_dof, rk4, out)
             : k_scan_occupancy_t<float>(n_dof, rk4, out);
}
""",
    "swimmer": _OCCUPANCY_OF + """
template <typename T>
static int k_scan_occupancy_t(int* out) {
  return k_scan_occupancy_of<planar::FluidModel<T>, T, 5, true, false, planar::kSwimmerRows,
                             kSwimmerLanes>(out);
}
extern "C" int k_scan_occupancy(int n_dof, int rk4, int f64, int* out) {
  if (n_dof != 5 || !rk4) return 1;
  return f64 ? k_scan_occupancy_t<double>(out) : k_scan_occupancy_t<float>(out);
}
""",
}


def scan(which_all: list[str], widths: list[int]) -> None:
    kernels = sorted({BUILDS[w].kernel for w in which_all})
    jobs = [(kernel, f"lanes{w}", (f"PLANAR_LANES={w}",) if w else (), False)
            for w in widths for kernel in kernels]
    libs = dict(zip([(job[0], job[1]) for job in jobs], build_all(jobs)))
    for (kernel, tag), (_, log) in libs.items():
        for line in ptxas(log):
            print(f"  ptxas ({kernel}, {tag}):", line)
    for which in which_all:
        b = BUILDS[which]
        env = b.env(dtype=torch.float32, device="cuda")
        x = start_state(which, env, "reset")
        for w in widths:
            lib = libs[(b.kernel, f"lanes{w}")][0]
            times = []
            for k in (1, 132, 264, 528, b.k, 2 * b.k):
                ctrl = controls(which, env, k)
                costs = torch.empty(k, dtype=torch.float32, device="cuda")
                launch = launcher(lib, b.kernel, env, x, ctrl, costs)
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
            n_lanes, warps = lanes(lib, b.kernel, env)
            print(f"{which} f32 T={b.horizon} from reset, W={n_lanes} ({warps} warps a block), "
                  "ms: " + ", ".join(times), flush=True)


class Copy:
    """One copy's kernels (planar, swimmer), each built with the occupancy
    query appended."""

    def __init__(self, source: Path, libs: dict):
        self.source = source.resolve()
        self.libs = {kernel: lib for kernel, (lib, _) in libs.items()}
        self.logs = {kernel: log for kernel, (_, log) in libs.items()}
        for lib in self.libs.values():
            lib.k_scan_occupancy.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
            lib.k_scan_occupancy.restype = ctypes.c_int

    def occupancy(self, kernel: str, env, f64: int) -> list[int]:
        out = (ctypes.c_int * 6)()
        m = env.MODEL
        if self.libs[kernel].k_scan_occupancy(m.n_dof, int(m.integrator == "rk4"), f64, out):
            raise RuntimeError(f"{self.source}: the occupancy query failed")
        return list(out)

    def rollout(self, kernel: str, env, x, ctrl, out):
        ints, dbl = planar_step._env_model(env)
        suffix = "f64" if x.dtype == torch.float64 else "f32"
        fn = getattr(self.libs[kernel], f"{kernel}_rollout_costs_{suffix}")
        rc = fn(ints, len(ints), dbl, len(dbl), x.data_ptr(), ctrl.data_ptr(), out.data_ptr(),
                ctrl.shape[2], ctrl.shape[0], torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{self.source}: rollout launch failed, CUDA error {rc}")
        return out

    def step(self, kernel: str, env, xs, acts, out):
        ints, dbl = planar_step._env_model(env)
        suffix = "f64" if xs.dtype == torch.float64 else "f32"
        fn = getattr(self.libs[kernel], f"{kernel}_step_states_{suffix}")
        rc = fn(ints, len(ints), dbl, len(dbl), xs.data_ptr(), acts.data_ptr(), out.data_ptr(),
                xs.shape[0], torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{self.source}: step launch failed, CUDA error {rc}")
        return out


def compare(copies: list[Copy], which_all: list[str], steps: int, rounds: int) -> None:
    print("copies:", ", ".join(f"[{i}] {c.source}" for i, c in enumerate(copies)))
    for i, c in enumerate(copies):
        for kernel, log in c.logs.items():
            for line in ptxas(log):
                print(f"  [{i}] ptxas ({kernel}):", line[:200])
    for which in which_all:
        b = BUILDS[which]
        env = b.env(dtype=torch.float32, device="cuda")
        for f64 in (0, 1):
            print(f"{which} f{64 if f64 else 32}: " + "; ".join(
                "[{}] W={}, {} warps a block, {} resident an SM, {} B a sample, {} registers, "
                "{} local B".format(i, *c.occupancy(b.kernel, env, f64))
                for i, c in enumerate(copies)), flush=True)
    for which in which_all:
        b = BUILDS[which]
        env32 = b.env(dtype=torch.float32, device="cuda")
        na = env32.action_dim
        main = f"main path after {steps} steps"
        kinds = ("reset", "dropped") + (("deep",) if b.deep is not None else ())
        starts = {s: start_state(which, env32, s) for s in kinds}
        starts[main] = main_path_state(which, env32, steps)
        rng = np.random.default_rng(b.seed)
        acts64 = rng.uniform(-1.2, 1.2, (b.k, na))
        for dtype in (torch.float32, torch.float64):
            env = b.env(dtype=dtype, device="cuda")
            ctrl = controls(which, env, dtype=dtype)
            acts = torch.as_tensor(acts64, dtype=dtype, device="cuda")
            for label, x0 in starts.items():
                x = x0.to(dtype).contiguous()
                noise = torch.as_tensor(rng.uniform(-0.01, 0.01, (b.k, x.numel())), dtype=dtype,
                                        device="cuda")
                xs = (x + noise).contiguous()
                costs = [c.rollout(b.kernel, env, x, ctrl,
                                   torch.empty(b.k, dtype=dtype, device="cuda")) for c in copies]
                states = [c.step(b.kernel, env, xs, acts, torch.empty_like(xs)) for c in copies]
                torch.cuda.synchronize()
                print(f"{which} {str(dtype)[6:]} K={b.k} T={b.horizon} from {label}: " + "; ".join(
                    f"[{i}] costs {largest_difference(costs[i], costs[0])}, step states "
                    f"{largest_difference(states[i], states[0])}"
                    for i in range(1, len(copies))), flush=True)
        if rounds < 1:
            continue
        x = starts[main]
        ctrl = controls(which, env32)
        act1 = torch.as_tensor(acts64[:1], dtype=torch.float32, device="cuda")
        costs = torch.empty(b.k, dtype=torch.float32, device="cuda")
        out1 = torch.empty_like(x[None])
        roll = [[] for _ in copies]
        step = [[] for _ in copies]
        for c in copies:  # warm-up
            c.rollout(b.kernel, env32, x, ctrl, costs)
            c.step(b.kernel, env32, x[None], act1, out1)
        torch.cuda.synchronize()
        for r in range(rounds):
            order = range(len(copies)) if r % 2 == 0 else reversed(range(len(copies)))
            for i in order:
                c = copies[i]
                roll[i].append(timed(lambda: c.rollout(b.kernel, env32, x, ctrl, costs)))
                step[i].append(timed(lambda: c.step(b.kernel, env32, x[None], act1, out1), 10))
        for name, ms in (("rollout", roll), ("one-state step entry", step)):
            print(f"{which} f32 {name} K={b.k} T={b.horizon} from the main path's state, ms a "
                  f"launch over {rounds} rounds: " + "; ".join(
                      f"[{i}] median {np.median(t):.4f} ({min(t):.4f}-{max(t):.4f})"
                      for i, t in enumerate(ms)), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=",".join(BUILDS), help="builds, comma-separated")
    ap.add_argument("--lanes", default="", help="widths to scan, comma-separated (default: "
                    "the builds' own)")
    ap.add_argument("--source", type=Path, nargs="+",
                    help="directories of kernel copies to hold against the tree's")
    ap.add_argument("--steps", type=int, default=10,
                    help="main-path control steps before the third start (--source)")
    ap.add_argument("--rounds", type=int, default=10,
                    help="timing rounds (--source; 0: no timing)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("planar_k_scan: needs a CUDA card")
    print(card())
    which_all = args.only.split(",")
    if not args.source:
        scan(which_all, [int(w) for w in args.lanes.split(",") if w] or [0])
        return
    kernels = sorted({BUILDS[w].kernel for w in which_all})
    sources = [build.CSRC_DIR, *args.source]
    jobs = [(kernel, f"k_scan{i}", (), False, src, OCCUPANCY[kernel])
            for i, src in enumerate(sources) for kernel in kernels]
    built = build_all(jobs)
    copies = [Copy(src, {kernel: built[i * len(kernels) + j] for j, kernel in enumerate(kernels)})
              for i, src in enumerate(sources)]
    compare(copies, which_all, args.steps, args.rounds)


if __name__ == "__main__":
    main()
