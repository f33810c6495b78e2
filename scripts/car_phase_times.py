"""Phase times of the car rollout kernel (csrc/car_rollout.cu) on the card,
and its time against K.

Builds a copy of the kernel with CAR_STAMP defined, so that each stamp in
car_rollout.cu reads %globaltimer (ns) and charges the time since the
previous stamp (CAR_STAMP_START at the sample's start) to its phase (the
`CarPhase` enum there): the substep dynamics, the track sweep, the rest of
the reward, and the waits of a design whose warps hand states to each other.
The first lane of each warp of every (blocks / 132)-th block records, summed
over its whole rollout. A warp that integrates (any dynamics time) and a warp
that only scores are reported apart. Then an unstamped copy is timed by CUDA
events at each K of `--k` (f32, T = 50, chip_smoke.py's candidate controls)
and at K = 8192 for each car count of `--cars`.

    python scripts/car_phase_times.py
    python scripts/car_phase_times.py --source _export/parent/mpopis_tpu_torch/csrc/car_rollout.cu

`--source` takes another copy of car_rollout.cu (a parent's, unpacked under
a directory that .gitignore lists) with the same C interface. The copies are
built under mpopis_tpu_torch/_build/phase_times/ with the flags of
kernels/build.py; the kernel itself is not changed.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from mpopis_tpu_torch.kernels import build, car_rollout  # noqa: E402
from mpopis_tpu_torch.models import CarRacingEnv  # noqa: E402

OUT = build.BUILD_DIR / "phase_times"
MAX_WARPS = 32  # recording slots a block: one per warp
PRELUDE = """#include <cuda_runtime.h>
__device__ unsigned long long* g_car_ns;    // [slots][phases]
__device__ unsigned long long* g_car_last;  // [slots]: the previous stamp
__device__ int g_car_bstride, g_car_slots, g_car_phases;
// The recording slot of this thread, or -1: the first lane of each warp of
// every g_car_bstride-th block.
__device__ __forceinline__ int car_stamp_slot() {
  if ((threadIdx.x & 31) != 0 || blockIdx.x % g_car_bstride != 0) return -1;
  const int s = (blockIdx.x / g_car_bstride) * MAX_WARPS + (threadIdx.x >> 5);
  return s < g_car_slots ? s : -1;
}
__host__ __device__ __forceinline__ void car_stamp(int phase, bool start) {
#ifdef __CUDA_ARCH__  // the stamps sit in code built for the host too
  const int s = car_stamp_slot();
  if (s < 0) return;
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  if (!start) g_car_ns[s * g_car_phases + phase] += now - g_car_last[s];
  g_car_last[s] = now;
#endif
}
#define CAR_STAMP(phase) car_stamp(phase, false)
#define CAR_STAMP_START() car_stamp(0, true)
""".replace("MAX_WARPS", str(MAX_WARPS))
SETUP = """
extern "C" int phase_setup(void* ns, void* last, int bstride, int slots, int phases) {
  cudaError_t e = cudaMemcpyToSymbol(g_car_ns, &ns, sizeof(ns));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_car_last, &last, sizeof(last));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_car_bstride, &bstride, sizeof(int));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_car_slots, &slots, sizeof(int));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_car_phases, &phases, sizeof(int));
  return static_cast<int>(e);
}
"""


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def phase_names(source: Path) -> list[str]:
    """The `CarPhase` enum of the source or of csrc/car_dynamics.cuh beside
    it, kCarPhases excluded."""
    texts = [f.read_text() for f in (source, source.with_name("car_dynamics.cuh"))
             if f.is_file()]
    body = next((m for m in (re.search(r"enum CarPhase \{(.*?)\};", t, re.S) for t in texts)
                 if m), None)
    if body is None:
        raise RuntimeError(f"neither {source} nor the car_dynamics.cuh beside it has "
                           "`enum CarPhase`")
    names = [n.strip() for n in body.group(1).split(",") if n.strip()]
    if names[-1] != "kCarPhases":
        raise RuntimeError("`enum CarPhase` must end with kCarPhases")
    return [n[4:].lower() for n in names[:-1]]


def build_copy(source: Path, tag: str, stamped: bool) -> tuple[ctypes.CDLL, str]:
    """Build `source` (with the stamps) into OUT/tag; returns the library and
    its ptxas log."""
    out = OUT / tag
    out.mkdir(parents=True, exist_ok=True)
    src = out / "car_rollout.cu"
    main = f'#include "{source.resolve()}"\n'
    src.write_text(PRELUDE + main + SETUP if stamped else main)
    so = out / "libcar_rollout.so"
    cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    if stamped:
        lib.phase_setup.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 3
        lib.phase_setup.restype = ctypes.c_int
    lib.car_rollout_costs_f32.argtypes = car_rollout._ARGTYPES
    lib.car_rollout_costs_f32.restype = ctypes.c_int
    return lib, proc.stdout + proc.stderr


def controls(k: int, horizon: int, seed: int = 2) -> torch.Tensor:
    """chip_smoke.py's candidates: N(0, diag(0.0625, 0.1)) clamped, (T, 2, K)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    std = torch.tensor([0.25, 0.1**0.5], device="cuda")
    z = torch.randn((horizon, 2, k), generator=g, device="cuda")
    return torch.clamp(z * std[None, :, None], -1.0, 1.0).contiguous()


def launcher(lib, env, x, ctrl, costs, num_cars=1):
    params = car_rollout._kernel_params(env)
    horizon, k = ctrl.shape[0], ctrl.shape[2]
    n_sub = int(round(env.dt / env.ddt))

    def launch():
        rc = lib.car_rollout_costs_f32(
            x.data_ptr(), env.track_xyw.data_ptr(), env.track_xyw.shape[1], ctrl.data_ptr(),
            costs.data_ptr(), k, horizon, num_cars, ctypes.addressof(params), n_sub,
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
    return launch


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", type=Path, default=build.CSRC_DIR / "car_rollout.cu")
    ap.add_argument("--k", type=int, nargs="+", default=[1, 150, 1024, 8192, 16384])
    ap.add_argument("--cars", type=int, nargs="*", default=[2, 3, 4],
                    help="car counts timed at K = 8192 besides one car")
    ap.add_argument("--horizon", type=int, default=50)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("car_phase_times: needs a CUDA card")
    print(card(), "| source", args.source)
    names = phase_names(args.source)
    with ThreadPoolExecutor(max_workers=2) as pool:
        (stamped, log), (plain, _) = pool.map(lambda job: build_copy(args.source, *job),
                                             (("stamped", True), ("unstamped", False)))
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas (stamped copy):", line.strip())
    env = CarRacingEnv(dtype=torch.float32, device="cuda")
    x = env.reset().x.contiguous()
    horizon = args.horizon

    # phases at the main path's K
    k = 8192
    ctrl = controls(k, horizon)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = -(-k // 32)  # at most: 32 samples or more a block
    bstride = max(blocks // n_sm, 1)
    slots = MAX_WARPS * -(-blocks // bstride)
    ns = torch.zeros((slots, len(names)), dtype=torch.int64, device="cuda")
    last = torch.zeros(slots, dtype=torch.int64, device="cuda")
    if stamped.phase_setup(ns.data_ptr(), last.data_ptr(), bstride, slots, len(names)) != 0:
        raise RuntimeError("could not point the kernel at the stamp buffers")
    costs = torch.empty(k, device="cuda")
    launch = launcher(stamped, env, x, ctrl, costs)
    launch()
    ns.zero_()
    launch()
    torch.cuda.synchronize()
    want = car_rollout.car_rollout_costs_tak(env, x, ctrl, horizon)
    rel = ((costs - want).abs() / want.abs().clamp(min=1e-30)).cpu().numpy()
    if float(np.median(rel)) > 2e-4:
        raise RuntimeError("the stamped copy disagrees with the kernel")
    per = ns.double().cpu().numpy()
    dyn = names.index("dynamics")
    groups = {"integrating warps": per[:, dyn] > 0,
              "scoring-only warps": (per[:, dyn] == 0) & (per.sum(1) > 0)}
    print(f"K={k} T={horizon} f32, stamped copy (the stamps add time: read shares); median "
          f"relative difference to the kernel {np.median(rel):.2e}")
    for label, rows in groups.items():
        if not rows.any():
            continue
        sub = per[rows]
        total = sub.sum(1)
        share = sub / total[:, None]
        print(f"  {label} ({int(rows.sum())} recorded): {np.mean(total) / 1e3:.2f} us a rollout, "
              f"{np.mean(total) / horizon / 1e3:.3f} us an action step; share " + ", ".join(
                  f"{name} {100 * share[:, i].mean():.1f}%" for i, name in enumerate(names)))

    # time against K (one car) and against the cars (K = 8192), unstamped; the
    # cars of a joint state start 5 m apart along x
    runs = [(k, 1) for k in args.k] + [(8192, c) for c in args.cars]
    for k, num_cars in runs:
        ctrl = torch.cat([controls(k, horizon, seed=2 + c) for c in range(num_cars)], dim=1)
        xs = x.repeat(num_cars)
        xs[0::8] += 5.0 * torch.arange(num_cars, device="cuda", dtype=xs.dtype)
        costs = torch.empty(k, device="cuda")
        launch = launcher(plain, env, xs.contiguous(), ctrl.contiguous(), costs, num_cars)
        launch()
        torch.cuda.synchronize()
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(args.reps):
            launch()
        t1.record()
        torch.cuda.synchronize()
        print(f"  unstamped K={k} T={horizon} {num_cars} car(s) f32: "
              f"{t0.elapsed_time(t1) / args.reps:.4f} ms a call (CUDA events, {args.reps} calls)")


if __name__ == "__main__":
    main()
