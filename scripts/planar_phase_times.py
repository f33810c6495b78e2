"""Phase times of the planar rollout kernels (csrc/planar_rollout.cu and
csrc/swimmer_rollout.cu over csrc/planar_dynamics.cuh) on the card.

Builds a copy of each kernel with PLANAR_STAMP defined, so that each stamp in
planar_dynamics.cuh reads %globaltimer (ns) and charges the time since the
previous stamp (PLANAR_STAMP_START at the sample's start) to its phase (the
`Phase` enum there): frames, mass and bias, the Swimmer's fluid force, the
factorizations and solves with M, the rows, the QP's operator applications
and the rest of the QP, and integration with the reward. One sample in
every K / 132 (about one per SM) records, by the first lane of its group,
summed over its whole rollout. Then for each build it runs a rollout at the
main path's K and T from the start that chip_smoke.py times (the reset;
the Swimmer's reset), from the dropped start that fills the rows
(chip_smoke's DROP; the Swimmer's limit start) and from the state that
`--steps` control steps of the main path's CEMPPI reach, and prints each
phase's mean share and its time per forward pass.

    python scripts/planar_phase_times.py                          # all four builds
    python scripts/planar_phase_times.py --only cheetah --steps 5

The copies are built under mpopis_tpu_torch/_build/phase_times/ with the
flags of kernels/build.py; the kernels themselves are not changed.
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

from mpopis_tpu_torch.kernels import build, planar_step  # noqa: E402
from mpopis_tpu_torch.models import (  # noqa: E402
    CheetahDeviceEnv,
    HopperDeviceEnv,
    SwimmerDeviceEnv,
    Walker2dDeviceEnv,
)
from mpopis_tpu_torch.policies import PolicyConfig, make_policy  # noqa: E402

OUT = build.BUILD_DIR / "phase_times"
PRELUDE = """#include <cuda_runtime.h>
__device__ unsigned long long* g_phase_ns;    // [slots][phases]
__device__ unsigned long long* g_phase_last;  // [slots]: the previous stamp
__device__ int g_phase_stride, g_phase_slots, g_phase_count, g_phase_lanes;
// The recording slot of this thread's sample, or -1: the first lane of every
// g_phase_stride-th sample. A block holds whole groups of g_phase_lanes
// lanes, sample k on threads k W .. k W + W - 1 of the grid.
__device__ __forceinline__ int planar_stamp_slot() {
  const long long g = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (g % g_phase_lanes != 0) return -1;
  const long long k = g / g_phase_lanes;
  if (k % g_phase_stride != 0 || k / g_phase_stride >= g_phase_slots) return -1;
  return static_cast<int>(k / g_phase_stride);
}
__device__ __forceinline__ void planar_stamp(int phase, bool start) {
  const int s = planar_stamp_slot();
  if (s < 0) return;
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  if (!start) atomicAdd(g_phase_ns + s * g_phase_count + phase, now - g_phase_last[s]);
  g_phase_last[s] = now;
}
#define PLANAR_STAMP(phase) planar_stamp(phase, false)
#define PLANAR_STAMP_START() planar_stamp(0, true)
"""
SETUP = """
extern "C" int phase_setup(void* ns, void* last, int stride, int slots, int count, int lanes) {
  cudaError_t e = cudaMemcpyToSymbol(g_phase_ns, &ns, sizeof(ns));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_phase_last, &last, sizeof(last));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_phase_stride, &stride, sizeof(int));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_phase_slots, &slots, sizeof(int));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_phase_count, &count, sizeof(int));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_phase_lanes, &lanes, sizeof(int));
  return static_cast<int>(e);
}
"""
# build -> (env class, kernel, main path's K, T, AIS iterations, lambda,
# control seed of chip_smoke's timed rollout, dropped start)
BUILDS = {
    "cheetah": (CheetahDeviceEnv, "planar", 2048, 15, 3, 0.1, 10, ("x1", -0.35)),
    "hopper": (HopperDeviceEnv, "planar", 2048, 15, 3, 0.1, 10, ("x1", 1.15)),
    "walker2d": (Walker2dDeviceEnv, "planar", 2048, 15, 3, 0.1, 10, ("x1", 1.17)),
    "swimmer": (SwimmerDeviceEnv, "swimmer", 4096, 25, 3, 0.1, 21, ("limits", None)),
}
_LIM = float(np.deg2rad(100.0))
SWIMMER_LIMITS = (0.1, -0.2, 0.3, 1.03 * _LIM, -1.04 * _LIM, 0.5, -0.4, 1.0, 2.0, -1.5)


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def phase_names() -> list[str]:
    """The `Phase` enum of planar_dynamics.cuh, kPhases excluded."""
    src = (build.CSRC_DIR / "planar_dynamics.cuh").read_text()
    body = re.search(r"enum Phase \{(.*?)\};", src, re.S)
    if body is None:
        raise RuntimeError("planar_dynamics.cuh no longer has `enum Phase`")
    names = [n.strip() for n in body.group(1).split(",") if n.strip()]
    if names[-1] != "kPhases":
        raise RuntimeError("`enum Phase` must end with kPhases")
    return [n[3:].lower() for n in names[:-1]]


def build_copy(kernel: str, tag: str, defines=(), stamped=False) -> tuple[ctypes.CDLL, str]:
    """Build `csrc/{kernel}_rollout.cu` (with the stamps, and -D `defines`)
    into OUT; returns the library and its ptxas log."""
    out = OUT / tag
    out.mkdir(parents=True, exist_ok=True)
    src = out / f"{kernel}.cu"
    main = f'#include "{build.CSRC_DIR / f"{kernel}_rollout.cu"}"\n'
    src.write_text(PRELUDE + main + SETUP if stamped else main)
    so = out / f"lib{kernel}.so"
    cmd = [build.find_nvcc(), *build.NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o", str(so),
           str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    if stamped:
        lib.phase_setup.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 4
        lib.phase_setup.restype = ctypes.c_int
    fn = getattr(lib, f"{kernel}_rollout_costs_f32")
    fn.argtypes = planar_step._ROLLOUT_ARGS
    fn.restype = ctypes.c_int
    return lib, proc.stdout + proc.stderr


def build_all(jobs) -> list:
    """build_copy for each (kernel, tag, defines, stamped), all at once."""
    with ThreadPoolExecutor(max_workers=max(len(jobs), 1)) as pool:
        return [f.result() for f in [pool.submit(build_copy, *job) for job in jobs]]


def ptxas(log: str):
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            yield line.strip()


def lanes(lib, kernel, env) -> tuple[int, int]:
    """(lanes a sample, warps a block) of env's f32 build in lib: (1, 1) for
    a library without `{kernel}_launch_shape` (one thread per sample)."""
    fn = getattr(lib, f"{kernel}_launch_shape", None)
    if fn is None:
        return 1, 1
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 2)()
    m = env.MODEL
    if fn(m.n_dof, int(m.integrator == "rk4"), 0, out) != 0:
        raise RuntimeError(f"{kernel}_launch_shape refuses the build")
    return out[0], out[1]


def launcher(lib, kernel, env, x, ctrl, costs):
    ints, dbl = planar_step._env_model(env)
    fn = getattr(lib, f"{kernel}_rollout_costs_f32")
    horizon, k = ctrl.shape[0], ctrl.shape[2]

    def launch():
        rc = fn(ints, len(ints), dbl, len(dbl), x.data_ptr(), ctrl.data_ptr(), costs.data_ptr(),
                k, horizon, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
    return launch


def start_state(which: str, env, start: str) -> torch.Tensor:
    x = env.reset().x.clone()
    drop = BUILDS[which][7]
    if start == "dropped":
        if drop[0] == "limits":
            x = env.tensor(SWIMMER_LIMITS)
        else:
            x[1] = drop[1]
    return x.contiguous()


def controls(which: str, env, k: int | None = None) -> torch.Tensor:
    """chip_smoke's timed controls: uniform in [−1, 1], (T, na, K)."""
    _, _, k0, horizon, _, _, seed, _ = BUILDS[which]
    k = k0 if k is None else k
    ctrl = np.random.default_rng(seed).uniform(-1, 1, size=(horizon, env.action_dim, k))
    return torch.as_tensor(ctrl, dtype=torch.float32, device="cuda")


def main_path_state(env, k, horizon, its, lam, steps) -> torch.Tensor:
    """The state after `steps` control steps of the main path's CEMPPI (f32,
    seed 1) on the production kernel."""
    na = env.action_dim
    pol = make_policy(env, PolicyConfig(kind="cemppi", num_samples=k, horizon=horizon, lam=lam,
                                        opt_its=its, sigma_est="mle"),
                      cov_mat=0.25 * np.eye(na))
    s, ps = env.reset(), pol.init_state(1)
    for _ in range(steps):
        a, ps, _ = pol.step(s, ps)
        s = env.step(s, a)
    return s.x.contiguous()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=",".join(BUILDS), help="builds, comma-separated")
    ap.add_argument("--steps", type=int, default=10,
                    help="main-path control steps before the third start")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("planar_phase_times: needs a CUDA card")
    print(card())
    names = phase_names()
    which_all = args.only.split(",")
    kernels = sorted({BUILDS[w][1] for w in which_all})
    libs = dict(zip(kernels, build_all([(k, "stamped", (), True) for k in kernels])))
    for kernel, (_, log) in libs.items():
        for line in ptxas(log):
            print(f"  ptxas ({kernel}):", line)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for which in which_all:
        cls, kernel, k, horizon, its, lam, _, _ = BUILDS[which]
        lib = libs[kernel][0]
        env = cls(dtype=torch.float32, device="cuda")
        w, warps = lanes(lib, kernel, env)
        ctrl = controls(which, env)
        stride = max(k // n_sm, 1)
        slots = (k + stride - 1) // stride
        ns = torch.zeros((slots, len(names)), dtype=torch.int64, device="cuda")
        last = torch.zeros(slots, dtype=torch.int64, device="cuda")
        if lib.phase_setup(ns.data_ptr(), last.data_ptr(), stride, slots, len(names), w) != 0:
            raise RuntimeError("could not point the kernel at the stamp buffers")
        passes = horizon * env.FRAME_SKIP * (4 if env.MODEL.integrator == "rk4" else 1)
        starts = {s: start_state(which, env, s) for s in ("reset", "dropped")}
        starts[f"main path after {args.steps} steps"] = main_path_state(env, k, horizon, its,
                                                                        lam, args.steps)
        rollout = getattr(planar_step, f"{kernel}_rollout_costs_tak")
        for label, x in starts.items():
            costs = torch.empty(k, dtype=torch.float32, device="cuda")
            want = rollout(env, x, ctrl)
            launch = launcher(lib, kernel, env, x, ctrl, costs)
            launch()  # warm-up
            ns.zero_()
            t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0.record()
            launch()
            t1.record()
            torch.cuda.synchronize()
            if not torch.allclose(costs, want, rtol=2e-4, atol=2e-3):
                raise RuntimeError(f"{which}: the stamped kernel disagrees with the kernel")
            per = ns.double().cpu().numpy()  # ns per recording sample and phase
            total = per.sum(1)
            mean = per.mean(0)
            n_lim, n_con = planar_step.first_substep_active_rows(env, x)
            print(f"{which} K={k} T={horizon} from {label} ({n_lim} limit and {n_con} other rows "
                  f"valid in the first substep; W={w}, {warps} warps a block): kernel "
                  f"{t0.elapsed_time(t1):.3f} ms (events, stamped copy); a recording sample's "
                  f"stamped time {total.mean() / 1e6:.3f} ms (min {total.min() / 1e6:.3f}, max "
                  f"{total.max() / 1e6:.3f}) over {slots} samples, {passes} forward passes")
            print("  " + ", ".join(f"{n} {100 * v / mean.sum():.1f}% "
                                   f"({v / passes / 1e3:.3f} us/pass)"
                                   for n, v in zip(names, mean)))


if __name__ == "__main__":
    main()
