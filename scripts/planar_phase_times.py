"""Phase times of the planar rollout kernels (csrc/planar_rollout.cu and
csrc/swimmer_rollout.cu over csrc/planar_dynamics.cuh) on the card.

Builds a copy of each kernel with PLANAR_STAMP defined, so that each stamp in
planar_dynamics.cuh reads %globaltimer (ns) and charges the time since the
previous stamp (PLANAR_STAMP_START at the sample's start) to its phase (the
`Phase` enum there): frames, mass and bias, the Swimmer's fluid force, the
factorizations and solves with M, the rows, the QP's operator applications
and the rest of the QP, and integration with the reward. One sample in
every K / 132 (about one per SM) records, by the first lane of its group,
summed over its whole rollout (its slot and previous stamp kept in shared
memory, so that a stamp costs the other samples a few instructions); it
also counts its forward passes by their valid rows (PLANAR_ROWS), which
says how often the QP takes its dense path (at most 32 rows). Then for
each build it runs a rollout at the main path's K and T from the start
that chip_smoke.py times (the reset; the Swimmer's reset), from the
dropped start that fills the rows (chip_smoke's DROP; the Swimmer's limit
start) and from the states that `--steps` control steps of the main path's
CEMPPI reach (one start per count), and prints each phase's mean share and
its time per forward pass, the QP's share of a pass, and the share of
forward passes with no row, on the dense path and past it, with the median
and largest valid-row count. `cheetah_k100` is the HalfCheetah at the
upstream recipe's K = 100, T = 50 (5 iterations, lambda 1, `ss`).

    python scripts/planar_phase_times.py                          # all five builds
    python scripts/planar_phase_times.py --only cheetah --steps 5
    python scripts/planar_phase_times.py --only cheetah,cheetah_k100 --steps 10 40

`--source` stamps another copy of the kernels (a directory holding its
planar_rollout.cu, swimmer_rollout.cu and their headers, such as a parent's
csrc unpacked under a directory that .gitignore lists; the row counts need
its PLANAR_ROWS hook). The copies are built under
mpopis_tpu_torch/_build/phase_times/ with the flags of kernels/build.py; the
kernels themselves are not changed.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import NamedTuple

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
__constant__ unsigned long long* c_phase_ns;  // [slots][phases]
__constant__ unsigned long long* c_rows_hist;  // [rows + 1]: forward passes by valid rows
__constant__ int c_phase_stride, c_phase_slots, c_phase_count, c_phase_shift;
// Per group of the block (at most 64, of 2^c_phase_shift lanes each) its
// recording slot, or -1, and its previous stamp, in shared memory: a stamp
// costs a lane that does not record a few instructions.
__device__ __forceinline__ int* planar_stamp_slot() {
  __shared__ int slot[64];
  return slot + (threadIdx.x >> c_phase_shift);
}
__device__ __forceinline__ unsigned long long* planar_stamp_last() {
  __shared__ unsigned long long last[64];
  return last + (threadIdx.x >> c_phase_shift);
}
// Charges the time since the group's previous stamp to `phase`, by the first
// lane of every c_phase_stride-th sample (sample k on threads k W .. k W +
// W - 1 of the grid); the sums in global memory by reductions that do not
// wait for their result. The start stamp sets the group's slot.
__device__ __forceinline__ void planar_stamp(int phase, bool start) {
  if (threadIdx.x & ((1 << c_phase_shift) - 1)) return;
  if (start) {
    const int k = (blockIdx.x * blockDim.x + threadIdx.x) >> c_phase_shift;
    *planar_stamp_slot() = k % c_phase_stride == 0 && k / c_phase_stride < c_phase_slots
                               ? k / c_phase_stride : -1;
  }
  const int s = *planar_stamp_slot();
  if (s < 0) return;
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  unsigned long long* last = planar_stamp_last();
  if (!start) atomicAdd(c_phase_ns + s * c_phase_count + phase, now - *last);
  *last = now;
}
#define PLANAR_STAMP(phase) planar_stamp(phase, false)
#define PLANAR_STAMP_START() planar_stamp(0, true)
__device__ __forceinline__ void planar_rows(int nv) {
  if (threadIdx.x & ((1 << c_phase_shift) - 1)) return;
  if (*planar_stamp_slot() >= 0) atomicAdd(c_rows_hist + nv, 1ull);
}
#define PLANAR_ROWS(nv) planar_rows(nv)
"""
SETUP = """
extern "C" int phase_setup(void* ns, int stride, int slots, int count, int lanes, void* rows) {
  int shift = 0;
  while ((1 << shift) < lanes) ++shift;
  cudaError_t e = cudaMemcpyToSymbol(c_phase_ns, &ns, sizeof(ns));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(c_rows_hist, &rows, sizeof(rows));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(c_phase_stride, &stride, sizeof(int));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(c_phase_slots, &slots, sizeof(int));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(c_phase_count, &count, sizeof(int));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(c_phase_shift, &shift, sizeof(int));
  return static_cast<int>(e);
}
"""


class Build(NamedTuple):
    env: type  # the env class
    kernel: str  # planar or swimmer
    k: int  # the main path's K, T, AIS iterations, lambda and estimator
    horizon: int
    its: int
    lam: float
    seed: int  # the control seed of chip_smoke's timed rollout
    drop: tuple  # the dropped start
    sigma_est: str = "mle"
    deep: float | None = None  # x[1] of a start past the QP's 32 dense rows


BUILDS = {
    "cheetah": Build(CheetahDeviceEnv, "planar", 2048, 15, 3, 0.1, 10, ("x1", -0.35), deep=-0.7),
    "cheetah_k100": Build(CheetahDeviceEnv, "planar", 100, 50, 5, 1.0, 10, ("x1", -0.35), "ss",
                          -0.7),
    "hopper": Build(HopperDeviceEnv, "planar", 2048, 15, 3, 0.1, 10, ("x1", 1.15)),
    "walker2d": Build(Walker2dDeviceEnv, "planar", 2048, 15, 3, 0.1, 10, ("x1", 1.17), deep=0.2),
    "swimmer": Build(SwimmerDeviceEnv, "swimmer", 4096, 25, 3, 0.1, 21, ("limits", None)),
}
_LIM = float(np.deg2rad(100.0))
SWIMMER_LIMITS = (0.1, -0.2, 0.3, 1.03 * _LIM, -1.04 * _LIM, 0.5, -0.4, 1.0, 2.0, -1.5)


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def phase_names(source: Path = build.CSRC_DIR) -> list[str]:
    """The `Phase` enum of source/planar_dynamics.cuh, kPhases excluded."""
    src = (source / "planar_dynamics.cuh").read_text()
    body = re.search(r"enum Phase \{(.*?)\};", src, re.S)
    if body is None:
        raise RuntimeError("planar_dynamics.cuh no longer has `enum Phase`")
    names = [n.strip() for n in body.group(1).split(",") if n.strip()]
    if names[-1] != "kPhases":
        raise RuntimeError("`enum Phase` must end with kPhases")
    return [n[3:].lower() for n in names[:-1]]


def build_copy(kernel: str, tag: str, defines=(), stamped=False, source: Path = build.CSRC_DIR,
               appended: str = "") -> tuple[ctypes.CDLL, str]:
    """Build source/{kernel}_rollout.cu (with the stamps, -D `defines` and
    `appended` after it) into OUT/tag-<source's hash>; returns the library and
    its ptxas log."""
    source = source.resolve()
    out = OUT / f"{tag}-{hashlib.sha256(str(source).encode()).hexdigest()[:8]}"
    out.mkdir(parents=True, exist_ok=True)
    src = out / f"{kernel}.cu"
    main = f'#include "{source / f"{kernel}_rollout.cu"}"\n' + appended
    src.write_text(PRELUDE + main + SETUP if stamped else main)
    so = out / f"lib{kernel}.so"
    cmd = [build.find_nvcc(), *build.NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o", str(so),
           str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    if stamped:
        lib.phase_setup.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.phase_setup.restype = ctypes.c_int
    for suffix in ("f32", "f64"):
        for name, args in (("rollout_costs", planar_step._ROLLOUT_ARGS),
                           ("step_states", planar_step._STEP_ARGS)):
            fn = getattr(lib, f"{kernel}_{name}_{suffix}")
            fn.argtypes, fn.restype = args, ctypes.c_int
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
    drop = BUILDS[which].drop
    if start == "deep":
        x[1] = BUILDS[which].deep
    elif start == "dropped":
        if drop[0] == "limits":
            x = env.tensor(SWIMMER_LIMITS)
        else:
            x[1] = drop[1]
    return x.contiguous()


def controls(which: str, env, k: int | None = None, dtype=torch.float32) -> torch.Tensor:
    """chip_smoke's timed controls: uniform in [−1, 1], (T, na, K)."""
    b = BUILDS[which]
    k = b.k if k is None else k
    ctrl = np.random.default_rng(b.seed).uniform(-1, 1, size=(b.horizon, env.action_dim, k))
    return torch.as_tensor(ctrl, dtype=dtype, device="cuda")


def main_path_state(which: str, env, steps: int) -> torch.Tensor:
    """The state after `steps` control steps of the main path's CEMPPI (f32,
    seed 1) on the production kernel."""
    b = BUILDS[which]
    na = env.action_dim
    pol = make_policy(env, PolicyConfig(kind="cemppi", num_samples=b.k, horizon=b.horizon,
                                        lam=b.lam, opt_its=b.its, sigma_est=b.sigma_est),
                      cov_mat=0.25 * np.eye(na))
    s, ps = env.reset(), pol.init_state(1)
    for _ in range(steps):
        a, ps, _ = pol.step(s, ps)
        s = env.step(s, a)
    return s.x.contiguous()


def row_counts(hist: np.ndarray) -> str:
    """The recording samples' forward passes by the QP's path (no row, the
    dense path at 1-32 rows, the wide path past 32), with the median and
    largest valid-row count."""
    n = hist.sum()
    if n == 0:
        return "no forward pass counted (a copy without PLANAR_ROWS)"
    rows = np.arange(len(hist))
    cum = np.cumsum(hist)
    median = int(rows[np.searchsorted(cum, (n + 1) // 2)])
    largest = int(rows[hist > 0].max())
    return (f"forward passes {n}: no row {100 * hist[0] / n:.1f}%, dense (1-32 rows) "
            f"{100 * hist[1:33].sum() / n:.1f}%, past 32 rows {100 * hist[33:].sum() / n:.1f}%; "
            f"with a row, dense {100 * hist[1:33].sum() / max(n - hist[0], 1):.1f}%; "
            f"valid rows median {median}, largest {largest}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=",".join(BUILDS), help="builds, comma-separated")
    ap.add_argument("--steps", type=int, nargs="+", default=[10],
                    help="main-path control steps before the further starts")
    ap.add_argument("--source", type=Path, default=build.CSRC_DIR,
                    help="the directory of the kernels to stamp (their headers beside them)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("planar_phase_times: needs a CUDA card")
    print(card())
    print("source", args.source.resolve())
    own = args.source.resolve() == build.CSRC_DIR.resolve()  # the tree's kernels
    names = phase_names(args.source)
    qp = [names.index("apply"), names.index("qp")]
    which_all = args.only.split(",")
    kernels = sorted({BUILDS[w].kernel for w in which_all})
    libs = dict(zip(kernels, build_all([(k, "stamped", (), True, args.source) for k in kernels])))
    for kernel, (_, log) in libs.items():
        for line in ptxas(log):
            print(f"  ptxas ({kernel}):", line)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for which in which_all:
        b = BUILDS[which]
        k, horizon = b.k, b.horizon
        lib = libs[b.kernel][0]
        env = b.env(dtype=torch.float32, device="cuda")
        w, warps = lanes(lib, b.kernel, env)
        ctrl = controls(which, env)
        stride = max(k // n_sm, 1)
        slots = (k + stride - 1) // stride
        ns = torch.zeros((slots, len(names)), dtype=torch.int64, device="cuda")
        rows = torch.zeros(planar_step.MAX_ROWS + 1, dtype=torch.int64, device="cuda")
        if lib.phase_setup(ns.data_ptr(), stride, slots, len(names), w, rows.data_ptr()) != 0:
            raise RuntimeError("could not point the kernel at the stamp buffers")
        passes = horizon * env.FRAME_SKIP * (4 if env.MODEL.integrator == "rk4" else 1)
        starts = {s: start_state(which, env, s) for s in ("reset", "dropped")}
        for n in args.steps:
            starts[f"main path after {n} steps"] = main_path_state(which, env, n)
        rollout = getattr(planar_step, f"{b.kernel}_rollout_costs_tak")
        for label, x in starts.items():
            costs = torch.empty(k, dtype=torch.float32, device="cuda")
            want = rollout(env, x, ctrl)
            launch = launcher(lib, b.kernel, env, x, ctrl, costs)
            launch()  # warm-up
            ns.zero_()
            rows.zero_()
            t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0.record()
            launch()
            t1.record()
            torch.cuda.synchronize()
            # another copy's f32 rollouts part from the tree's where contacts switch
            if own and not torch.allclose(costs, want, rtol=2e-4, atol=2e-3):
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
            print(f"  the QP's share of a pass {100 * mean[qp].sum() / mean.sum():.1f}% "
                  f"(apply {100 * mean[qp[0]] / mean.sum():.1f}%, qp "
                  f"{100 * mean[qp[1]] / mean.sum():.1f}%)")
            print("  " + row_counts(rows.cpu().numpy()), flush=True)


if __name__ == "__main__":
    main()
