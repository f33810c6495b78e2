"""Phase times of the spatial-contact rollout kernel (csrc/spatial_rollout.cu
over csrc/spatial_dynamics.cuh) on the card.

Builds a copy of the kernel with SPATIAL_STAMP defined, so that each stamp in
spatial_dynamics.cuh reads %globaltimer (ns) and charges the time since the
previous stamp (SPATIAL_STAMP_START at the sample's start) to its phase (the
`Phase` enum there): frames, mass and bias,
the factorizations and solves with M, the rows (limits, floor, cylinder
pairs, self pairs), the QP's operator applications and the rest of the QP,
integration (the RK4 or Euler bookkeeping between forward passes) and the
per-step reward. One sample in every K / 132 (about one per SM) records, by
its first lane, summed over its whole rollout; it also counts its forward
passes by their valid rows (SPATIAL_ROWS), which says how often the QP takes
its dense path (at most 32 rows, one a lane), and those rows by kind. Then
for each build it runs a rollout at the main path's K and T from the start
that chip_smoke.py times (Ant grounded, the Pusher's reset, the Humanoid's
crouch, the Standup's supine reset) and from the states that `--steps`
control steps of the main path's CEMPPI reach (one start per count), and
prints each phase's mean share and its time per forward pass, the share of
forward passes on each QP path with the median and largest valid-row count,
the valid rows' kinds with the share of passes that have a row of each
kind, and the recording samples' slowest total time
against their median (whether a few slow samples set the launch).

    python scripts/spatial_phase_times.py                          # all four builds
    python scripts/spatial_phase_times.py --only humanoid --steps 5
    python scripts/spatial_phase_times.py --only ant --steps 10 60

`--source` stamps another copy of spatial_rollout.cu (a parent's unpacked
under a directory that .gitignore lists, its headers beside it; the row
counts need its SPATIAL_ROWS hook). The copy is built under
mpopis_tpu_torch/_build/phase_times/ with the flags of kernels/build.py; the
kernel itself is not changed.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from mpopis_tpu_torch.kernels import build, spatial_step  # noqa: E402
from mpopis_tpu_torch.models import (  # noqa: E402
    AntDeviceEnv,
    HumanoidDeviceEnv,
    HumanoidStandupDeviceEnv,
    PusherDeviceEnv,
    humanoid_device,
)
from mpopis_tpu_torch.policies import PolicyConfig, make_policy  # noqa: E402

OUT = build.BUILD_DIR / "phase_times"
PRELUDE = """#include <cuda_runtime.h>
__device__ unsigned long long* g_phase_ns;  // [slots][phases]
__device__ int g_phase_stride, g_phase_slots, g_phase_count;
// The recording slot of this thread's sample, or -1: lane 0 of every
// g_phase_stride-th sample. Warp w of block b runs sample b * warps + w, as
// in spatial_kernel.
__device__ __forceinline__ int spatial_stamp_slot() {
  if ((threadIdx.x & 31) != 0) return -1;
  const int k = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (k % g_phase_stride != 0 || k / g_phase_stride >= g_phase_slots) return -1;
  return k / g_phase_stride;
}
// The previous stamp of each warp's sample in shared memory, the sums in
// global memory by reductions that do not wait for their result.
__device__ __forceinline__ unsigned long long* spatial_stamp_last() {
  __shared__ unsigned long long last[32];
  return last + (threadIdx.x >> 5);
}
__device__ __forceinline__ void spatial_stamp(int phase, bool start) {
  const int s = spatial_stamp_slot();
  if (s < 0) return;
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  unsigned long long* last = spatial_stamp_last();
  if (!start) atomicAdd(g_phase_ns + s * g_phase_count + phase, now - *last);
  *last = now;
}
#define SPATIAL_STAMP(phase) spatial_stamp(phase, false)
#define SPATIAL_STAMP_START() spatial_stamp(0, true)
__device__ unsigned long long* g_rows_hist;  // [rows + 1]: forward passes by valid rows
// [8]: valid rows by kind (limits, floor, cylinder pairs, self pairs), then
// forward passes with at least one row of each kind
__device__ unsigned long long* g_kind_rows;
// Counts the pass by its valid rows, and those by kind from their model rows
// (wk.idx, compacted in the model's row order). SPATIAL_ROWS expands inside
// forward_acc, whose model and workspace are `m` and `wk`.
template <class M, class Wk>
__device__ __forceinline__ void spatial_rows(int nv, const M& m, const Wk& wk) {
  if (spatial_stamp_slot() < 0) return;
  atomicAdd(g_rows_hist + nv, 1ull);
  const int cyl0 = m.n_rows - m.n_cap - m.n_cyl, self0 = m.n_rows - m.n_cap;
  unsigned long long kinds[4] = {0, 0, 0, 0};
  for (int i = 0; i < nv; ++i) {
    const int r = wk.idx[i];
    ++kinds[r < m.n_limits ? 0 : r < cyl0 ? 1 : r < self0 ? 2 : 3];
  }
  for (int k = 0; k < 4; ++k) {
    if (kinds[k] == 0) continue;
    atomicAdd(g_kind_rows + k, kinds[k]);
    atomicAdd(g_kind_rows + 4 + k, 1ull);
  }
}
#define SPATIAL_ROWS(nv) spatial_rows(nv, m, wk)
"""
SETUP = """
extern "C" int phase_setup(void* ns, int stride, int slots, int count, void* rows,
                           void* kinds) {
  cudaError_t e = cudaMemcpyToSymbol(g_phase_ns, &ns, sizeof(ns));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_rows_hist, &rows, sizeof(rows));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_kind_rows, &kinds, sizeof(kinds));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_phase_stride, &stride, sizeof(int));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_phase_slots, &slots, sizeof(int));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_phase_count, &count, sizeof(int));
  return static_cast<int>(e);
}
"""
# build -> (env class, main path's K, T, AIS iterations, lambda, timed start,
# control bound, control seed)
BUILDS = {
    "ant": (AntDeviceEnv, 1024, 10, 2, 1.0, "grounded", 1.0, 20),
    "pusher": (PusherDeviceEnv, 1024, 10, 2, 0.1, "reset", 2.0, 25),
    "humanoid": (HumanoidDeviceEnv, 1024, 8, 2, 1.0, "crouch", 0.4, 29),
    "standup": (HumanoidStandupDeviceEnv, 1024, 8, 2, 0.3, "reset", 0.4, 33),
}


def phase_names(source: Path) -> list[str]:
    """The `Phase` enum of the spatial_dynamics.cuh beside `source`, kPhases
    excluded."""
    src = (source.parent / "spatial_dynamics.cuh").read_text()
    body = re.search(r"enum Phase \{(.*?)\};", src, re.S)
    if body is None:
        raise RuntimeError("spatial_dynamics.cuh no longer has `enum Phase`")
    names = [n.strip() for n in body.group(1).split(",") if n.strip()]
    if names[-1] != "kPhases":
        raise RuntimeError("`enum Phase` must end with kPhases")
    return [n[3:].lower() for n in names[:-1]]


def stamped_library(source: Path) -> tuple[ctypes.CDLL, str]:
    """Build the stamped copy of `source`; returns it and its ptxas log."""
    OUT.mkdir(parents=True, exist_ok=True)
    src = OUT / "spatial_phases.cu"
    src.write_text(PRELUDE + f'#include "{source.resolve()}"\n' + SETUP)
    so = OUT / "libspatial_phases.so"
    cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.phase_setup.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    lib.phase_setup.restype = ctypes.c_int
    lib.spatial_model_bytes.argtypes = [ctypes.c_int]
    lib.spatial_model_bytes.restype = ctypes.c_int
    lib.spatial_pack_model.argtypes = [
        ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
    lib.spatial_pack_model.restype = ctypes.c_int
    lib.spatial_rollout_costs_f32.argtypes = spatial_step._ROLLOUT_ARGS
    lib.spatial_rollout_costs_f32.restype = ctypes.c_int
    return lib, proc.stdout + proc.stderr


def row_counts(hist: np.ndarray) -> str:
    """The recording samples' forward passes by the QP's path (no row, the
    dense path at 1-32 rows, the lanes' sums past 32), with the median and
    largest valid-row count."""
    n = hist.sum()
    if n == 0:
        return "no forward pass counted"
    rows = np.arange(len(hist))
    cum = np.cumsum(hist)
    median = int(rows[np.searchsorted(cum, (n + 1) // 2)])
    largest = int(rows[hist > 0].max())
    return (f"forward passes {n}: no row {100 * hist[0] / n:.1f}%, dense (1-32 rows) "
            f"{100 * hist[1:33].sum() / n:.1f}%, past 32 rows {100 * hist[33:].sum() / n:.1f}%; "
            f"valid rows median {median}, largest {largest}")


KINDS = ("limits", "floor", "cylinder pairs", "self pairs")


def kind_counts(kinds: np.ndarray, passes: int) -> str:
    """The recording samples' valid rows by kind, and the share of forward
    passes with at least one row of each kind."""
    n = kinds[:4].sum()
    if n == 0:
        return "no valid row counted"
    return ("valid rows by kind: " + ", ".join(f"{k} {100 * kinds[i] / n:.1f}%"
                                               for i, k in enumerate(KINDS))
            + "; passes with a row of the kind: "
            + ", ".join(f"{k} {100 * kinds[4 + i] / max(passes, 1):.1f}%"
                        for i, k in enumerate(KINDS)))


def start_state(which: str, env, start: str) -> torch.Tensor:
    x = env.reset().x.clone()
    if which == "ant" and start == "grounded":
        x[2] = 0.75 - 0.45
    elif which == "humanoid" and start == "crouch":
        q = humanoid_device.crouched_qpos(env.MODEL)
        qv = torch.as_tensor(np.random.default_rng(4).uniform(-0.3, 0.3, 23))
        x = torch.cat([q, qv, humanoid_device.com_x(q)[None]]).to(x.device, x.dtype)
    return x


def main_path_state(env, na, k, horizon, its, lam, steps) -> torch.Tensor:
    """The state after `steps` control steps of the main path's CEMPPI (f32,
    seed 1) on the production kernel."""
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
    ap.add_argument("--steps", type=int, nargs="+", default=[10],
                    help="main-path control steps before the further starts")
    ap.add_argument("--source", type=Path, default=build.CSRC_DIR / "spatial_rollout.cu",
                    help="the spatial_rollout.cu to stamp (its headers beside it)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("spatial_phase_times: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    print("source", args.source)
    names = phase_names(args.source)
    qp = [names.index("apply"), names.index("qp")]
    lib, log = stamped_library(args.source)
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for which in args.only.split(","):
        cls, k, horizon, its, lam, start, hi, seed = BUILDS[which]
        env = cls(dtype=torch.float32, device="cuda")
        na = env.action_dim
        ints, dbl = spatial_step._env_model(env)
        nbytes = lib.spatial_model_bytes(0)
        buf = ctypes.create_string_buffer(nbytes)
        if lib.spatial_pack_model(0, ints, len(ints), dbl, len(dbl), buf, nbytes) != 0:
            raise RuntimeError("the stamped kernel rejects the packed model")
        model = torch.frombuffer(bytearray(buf.raw), dtype=torch.uint8).to("cuda")
        ctrl = torch.as_tensor(np.random.default_rng(seed).uniform(-hi, hi, (horizon, na, k)),
                               dtype=torch.float32, device="cuda")
        stride = max(k // n_sm, 1)
        slots = (k + stride - 1) // stride
        ns = torch.zeros((slots, len(names)), dtype=torch.int64, device="cuda")
        rows = torch.zeros(spatial_step.LAYOUT["wide_rows"] + 1, dtype=torch.int64,
                           device="cuda")
        kinds = torch.zeros(8, dtype=torch.int64, device="cuda")
        if lib.phase_setup(ns.data_ptr(), stride, slots, len(names), rows.data_ptr(),
                           kinds.data_ptr()) != 0:
            raise RuntimeError("could not point the kernel at the stamp buffers")
        passes = horizon * env.FRAME_SKIP * (1 if env.MODEL.integrator == "euler_implicit"
                                             else 4)
        starts = {start: start_state(which, env, start).contiguous()}
        for n in args.steps:
            starts[f"main path after {n} steps"] = main_path_state(env, na, k, horizon, its, lam,
                                                                   n)
        for label, x in starts.items():
            costs = torch.empty(k, dtype=torch.float32, device="cuda")
            want = spatial_step.spatial_rollout_costs_tak(env, x, ctrl)

            def launch():
                rc = lib.spatial_rollout_costs_f32(
                    model.data_ptr(), env.MODEL.n_dof, env.MODEL.n_q, ints[12], na,
                    x.data_ptr(), ctrl.data_ptr(), costs.data_ptr(), k, horizon,
                    torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"launch failed: CUDA error {rc}")

            launch()  # warm-up
            ns.zero_()
            rows.zero_()
            kinds.zero_()
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
            print(f"{which} K={k} T={horizon} from {label}: kernel {t0.elapsed_time(t1):.3f} ms "
                  f"(events, stamped copy); a recording sample's stamped time "
                  f"{total.mean() / 1e6:.3f} ms (min {total.min() / 1e6:.3f}, max "
                  f"{total.max() / 1e6:.3f}) over {slots} samples, {passes} forward passes")
            print("  " + ", ".join(f"{n} {100 * v / mean.sum():.1f}% "
                                   f"({v / passes / 1e3:.3f} us/pass)"
                                   for n, v in zip(names, mean)))
            print(f"  the QP's share of a pass {100 * mean[qp].sum() / mean.sum():.1f}% "
                  f"(apply and qp); a recording sample's total: median "
                  f"{np.median(total) / 1e6:.3f} ms, slowest {total.max() / 1e6:.3f} ms "
                  f"({total.max() / np.median(total):.3f}x the median)")
            hist = rows.cpu().numpy()
            print("  " + row_counts(hist))
            print("  " + kind_counts(kinds.cpu().numpy(), int(hist.sum())))


if __name__ == "__main__":
    main()
