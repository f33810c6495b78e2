"""Time the spatial-contact rollout kernel (csrc/spatial_rollout.cu) against
the number of samples K, one warp each, on the card; or, with --source,
hold other copies of the kernel against the tree's, bit for bit, and time
them in turns.

Without --source, for each build it runs the f32 rollout at the main path's
T from the start that chip_smoke.py times, at K = 1 (one sample alone), 132
(one an SM), 264, 528 (four an SM, one a scheduler), 792, 924, 1024 (the
main path's) and 2048, and prints the CUDA-event time of each (the mean of
two launches after one warm-up): how the time of a sample grows with the
samples that share an SM.

With --source, it builds each given spatial_rollout.cu beside the tree's
(the same C interface; its headers beside it, as in a parent unpacked under
a directory that .gitignore lists), each with a query of the builds'
occupancy appended. For each build it prints, per copy, the warps a block,
the warps resident on an SM, the workspace bytes a warp and the registers
and local bytes a thread. Then, f32 and f64, from chip_smoke's start and
from the state that --steps control steps of the main path's CEMPPI reach,
it runs every copy's rollout at the main path's K and T and its step entry
on K states near that state, and prints the largest difference of the
costs and of the states against the tree's (0: bit-equal). Last it times
the f32 rollouts at the main path's K and T (from the main-path state) and
the one-state step entry, copies in turns (first to last, then last to
first), and prints each copy's median and range.

    python scripts/spatial_k_scan.py                 # all four builds
    python scripts/spatial_k_scan.py --only humanoid
    python scripts/spatial_k_scan.py \
        --source _export/parent/mpopis_tpu_torch/csrc/spatial_rollout.cu

The copies are built under mpopis_tpu_torch/_build/k_scan/ with the flags of
kernels/build.py; the kernel itself is not changed.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from spatial_phase_times import BUILDS, main_path_state, start_state  # noqa: E402

from mpopis_tpu_torch.kernels import build, spatial_step  # noqa: E402

KS = (1, 132, 264, 528, 792, 924, 1024, 2048)
OUT = build.BUILD_DIR / "k_scan"
# The occupancy query appended to each copy: for build `which` (the order of
# BUILDS) and f64, out = [warps a block, resident warps an SM, workspace
# bytes a warp, registers a thread, local bytes a thread].
OCCUPANCY = """
template <typename T, int N, int NQ, int F>
static int k_scan_occupancy_of(int* out) {
  const auto kern = spatial_kernel<T, N, NQ, F>;
  const int warps = block_warps<T, N, NQ, F>();
  const int per_warp = static_cast<int>(sizeof(spatial::Work<T, N, spatial::RowCap<F>::n, F>));
  int blocks = 0;
  cudaFuncAttributes attr;
  if (warps < 1 ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, 32 * warps, warps * per_warp) !=
          cudaSuccess ||
      cudaFuncGetAttributes(&attr, kern) != cudaSuccess)
    return 1;
  out[0] = warps;
  out[1] = blocks * warps;
  out[2] = per_warp;
  out[3] = attr.numRegs;
  out[4] = static_cast<int>(attr.localSizeBytes);
  return 0;
}
template <typename T>
static int k_scan_occupancy_t(int which, int* out) {
  switch (which) {
    case 0: return k_scan_occupancy_of<T, 14, 15, kAntFeatures>(out);
    case 1: return k_scan_occupancy_of<T, 11, 11, kPusherFeatures>(out);
    case 2: return k_scan_occupancy_of<T, 23, 24, kHumanoidFeatures>(out);
    case 3: return k_scan_occupancy_of<T, 23, 24, kStandupFeatures>(out);
  }
  return 1;
}
extern "C" int k_scan_occupancy(int f64, int which, int* out) {
  return f64 ? k_scan_occupancy_t<double>(which, out) : k_scan_occupancy_t<float>(which, out);
}
"""


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def scan(only: list[str]) -> None:
    for which in only:
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


class Copy:
    """One spatial_rollout.cu built with the occupancy query appended."""

    def __init__(self, source: Path):
        self.source = source.resolve()
        out = OUT / hashlib.sha256(str(self.source).encode()).hexdigest()[:8]
        out.mkdir(parents=True, exist_ok=True)
        src = out / "spatial_rollout_copy.cu"
        src.write_text(f'#include "{self.source}"\n' + OCCUPANCY)
        so = out / "libspatial_rollout_copy.so"  # rebuilt every run: the name says which source
        cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True, check=False, timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.source}:\n{proc.stdout}{proc.stderr}")
        self.log = proc.stdout + proc.stderr
        lib = ctypes.CDLL(str(so))
        lib.k_scan_occupancy.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.k_scan_occupancy.restype = ctypes.c_int
        lib.spatial_model_bytes.argtypes = [ctypes.c_int]
        lib.spatial_model_bytes.restype = ctypes.c_int
        lib.spatial_pack_model.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.c_int,
            ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
        lib.spatial_pack_model.restype = ctypes.c_int
        for suffix in ("f32", "f64"):
            for name, args in (("spatial_rollout_costs", spatial_step._ROLLOUT_ARGS),
                               ("spatial_step_states", spatial_step._STEP_ARGS)):
                fn = getattr(lib, f"{name}_{suffix}")
                fn.argtypes, fn.restype = args, ctypes.c_int
        self.lib = lib
        self.models: dict = {}

    def occupancy(self, f64: int, which: int) -> list[int]:
        out = (ctypes.c_int * 5)()
        if self.lib.k_scan_occupancy(f64, which, out) != 0:
            raise RuntimeError(f"{self.source}: the occupancy query failed")
        return list(out)

    def _model(self, env, f64: int) -> torch.Tensor:
        key = (type(env).__name__, f64)
        if key not in self.models:
            ints, dbl = spatial_step._env_model(env)
            nbytes = self.lib.spatial_model_bytes(f64)
            buf = ctypes.create_string_buffer(nbytes)
            if self.lib.spatial_pack_model(f64, ints, len(ints), dbl, len(dbl), buf, nbytes) != 0:
                raise RuntimeError(f"{self.source} rejects the packed model")
            self.models[key] = torch.frombuffer(bytearray(buf.raw), dtype=torch.uint8).to("cuda")
        return self.models[key]

    def _head(self, env, dtype):
        f64 = int(dtype == torch.float64)
        ints, _ = spatial_step._env_model(env)
        return f64, (self._model(env, f64).data_ptr(), env.MODEL.n_dof, env.MODEL.n_q, ints[12],
                     env.action_dim)

    def rollout(self, env, x, ctrl, out):
        f64, head = self._head(env, x.dtype)
        fn = self.lib.spatial_rollout_costs_f64 if f64 else self.lib.spatial_rollout_costs_f32
        rc = fn(*head, x.data_ptr(), ctrl.data_ptr(), out.data_ptr(), ctrl.shape[2], ctrl.shape[0],
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{self.source}: rollout launch failed, CUDA error {rc}")
        return out

    def step(self, env, xs, acts, out):
        f64, head = self._head(env, xs.dtype)
        fn = self.lib.spatial_step_states_f64 if f64 else self.lib.spatial_step_states_f32
        rc = fn(*head, xs.data_ptr(), acts.data_ptr(), out.data_ptr(), xs.shape[0],
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{self.source}: step launch failed, CUDA error {rc}")
        return out


def largest_difference(a: torch.Tensor, b: torch.Tensor) -> str:
    """The largest |a - b| and how many entries differ in their bits."""
    bits = torch.int64 if a.dtype == torch.float64 else torch.int32
    apart = a.view(bits) != b.view(bits)
    differ = int(apart.sum())
    largest = float((a - b)[apart].abs().nan_to_num(float("inf")).max()) if differ else 0.0
    return f"{largest:.3g} ({differ} of {a.numel()} differ)"


def timed(fn, launches: int = 3) -> float:
    """ms a launch: `launches` back to back between CUDA events."""
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(launches):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / launches


def compare(copies: list[Copy], only: list[str], steps: int, rounds: int) -> None:
    print("copies:", ", ".join(f"[{i}] {c.source}" for i, c in enumerate(copies)))
    for i, c in enumerate(copies):
        for line in c.log.splitlines():
            if "Function properties" in line:
                print(f"  [{i}] ptxas:", line.strip()[:40], "...", line.strip()[-60:])
            elif "registers" in line or "spill" in line:
                print(f"  [{i}] ptxas:", line.strip())
    for which in only:
        b = list(BUILDS).index(which)
        for f64 in (0, 1):
            print(f"{which} f{64 if f64 else 32}: " + "; ".join(
                "[{}] {} warps a block, {} resident an SM, {} B a warp, {} registers, "
                "{} local B".format(i, *c.occupancy(f64, b)) for i, c in enumerate(copies)))
    for which in only:
        cls, k, horizon, its, lam, start, hi, seed = BUILDS[which]
        env32 = cls(dtype=torch.float32, device="cuda")
        na = env32.action_dim
        starts = {start: start_state(which, env32, start).contiguous(),
                  f"main path after {steps} steps": main_path_state(env32, na, k, horizon, its,
                                                                     lam, steps)}
        rng = np.random.default_rng(seed)
        ctrl64 = rng.uniform(-hi, hi, (horizon, na, k))
        acts64 = rng.uniform(-hi, hi, (k, na))
        for dtype in (torch.float32, torch.float64):
            env = cls(dtype=dtype, device="cuda")
            ctrl = torch.as_tensor(ctrl64, dtype=dtype, device="cuda")
            acts = torch.as_tensor(acts64, dtype=dtype, device="cuda")
            for label, x0 in starts.items():
                x = x0.to(dtype).contiguous()
                noise = torch.as_tensor(rng.uniform(-0.01, 0.01, (k, x.numel())), dtype=dtype,
                                        device="cuda")
                noise[:, env.MODEL.n_q + env.MODEL.n_dof:] = 0  # the carry stays the state's
                xs = (x + noise).contiguous()
                costs = [c.rollout(env, x, ctrl, torch.empty(k, dtype=dtype, device="cuda"))
                         for c in copies]
                states = [c.step(env, xs, acts, torch.empty_like(xs)) for c in copies]
                torch.cuda.synchronize()
                print(f"{which} {str(dtype)[6:]} K={k} T={horizon} from {label}: " + "; ".join(
                    f"[{i}] costs {largest_difference(costs[i], costs[0])}, step states "
                    f"{largest_difference(states[i], states[0])}"
                    for i in range(1, len(copies))), flush=True)
        if rounds < 1:
            continue
        x = starts[f"main path after {steps} steps"]
        ctrl = torch.as_tensor(ctrl64, dtype=torch.float32, device="cuda")
        act1 = torch.as_tensor(acts64[:1], dtype=torch.float32, device="cuda")
        costs = torch.empty(k, dtype=torch.float32, device="cuda")
        out1 = torch.empty_like(x[None])
        roll = [[] for _ in copies]
        step = [[] for _ in copies]
        for c in copies:  # warm-up
            c.rollout(env32, x, ctrl, costs)
            c.step(env32, x[None], act1, out1)
        torch.cuda.synchronize()
        for r in range(rounds):
            order = range(len(copies)) if r % 2 == 0 else reversed(range(len(copies)))
            for i in order:
                c = copies[i]
                roll[i].append(timed(lambda: c.rollout(env32, x, ctrl, costs)))
                step[i].append(timed(lambda: c.step(env32, x[None], act1, out1), 10))
        for name, ms in (("rollout", roll), ("one-state step entry", step)):
            print(f"{which} f32 {name} from the main path's state, ms a launch over {rounds} "
                  "rounds: " + "; ".join(
                      f"[{i}] median {np.median(t):.4f} ({min(t):.4f}-{max(t):.4f})"
                      for i, t in enumerate(ms)), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=",".join(BUILDS), help="builds, comma-separated")
    ap.add_argument("--source", type=Path, nargs="+",
                    help="copies of spatial_rollout.cu to hold against the tree's")
    ap.add_argument("--steps", type=int, default=10,
                    help="main-path control steps before the second start (--source)")
    ap.add_argument("--rounds", type=int, default=10,
                    help="timing rounds (--source; 0: no timing)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("spatial_k_scan: needs a CUDA card")
    print(card())
    only = args.only.split(",")
    if not args.source:
        scan(only)
        return
    sources = [build.CSRC_DIR / "spatial_rollout.cu", *args.source]
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        copies = list(pool.map(Copy, sources))
    compare(copies, only, args.steps, args.rounds)


if __name__ == "__main__":
    main()
