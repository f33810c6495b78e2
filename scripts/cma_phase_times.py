"""Phase times of the CMA-tail kernel (csrc/ais_update.cu) on the card.

Builds a copy of ais_update.cu with CMA_STAMP defined, so that each stamp
reads %globaltimer (ns) on thread 0 of the first block (block 0 of the
cluster), after a barrier, and charges the time since the previous stamp to
its phase (the `CmaPhase` enum of the source): the set-up, the copies of a
whole matrix into shared memory (pull), the two Newton–Schulz stages of each
of the 20 steps (t = 1.5 I - 0.5 z y, ending with its cluster barrier and
the copy of z beside it; y t and t z, ending with theirs), the scaling to C
dw and ||C||^2, the tail (the paths, the step size and rank-mu over K),
Sigma_new, the jitter with the Cholesky, and the copy-out. Runs it at
chip_smoke.py's phase-12 shapes (f32, K = 8192, iteration 3), holds it
against the kernel, and times the kernel (kernels/ais_update.py) back to back.

    python scripts/cma_phase_times.py                       # n = 100
    python scripts/cma_phase_times.py --n 100 136
    python scripts/cma_phase_times.py --source _export/parent/mpopis_tpu_torch/csrc/ais_update.cu

`--source` takes another copy of ais_update.cu (a parent's, unpacked under a
directory that .gitignore lists, with its block_linalg.cuh beside it) with
the same C interface. The copies are built under mpopis_tpu_torch/_build/phase_times/cma/ with the flags of
kernels/build.py; the kernel itself is not changed.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import re
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from mpopis_tpu_torch.kernels import ais_update, build  # noqa: E402
from mpopis_tpu_torch.policies.strategies import CMAStrategy  # noqa: E402

OUT = build.BUILD_DIR / "phase_times" / "cma"
PRELUDE = """#include <cuda_runtime.h>
__device__ unsigned long long* g_cma_ns;  // [phases][2]: ns and stamps
__shared__ unsigned long long s_cma_last;
__device__ __forceinline__ void cma_stamp(int phase, bool start) {
  if (threadIdx.x != 0 || blockIdx.x != 0) return;
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  if (!start) {
    g_cma_ns[2 * phase] += now - s_cma_last;
    g_cma_ns[2 * phase + 1] += 1;
  }
  s_cma_last = now;
}
#define CMA_STAMP(phase) cma_stamp(phase, false)
#define CMA_STAMP_START() cma_stamp(0, true)
"""
SETUP = """
extern "C" int phase_setup(void* ns) {
  return static_cast<int>(cudaMemcpyToSymbol(g_cma_ns, &ns, sizeof(ns)));
}
"""


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def phase_names(source: Path) -> list[str]:
    """The `CmaPhase` enum of the source, kCmaPhases excluded."""
    body = re.search(r"enum CmaPhase \{(.*?)\};", source.read_text(), re.S)
    if body is None:
        raise RuntimeError(f"{source} has no `enum CmaPhase`")
    names = [n.strip() for n in body.group(1).split(",") if n.strip()]
    if names[-1] != "kCmaPhases":
        raise RuntimeError("`enum CmaPhase` must end with kCmaPhases")
    return [n[4:].lower() for n in names[:-1]]


def build_copy(source: Path) -> tuple[ctypes.CDLL, str]:
    out = OUT / hashlib.sha256(str(source.resolve()).encode()).hexdigest()[:8]
    out.mkdir(parents=True, exist_ok=True)
    src = out / "ais_update.cu"
    src.write_text(PRELUDE + f'#include "{source.resolve()}"\n' + SETUP)
    so = out / "libais_update_phases.so"
    log = out / "build.log"
    if not (so.exists() and log.exists() and so.stat().st_mtime > source.stat().st_mtime):
        cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True, check=False, timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
        log.write_text(proc.stdout + proc.stderr)
    lib = ctypes.CDLL(str(so))
    lib.phase_setup.argtypes, lib.phase_setup.restype = [ctypes.c_void_p], ctypes.c_int
    ptr, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.ais_cma_update_f32.argtypes = [ptr] * 7 + [i32, i32, ptr, f64, f64, i32, i32, i32] + \
        [ptr] * 7
    lib.ais_cma_update_f32.restype = ctypes.c_int
    lib.ais_cma_scratch_elems.argtypes, lib.ais_cma_scratch_elems.restype = [i32], \
        ctypes.c_longlong
    if hasattr(lib, "ais_cma_cluster_size"):
        lib.ais_cma_cluster_size.argtypes, lib.ais_cma_cluster_size.restype = [i32, i32], i32
    return lib, log.read_text()


def inputs(n: int, k: int):
    """chip_smoke.py phase 12's CMA inputs (seed 12 there; 5 here), f32."""
    g = torch.Generator("cuda").manual_seed(5)
    a = 0.05 * torch.randn((n, n), generator=g, device="cuda", dtype=torch.float64)
    consts = CMAStrategy.constants(k, n, 0.8)
    consts_t = tuple(sorted((name, float(consts[name])) for name in ais_update.CMA_CONSTS))
    args = (a @ a.T + 0.3 * torch.eye(n, device="cuda", dtype=torch.float64),
            0.3 * torch.randn(n, generator=g, device="cuda", dtype=torch.float64),
            0.5 * torch.randn(n, generator=g, device="cuda", dtype=torch.float64),
            0.1 * torch.randn(n, generator=g, device="cuda", dtype=torch.float64),
            torch.randn(k, generator=g, device="cuda", dtype=torch.float64),
            torch.as_tensor(consts["ws"], device="cuda"),
            torch.tensor(0.8, device="cuda", dtype=torch.float64))
    return tuple(t.float().contiguous() for t in args), consts_t


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", type=Path, default=build.CSRC_DIR / "ais_update.cu")
    ap.add_argument("--n", type=int, nargs="+", default=[100])
    ap.add_argument("--k", type=int, default=8192)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--build-only", action="store_true",
                    help="build the copy (kept for the next run of the same source) and stop")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("cma_phase_times: needs a CUDA card")
    print(card(), "| source", args.source)
    names = phase_names(args.source)
    lib, log = build_copy(args.source)
    if args.build_only:
        return
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())
    ns = torch.zeros((len(names), 2), dtype=torch.int64, device="cuda")
    if lib.phase_setup(ns.data_ptr()) != 0:
        raise RuntimeError("could not point the kernel at the stamp buffer")
    for n in args.n:
        cma, consts_t = inputs(n, args.k)
        want = ais_update.cma_update_chol(*cma, 3.0, consts_t, 1e-8)
        cvals = (ctypes.c_double * len(ais_update.CMA_CONSTS))(
            *(dict(consts_t)[name] for name in ais_update.CMA_CONSTS))
        scratch = torch.empty(int(lib.ais_cma_scratch_elems(n)), device="cuda")
        outs = [torch.empty((n, n), device="cuda"), torch.empty((n, n), device="cuda"),
                torch.empty(n, device="cuda"), torch.empty(n, device="cuda"),
                torch.empty((), device="cuda")]

        def launch():
            rc = lib.ais_cma_update_f32(
                *(t.data_ptr() for t in cma), n, args.k, ctypes.addressof(cvals), 3.0, 1e-8, 1,
                20, 1, scratch.data_ptr(), *(t.data_ptr() for t in outs),
                torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"launch failed: CUDA error {rc}")

        launch()
        torch.cuda.synchronize()
        ns.zero_()
        for _ in range(args.reps):
            launch()
        torch.cuda.synchronize()
        err = max(float((o - w).abs().max() / w.abs().max().clamp(min=1e-30))
                  for o, w in zip(outs, want))
        per = ns.double().cpu().numpy() / args.reps
        total = per[:, 0].sum()
        blocks = lib.ais_cma_cluster_size(n, 0) if hasattr(lib, "ais_cma_cluster_size") else 1
        print(f"n={n} K={args.k} f32, {blocks} blocks: {total / 1e3:.2f} us from the first stamp "
              f"to the last "
              f"(mean of {args.reps} calls); max|err| / max|kernel| against the kernel {err:.2e}")
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(args.reps):
            ais_update.cma_update_chol(*cma, 3.0, consts_t, 1e-8)
        t1.record()
        torch.cuda.synchronize()
        print(f"  the unstamped kernel (kernels/ais_update.py): {t0.elapsed_time(t1) / args.reps:.4f}"
              f" ms a call back to back (CUDA events, {args.reps} calls)")
        print("  " + ", ".join(
            f"{name} {per[i, 0] / 1e3:.2f} us ({100 * per[i, 0] / total:.1f}%, "
            f"{int(per[i, 1])} stamps)" for i, name in enumerate(names) if per[i, 1] > 0))


if __name__ == "__main__":
    main()
