"""Phase times of the covariance-refit kernels (csrc/ais_update.cu) on the card.

Builds two copies of ais_update.cu, one with REFIT_STAMP defined and one
as it is, in parallel. In the stamped copy each stamp reads %globaltimer
(ns) on thread 0 of the first block, after a barrier, and charges the time
since the previous stamp to its phase (the `RefitPhase` enum of the
source) by a reduction that thread 0 does not wait for; a launch of many blocks is charged as one span, from its first
block's entry to its last block's exit (REFIT_SPAN_*). Runs both at
chip_smoke.py's phase-12 shapes (f32, K = 8192, m = 1638 elite columns of
a random mask; the weights w^4 normalised; PMC's multinomial counts / K),
holds them against the plain version, and prints the stamped split and
the unstamped copy's time: device-only (30 calls in a CUDA graph) and back
to back (CUDA events).

    python scripts/refit_phase_times.py                        # n = 100, 136; ss, mle, weighted
    python scripts/refit_phase_times.py --n 100 --methods ss lw pmc
    python scripts/refit_phase_times.py --source _export/parent/mpopis_tpu_torch/csrc/ais_update.cu \
        mpopis_tpu_torch/csrc/ais_update.cu    # parent, change, change, parent

`--source` takes one or more copies of ais_update.cu with the same C
interface (a parent's unpacked under a directory that .gitignore lists,
with its headers beside it). The copies are built under mpopis_tpu_torch/_build/phase_times/
refit/ with the flags of kernels/build.py; the kernel itself is not changed.
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

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from mpopis_tpu_torch.kernels import ais_update, build  # noqa: E402

OUT = build.BUILD_DIR / "phase_times" / "refit"
PRELUDE = """#include <cuda_runtime.h>
__device__ unsigned long long* g_refit_ns;  // [phases][2]: ns and stamps
__device__ unsigned long long g_span_first = ~0ull;
__device__ unsigned long long g_span_last = 0ull;
__shared__ unsigned long long s_refit_last;
__device__ __forceinline__ unsigned long long refit_now() {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  return now;
}
__device__ __forceinline__ bool refit_first_thread() {
  return threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0;
}
__device__ __forceinline__ void refit_stamp(int phase, bool start) {
  if (!refit_first_thread()) return;
  const unsigned long long now = refit_now();
  if (!start) {  // reductions: thread 0 does not wait for the sums' old values
    atomicAdd(g_refit_ns + 2 * phase, now - s_refit_last);
    atomicAdd(g_refit_ns + 2 * phase + 1, 1ull);
  }
  s_refit_last = now;
}
__device__ __forceinline__ void refit_span_enter() {
  if (threadIdx.x == 0) atomicMin(&g_span_first, refit_now());
}
__device__ __forceinline__ void refit_span_exit() {
  __syncthreads();
  if (threadIdx.x == 0) atomicMax(&g_span_last, refit_now());
}
__device__ __forceinline__ void refit_stamp_span(int span, int gap) {
  if (!refit_first_thread()) return;
  const unsigned long long now = refit_now();
  atomicAdd(g_refit_ns + 2 * span, g_span_last - g_span_first);
  atomicAdd(g_refit_ns + 2 * span + 1, 1ull);
  atomicAdd(g_refit_ns + 2 * gap, now - g_span_last);
  atomicAdd(g_refit_ns + 2 * gap + 1, 1ull);
  g_span_first = ~0ull;
  g_span_last = 0ull;
  s_refit_last = now;
}
#define REFIT_STAMP(phase) refit_stamp(phase, false)
#define REFIT_STAMP_START() refit_stamp(0, true)
#define REFIT_STAMP_BARRIER(phase) do { __syncthreads(); refit_stamp(phase, false); } while (0)
#define REFIT_SPAN_ENTER() refit_span_enter()
#define REFIT_SPAN_EXIT() refit_span_exit()
#define REFIT_STAMP_SPAN(span, gap) refit_stamp_span(span, gap)
"""
SETUP = """
extern "C" int phase_setup(void* ns) {
  return static_cast<int>(cudaMemcpyToSymbol(g_refit_ns, &ns, sizeof(ns)));
}
"""
METHODS = (*ais_update.METHODS, "weighted", "pmc")


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def phase_names(source: Path) -> list[str]:
    """The `RefitPhase` enum of the source, kRefitPhases excluded."""
    body = re.search(r"enum RefitPhase \{(.*?)\};", source.read_text(), re.S)
    if body is None:
        raise RuntimeError(f"{source} has no `enum RefitPhase`")
    names = [n.strip() for n in body.group(1).split(",") if n.strip()]
    if names[-1] != "kRefitPhases":
        raise RuntimeError("`enum RefitPhase` must end with kRefitPhases")
    return [n[6:].lower() for n in names[:-1]]


def _nvcc(src: Path, so: Path) -> str:
    cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    return proc.stdout + proc.stderr


def _bind(so: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(so))
    ptr, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.ais_refit_chol_f32.argtypes = [ptr, ptr, ptr, i32, i32, i32, f64, f64, i32, ptr, ptr, ptr]
    lib.ais_refit_chol_f32.restype = i32
    # the two-launch kernels' scratch takes (n, k); the cluster kernel's (n, k, f64)
    lib.ais_refit_scratch_elems.argtypes = [i32, i32, i32]
    lib.ais_refit_scratch_elems.restype = ctypes.c_longlong
    if hasattr(lib, "ais_refit_layout"):
        lib.ais_refit_layout.argtypes, lib.ais_refit_layout.restype = [i32, i32, i32], i32
    return lib


def build_copies(source: Path):
    """(stamped library, unstamped library, the unstamped build's log)."""
    out = OUT / hashlib.sha256(str(source.resolve()).encode()).hexdigest()[:8]
    # both copies are rebuilt every run: a copy's name says which source, not which contents
    out.mkdir(parents=True, exist_ok=True)
    stamped = out / "ais_update_stamped.cu"
    stamped.write_text(PRELUDE + f'#include "{source.resolve()}"\n' + SETUP)
    plain = out / "ais_update_plain.cu"
    plain.write_text(f'#include "{source.resolve()}"\n')
    jobs = ((stamped, out / "libais_update_stamped.so"), (plain, out / "libais_update_plain.so"))
    with ThreadPoolExecutor(max_workers=2) as pool:
        logs = list(pool.map(lambda j: _nvcc(*j), jobs))
    lib_s, lib_p = _bind(jobs[0][1]), _bind(jobs[1][1])
    lib_s.phase_setup.argtypes, lib_s.phase_setup.restype = [ctypes.c_void_p], ctypes.c_int
    return lib_s, lib_p, logs[1]


def inputs(n: int, k: int, m: int):
    """(E, mask, w, counts / K) as chip_smoke.py phase 12 makes them (seed 12
    there; n + k here), float32 on the card."""
    g = torch.Generator("cuda").manual_seed(n + k)
    e = 0.3 * torch.randn((n, k), generator=g, device="cuda", dtype=torch.float64)
    mask = torch.zeros(k, device="cuda", dtype=torch.float64)
    mask[torch.randperm(k, generator=g, device="cuda")[:m]] = 1.0
    w = torch.rand(k, generator=g, device="cuda", dtype=torch.float64) ** 4
    w /= w.sum()
    counts = torch.bincount(torch.multinomial(w, k, replacement=True, generator=g),
                            minlength=k).to(torch.float64)
    return tuple(t.float().contiguous() for t in (e, mask, w, counts / k))


def case(method: str, e, mask, w, pmc, m: int):
    """(weights, mu, method id, m, corrected, the plain version's result)."""
    if method in ais_update.METHODS:
        mu = (e @ mask) / m
        return (mask, mu, ais_update.METHODS.index(method), m, 0,
                ais_update.masked_refit_chol_reference(e, mask, mu, m, method, 1e-8))
    wts, corrected = (w, False) if method == "weighted" else (pmc, True)
    mu = e @ wts
    return (wts, mu, len(ais_update.METHODS), e.shape[1], int(corrected),
            ais_update.weighted_refit_chol_reference(e, wts, mu, corrected, 1e-8))


def device_ms(fn, reps: int = 30) -> float:
    """ms a call of `reps` calls captured in a CUDA graph, its replay timed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def back_to_back_ms(fn, reps: int = 30) -> float:
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


class Copy:
    """A source's stamped and unstamped builds, its phases and stamp buffer."""

    def __init__(self, source: Path):
        self.source = source
        self.names = phase_names(source)
        self.lib_s, self.lib_p, self.log = build_copies(source)
        self.ns = torch.zeros((len(self.names), 2), dtype=torch.int64, device="cuda")
        if self.lib_s.phase_setup(self.ns.data_ptr()) != 0:
            raise RuntimeError("could not point the kernel at the stamp buffer")

    def launcher(self, lib, n, k, e, wts, mu, mid, m, corrected):
        scratch = torch.empty(max(int(self.lib_p.ais_refit_scratch_elems(n, k, 0)), 1),
                              device="cuda")
        out = torch.empty((n, n), device="cuda")

        def launch():
            rc = lib.ais_refit_chol_f32(
                e.data_ptr(), wts.data_ptr(), mu.data_ptr(), n, k, mid, float(m), 1e-8,
                corrected, scratch.data_ptr(), out.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"launch failed: CUDA error {rc}")
            return out

        return launch


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", type=Path, nargs="+", default=[build.CSRC_DIR / "ais_update.cu"],
                    help="one or more copies of ais_update.cu; with two or more, the "
                         "unstamped ones are timed in turns: each in order, then in reverse")
    ap.add_argument("--n", type=int, nargs="+", default=[100, 136])
    ap.add_argument("--k", type=int, default=8192)
    ap.add_argument("--m", type=int, default=round(0.2 * 8192))
    ap.add_argument("--methods", nargs="+", choices=METHODS, default=["ss", "mle", "weighted"])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("refit_phase_times: needs a CUDA card")
    print(card(), "| sources", *args.source)
    with ThreadPoolExecutor(max_workers=len(args.source)) as pool:
        copies = list(pool.map(Copy, args.source))
    for label, cp in enumerate(copies):
        print(f"[{label}] {cp.source}")
        for line in cp.log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print("  ptxas:", line.strip())
    order = list(range(len(copies))) + list(range(len(copies)))[::-1]
    for n in args.n:
        e, mask, w, pmc = inputs(n, args.k, args.m)
        for method in args.methods:
            wts, mu, mid, m, corrected, want = case(method, e, mask, w, pmc, args.m)
            scale = float(want.abs().max())
            runs = []
            for label, cp in enumerate(copies):
                run_s = cp.launcher(cp.lib_s, n, args.k, e, wts, mu, mid, m, corrected)
                run_p = cp.launcher(cp.lib_p, n, args.k, e, wts, mu, mid, m, corrected)
                errs = [float((run() - want).abs().max()) / scale for run in (run_p, run_s)]
                torch.cuda.synchronize()
                cp.ns.zero_()
                for _ in range(args.reps):
                    run_s()
                torch.cuda.synchronize()
                per = cp.ns.double().cpu().numpy() / args.reps
                total = per[:, 0].sum()
                layout = (f", layout {cp.lib_p.ais_refit_layout(n, args.k, 0)}"
                          if hasattr(cp.lib_p, "ais_refit_layout") else "")
                print(f"[{label}] n={n} K={args.k} {method} f32{layout}: stamped "
                      f"{total / 1e3:.2f} us from the first stamp to the last (mean of "
                      f"{args.reps} calls); max|err| / max|plain| {errs[0]:.2e} (stamped "
                      f"{errs[1]:.2e})")
                print("  " + ", ".join(
                    f"{name} {per[i, 0] / 1e3:.2f} us ({100 * per[i, 0] / total:.1f}%, "
                    f"{int(per[i, 1])} stamps)" for i, name in enumerate(cp.names)
                    if per[i, 1] > 0))
                runs.append(run_p)
            timed = [(label, device_ms(runs[label]), back_to_back_ms(runs[label]))
                     for label in order]
            print("  unstamped, in turns: " + "; ".join(
                f"[{label}] {dev:.4f} ms device-only (CUDA graph of 30), {b2b:.4f} back to back"
                for label, dev, b2b in timed))


if __name__ == "__main__":
    main()
