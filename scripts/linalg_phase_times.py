"""Phase times of the Cholesky kernel (csrc/linalg.cu over csrc/block_linalg.cuh)
on the card.

Builds a copy of the kernel with a timestamp (%globaltimer, ns) taken by
thread 0 after each block barrier of `block_cholesky` and at the kernel's
entry and exit, runs it at each n, checks it against the plain version, and
prints the time between stamps: the staging copy, then per panel of 32
columns the diagonal block, the panel solve and the trailing update (with the
write-through of the finished panel), and the exit. Thread 0 reaches a stamp
after the barrier, so each phase includes the barrier that ends it.

    python scripts/linalg_phase_times.py                    # n = 100, 136
    python scripts/linalg_phase_times.py --n 100 --threads 256 384 512 1024

The copy is built under mpopis_tpu_torch/_build/phase_times/ with the flags
of kernels/build.py; the kernel itself is not changed.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from mpopis_tpu_torch.kernels import build, linalg  # noqa: E402

OUT = build.BUILD_DIR / "phase_times"
STAMP = ('#define STAMP() do { if (threadIdx.x == 0) { unsigned long long t_; '
         'asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)); '
         'g_stamps[s_nstamps++] = t_; } } while (0)\n')
BARRIERS = ("__syncthreads();  // the caller's writes to `a` are complete",
            "__syncthreads();  // L11 and inv are visible",
            "__syncthreads();  // L21 is visible",
            "__syncthreads();  // the trailing matrix is updated")
ENTRY = "  T* w = kSmem ? reinterpret_cast<T*>(smem_raw) : l;\n"
EXIT = ("  mpopis::block_cholesky(w, n, lda, kSmem ? l : nullptr);"
        "  // its first barrier orders the copy\n")


def _instrumented(threads: int) -> Path:
    """Write the stamped copy of the sources for `threads` and build it."""
    header = (build.CSRC_DIR / "block_linalg.cuh").read_text()
    for anchor in BARRIERS:
        if anchor not in header:
            raise RuntimeError(f"block_linalg.cuh no longer has {anchor!r}")
        header = header.replace(anchor, anchor + "\n  STAMP();")
    src = (build.CSRC_DIR / "linalg.cu").read_text()
    for anchor in (ENTRY, EXIT, "constexpr int kCholThreads = ", '#include "block_linalg.cuh"'):
        if anchor not in src:
            raise RuntimeError(f"linalg.cu no longer has {anchor!r}")
    src = src.replace(ENTRY, ENTRY + "  if (threadIdx.x == 0) s_nstamps = 0;\n  STAMP();\n")
    src = src.replace(EXIT, EXIT + "  __syncthreads();\n  STAMP();\n"
                      "  if (threadIdx.x == 0) g_nstamps = s_nstamps;\n")
    head, tail = src.split("constexpr int kCholThreads = ", 1)
    src = head + f"constexpr int kCholThreads = {threads};" + tail.split(";", 1)[1]
    src = src.replace('#include "block_linalg.cuh"',
                      "__device__ unsigned long long* g_stamps;\n__device__ int g_nstamps;\n"
                      "__shared__ int s_nstamps;\n" + STAMP + '#include "block_linalg.cuh"')
    src += ('\nextern "C" int phase_set_stamps(void* p) {\n'
            "  return static_cast<int>(cudaMemcpyToSymbol(g_stamps, &p, sizeof(p)));\n}\n"
            'extern "C" int phase_count() {\n  int v = 0;\n'
            "  cudaMemcpyFromSymbol(&v, g_nstamps, sizeof(int));\n  return v;\n}\n")
    d = OUT / f"t{threads}"
    d.mkdir(parents=True, exist_ok=True)
    (d / "block_linalg.cuh").write_text(header)
    (d / "linalg.cu").write_text(src)
    so = d / "liblinalg_phases.so"
    cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(d / "linalg.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {threads} threads:\n{proc.stdout}{proc.stderr}")
    return so


def _names(n: int) -> list[str]:
    names = ["stage"]
    for j0 in range(0, n, 32):
        names.append(f"diag@{j0}")
        if j0 + 32 < n:
            names += [f"panel@{j0}", f"syrk@{j0}"]
    return names + ["exit"]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, nargs="+", default=[100, 136])
    ap.add_argument("--threads", type=int, nargs="+", default=[384])
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("linalg_phase_times: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    with ThreadPoolExecutor(max_workers=len(args.threads)) as pool:
        libs = dict(zip(args.threads, pool.map(_instrumented, args.threads)))
    g = torch.Generator("cuda").manual_seed(0)
    stamps = torch.zeros(256, dtype=torch.int64, device="cuda")
    for n in args.n:
        b = 0.2 * torch.randn((n, n), generator=g, device="cuda", dtype=torch.float64)
        a = (b @ b.T + torch.eye(n, device="cuda", dtype=torch.float64)).float()
        want = linalg.chol_reference(a)
        for threads, so in libs.items():
            lib = ctypes.CDLL(str(so))
            fn = lib.linalg_chol_f32
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            lib.phase_set_stamps.argtypes = [ctypes.c_void_p]
            lib.phase_set_stamps.restype = ctypes.c_int
            lib.phase_count.argtypes, lib.phase_count.restype = [], ctypes.c_int
            if lib.phase_set_stamps(stamps.data_ptr()) != 0:
                raise RuntimeError("could not point the kernel at the stamp buffer")
            out = torch.empty_like(a)
            stream = torch.cuda.current_stream().cuda_stream
            for _ in range(args.reps):
                if fn(a.data_ptr(), out.data_ptr(), n, stream) != 0:
                    raise RuntimeError("launch failed")
            torch.cuda.synchronize()
            err = float((out - want).abs().max())
            t = stamps[:lib.phase_count()].cpu().tolist()
            phases = [(t[i + 1] - t[i]) / 1e3 for i in range(len(t) - 1)]
            names = _names(n)
            if len(names) != len(phases):
                raise RuntimeError(f"{len(phases)} phases, expected {len(names)}")
            print(f"n={n} f32, {threads} threads: {(t[-1] - t[0]) / 1e3:.2f} us from entry to "
                  f"exit (the last of {args.reps} calls), max|err| against the plain version "
                  f"{err:.2e}")
            print("  " + ", ".join(f"{name} {us:.2f}" for name, us in zip(names, phases)))


if __name__ == "__main__":
    main()
