"""Build and load the CUDA sources under `csrc/` at first use.

Each `csrc/<name>.cu` has a plain C interface. It is compiled with nvcc for
Hopper (`sm_90a`) into a shared library under `mpopis_tpu_torch/_build/`
(listed in .gitignore), named by a hash of the source and the flags, and
loaded with ctypes. A missing nvcc or a failed compile raises: there is no
fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / shared memory / spills into the build log
)

# name -> loaded library, and name -> {"so", "seconds", "log"} of its build
# in this process. A loaded shared library stays for the life of the
# process, so these caches are process-wide by nature.
_LOADED: dict[str, ctypes.CDLL] = {}
BUILD_INFO: dict[str, dict] = {}


def find_nvcc() -> str:
    """nvcc from PATH, else from the CUDA toolkit torch finds (CUDA_HOME)."""
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME): the CUDA kernels of mpopis_tpu_torch "
        "are compiled at first use and need the CUDA toolkit"
    )


def library_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(name: str) -> Path:
    """Compile `csrc/<name>.cu` unless its library is already built."""
    so = library_path(name)
    log_path = so.with_name(so.name + ".log")
    if so.exists():
        log = log_path.read_text() if log_path.exists() else ""
        BUILD_INFO.setdefault(name, {"so": str(so), "seconds": 0.0, "log": log})
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False, timeout=900)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}) building {name}.cu:\n"
            f"{proc.stdout}{proc.stderr}"
        )
    log = proc.stdout + proc.stderr
    log_path.write_text(log)
    os.replace(tmp, so)  # atomic: a concurrent build sees all or nothing
    BUILD_INFO[name] = {"so": str(so), "seconds": seconds, "log": log}
    return so


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _LOADED[name] = lib
    return lib
