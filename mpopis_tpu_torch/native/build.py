"""Build the envpool_lite native engine against the MuJoCo library shipped
with the `mujoco` wheel.

Counterpart of `mpopis_tpu/native/build.py`. `envpool_lite.cc` (a copy of
the JAX package's, pinned to it by a test) is compiled with g++ into
`mpopis_tpu_torch/_build/` (listed in .gitignore), named by a hash of the
source and the command line, so a changed source or another wheel builds
anew. The library is written under a temporary name and renamed into place,
so processes that build at once each see all of it or nothing. A failed
build raises: there is no fallback.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC = _PKG / "native" / "envpool_lite.cc"
BUILD_DIR = _PKG / "_build"
CXX = "g++"


def _mujoco_paths():
    import mujoco

    pkg = os.path.dirname(mujoco.__file__)
    include = os.path.join(pkg, "include")
    libs = sorted(f for f in os.listdir(pkg) if f.startswith("libmujoco.so"))
    if not os.path.isdir(include) or not libs:
        raise RuntimeError("the mujoco wheel does not ship its headers and library")
    return pkg, include, libs[0]


def build() -> str:
    """Compile (if needed) and return the path of the engine's library."""
    pkg, include, libname = _mujoco_paths()
    # link the versioned .so directly and rpath the wheel's directory
    flags = ["-O2", "-shared", "-fPIC", "-std=c++17", "-pthread", "-fopenmp", f"-I{include}"]
    link = [os.path.join(pkg, libname), f"-Wl,-rpath,{pkg}"]
    digest = hashlib.sha256(SRC.read_bytes() + " ".join([CXX, *flags, *link]).encode())
    out = BUILD_DIR / f"libenvpool_lite_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return str(out)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [CXX, *flags, str(SRC), *link, "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, check=False, timeout=600)
    except OSError as exc:
        raise RuntimeError(f"envpool_lite: cannot run {CXX}: {exc}") from exc
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"envpool_lite: {CXX} failed (exit {proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    return str(out)
