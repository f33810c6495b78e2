"""Small-matrix linear algebra for the AIS update path: the library
functions (the default), the CUDA kernels `csrc/linalg.cu`, their plain
PyTorch versions, and the switch between them.

Counterpart of `mpopis_tpu/kernels/linalg.py`. `cholesky_lower` and
`forward_solve` go to the library (`torch.linalg.cholesky_ex`,
`solve_triangular`) unless `MPOPIS_PALLAS_LINALG` is set, read at call time
as the JAX package reads it; then a float32 matrix of n ≤ 1024 on a CUDA
tensor goes to the hand-written kernels (the JAX package's Pallas kernels
`_chol_kernel` and `_fwd_solve_kernel`). Off the card the switch leaves the
library path, as the JAX package's does off the TPU.

The kernel wrappers `chol_kernel` and `fwd_solve_kernel` take a CPU tensor
to their plain versions (`chol_reference`, `fwd_solve_reference`) and a CUDA
tensor to the kernel, or raise. `CHOL_LAUNCHES` and `SOLVE_LAUNCHES` count
kernel launches, and nothing else.
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch

from mpopis_tpu_torch.kernels.build import load_library

MAX_N = 1024  # the largest matrix the switch sends to the kernels
MAX_RHS = 16  # kMaxRhs of csrc/linalg.cu: one warp per right-hand side
CHOL_LAUNCHES = 0
SOLVE_LAUNCHES = 0

_LIB: list[ctypes.CDLL] = []  # the loaded library, its argument types set
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _lib() -> ctypes.CDLL:
    if not _LIB:
        lib = load_library("linalg")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for name, argtypes, restype in (
            *((f"linalg_chol_{sfx}", [ptr, ptr, i32, ptr], i32) for sfx in _SUFFIX.values()),
            *((f"linalg_fwd_solve_{sfx}", [ptr, ptr, ptr, i32, i32, ptr], i32)
              for sfx in _SUFFIX.values()),
            ("linalg_max_solve_rhs", [], i32),
            ("linalg_chol_lda", [i32, i32], i32),
            ("linalg_fwd_solve_smem", [i32, i32, i32], ctypes.c_longlong),
        ):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, restype
        if lib.linalg_max_solve_rhs() != MAX_RHS:
            raise RuntimeError("linalg.cu and its wrapper disagree on the interface")
        _LIB.append(lib)
    return _LIB[0]


def chol_lda(n: int, dtype: torch.dtype) -> int:
    """The row stride the Cholesky kernel factors an (n, n) matrix with: an odd
    number of 16-byte units where those rows fit a block's shared memory, else n."""
    return _lib().linalg_chol_lda(n, torch.finfo(dtype).bits // 8)


@functools.lru_cache(maxsize=None)
def fwd_solve_fits(n: int, nrhs: int, dtype: torch.dtype) -> bool:
    """Whether the forward-solve kernel takes nrhs right-hand sides of length
    n: nrhs ≤ MAX_RHS and its two stages of L and y fit a block's shared memory.
    Cached, so a launch pays the library's answer once per shape."""
    return _lib().linalg_fwd_solve_smem(n, nrhs, torch.finfo(dtype).bits // 8) >= 0


def chol_reference(a: torch.Tensor) -> torch.Tensor:
    """Plain version of the Cholesky kernel: the TPU kernel's right-looking
    loop — column j is the pivot column times 1/√pivot, then the trailing
    matrix loses its outer product. Not positive definite → NaNs."""
    n = a.shape[0]
    rows = torch.arange(n, device=a.device)
    l = torch.zeros_like(a)
    for j in range(n):
        inv = 1.0 / torch.sqrt(a[j, j])
        colm = torch.where(rows >= j, a[:, j] * inv, 0.0)
        l[:, j] = colm
        a = a - colm[:, None] * colm[None, :]
    return l


def fwd_solve_reference(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of the forward-solve kernel: y = L⁻¹ b for b (nrhs, n)
    by the TPU kernel's right-looking substitution."""
    n = l.shape[0]
    cols = torch.arange(n, device=l.device)[None, :]
    y = b
    for j in range(n):
        yj = y[:, j : j + 1] / l[j, j]
        y = torch.where(cols == j, yj, y - torch.where(cols > j, l[:, j][None, :], 0.0) * yj)
    return y


def check_arg(fn: str, cond: bool, msg: str):
    """Raise ValueError(f"{fn}: {msg}") unless `cond` (the wrappers' argument checks)."""
    if not cond:
        raise ValueError(f"{fn}: {msg}")


def check_tensor(fn: str, name: str, t: torch.Tensor, dev, dtype):
    """`t` must be a contiguous `dtype` tensor on `dev`."""
    check_arg(fn, t.device == dev and t.dtype == dtype,
              f"{name} is {t.dtype} on {t.device}, want {dtype} on {dev}")
    check_arg(fn, t.is_contiguous(), f"{name} must be contiguous")


def chol_kernel(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of the symmetric (n, n) `a`: the plain version
    for a CPU tensor, the CUDA kernel for a CUDA tensor."""
    global CHOL_LAUNCHES
    dev = a.device
    if dev.type == "cpu":
        return chol_reference(a)
    check_arg("chol_kernel", dev.type == "cuda", f"tensor on {dev} (cpu or cuda only)")
    check_arg("chol_kernel", a.dtype in (torch.float32, torch.float64),
              f"dtype {a.dtype} (float32/float64 only)")
    check_arg("chol_kernel", a.dim() == 2 and a.shape[0] == a.shape[1] and a.shape[0] >= 1,
              f"shape {tuple(a.shape)}, want (n, n)")
    check_arg("chol_kernel", a.is_contiguous(), "matrix must be contiguous")
    n = a.shape[0]
    out = torch.empty_like(a)
    fn = getattr(_lib(), f"linalg_chol_{_SUFFIX[a.dtype]}")
    with torch.cuda.device(dev):
        rc = fn(a.data_ptr(), out.data_ptr(), n, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"linalg_chol kernel launch failed: CUDA error {rc}")
    CHOL_LAUNCHES += 1
    return out


def fwd_solve_kernel(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """y = L⁻¹ b for b (nrhs, n): the plain version for CPU tensors, the
    CUDA kernel for CUDA tensors."""
    global SOLVE_LAUNCHES
    dev = l.device
    if dev.type == "cpu" and b.device.type == "cpu":
        return fwd_solve_reference(l, b)
    check_arg("fwd_solve_kernel", dev.type == "cuda", f"tensor on {dev} (cpu or cuda only)")
    check_arg("fwd_solve_kernel", l.dtype in (torch.float32, torch.float64),
              f"dtype {l.dtype} (float32/float64 only)")
    check_arg("fwd_solve_kernel", l.dim() == 2 and l.shape[0] == l.shape[1] and l.shape[0] >= 1,
              f"L shape {tuple(l.shape)}, want (n, n)")
    n = l.shape[0]
    check_arg("fwd_solve_kernel", b.dim() == 2 and b.shape[1] == n and b.shape[0] >= 1,
              f"b shape {tuple(b.shape)}, want (nrhs, {n})")
    check_tensor("fwd_solve_kernel", "L", l, dev, l.dtype)
    check_tensor("fwd_solve_kernel", "b", b, dev, l.dtype)
    nrhs = b.shape[0]
    check_arg("fwd_solve_kernel", fwd_solve_fits(n, nrhs, l.dtype),
              f"{nrhs} right-hand sides of length {n} (too many)")
    fn = getattr(_lib(), f"linalg_fwd_solve_{_SUFFIX[l.dtype]}")
    out = torch.empty_like(b)
    with torch.cuda.device(dev):
        rc = fn(l.data_ptr(), b.data_ptr(), out.data_ptr(), n, nrhs,
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"linalg_fwd_solve kernel launch failed: CUDA error {rc}")
    SOLVE_LAUNCHES += 1
    return out


def _use_kernel(x: torch.Tensor) -> bool:
    """MPOPIS_PALLAS_LINALG set (any value), and a float32 matrix of
    n ≤ MAX_N on a CUDA tensor."""
    if not os.environ.get("MPOPIS_PALLAS_LINALG"):
        return False
    return x.device.type == "cuda" and x.dtype == torch.float32 and x.shape[-1] <= MAX_N


def cholesky_lower(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor. On the library path, like `jnp.linalg.cholesky`,
    a matrix that is not positive definite gives NaNs instead of raising —
    and on the card `cholesky_ex` leaves the error code on the device, so no
    host sync. With the switch on, the kernel (NaNs from the failing column on)."""
    if _use_kernel(a):
        return chol_kernel(a.contiguous())
    l, info = torch.linalg.cholesky_ex(a)
    return torch.where(info[..., None, None] == 0, l, torch.nan)


def forward_solve(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """y = L⁻¹ b for b of shape (nrhs, n) (row-stacked right-hand sides)."""
    if _use_kernel(l):
        return fwd_solve_kernel(l.contiguous(), b.contiguous())
    return torch.linalg.solve_triangular(l, b.T, upper=False).T
