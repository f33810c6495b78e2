"""Small-matrix linear algebra for the AIS update path.

Counterpart of `mpopis_tpu/kernels/linalg.py` on its default path, which
is the library one: the JAX package's Pallas Cholesky and forward-solve
kernels are opt-in there (`MPOPIS_PALLAS_LINALG=1`) and are not ported
yet. These two functions keep the JAX package's names so the hand-written
kernels can replace them later.
"""

from __future__ import annotations

import torch


def cholesky_lower(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor. Like `jnp.linalg.cholesky`, a matrix that is
    not positive definite gives NaNs instead of raising — and on the card
    `cholesky_ex` leaves the error code on the device, so no host sync."""
    l, info = torch.linalg.cholesky_ex(a)
    return torch.where(info[..., None, None] == 0, l, torch.nan)


def forward_solve(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """y = L⁻¹ b for b of shape (nrhs, n) (row-stacked right-hand sides)."""
    return torch.linalg.solve_triangular(l, b.T, upper=False).T
