"""Frozen copy of `mpopis_tpu_torch/models/planar.py` at commit 3b1bee442fec:
mjMINIMP and the unrolled Cholesky factor and solve (`MIN_IMP`,
`chol_unrolled`, `chol_solve`).

The benchmark's plain reference: it imports nothing of the program, and a
later change to the program leaves it as it is. Only the imports differ from
the original, which follows below as it stood.
"""

from __future__ import annotations

import torch

MIN_IMP = 1e-4  # mjMINIMP: MuJoCo clamps d0 to it before the sigmoid


def chol_unrolled(m: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of the symmetric (..., n, n) `m` (only its
    lower triangle is read), one column per step, unrolled over n. A matrix
    that is not positive definite gives NaNs, as the JAX unrolled factor
    does; nothing is checked, so on the card nothing synchronises."""
    n = m.shape[-1]
    cols = []
    for j in range(n):
        s = m[..., j:, j]
        if j:
            lp = torch.stack(cols, dim=-1)  # (..., n, j): the columns so far
            s = s - torch.sum(lp[..., j:, :] * lp[..., j : j + 1, :], dim=-1)
        d = torch.sqrt(s[..., :1])
        col = torch.cat([s[..., :1].new_zeros(s.shape[:-1] + (j,)), d, s[..., 1:] / d], dim=-1)
        cols.append(col)
    return torch.stack(cols, dim=-1)


def chol_solve(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve L Lᵀ x = b for b (..., n) with the factor of `chol_unrolled`.
    Counterpart of `chol_solve_unrolled`: forward then back substitution,
    here as two batched triangular solves."""
    y = torch.linalg.solve_triangular(l, b.unsqueeze(-1), upper=False)
    return torch.linalg.solve_triangular(l.transpose(-1, -2), y, upper=True).squeeze(-1)
