"""Closed-form planar MuJoCo toolkit: the soft-constraint constants and the
small Cholesky factor and solve the contact stepper runs every substep.

Counterpart of `mpopis_tpu/models/planar.py:41-92`. The JAX package writes
these over tuples of scalars (one (K,) vector per matrix entry under vmap);
the port writes them over dense batched tensors — a mass matrix is one
(..., n, n) tensor — so a (K, n, n) batch factors in n column steps.
The energy-AD route (`build_planar_dynamics`, `rk4_step`) belongs to the
contact-free tasks and is not ported yet.
"""

from __future__ import annotations

import torch

# solimp defaults (0.9, 0.95, 0.001, 0.5, 2) and solref (0.02, 1)
_D0, _DMAX, _WIDTH, _MID = 0.9, 0.95, 0.001, 0.5
_SOLREF_TC = 0.02
MIN_IMP = 1e-4  # mjMINIMP: MuJoCo clamps d0 to it before the sigmoid


def _kb(timestep: float):
    """Constraint stiffness/damping from solref; MuJoCo clamps the
    timeconst to at least 2·timestep."""
    tc = max(_SOLREF_TC, 2.0 * timestep)
    return 1.0 / (_DMAX * tc) ** 2, 2.0 / (_DMAX * tc)


def impedance(pos: torch.Tensor, d0=_D0, dmax=_DMAX, width=_WIDTH) -> torch.Tensor:
    """solimp sigmoid d(|pos|), power 2, midpoint 0.5, with d0 clamped to
    mjMINIMP before the sigmoid (HalfCheetah's d0 = 0 becomes 1e-4)."""
    d0_eff = max(d0, MIN_IMP)
    x = torch.clamp(torch.abs(pos) / width, 0.0, 1.0)
    y = torch.where(x < _MID, 2.0 * x * x, 1.0 - 2.0 * (1.0 - x) ** 2)
    return d0_eff + (dmax - d0_eff) * y


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
