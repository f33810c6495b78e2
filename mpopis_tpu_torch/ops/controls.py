"""Control-vector utilities: block-diagonal covariance tiling, clamping and
the receding-horizon shift; counterpart of `mpopis_tpu/ops/controls.py`."""

from __future__ import annotations

import numpy as np
import torch


def block_diag_repeat(a: torch.Tensor, reps: int) -> torch.Tensor:
    """A (d,) variance vector or a (d, d) covariance block tiled `reps`
    times along the diagonal of a (d·reps, d·reps) matrix: the per-step
    action covariance expanded over the horizon."""
    a = torch.as_tensor(a)
    if a.dim() == 1:
        return torch.diag(a.repeat(reps))
    if a.dim() != 2 or a.shape[0] != a.shape[1]:
        raise ValueError(f"expected (d,) or (d,d), got {tuple(a.shape)}")
    return torch.block_diag(*([a] * reps))


def controls_from_flat(v_flat: torch.Tensor, horizon: int, action_dim: int) -> torch.Tensor:
    """A flat timestep-major (cs,) control vector [u_1; …; u_T] as
    (horizon, action_dim)."""
    return v_flat.reshape(horizon, action_dim)


def action_bounds_tiled(low, high, horizon: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-step action bounds tiled over the horizon for flat (cs,) vectors."""
    return np.tile(np.asarray(low), horizon), np.tile(np.asarray(high), horizon)


def clamp_controls(v: torch.Tensor, low: torch.Tensor, high: torch.Tensor) -> torch.Tensor:
    """Clamp controls `v` (..., as) to per-dimension bounds `low`/`high`
    (as,) — or to any bounds that broadcast against `v`."""
    return torch.clamp(v, low, high)


def roll_controls(
    weighted_controls: torch.Tensor,
    u0: torch.Tensor,
    action_dim: int,
    reference_quirk: bool = True,
) -> torch.Tensor:
    """Drop the first action, shift everything left by one timestep, refill
    the tail from the nominal control U0.

    The reference's refill writes `as+1` elements, overwriting one element
    of the shifted region; `reference_quirk=True` (default) reproduces that
    exactly, `False` applies the intended `as`-element refill. Flat (cs,)
    vectors in and out; for horizon == 1 U is replaced wholesale.
    """
    cs = weighted_controls.shape[0]
    if cs == action_dim:  # horizon == 1
        return weighted_controls
    shifted = torch.cat([weighted_controls[action_dim:], u0[cs - action_dim :]])
    if reference_quirk:
        # overwrite one extra element (index cs-as-1) from U0
        shifted[cs - action_dim - 1] = u0[cs - action_dim - 1]
    return shifted
