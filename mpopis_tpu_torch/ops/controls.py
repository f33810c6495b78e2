"""Control clamping and the receding-horizon shift; counterpart of
`mpopis_tpu/ops/controls.py`."""

from __future__ import annotations

import torch


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
