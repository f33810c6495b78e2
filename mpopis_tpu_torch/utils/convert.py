"""Hand the JAX package's parameters and state to the port.

The system has no learned weights: what carries across is its physical
parameters, track geometry, environment state, policy mean and sampling
covariance. Each function takes the JAX package's value as numpy arrays or
a plain dict (e.g. `dataclasses.asdict(jax_params)`, `np.asarray(state.x)`)
and returns the port's; nothing here imports jax.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mpopis_tpu_torch.models.base import EnvState, make_state
from mpopis_tpu_torch.models.car_racing import CarParams
from mpopis_tpu_torch.models.track import Track
from mpopis_tpu_torch.policies.config import PolicyState, init_policy_state


def car_params(d: dict) -> CarParams:
    """CarParams from a dict holding every field."""
    return CarParams(**{f.name: float(d[f.name]) for f in dataclasses.fields(CarParams)})


def track(d: dict) -> Track:
    """Track from a dict of its fields (numpy arrays and `sample_factor`)."""
    arrays = {
        f.name: np.asarray(d[f.name], dtype=float)
        for f in dataclasses.fields(Track)
        if f.name != "sample_factor"
    }
    return Track(**arrays, sample_factor=int(d["sample_factor"]))


def env_state(x, dtype=torch.float32, device="cpu", t: int = 0) -> EnvState:
    """EnvState from a state vector (e.g. `np.asarray(jax_state.x)`)."""
    return make_state(torch.as_tensor(np.asarray(x), dtype=dtype, device=device), t=t)


def policy_state(u, seed: int, dtype=torch.float32, device="cpu") -> PolicyState:
    """PolicyState from a flat control mean U and a seed for its generator."""
    return init_policy_state(torch.as_tensor(np.asarray(u), dtype=dtype, device=device), seed)


def u0_and_sigma(u0, sigma, dtype=torch.float32, device="cpu"):
    """(U₀, Σ) as tensors: the nominal controls and the sampling covariance."""
    return (
        torch.as_tensor(np.asarray(u0), dtype=dtype, device=device),
        torch.as_tensor(np.asarray(sigma), dtype=dtype, device=device),
    )
