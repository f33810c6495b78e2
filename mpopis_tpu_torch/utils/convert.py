"""Hand the JAX package's parameters and state to the port.

The system has no learned weights: what carries across is its physical
parameters, the planar and spatial contact models' tables, track geometry,
environment state, policy mean and sampling covariance, and the AIS state
inside a control step. Each function takes the JAX package's value as numpy
arrays or a plain dict (e.g. `dataclasses.asdict(jax_params)`,
`np.asarray(state.x)`) and returns the port's; nothing here imports jax.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mpopis_tpu_torch.models.base import EnvState, make_state
from mpopis_tpu_torch.models.car_racing import CarParams
from mpopis_tpu_torch.models.planar_contact import (
    PCBody,
    PCCapsulePair,
    PCContact,
    PCLimit,
    PlanarContactModel,
)
from mpopis_tpu_torch.models.spatial_contact import (
    SCBody,
    SCContact,
    SCLimit,
    SCPairCapsule,
    SCPairCylinder,
    SJoint,
    SpatialContactModel,
)
from mpopis_tpu_torch.models.track import Track
from mpopis_tpu_torch.policies.config import PolicyState, init_policy_state
from mpopis_tpu_torch.policies.strategies import AISCarry


def car_params(d: dict) -> CarParams:
    """CarParams from a dict holding every field."""
    return CarParams(**{f.name: float(d[f.name]) for f in dataclasses.fields(CarParams)})


def _frozen(cls, d: dict):
    """A table dataclass from a dict of its fields, lists made tuples."""
    return cls(**{
        f.name: tuple(d[f.name]) if isinstance(d[f.name], (list, tuple)) else d[f.name]
        for f in dataclasses.fields(cls)
    })


def planar_model(d: dict) -> PlanarContactModel:
    """PlanarContactModel from `dataclasses.asdict(jax_model)`, its nested
    body, contact, limit and capsule-pair tables included."""
    nested = {"bodies": PCBody, "contacts": PCContact, "limits": PCLimit,
              "pairs": PCCapsulePair}
    d = dict(d)
    for name, cls in nested.items():
        d[name] = tuple(_frozen(cls, item) for item in d[name])
    return _frozen(PlanarContactModel, d)


def spatial_model(d: dict) -> SpatialContactModel:
    """SpatialContactModel from `dataclasses.asdict(jax_model)`, its nested
    body (with their joints), contact, limit and pair tables included."""
    d = dict(d)
    d["bodies"] = tuple(
        _frozen(SCBody, dict(b, joints=tuple(_frozen(SJoint, j) for j in b["joints"])))
        for b in d["bodies"]
    )
    for name, cls in (("contacts", SCContact), ("limits", SCLimit), ("pairs", SCPairCylinder),
                      ("self_pairs", SCPairCapsule)):
        d[name] = tuple(_frozen(cls, item) for item in d[name])
    return _frozen(SpatialContactModel, d)


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


def ais_carry(d: dict, dtype=torch.float32, device="cpu") -> AISCarry:
    """AISCarry from a JAX AISCarry's fields as numpy arrays: `U`, `chol`,
    `E`, `costs`, optionally `trajs`, and `extra` — None, or a dict of
    arrays (CMA's `Sigma`, `sigma`, `p_sigma`, `p_Sigma`; NES's `A`). The
    JAX carry's `done` and `key` have no counterpart: the port's driver
    keeps the stop flag and the generator outside the carry."""

    def tensor(a):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    extra = d.get("extra")
    return AISCarry(
        U=tensor(d["U"]),
        chol=tensor(d["chol"]),
        E=tensor(d["E"]),
        costs=tensor(d["costs"]),
        trajs=None if d.get("trajs") is None else tensor(d["trajs"]),
        extra=None if extra is None else {name: tensor(v) for name, v in extra.items()},
    )
