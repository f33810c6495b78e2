"""Walker2d-v4 with on-device dynamics, contacts included.

Counterpart of `mpopis_tpu/models/walker2d_device.py`: the 9-DoF planar
tree of walker2d.xml (two thigh/leg/foot chains hinged about −y, leg and
foot joints anchored off their body origins), 14 plane-capsule contacts
with sigmoid solimp (0.9, 0.95, 0.001), no margin, μ 0.9 (1.9 on the left
foot), no self-collision, RK4 integration, frame skip 4. The constants are
copies of the JAX package's probed table (a test pins MODEL to it).

Obs/reward follow walker2d_v4.py: obs = [qpos[1:], clip(qvel, ±10)],
reward = 1 (healthy) + (x'−x)/dt − 1e-3·Σa²; episodes do not terminate.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from mpopis_tpu_torch.models.planar_contact import (
    PCBody,
    PCContact,
    PCLimit,
    PlanarContactEnv,
    PlanarContactModel,
)

_H = 0.002
_FRAME_SKIP = 4
_GEAR = (100.0,) * 6  # dofs 3..8

# right chain: thigh (1) → leg (2) → foot (3); the left chain (4..6) duplicates it
_BODIES = (
    PCBody(parent=-1, pos=(0.0, 0.0), anchor=(0.0, 0.0), sign=1.0,
           com=(0.0, 0.0), mass=3.6651914291880923,
           iyy=0.069245938072875, dof=2),  # torso
    PCBody(parent=0, pos=(0.0, -0.19999999999999996), anchor=(0.0, 0.0),
           sign=-1.0, com=(0.0, -0.2250000000000001),
           mass=4.057890510886818, iyy=0.09329875682692194, dof=3),
    PCBody(parent=1, pos=(0.0, -0.7000000000000001), anchor=(0.0, 0.25),
           sign=-1.0, com=(0.0, 0.0),
           mass=2.7813566959781637, iyy=0.07230254017320971, dof=4),
    PCBody(parent=2, pos=(0.2, -0.35), anchor=(-0.2, 0.1), sign=-1.0,
           com=(-0.1, 0.1), mass=3.1667253948185117,
           iyy=0.02399774663482943, dof=5),
    PCBody(parent=0, pos=(0.0, -0.19999999999999996), anchor=(0.0, 0.0),
           sign=-1.0, com=(0.0, -0.2250000000000001),
           mass=4.057890510886818, iyy=0.09329875682692194, dof=6),
    PCBody(parent=4, pos=(0.0, -0.7000000000000001), anchor=(0.0, 0.25),
           sign=-1.0, com=(0.0, 0.0),
           mass=2.7813566959781637, iyy=0.07230254017320971, dof=7),
    PCBody(parent=5, pos=(0.2, -0.35), anchor=(-0.2, 0.1), sign=-1.0,
           com=(-0.1, 0.1), mass=3.1667253948185117,
           iyy=0.02399774663482943, dof=8),
)

_CON_SOLIMP = (0.9, 0.95, 0.001)
# (body, local (x, z), radius, mu): capsule end spheres, μ max-combined with the floor's 0.7
_CAPSULES = (
    (0, (0.0, 0.19999999999999996), 0.05, 0.9),
    (0, (0.0, -0.19999999999999996), 0.05, 0.9),
    (1, (0.0, -5.551115123125783e-17), 0.05, 0.9),
    (1, (0.0, -0.4500000000000001), 0.05, 0.9),
    (2, (0.0, 0.25), 0.04, 0.9),
    (2, (0.0, -0.25), 0.04, 0.9),
    (3, (-0.2, 0.10000000000000003), 0.06, 0.9),
    (3, (0.0, 0.09999999999999998), 0.06, 0.9),
    (4, (0.0, -5.551115123125783e-17), 0.05, 0.9),
    (4, (0.0, -0.4500000000000001), 0.05, 0.9),
    (5, (0.0, 0.25), 0.04, 0.9),
    (5, (0.0, -0.25), 0.04, 0.9),
    (6, (-0.2, 0.10000000000000003), 0.06, 1.9),
    (6, (0.0, 0.09999999999999998), 0.06, 1.9),
)
_LIM_SOLIMP = (0.9, 0.95, 0.001)
_LIMITS = (
    (3, -2.6179938779914944, 0.0),
    (4, -2.6179938779914944, 0.0),
    (5, -0.7853981633974483, 0.7853981633974483),
    (6, -2.6179938779914944, 0.0),
    (7, -2.6179938779914944, 0.0),
    (8, -0.7853981633974483, 0.7853981633974483),
)
_DOF_INVWEIGHT0 = (
    0.20743031034355516, 0.04851918372605742, 6.0249121053811585,
    12.106152843486317, 9.595294937183608, 18.21142212360485,
    12.106152843486317, 9.595294937183608, 18.21142212360485,
)
_BODY_INVWEIGHT0 = (
    0.0853164980232042, 0.06051637875212593, 0.06299719488697496,
    0.13474576502547686, 0.06051637875212593, 0.06299719488697496,
    0.13474576502547686,
)

MODEL = PlanarContactModel(
    n_dof=9,
    root_offset=(0.0, 0.0),  # rootz ref 1.25: torso z = q1 (qpos0[1] = 1.25)
    bodies=_BODIES,
    contacts=tuple(
        PCContact(body=b, local=loc, radius=r, mu=mu, margin=0.0, solimp=_CON_SOLIMP)
        for (b, loc, r, mu) in _CAPSULES
    ),
    limits=tuple(
        PCLimit(dof=d, lo=lo, hi=hi, solimp=_LIM_SOLIMP) for (d, lo, hi) in _LIMITS
    ),
    damping=(0.0, 0.0, 0.0) + (0.1,) * 6,
    armature=(0.0, 0.0, 0.0) + (0.01,) * 6,
    stiffness=(0.0,) * 9,
    gear=_GEAR,
    dof_invweight0=_DOF_INVWEIGHT0,
    body_invweight0=_BODY_INVWEIGHT0,
    timestep=_H,
    integrator="rk4",
)


@dataclasses.dataclass(frozen=True, eq=False)
class Walker2dDeviceEnv(PlanarContactEnv):
    """gymnasium Walker2d-v4: x = [qpos(9), qvel(9)], 6 torques ∈ [−1, 1]."""

    MODEL = MODEL
    FRAME_SKIP = _FRAME_SKIP
    HEALTHY = 1.0
    CTRL_W = 1e-3
    INIT_QPOS = (0.0, 1.25) + (0.0,) * 7
    OBS_CLIP = 10.0

    state_dim = 18
    action_dim = 6
    action_low = np.array([-1.0] * 6)
    action_high = np.array([1.0] * 6)
