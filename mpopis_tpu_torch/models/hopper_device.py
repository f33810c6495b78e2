"""Hopper-v4 with on-device dynamics, contacts included.

Counterpart of `mpopis_tpu/models/hopper_device.py`: the 6-DoF planar tree
of hopper.xml (leg joints hinged about −y and anchored off their body
origins), 8 plane-capsule contacts with per-geom friction (foot 2.0,
others 1.0), contact margin 0.002, constant contact impedance 0.8, sigmoid
limit solimp (0.9, 0.95, 0.001), three capsule-capsule self-collision
pairs, RK4 integration (the contact QP at all 4 stages), frame skip 4. The
constants are copies of the JAX package's probed table (a test pins MODEL
to it).

Obs/reward follow hopper_v4.py: obs = [qpos[1:], clip(qvel, ±10)],
reward = 1 (healthy) + (x'−x)/dt − 1e-3·Σa²; episodes do not terminate.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from mpopis_tpu_torch.models.planar_contact import (
    PCBody,
    PCCapsulePair,
    PCContact,
    PCLimit,
    PlanarContactEnv,
    PlanarContactModel,
)

_H = 0.002
_FRAME_SKIP = 4
_GEAR = (200.0, 200.0, 200.0)  # dofs 3..5

_BODIES = (
    PCBody(parent=-1, pos=(0.0, 0.0), anchor=(0.0, 0.0), sign=1.0,
           com=(0.0, 0.0), mass=3.6651914291880923,
           iyy=0.069245938072875, dof=2),  # torso (rooty about +y)
    PCBody(parent=0, pos=(0.0, -0.19999999999999996), anchor=(0.0, 0.0),
           sign=-1.0, com=(0.0, -0.2250000000000001),
           mass=4.057890510886818, iyy=0.09329875682692194, dof=3),  # thigh
    PCBody(parent=1, pos=(0.0, -0.7000000000000001), anchor=(0.0, 0.25),
           sign=-1.0, com=(0.0, 0.0),
           mass=2.7813566959781637, iyy=0.07230254017320971, dof=4),  # leg
    PCBody(parent=2, pos=(0.13, -0.35), anchor=(-0.13, 0.1), sign=-1.0,
           com=(-0.065, 0.1), mass=5.315574769873931,
           iyy=0.1035230805900054, dof=5),  # foot
)

_CON_SOLIMP = (0.8, 0.8, 0.01)  # constant impedance 0.8
_MARGIN = 0.002  # includemargin = geom margin 0.001 + floor margin 0.001
# (body, local (x, z), radius, mu): capsule end spheres, μ max-combined with the floor's
_CAPSULES = (
    (0, (0.0, 0.19999999999999996), 0.05, 1.0),   # torso top
    (0, (0.0, -0.19999999999999996), 0.05, 1.0),  # torso bottom
    (1, (0.0, -5.551115123125783e-17), 0.05, 1.0),
    (1, (0.0, -0.4500000000000001), 0.05, 1.0),   # thigh
    (2, (0.0, 0.25), 0.04, 1.0),
    (2, (0.0, -0.25), 0.04, 1.0),                 # leg
    (3, (-0.26, 0.10000000000000005), 0.06, 2.0),
    (3, (0.13, 0.09999999999999996), 0.06, 2.0),  # foot
)
# full capsule segments per body (endpoint 1, endpoint 2, radius) for the pairs
_SEGS = {
    0: ((0.0, 0.19999999999999996), (0.0, -0.19999999999999996), 0.05),
    1: ((0.0, -5.551115123125783e-17), (0.0, -0.4500000000000001), 0.05),
    2: ((0.0, 0.25), (0.0, -0.25), 0.04),
    3: ((-0.26, 0.10000000000000005), (0.13, 0.09999999999999996), 0.06),
}
_LIM_SOLIMP = (0.9, 0.95, 0.001)
_LIMITS = (  # (dof, lo, hi) in radians
    (3, -2.6179938779914944, 0.0),
    (4, -2.6179938779914944, 0.0),
    (5, -0.7853981633974483, 0.7853981633974483),
)
_DOF_INVWEIGHT0 = (
    0.1909279154706013, 0.06383927369632438, 1.0585064134514297,
    0.9173573040079763, 0.8423092317158408, 0.9000381439194955,
)
_BODY_INVWEIGHT0 = (
    0.08492239638897524, 0.051923310146107036, 0.04959511864425975,
    0.06690271076821869,
)

MODEL = PlanarContactModel(
    n_dof=6,
    root_offset=(0.0, 0.0),  # rootz ref 1.25: torso z = q1 (qpos0[1] = 1.25)
    bodies=_BODIES,
    contacts=tuple(
        PCContact(body=b, local=loc, radius=r, mu=mu, margin=_MARGIN, solimp=_CON_SOLIMP)
        for (b, loc, r, mu) in _CAPSULES
    ),
    limits=tuple(
        PCLimit(dof=d, lo=lo, hi=hi, solimp=_LIM_SOLIMP) for (d, lo, hi) in _LIMITS
    ),
    # capsule-capsule self-collision: the pairs MuJoCo keeps (not the same
    # body, not parent-child)
    pairs=tuple(
        PCCapsulePair(
            body1=bi1, a1=_SEGS[bi1][0], b1=_SEGS[bi1][1], r1=_SEGS[bi1][2],
            body2=bi2, a2=_SEGS[bi2][0], b2=_SEGS[bi2][1], r2=_SEGS[bi2][2],
            margin=_MARGIN, solimp=_CON_SOLIMP,
        )
        for (bi1, bi2) in ((0, 2), (0, 3), (1, 3))
    ),
    damping=(0.0, 0.0, 0.0, 1.0, 1.0, 1.0),
    armature=(0.0, 0.0, 0.0, 1.0, 1.0, 1.0),
    stiffness=(0.0,) * 6,
    gear=_GEAR,
    dof_invweight0=_DOF_INVWEIGHT0,
    body_invweight0=_BODY_INVWEIGHT0,
    timestep=_H,
    integrator="rk4",
)


@dataclasses.dataclass(frozen=True, eq=False)
class HopperDeviceEnv(PlanarContactEnv):
    """gymnasium Hopper-v4: x = [qpos(6), qvel(6)], 3 torques ∈ [−1, 1]."""

    MODEL = MODEL
    FRAME_SKIP = _FRAME_SKIP
    HEALTHY = 1.0
    CTRL_W = 1e-3
    INIT_QPOS = (0.0, 1.25, 0.0, 0.0, 0.0, 0.0)
    OBS_CLIP = 10.0

    state_dim = 12
    action_dim = 3
    action_low = np.array([-1.0] * 3)
    action_high = np.array([1.0] * 3)
