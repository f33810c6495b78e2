"""Pusher-v4 with on-device dynamics, the arm–object contact included.

Counterpart of `mpopis_tpu/models/pusher_device.py`: pusher.xml's 7-hinge arm
plus the object and goal, each on two slide joints (nq = nv = 11, no
quaternion), no gravity, the Euler integrator with implicit joint damping at
0.01 s and frame skip 5. Three contact families: the 6 fingertip capsule ends
against the table plane at z = −0.325 (condim 1: one frictionless normal
row each), the 3 fingertip capsules against the object's upright cylinder
(condim 1, the pushing interaction), and the object cylinder against the
table, which the JAX package leaves out (its body has only x/y slides, so
the rows' Jacobian is zero). With the 11 joint limits: 20 QP rows. The
constants are copies of the JAX package's probed table (a test pins MODEL
to it).

Obs/reward follow gymnasium pusher_v4.py: obs = [qpos[:7], qvel[:7],
xpos(tips_arm), xpos(object), xpos(goal)] (23,); reward = −|obj − goal| −
0.1·Σa² − 0.5·|obj − tips| with the distances read from data.xpos before
the step, which holds the kinematics of the previous control step's last
substep before its integration (Euler runs no forward pass after
integrating). The state carries those 9 stale entries after qpos and qvel.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mpopis_tpu_torch.models.base import EnvState, make_state
from mpopis_tpu_torch.models.spatial_contact import (
    SCBody,
    SCContact,
    SCLimit,
    SCPairCylinder,
    SJoint,
    SpatialContactEnv,
    SpatialContactModel,
    frames,
)

_H = 0.01
_FRAME_SKIP = 5

# === Pusher-v4 ===
# timestep=0.01 integrator=0 (0=Euler 1=RK4) gravity=0.0 cone=0
# frame_skip=5 nq=11 nv=11 nu=7 nbody=13
# qpos0 = zeros(11)
_BODIES = (  # parent, pos, quat, joints, com(ipos), mass, inertia(full body-frame 6)
    # r_shoulder_pan_link
    (-1, (0.0, -0.6, 0.0), (1.0, 0.0, 0.0, 0.0), (SJoint(kind='hinge', dof=0, qadr=0, axis=(0.0, 0.0, 1.0), anchor=(0.0, 0.0, 0.0)),), (0.0, 0.0029910406616126804, -0.08428669882839421), 7.293521504574065, (0.36437053959404203, -2.0994170859380347e-19, 9.17394969821784e-18, 0.36447600218823506, -0.006201776703614731, 0.03628453502376305)),
    # r_shoulder_lift_link
    (0, (0.1, 0.0, 0.0), (1.0, 0.0, 0.0, 0.0), (SJoint(kind='hinge', dof=1, qadr=1, axis=(0.0, 1.0, 0.0), anchor=(0.0, 0.0, 0.0)),), (0.0, 0.0, 0.0), 3.141592653589794, (0.03801327110843651, 0.0, 0.0, 0.014451326206513054, 5.23180274701295e-18, 0.03801327110843651)),
    # r_upper_arm_roll_link
    (1, (0.0, 0.0, 0.0), (1.0, 0.0, 0.0, 0.0), (SJoint(kind='hinge', dof=2, qadr=2, axis=(1.0, 0.0, 0.0), anchor=(0.0, 0.0, 0.0)),), (0.0, 0.0, 0.0), 0.08545132017764237, (1.6688140175868983e-05, 0.0, 7.980243123443751e-20, 0.00037608633974654137, 0.0, 0.00037608633974654137)),
    # r_upper_arm_link
    (2, (0.0, 0.0, 0.0), (1.0, 0.0, 0.0, 0.0), (), (0.2, 0.0, 0.0), 1.6286016316209488, (0.002833766839020451, 0.0, 6.700055869934662e-18, 0.0330081359582197, 0.0, 0.0330081359582197)),
    # r_elbow_flex_link
    (3, (0.4, 0.0, 0.0), (1.0, 0.0, 0.0, 0.0), (SJoint(kind='hinge', dof=3, qadr=3, axis=(0.0, 1.0, 0.0), anchor=(0.0, 0.0, 0.0)),), (0.0, 0.0, 0.0), 0.4071504079052372, (0.0008839687744964818, 0.0, 0.0, 0.0006351546363321701, 5.524783700845674e-20, 0.0008839687744964818)),
    # r_forearm_roll_link
    (4, (0.0, 0.0, 0.0), (1.0, 0.0, 0.0, 0.0), (SJoint(kind='hinge', dof=4, qadr=4, axis=(1.0, 0.0, 0.0), anchor=(0.0, 0.0, 0.0)),), (0.0, 0.0, 0.0), 0.08545132017764237, (1.6688140175868983e-05, 0.0, 7.980243123443751e-20, 0.00037608633974654137, 0.0, 0.00037608633974654137)),
    # r_forearm_link
    (5, (0.0, 0.0, 0.0), (1.0, 0.0, 0.0, 0.0), (), (0.1455, 0.0, 0.0), 0.8427322293254622, (0.0010141453784869555, 0.0, 1.907902042578994e-18, 0.00960657230650512, 0.0, 0.00960657230650512)),
    # r_wrist_flex_link
    (6, (0.321, 0.0, 0.0), (1.0, 0.0, 0.0, 0.0), (SJoint(kind='hinge', dof=5, qadr=5, axis=(0.0, 1.0, 0.0), anchor=(0.0, 0.0, 0.0)),), (0.0, 0.0, 0.0), 0.00502654824574367, (1.338318470429252e-06, 0.0, 0.0, 2.3876104167282434e-07, 2.4415079486060425e-22, 1.338318470429252e-06)),
    # r_wrist_roll_link
    (7, (0.0, 0.0, 0.0), (1.0, 0.0, 0.0, 0.0), (SJoint(kind='hinge', dof=6, qadr=6, axis=(1.0, 0.0, 0.0), anchor=(0.0, 0.0, 0.0)),), (0.026388888888888896, 0.0, 0.0), 0.1809557368467721, (0.0013494271420523532, 3.595596199585537e-18, -4.217459900323825e-18, 0.0002683702033670592, 7.150818693634657e-19, 0.001582812569629036)),
    # tips_arm
    (8, (0.0, 0.0, 0.0), (1.0, 0.0, 0.0, 0.0), (), (0.09999999999999999, 0.0, 0.0), 0.002513274122871835, (2.5233272193633227e-05, 0.0, 0.0, 1.0053096491487366e-07, -3.348353758088292e-20, 2.5233272193633295e-05)),
    # object (two slide joints: y first, then x — the XML order)
    (-1, (0.45, -0.05, -0.275), (1.0, 0.0, 0.0, 0.0), (SJoint(kind='slide', dof=7, qadr=7, axis=(0.0, 1.0, 0.0), anchor=(0.0, 0.0, 0.0)), SJoint(kind='slide', dof=8, qadr=8, axis=(1.0, 0.0, 0.0), anchor=(0.0, 0.0, 0.0)),), (0.0, 0.0, 0.0), 1.3089969389957475e-08, (1.668971097219578e-11, 0.0, 0.0, 1.668971097219578e-11, 0.0, 1.5053464798451097e-11)),
    # goal
    (-1, (0.45, -0.05, -0.323), (1.0, 0.0, 0.0, 0.0), (SJoint(kind='slide', dof=9, qadr=9, axis=(0.0, 1.0, 0.0), anchor=(0.0, 0.0, 0.0)), SJoint(kind='slide', dof=10, qadr=10, axis=(1.0, 0.0, 0.0), anchor=(0.0, 0.0, 0.0)),), (0.0, 0.0, 0.0), 4.021238596594936e-10, (6.435322167417429e-13, 0.0, 0.0, 6.435322167417429e-13, 0.0, 1.2867963509103798e-12)),
)
_FLOOR_Z = -0.325
_CONTACTS = (  # body(0-based), local center, radius, mu, includemargin, solimp, capsule axis_local, condim
    # fingertip capsule ends vs the table plane (3 capsules x 2 ends)
    (8, (0.0, -0.1, 2.2204460492503132e-17), 0.02, 0.8, 0.004, (0.9, 0.95, 0.001), (0.0, -1.0, 2.220446049250313e-16), 1),
    (8, (0.0, 0.1, -2.2204460492503132e-17), 0.02, 0.8, 0.004, (0.9, 0.95, 0.001), (0.0, -1.0, 2.220446049250313e-16), 1),
    (8, (0.0, -0.1, 1.1102230246251566e-17), 0.02, 0.8, 0.004, (0.9, 0.95, 0.001), (-1.0, -0.0, 2.220446049250313e-16), 1),
    (8, (0.1, -0.1, -1.1102230246251566e-17), 0.02, 0.8, 0.004, (0.9, 0.95, 0.001), (-1.0, -0.0, 2.220446049250313e-16), 1),
    (8, (0.0, 0.1, 1.1102230246251566e-17), 0.02, 0.8, 0.004, (0.9, 0.95, 0.001), (-1.0, -0.0, 2.220446049250313e-16), 1),
    (8, (0.1, 0.1, -1.1102230246251566e-17), 0.02, 0.8, 0.004, (0.9, 0.95, 0.001), (-1.0, -0.0, 2.220446049250313e-16), 1),
    # the object cylinder vs the plane is omitted: its body has no z/tilt
    # dofs, so J == 0 identically and the rows are dynamically inert
)
_PAIRS = (  # body1, a1, b1, r1, body2, center2, r2, hh2, mu, includemargin, solimp, condim
    (8, (0.0, 0.1, -2.2204460492503132e-17), (0.0, -0.1, 2.2204460492503132e-17), 0.02, 10, (0.0, 0.0, 0.0), 0.05, 0.05, 0.8, 0.004, (0.9, 0.95, 0.001), 1),
    (8, (0.1, -0.1, -1.1102230246251566e-17), (0.0, -0.1, 1.1102230246251566e-17), 0.02, 10, (0.0, 0.0, 0.0), 0.05, 0.05, 0.8, 0.004, (0.9, 0.95, 0.001), 1),
    (8, (0.1, 0.1, -1.1102230246251566e-17), (0.0, 0.1, 1.1102230246251566e-17), 0.02, 10, (0.0, 0.0, 0.0), 0.05, 0.05, 0.8, 0.004, (0.9, 0.95, 0.001), 1),
)
_LIMITS = (  # dof, lo, hi, solimp, margin
    (0, -2.2854, 1.714602, (0.9, 0.95, 0.001), 0.0),
    (1, -0.5236, 1.3963, (0.9, 0.95, 0.001), 0.0),
    (2, -1.5, 1.7, (0.9, 0.95, 0.001), 0.0),
    (3, -2.3213, 0.0, (0.9, 0.95, 0.001), 0.0),
    (4, -1.5, 1.5, (0.9, 0.95, 0.001), 0.0),
    (5, -1.094, 0.0, (0.9, 0.95, 0.001), 0.0),
    (6, -1.5, 1.5, (0.9, 0.95, 0.001), 0.0),
    (7, -10.3213, 10.3, (0.9, 0.95, 0.001), 0.0),
    (8, -10.3213, 10.3, (0.9, 0.95, 0.001), 0.0),
    (9, -10.3213, 10.3, (0.9, 0.95, 0.001), 0.0),
    (10, -10.3213, 10.3, (0.9, 0.95, 0.001), 0.0),
)
_DAMPING = (1.0, 1.0, 0.1, 0.1, 0.1, 0.1, 0.1, 0.5, 0.5, 0.5, 0.5)
_ARMATURE = (0.04,) * 11
_STIFFNESS = (0.0,) * 11
_SPRINGREF = (0.0,) * 11
_DOF_INVWEIGHT0 = (1.0539426498091766, 2.3631094710931526, 21.7561687466271, 15.467935531072987, 23.67412269693543, 24.770180508653834, 24.216854994363437, 76394372.68410975, 76394372.68410975, 2486795985.810864, 2486795985.810864)
_BODY_INVWEIGHT0 = (3.1429708916490028e-06, 0.003513142166030589, 0.003513142166030589, 0.06312640577551736, 0.21386105927573285, 0.21386105927573285, 0.3168059260304052, 0.6727262724077382, 0.7502106844267026, 1.0548471154413133, 76394372.68410975, 2486795985.810864)
_ACTUATORS = tuple((d, 1.0) for d in range(7))  # gear 1, XML order = dof order

MODEL = SpatialContactModel(
    n_dof=11,
    n_q=11,
    bodies=tuple(
        SCBody(parent=p, pos=pos, quat=quat, joints=joints, com=com,
               mass=mass, inertia=inertia)
        for (p, pos, quat, joints, com, mass, inertia) in _BODIES
    ),
    contacts=tuple(
        SCContact(body=b, local=loc, radius=r, mu=mu, margin=margin,
                  solimp=solimp, axis_local=axis, condim=condim)
        for (b, loc, r, mu, margin, solimp, axis, condim) in _CONTACTS
    ),
    limits=tuple(
        SCLimit(dof=d, lo=lo, hi=hi, solimp=solimp, margin=margin)
        for (d, lo, hi, solimp, margin) in _LIMITS
    ),
    damping=_DAMPING,
    armature=_ARMATURE,
    stiffness=_STIFFNESS,
    springref=_SPRINGREF,
    dof_invweight0=_DOF_INVWEIGHT0,
    body_invweight0=_BODY_INVWEIGHT0,
    timestep=_H,
    integrator="euler_implicit",
    gravity=0.0,
    floor_z=_FLOOR_Z,
    pairs=tuple(
        SCPairCylinder(body1=b1, a1=a1, b1=b1v, r1=r1, body2=b2,
                       center2=c2, r2=r2, hh2=hh2, mu=mu, margin=margin,
                       solimp=solimp, condim=condim)
        for (b1, a1, b1v, r1, b2, c2, r2, hh2, mu, margin, solimp,
             condim) in _PAIRS
    ),
)
assert MODEL.n_rows == 11 + 6 + 3 == 20

# body indices whose frame origins (data.xpos) feed obs/reward
_B_TIPS, _B_OBJ, _B_GOAL = 9, 10, 11
# FK of qpos0 (pinned against mj_forward in the JAX package's tests): xpos after reset
_XPOS0 = (0.821, -0.6, 0.0, 0.45, -0.05, -0.275, 0.45, -0.05, -0.323)


def xpos9(q: torch.Tensor) -> torch.Tensor:
    """(tips_arm, object, goal) body-frame origins at qpos q (..., 11) →
    (..., 9): the three data.xpos reads of gymnasium pusher_v4
    (get_body_com returns the frame origin, not the com)."""
    fr = frames(MODEL, q)
    return torch.cat([fr.origin[_B_TIPS], fr.origin[_B_OBJ], fr.origin[_B_GOAL]], dim=-1)


def touching_state(z_tip: float, dx: float, qv=None) -> torch.Tensor:
    """A float64 state (31,) with the fingertip capsules at height z_tip (the
    shoulder lift found by bisection, the other joints at 0) and the object's
    cylinder axis at horizontal offset dx along world x from the middle of
    the first fingertip capsule (pair 0's axis): e.g. the side wall at
    mid-height (z_tip = −0.275, dx = 0.069 puts it 1 mm inside the capsule
    radius), the cap from above (z_tip = −0.206, dx = 0). `qv` (11,) sets
    the velocities (default 0); the xpos carry is that of the state."""
    pair = MODEL.pairs[0]
    mid = torch.tensor([0.5 * (a + b) for a, b in zip(pair.a1, pair.b1)], dtype=torch.float64)
    q = torch.zeros(11, dtype=torch.float64)

    def capsule_mid():
        fr = frames(MODEL, q)
        return fr.origin[pair.body1] + fr.rot[pair.body1] @ mid

    lo, hi = 0.0, 1.3  # the shoulder lift lowers the arm monotonically here
    for _ in range(60):
        q[1] = 0.5 * (lo + hi)
        lo, hi = (q[1].item(), hi) if capsule_mid()[2] > z_tip else (lo, q[1].item())
    c = capsule_mid()
    q[8] = c[0] + dx - MODEL.bodies[_B_OBJ].pos[0]  # the object's x slide
    q[7] = c[1] - MODEL.bodies[_B_OBJ].pos[1]  # its y slide
    qv = torch.zeros(11, dtype=torch.float64) if qv is None else torch.as_tensor(qv).double()
    return torch.cat([q, qv, xpos9(q)])


def _dist3(x: torch.Tensor, i: int, j: int) -> torch.Tensor:
    d0 = x[..., i] - x[..., j]
    d1 = x[..., i + 1] - x[..., j + 1]
    d2 = x[..., i + 2] - x[..., j + 2]
    return torch.sqrt(torch.clamp(d0 * d0 + d1 * d1 + d2 * d2, min=1e-30))


@dataclasses.dataclass(frozen=True, eq=False)
class PusherDeviceEnv(SpatialContactEnv):
    """gymnasium Pusher-v4: x = [qpos(11), qvel(11), xpos_tips(3),
    xpos_obj(3), xpos_goal(3)] (31,); 7 arm torques clamped to the ctrlrange
    [−2, 2] (gear 1). The `pusher` reward family: the state carries the
    stale xpos snapshot and the reward reads the pre-step one.
    solver_outer/solver_cg: (3, 6) is control grade, (6, 40) matches mj_step
    to solver tolerance."""

    MODEL = MODEL
    FRAME_SKIP = _FRAME_SKIP
    ACTUATORS = _ACTUATORS
    ACTION_CLIP = 2.0
    HEALTHY = 0.0
    FWD_W = 0.0
    CTRL_W = 0.1
    INIT_QPOS = (0.0,) * 11
    FAMILY = "pusher"
    N_CARRY = 9
    CARRY_BODIES = (_B_TIPS, _B_OBJ, _B_GOAL)

    state_dim = 31
    action_dim = 7
    action_low = np.array([-2.0] * 7)
    action_high = np.array([2.0] * 7)

    def reset(self) -> EnvState:
        """qpos0 (all zeros), zero velocity, the xpos of qpos0. (The gymnasium
        reset randomizes the object and goal even at reset_noise_scale 0; the
        JAX package's engines pin them to qpos0, and so does the port.)"""
        x = np.zeros(31)
        x[22:] = _XPOS0
        return make_state(self.tensor(x))

    def _carry(self, q_snap: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
        return xpos9(q_snap)

    def _reward(self, x0, x1, action):
        """pusher_v4 step(): the distances of the pre-step xpos snapshot, the
        control cost of the action as given."""
        return (-_dist3(x0, 25, 28) - self.CTRL_W * torch.sum(action * action, dim=-1)
                - 0.5 * _dist3(x0, 25, 22))

    def reward(self, state: EnvState) -> torch.Tensor:
        """Instantaneous shaped reward (harness accounting)."""
        return -_dist3(state.x, 25, 28) - 0.5 * _dist3(state.x, 25, 22)

    def observation(self, state: EnvState) -> torch.Tensor:
        """gym obs: qpos[:7], qvel[:7], xpos(tips/object/goal) (23,)."""
        x = state.x
        return torch.cat([x[..., 0:7], x[..., 11:18], x[..., 22:31]], dim=-1)
