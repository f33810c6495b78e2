"""Plain reference of the configuration `halfcheetah-v4`: Gymnasium's
HalfCheetah-v4 as the port runs it on the device (the 9-dof planar tree,
16 plane-capsule contacts, 6 joint limits, Euler-implicit at 0.01 s, frame
skip 5, the contact QP at (3, 6) iterations).

The model table is a frozen copy of `mpopis_tpu_torch/models/cheetah_device.py`
at commit 3b1bee442fec (`_H` to `MODEL`), the task constants those of its
`CheetahDeviceEnv`. Imports nothing of the program.

Besides the plain `task`, it gives the harness what is particular to the
configuration: the port's env's `env_kwargs` and `facts`, the
`policy_step` reference and the rollout's `rollout_work`.
"""

from __future__ import annotations

from benchmark.reference import ce
from benchmark.reference.planar_contact import PCBody, PCContact, PCLimit, PlanarContactModel
from benchmark.reference.tasks import PlanarTask, contact_env_kwargs, contact_facts
from benchmark.roofline import ContactWork

_H = 0.01
_FRAME_SKIP = 5
_MU = 0.4
_RADIUS = 0.046

# (name, parent, offset (x, z) in parent, com (x, z), mass, body-frame I_yy,
#  hinge dof); the torso is the root: origin (q0, 0.7+q1), angle q2
_BODIES = (
    ("torso", -1, (0.0, 0.7), (0.15238987816307403, 0.025398313027179008),
     6.25020920502092, 0.8971176881117483, 2),
    ("bthigh", 0, (-0.5, 0.0), (0.1, -0.13),
     1.5435146443514645, 0.01684433958158996, 3),
    ("bshin", 1, (0.16, -0.25), (-0.14, -0.07),
     1.5874476987447697, 0.018267419079497905, 4),
    ("bfoot", 2, (-0.28, -0.14), (0.03, -0.097),
     1.0953974895397491, 0.0063524232635983275, 5),
    ("fthigh", 0, (0.5, 0.0), (-0.07, -0.12),
     1.4380753138075317, 0.013739643347280341, 6),
    ("fshin", 4, (-0.14, -0.24), (0.065, -0.09),
     1.200836820083682, 0.008222108619246861, 7),
    ("ffoot", 5, (0.13, -0.18), (0.045, -0.07),
     0.8845188284518829, 0.003529109456066946, 8),
)
# capsule end spheres in body-local (x, z); two per geom
_ENDPOINTS = (
    (0, (-0.5, 3.061616997868383e-17)), (0, (0.5, -3.061616997868383e-17)),
    (0, (0.7146493405538257, 0.19672398208600017)),
    (0, (0.4853506594461742, 0.0032760179139998263)),
    (1, (0.18871939418669426, -0.24469031822759044)),
    (1, (0.011280605813305769, -0.015309681772409572)),
    (2, (-0.27446086117273405, -0.13648516234985636)),
    (2, (-0.005539138827266005, -0.003514837650143668)),
    (3, (0.004927244951249871, -0.006405535741606294)),
    (3, (0.05507275504875013, -0.1875944642583937)),
    (4, (-0.003914941666783009, -0.00458004910287256)),
    (4, (-0.136085058333217, -0.23541995089712742)),
    (5, (0.005147897820126257, -0.0025144248195740904)),
    (5, (0.12485210217987375, -0.1774855751804259)),
    (6, (0.005475026862347521, -0.01222650695632252)),
    (6, (0.08452497313765248, -0.1277734930436775)),
)
_DAMPING = (0.0, 0.0, 0.0, 6.0, 4.5, 3.0, 4.5, 3.0, 1.5)
_ARMATURE = (0.0, 0.0, 0.0, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1)
_STIFFNESS = (0.0, 0.0, 0.0, 240.0, 180.0, 120.0, 180.0, 120.0, 60.0)
_GEAR = (120.0, 90.0, 60.0, 120.0, 60.0, 30.0)  # dofs 3..8
_LIMITS = (  # (dof, lo, hi)
    (3, -0.52, 1.05), (4, -0.785, 0.785), (5, -0.4, 0.785),
    (6, -1.0, 0.7), (7, -1.2, 0.87), (8, -0.5, 0.5),
)
_DOF_INVWEIGHT0 = (
    0.10673572816871127, 0.08459229161068711, 0.41634706198577387,
    2.729788644884893, 5.893248984162904, 8.894877004054676,
    3.0813926054768768, 6.882795962275771, 9.468134962769764,
)
_BODY_INVWEIGHT0 = (  # translation component, bodies in _BODIES order
    0.06415751945610272, 0.09691101560963138, 0.12720922534654555,
    0.24374928349017175, 0.08148379481367073, 0.1319968179007737,
    0.2661441029233887,
)
_CON_SOLIMP = (0.0, 0.8, 0.01)
_LIM_SOLIMP = (0.0, 0.8, 0.03)

MODEL = PlanarContactModel(
    n_dof=9,
    root_offset=(0.0, 0.7),
    bodies=tuple(
        PCBody(parent=p, pos=off, anchor=(0.0, 0.0), sign=1.0, com=com,
               mass=m, iyy=iyy, dof=dof)
        for (_nm, p, off, com, m, iyy, dof) in _BODIES
    ),
    contacts=tuple(
        PCContact(body=b, local=loc, radius=_RADIUS, mu=_MU, margin=0.0,
                  solimp=_CON_SOLIMP)
        for (b, loc) in _ENDPOINTS
    ),
    limits=tuple(
        PCLimit(dof=d, lo=lo, hi=hi, solimp=_LIM_SOLIMP) for (d, lo, hi) in _LIMITS
    ),
    damping=_DAMPING,
    armature=_ARMATURE,
    stiffness=_STIFFNESS,
    gear=_GEAR,
    dof_invweight0=_DOF_INVWEIGHT0,
    body_invweight0=_BODY_INVWEIGHT0,
    timestep=_H,
    integrator="euler_implicit",
)


def task(config: dict) -> PlanarTask:
    """The plain reference's task."""
    return PlanarTask(model=MODEL, frame_skip=_FRAME_SKIP, healthy=0.0, ctrl_w=0.1,
                      init_qpos=(0.0,) * 9, action_dim=6, solver_outer=config["solver_outer"],
                      solver_cg=config["solver_cg"])


def env_kwargs(config: dict) -> dict:
    """The port's env as the configuration states it."""
    return contact_env_kwargs(config)


def facts(env) -> dict:
    """The port's env's facts, held against the configuration's file."""
    return contact_facts(env)


def policy_step(config: dict, traffic: dict, action_dim: int):
    """The plain reference of the policy step."""
    return ce.policy_step(config, traffic, action_dim)


def rollout_work(config: dict, traffic: dict) -> ContactWork:
    """The work of one rollout call, tallied over the checked rollouts."""
    return ContactWork(task(config).module, config, traffic)
