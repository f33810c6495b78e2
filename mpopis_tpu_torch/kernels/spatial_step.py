"""Spatial-contact rollout costs and control steps (Ant, Pusher, Humanoid,
HumanoidStandup): the CUDA kernel `csrc/spatial_rollout.cu`, its plain
PyTorch version, and the wrappers.

Counterpart of `mpopis_tpu/kernels/spatial_step.py` (the Pallas TPU kernel
`_make_kernel` with `_spatial_advance`, entry `spatial_rollout_costs_tak`),
for the `locomotion` reward family with the `q0` track (Ant) or the `com_x`
track (Humanoid), the `pusher` family (Pusher) and the `standup` family
(HumanoidStandup). Two entries share the kernel's device code:

- `spatial_rollout_costs_tak(env, state0_x, controls_tak)`: (K,) costs
  Σ_t −reward_t of clamped controls (T, na, K) from one state
  (n_q + n_dof + carry,);
- `spatial_step_states(env, x, actions)`: one control step of a batch of
  states (..., n_q + n_dof + carry) under actions (..., na) — the env's
  `step` on the card.

A CPU tensor goes to the plain version (`env.plain_step` / `rollout_batch`
over `env.plain_step_reward`); a CUDA tensor launches the kernel or raises.
`LAUNCHES` counts rollout-kernel launches and `STEP_LAUNCHES` step-kernel
launches, nothing else.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from mpopis_tpu_torch.kernels.build import load_library
from mpopis_tpu_torch.kernels.planar_step import impedance_consts
from mpopis_tpu_torch.models.base import make_state
from mpopis_tpu_torch.models.rollout import rollout_batch
from mpopis_tpu_torch.models.spatial_contact import (
    RK4_STAGES,
    contact_rows,
    hinge_k,
    joint_dofs,
    quat_matrix,
)
from mpopis_tpu_torch.utils.profiling import span

LAUNCHES = 0
STEP_LAUNCHES = 0
# what a build of the kernel takes (the feature mask of csrc/spatial_dynamics.cuh)
EULER, SLIDE, CONDIM1, CYLINDER, PUSHER = 1, 2, 4, 8, 16
SELF_PAIRS, SPRINGS, COM_X, STANDUP = 32, 64, 128, 256
FEATURE_NAMES = {EULER: "the euler_implicit substep", SLIDE: "slide joints",
                 CONDIM1: "condim-1 contacts", CYLINDER: "capsule–cylinder pairs",
                 PUSHER: "the pusher reward family", SELF_PAIRS: "self-collision pairs",
                 SPRINGS: "joint springs", COM_X: "the com_x track",
                 STANDUP: "the standup reward family"}
# the builds: (n_dof, n_q, feature mask)
ANT_BUILD = (14, 15, 0)
PUSHER_BUILD = (11, 11, EULER | SLIDE | CONDIM1 | CYLINDER | PUSHER)
HUMANOID_BUILD = (23, 24, SELF_PAIRS | SPRINGS | COM_X)
STANDUP_BUILD = (23, 24, SELF_PAIRS | SPRINGS | STANDUP)
BUILDS = (ANT_BUILD, PUSHER_BUILD, HUMANOID_BUILD, STANDUP_BUILD)
# the packing layout and capacities of csrc/spatial_rollout.cu (checked at load)
LAYOUT = {"int_header": 16, "double_header": 20, "bodies": 16, "joints": 24, "contacts": 32,
          "limits": 24, "actuators": 24, "pairs": 4, "self_pairs": 112, "rows": 128,
          "wide_rows": 248, "ant_features": ANT_BUILD[2], "pusher_features": PUSHER_BUILD[2],
          "humanoid_features": HUMANOID_BUILD[2], "standup_features": STANDUP_BUILD[2]}
_KINDS = {"free": 0, "hinge": 1, "slide": 2}
_FAMILIES = {"locomotion": 0, "pusher": PUSHER, "standup": STANDUP}
_TRACKS = {"q0": 0, "com_x": COM_X}

# model, n_dof, n_q, feature mask, na
_LAUNCH_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
_ROLLOUT_ARGS = _LAUNCH_ARGS + [
    ctypes.c_void_p,  # state0 (n_q + n_dof + carry,)
    ctypes.c_void_p,  # controls (T, na, K)
    ctypes.c_void_p,  # costs (K,)
    ctypes.c_int,  # K
    ctypes.c_int,  # T
    ctypes.c_void_p,  # cudaStream_t
]
_STEP_ARGS = _LAUNCH_ARGS + [
    ctypes.c_void_p,  # x (B, n_q + n_dof + carry)
    ctypes.c_void_p,  # actions (B, na)
    ctypes.c_void_p,  # out (B, n_q + n_dof + carry)
    ctypes.c_int,  # B
    ctypes.c_void_p,  # cudaStream_t
]
_LIB: list = []
_DEVICE_MODELS: dict = {}


def _lib():
    if not _LIB:
        lib = load_library("spatial_rollout")
        layout = (ctypes.c_int * len(LAYOUT))()
        lib.spatial_layout.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.spatial_layout.restype = None
        lib.spatial_layout(layout)
        if list(layout) != list(LAYOUT.values()):
            raise RuntimeError("spatial_rollout.cu and its wrapper disagree on the interface")
        lib.spatial_model_bytes.argtypes = [ctypes.c_int]
        lib.spatial_model_bytes.restype = ctypes.c_int
        lib.spatial_pack_model.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.c_int,
            ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
        lib.spatial_pack_model.restype = ctypes.c_int
        for suffix in ("f32", "f64"):
            for name, args in (("spatial_rollout_costs", _ROLLOUT_ARGS),
                               ("spatial_step_states", _STEP_ARGS)):
                fn = getattr(lib, f"{name}_{suffix}")
                fn.argtypes = args
                fn.restype = ctypes.c_int
        _LIB.append(lib)
    return _LIB[0]


def _require(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"spatial kernel: {msg}")


def model_features(model, family: str, track: str = "q0") -> int:
    """The feature mask a model, reward family and track need of a build."""
    _require(family in _FAMILIES, f"the {family} reward family is not yet ported")
    _require(track in _TRACKS, f"the {track} track is not yet ported")
    kinds = {j.kind for _, j in model.dof_joints}
    return ((EULER if model.integrator == "euler_implicit" else 0)
            | (SLIDE if "slide" in kinds else 0)
            | (CONDIM1 if any(c.condim == 1 for c in model.contacts) else 0)
            | (CYLINDER if model.pairs else 0)
            | (SELF_PAIRS if model.self_pairs else 0)
            | (SPRINGS if any(model.stiffness) else 0)
            | _FAMILIES[family] | (_TRACKS[track] if family == "locomotion" else 0))


def _names(mask: int) -> str:
    return ", ".join(name for bit, name in FEATURE_NAMES.items() if mask & bit) or "nothing"


def select_build(model, family: str, track: str = "q0") -> int:
    """The feature mask of the build that runs this model with this reward
    family and track: the one of BUILDS with exactly the features it needs;
    raises with what each build at its (n_dof, n_q) lacks and adds."""
    n, nq = model.n_dof, model.n_q
    need = model_features(model, family, track)
    if (n, nq, need) in BUILDS:
        return need
    masks = [mask for bn, bq, mask in BUILDS if (bn, bq) == (n, nq)]
    _require(bool(masks), f"{n} dofs and {nq} qpos (the kernel is built for "
             f"{sorted({(bn, bq) for bn, bq, _ in BUILDS})})")
    _require(False, f"no {(n, nq)} build fits: " + "; ".join(
        f"one lacks {_names(need & ~m)} and adds {_names(m & ~need)}" for m in masks))


@functools.lru_cache(maxsize=None)
def kernel_model(model, frame_skip: int, outer: int, cg: int, actuators, healthy: float,
                 fwd_w: float, ctrl_w: float, family: str = "locomotion", act_clip: float = 1.0,
                 carry_bodies: tuple = (-1, -1, -1), track: str = "q0"):
    """The model, solver counts, actuators, reward family and weights as the
    kernel's flat int and double arrays (layout: `make_model` in
    csrc/spatial_dynamics.cuh). Derived constants are computed here in
    double, as the plain version computes its Python floats. The kernel has
    four builds, BUILDS: Ant's (RK4, free and hinge joints, condim-3 floor
    contacts, the `locomotion` family with the `q0` track), the Pusher's
    (Euler-implicit, hinge and slide joints, condim-1 floor contacts,
    capsule–cylinder pairs, the `pusher` family), the Humanoid's (RK4,
    condim-3 contacts, self pairs, joint springs, `locomotion` with the
    `com_x` track) and the Standup's (the same with the `standup` family)."""
    n, nb = model.n_dof, len(model.bodies)
    joints = model.dof_joints
    build = select_build(model, family, track)
    _require(all(c.condim in (1, 3) for c in model.contacts), "condim must be 1 or 3")
    rows = LAYOUT["wide_rows"] if build & SELF_PAIRS else LAYOUT["rows"]
    _require(nb <= LAYOUT["bodies"] and len(joints) <= LAYOUT["joints"]
             and len(model.contacts) <= LAYOUT["contacts"]
             and len(model.limits) <= LAYOUT["limits"] and len(actuators) <= LAYOUT["actuators"]
             and len(model.pairs) <= LAYOUT["pairs"]
             and len(model.self_pairs) <= LAYOUT["self_pairs"]
             and model.n_rows <= rows, "too many bodies, joints, contacts, limits, "
             "actuators, pairs or rows")
    _require(all(b.parent < i for i, b in enumerate(model.bodies)), "parents must come first")
    _require(all(len(b.joints) == 1 for b in model.bodies
                 if any(j.kind == "free" for j in b.joints)),
             "a free joint must be alone on its body")
    qadr = {j.dof: j.qadr for _, j in joints if j.kind != "free"}

    h = model.timestep
    ints = [n, model.n_q, nb, len(joints), len(model.contacts), len(model.limits),
            len(actuators), len(model.pairs), len(model.self_pairs), frame_skip, outer, cg,
            build, *carry_bodies]
    j0 = 0
    for bi, b in enumerate(model.bodies):
        dofs = [d for c in model.chains[bi] for j in model.bodies[c].joints for d in joint_dofs(j)]
        ints += [b.parent, j0, len(b.joints), sum(1 << d for d in set(dofs))]
        j0 += len(b.joints)
    for bi, j in joints:
        ints += [bi, _KINDS[j.kind], j.dof, j.qadr]
    for c in model.contacts:
        ints += [c.body, int(c.axis_local is not None), c.condim]
    for lm in model.limits:
        ints += [lm.dof, qadr[lm.dof]]
    ints += [dof for dof, _ in actuators]
    for p in model.pairs:
        ints += [p.body1, p.body2]
    # per self pair its segments (body frames) and their squared lengths
    segs = []
    for p in model.self_pairs:
        d1, d2 = (tuple(b - a for a, b in zip(p.a1, p.b1)), tuple(b - a for a, b in zip(p.a2, p.b2)))
        segs.append((d1, d2, sum(c * c for c in d1), sum(c * c for c in d2)))
    for p, (_, _, la, le) in zip(model.self_pairs, segs):
        ints += [p.body1, p.body2, int(la > 0.0), int(le > 0.0)]

    dbl = [model.gravity, model.floor_z, h, 0.5 * h, healthy, fwd_w * (1.0 / (h * frame_skip)),
           ctrl_w, act_clip]
    dbl += [c * h for c, _ in RK4_STAGES] + [0.5 * (c * h) for c, _ in RK4_STAGES]
    dbl += [w for _, w in RK4_STAGES]
    for d in range(n):
        dbl += [model.damping[d], model.armature[d], h * model.damping[d]]
    for b in model.bodies:
        dbl += [*b.pos, *(v for row in quat_matrix(*b.quat) for v in row), *b.com, b.mass,
                *b.inertia]
    zero33 = ((0.0,) * 3,) * 3
    for _, j in joints:
        k, k2 = hinge_k(j.axis) if j.kind == "hinge" else (zero33, zero33)
        dbl += [*j.axis, *j.anchor, *(v for row in k for v in row),
                *(v for row in k2 for v in row)]
    for c in model.contacts:
        dbl += [*c.local, *(c.axis_local or (0.0, 0.0, 0.0)), c.radius, c.mu, c.margin,
                model.body_invweight0[c.body], 2.0 * c.mu * c.mu * (1.0 + c.mu * c.mu)]
        dbl += impedance_consts(c, model)
    for lm in model.limits:
        dbl += [lm.lo, lm.hi, lm.margin, model.dof_invweight0[lm.dof]]
        dbl += impedance_consts(lm, model)
    dbl += [gear for _, gear in actuators]
    for p in model.pairs:
        dbl += [*p.a1, *p.b1, *p.center2, p.r1, p.r2, p.hh2, p.margin,
                model.body_invweight0[p.body1] + model.body_invweight0[p.body2]]
        dbl += impedance_consts(p, model)
    for p, (d1, d2, la, le) in zip(model.self_pairs, segs):
        dbl += [*p.a1, *d1, *p.a2, *d2, la * le, 1e-12 * la * le, le,
                1.0 / la if la > 0.0 else 1.0, 1.0 / le if le > 0.0 else 1.0, p.r1, p.r2,
                p.margin, model.body_invweight0[p.body1] + model.body_invweight0[p.body2]]
        dbl += impedance_consts(p, model)
    if build & SPRINGS:
        for d in range(n):
            dbl += [model.stiffness[d], model.springref[d]]
    return (ctypes.c_int * len(ints))(*ints), (ctypes.c_double * len(dbl))(*dbl)


def _env_model(env):
    return kernel_model(env.MODEL, env.FRAME_SKIP, env.solver_outer, env.solver_cg,
                        tuple(env.ACTUATORS), float(env.HEALTHY), float(env.FWD_W),
                        float(env.CTRL_W), env.FAMILY, float(env.ACTION_CLIP),
                        tuple(getattr(env, "CARRY_BODIES", (-1, -1, -1))), env.TRACK)


def _device_model(env, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The kernel's model struct for this env on `device`, built once and kept."""
    ints, dbl = _env_model(env)
    key = (id(ints), dtype, device)  # kernel_model's cache keeps `ints` alive
    if key not in _DEVICE_MODELS:
        lib = _lib()
        f64 = int(dtype == torch.float64)
        nbytes = lib.spatial_model_bytes(f64)
        buf = ctypes.create_string_buffer(nbytes)
        rc = lib.spatial_pack_model(f64, ints, len(ints), dbl, len(dbl), buf, nbytes)
        _require(rc == 0, "the kernel rejects the packed model")
        host = torch.frombuffer(bytearray(buf.raw), dtype=torch.uint8)
        _DEVICE_MODELS[key] = host.to(device)
    return _DEVICE_MODELS[key]


def spatial_rollout_costs_tak_reference(env, state0_x, controls_tak):
    """Plain PyTorch version: `rollout_batch` over the env's plain
    `step_reward`, controls (T, na, K) → (K, T, na)."""
    costs, _ = rollout_batch(
        env, make_state(state0_x), controls_tak.permute(2, 0, 1),
        step_reward=env.plain_step_reward,
    )
    return costs


def first_substep_active_rows(env, x):
    """(joint-limit rows, floor-contact and capsule–cylinder pair rows,
    self-pair rows) active at the state x: the rows the first substep's QP
    solves for."""
    model = env.MODEL
    active = contact_rows(model, x[: model.n_q], x[model.n_q: model.n_q + model.n_dof])[3]
    n_lim, n_self = len(model.limits), model.n_rows - len(model.self_pairs)
    return (int(active[:n_lim].sum()), int(active[n_lim:n_self].sum()),
            int(active[n_self:].sum()))


def _check_cuda(dev, dtype):
    _require(dev.type == "cuda", f"tensors on {dev} (cpu or cuda only)")
    _require(dtype in (torch.float32, torch.float64), f"dtype {dtype} (float32/float64 only)")


def _launch_args(env, dtype, dev):
    model = env.MODEL
    ints, _ = _env_model(env)
    return (_device_model(env, dtype, dev).data_ptr(), model.n_dof, model.n_q, ints[12],
            env.action_dim)


def spatial_rollout_costs_tak(env, state0_x, controls_tak):
    """(K,) trajectory costs of controls (T, na, K), already clamped, from
    the state `state0_x` (n_q + n_dof + carry,)."""
    global LAUNCHES
    dev = controls_tak.device
    if dev.type == "cpu":
        return spatial_rollout_costs_tak_reference(env, state0_x, controls_tak)
    dtype = controls_tak.dtype
    _check_cuda(dev, dtype)
    na, nx = env.action_dim, env.state_dim
    _require(controls_tak.dim() == 3 and controls_tak.shape[1] == na,
             f"controls shape {tuple(controls_tak.shape)}, want (T, {na}, K)")
    _require(controls_tak.is_contiguous(), "controls must be contiguous")
    _require(
        state0_x.device == dev and state0_x.dtype == dtype and state0_x.is_contiguous()
        and tuple(state0_x.shape) == (nx,),
        f"state0_x must be a contiguous ({nx},) {dtype} vector on {dev}",
    )
    horizon, k = controls_tak.shape[0], controls_tak.shape[2]
    out = torch.empty(k, dtype=dtype, device=dev)
    if k == 0:
        return out
    args = _launch_args(env, dtype, dev)
    fn = getattr(_lib(), "spatial_rollout_costs_f64" if dtype == torch.float64
                 else "spatial_rollout_costs_f32")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        with span("mpopis.rollout.launch"):
            rc = fn(*args, state0_x.data_ptr(), controls_tak.data_ptr(), out.data_ptr(), k,
                    horizon, stream)
    if rc != 0:
        raise RuntimeError(f"spatial_rollout kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out


def spatial_step_states(env, x, actions):
    """One control step of the states x (..., n_q + n_dof + carry) under
    actions (..., na) (clamped to ±ACTION_CLIP for the torque); returns the
    new states."""
    global STEP_LAUNCHES
    dev = x.device
    if dev.type == "cpu":
        return env.plain_step(make_state(x), actions).x
    dtype = x.dtype
    _check_cuda(dev, dtype)
    na, nx = env.action_dim, env.state_dim
    _require(x.shape[-1] == nx and actions.shape == x.shape[:-1] + (na,),
             f"states {tuple(x.shape)} and actions {tuple(actions.shape)}, want (..., {nx}) "
             f"and (..., {na})")
    _require(actions.device == dev and actions.dtype == dtype,
             f"actions must be {dtype} on {dev}")
    xs = x.reshape(-1, nx).contiguous()
    acts = actions.reshape(-1, na).contiguous()
    out = torch.empty_like(xs)
    if xs.shape[0] == 0:
        return out.reshape(x.shape)
    args = _launch_args(env, dtype, dev)
    fn = getattr(_lib(), "spatial_step_states_f64" if dtype == torch.float64
                 else "spatial_step_states_f32")
    with torch.cuda.device(dev):
        rc = fn(*args, xs.data_ptr(), acts.data_ptr(), out.data_ptr(), xs.shape[0],
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"spatial_step kernel launch failed: CUDA error {rc}")
    STEP_LAUNCHES += 1
    return out.reshape(x.shape)
