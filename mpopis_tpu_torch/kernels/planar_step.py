"""Planar rollout costs and control steps (HalfCheetah, Hopper, Walker2d,
and the Swimmer): the CUDA kernels `csrc/planar_rollout.cu` and
`csrc/swimmer_rollout.cu` (their device code shared in
`csrc/planar_dynamics.cuh`), their plain PyTorch versions, and the wrappers.

Counterpart of `mpopis_tpu/kernels/planar_step.py`: the Pallas TPU kernel
`_make_kernel` with `_contact_advance` (entry `planar_rollout_costs_tak`)
and its Swimmer instance `_swimmer_rollout_impl` (entry
`swimmer_rollout_costs_tak`). Each kernel has two entries:

- `{planar,swimmer}_rollout_costs_tak(env, state0_x, controls_tak)`: (K,)
  costs Σ_t −reward_t of clamped controls (T, na, K) from one state (2n,);
- `{planar,swimmer}_step_states(env, x, actions)`: one control step of a
  batch of states (..., 2n) under actions (..., na) — the env's `step` on
  the card.

A CPU tensor goes to the plain version (`env.plain_step` / `rollout_batch`
over `env.plain_step_reward`); a CUDA tensor launches the kernel or raises.
Each kernel runs a group of lanes per sample; `launch_shape` gives a
build's group width and block.
`LAUNCHES` / `STEP_LAUNCHES` count the planar kernel's rollout and step
launches, `SWIMMER_LAUNCHES` / `SWIMMER_STEP_LAUNCHES` the Swimmer's, and
nothing else.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from mpopis_tpu_torch.kernels.build import load_library
from mpopis_tpu_torch.models.base import make_state
from mpopis_tpu_torch.models.planar import MIN_IMP
from mpopis_tpu_torch.models.planar_contact import contact_rows
from mpopis_tpu_torch.models.rollout import rollout_batch
from mpopis_tpu_torch.utils.profiling import span

LAUNCHES = 0
STEP_LAUNCHES = 0
SWIMMER_LAUNCHES = 0
SWIMMER_STEP_LAUNCHES = 0
MAX_BODIES, MAX_CONTACTS, MAX_LIMITS, MAX_PAIRS = 7, 16, 6, 3  # of csrc/planar_dynamics.cuh
MAX_ROWS = MAX_LIMITS + 3 * MAX_CONTACTS + MAX_PAIRS

_MODEL_ARGS = [  # the packed model: ints and their count, doubles and their count
    ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.POINTER(ctypes.c_double), ctypes.c_int,
]
_ROLLOUT_ARGS = _MODEL_ARGS + [
    ctypes.c_void_p,  # state0 (2n,)
    ctypes.c_void_p,  # controls (T, na, K)
    ctypes.c_void_p,  # costs (K,)
    ctypes.c_int,  # K
    ctypes.c_int,  # T
    ctypes.c_void_p,  # cudaStream_t
]
_STEP_ARGS = _MODEL_ARGS + [
    ctypes.c_void_p,  # x (B, 2n)
    ctypes.c_void_p,  # actions (B, na)
    ctypes.c_void_p,  # out (B, 2n)
    ctypes.c_int,  # B
    ctypes.c_void_p,  # cudaStream_t
]
_FNS: dict[tuple[str, str, torch.dtype], object] = {}


def _kernel_fn(kernel: str, entry: str, dtype: torch.dtype):
    """The C entry of `csrc/{kernel}_rollout.cu` (kernel: planar or swimmer)."""
    if (kernel, entry, dtype) not in _FNS:
        lib = load_library(f"{kernel}_rollout")
        max_rows = getattr(lib, f"{kernel}_max_rows")
        max_rows.restype = ctypes.c_int
        if max_rows() != MAX_ROWS:
            raise RuntimeError(f"{kernel}_rollout.cu and its wrapper disagree on the interface")
        for name, args in (("rollout", _ROLLOUT_ARGS), ("step", _STEP_ARGS)):
            for suffix, dt in (("f32", torch.float32), ("f64", torch.float64)):
                c_name = (
                    f"{kernel}_rollout_costs_{suffix}" if name == "rollout"
                    else f"{kernel}_step_states_{suffix}"
                )
                fn = getattr(lib, c_name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
                _FNS[(kernel, name, dt)] = fn
    return _FNS[(kernel, entry, dtype)]


def launch_shape(env, dtype: torch.dtype = torch.float32) -> tuple[int, int]:
    """(lanes a sample, warps a block) of the CUDA build that runs `env` in
    `dtype`: its group's width, chosen per build from scripts/planar_k_scan.py,
    and the block that keeps the most warps resident on an SM (needs a card)."""
    kernel = "swimmer" if getattr(env, "FLUID", ()) else "planar"
    _kernel_fn(kernel, "rollout", dtype)  # loads the library and checks its interface
    fn = getattr(load_library(f"{kernel}_rollout"), f"{kernel}_launch_shape")
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 2)()
    m = env.MODEL
    rc = fn(m.n_dof, int(m.integrator == "rk4"), int(dtype == torch.float64), out)
    if rc != 0:
        raise RuntimeError(f"{kernel}_launch_shape failed: CUDA error {rc}")
    return out[0], out[1]


def impedance_consts(item, model):
    """(d0 clamped to mjMINIMP, dmax − d0, width, k, b) of a row's solimp."""
    d0, dmax, width = item.solimp
    d0e = max(d0, MIN_IMP)
    kc, bc = model.kb(dmax)
    return [d0e, dmax - d0e, width, kc, bc]


@functools.lru_cache(maxsize=None)
def kernel_model(model, frame_skip: int, outer: int, cg: int, healthy: float, ctrl_w: float,
                 fluid: tuple = ()):
    """The model, solver counts and reward weights as the kernel's flat int and
    double arrays (layout: `make_model` in csrc/planar_dynamics.cuh), the
    Swimmer's 5 fluid coefficients `fluid` last. Derived constants are
    computed here in double, as the plain version computes its Python floats."""
    n, nb = model.n_dof, len(model.bodies)
    na = len(model.gear)
    if fluid:
        _require(n == 5 and len(fluid) == 5, f"{n} dofs and {len(fluid)} fluid coefficients "
                 "(the fluid kernel is built for the Swimmer's 5 and 5)")
    else:
        _require(n in (6, 9), f"{n} dofs (the kernel is built for 6 and 9)")
    _require(nb == n - 2 and na == n - 3, "the kernel needs n_dof − 2 bodies and n_dof − 3 gears")
    _require(all(b.dof == i + 2 for i, b in enumerate(model.bodies)),
             "the kernel needs body i to own hinge dof i + 2")
    _require(all(b.parent < i for i, b in enumerate(model.bodies)), "parents must come first")
    _require(len(model.contacts) <= MAX_CONTACTS and len(model.limits) <= MAX_LIMITS
             and len(model.pairs) <= MAX_PAIRS, "too many contacts, limits or pairs")
    chains = model.chains

    def mask(bodies):
        return sum(1 << b for b in bodies)

    h = model.timestep
    ints = [n, nb, len(model.contacts), len(model.limits), len(model.pairs),
            int(model.integrator == "rk4"), frame_skip, outer, cg, na]
    for i, b in enumerate(model.bodies):
        ints += [b.parent, mask(chains[i])]
    ints += [c.body for c in model.contacts]
    ints += [lm.dof for lm in model.limits]
    for p in model.pairs:
        s1, s2 = set(chains[p.body1]), set(chains[p.body2])
        ints += [p.body1, p.body2, mask(s2 - s1), mask(s1 - s2)]
    dbl = [model.root_offset[0], model.root_offset[1], model.gravity, h, 0.5 * h, h / 6.0,
           healthy, ctrl_w, 1.0 / (h * frame_skip)]
    for d in range(n):
        dbl += [model.damping[d], model.armature[d], model.stiffness[d], h * model.damping[d]]
    dbl += list(model.gear)
    for b in model.bodies:
        dbl += [b.pos[0] + b.anchor[0], b.pos[1] + b.anchor[1], b.anchor[0], b.anchor[1],
                b.sign, b.com[0], b.com[1], b.mass, b.iyy]
    for lm in model.limits:
        dbl += [lm.lo, lm.hi, model.dof_invweight0[lm.dof]] + impedance_consts(lm, model)
    for c in model.contacts:
        dbl += [c.local[0], c.local[1], c.radius, c.mu, c.margin, model.body_invweight0[c.body],
                2.0 * c.mu * c.mu * (1.0 + c.mu * c.mu)] + impedance_consts(c, model)
    for p in model.pairs:
        dbl += [*p.a1, *p.b1, p.r1, *p.a2, *p.b2, p.r2, p.margin,
                model.body_invweight0[p.body1] + model.body_invweight0[p.body2]]
        dbl += impedance_consts(p, model)
    dbl += [float(c) for c in fluid]
    return (ctypes.c_int * len(ints))(*ints), (ctypes.c_double * len(dbl))(*dbl)


def _env_model(env):
    return kernel_model(env.MODEL, env.FRAME_SKIP, env.solver_outer, env.solver_cg,
                        float(env.HEALTHY), float(env.CTRL_W), tuple(getattr(env, "FLUID", ())))


def _require(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"planar kernel: {msg}")


def planar_rollout_costs_tak_reference(env, state0_x, controls_tak):
    """Plain PyTorch version: `rollout_batch` over the env's plain
    `step_reward`, controls (T, na, K) → (K, T, na)."""
    costs, _ = rollout_batch(
        env, make_state(state0_x), controls_tak.permute(2, 0, 1),
        step_reward=env.plain_step_reward,
    )
    return costs


def _check_cuda(dev, dtype):
    _require(dev.type == "cuda", f"tensors on {dev} (cpu or cuda only)")
    _require(dtype in (torch.float32, torch.float64), f"dtype {dtype} (float32/float64 only)")


def first_substep_active_rows(env, x):
    """(joint-limit rows, contact and capsule-pair rows) active at the state
    x (2n,): the rows the first substep's QP solves for."""
    n = env.MODEL.n_dof
    active = contact_rows(env.MODEL, x[:n], x[n:])[3]
    n_lim = len(env.MODEL.limits)
    return int(active[:n_lim].sum()), int(active[n_lim:].sum())


def _rollout(kernel, env, state0_x, controls_tak):
    """Launch `kernel`'s rollout entry on CUDA tensors: (costs (K,), launched)."""
    dev = controls_tak.device
    dtype = controls_tak.dtype
    _check_cuda(dev, dtype)
    _require(bool(getattr(env, "FLUID", ())) == (kernel == "swimmer"),
             f"{type(env).__name__} does not run on the {kernel} kernel")
    n, na = env.MODEL.n_dof, env.action_dim
    _require(controls_tak.dim() == 3 and controls_tak.shape[1] == na,
             f"controls shape {tuple(controls_tak.shape)}, want (T, {na}, K)")
    _require(controls_tak.is_contiguous(), "controls must be contiguous")
    _require(
        state0_x.device == dev and state0_x.dtype == dtype and state0_x.is_contiguous()
        and tuple(state0_x.shape) == (2 * n,),
        f"state0_x must be a contiguous ({2 * n},) {dtype} vector on {dev}",
    )
    horizon, k = controls_tak.shape[0], controls_tak.shape[2]
    out = torch.empty(k, dtype=dtype, device=dev)
    if k == 0:
        return out, False
    ints, dbl = _env_model(env)
    fn = _kernel_fn(kernel, "rollout", dtype)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        with span("mpopis.rollout.launch"):
            rc = fn(ints, len(ints), dbl, len(dbl), state0_x.data_ptr(),
                    controls_tak.data_ptr(), out.data_ptr(), k, horizon, stream)
    if rc != 0:
        raise RuntimeError(f"{kernel}_rollout kernel launch failed: CUDA error {rc}")
    return out, True


def _step(kernel, env, x, actions):
    """Launch `kernel`'s step entry on CUDA tensors: (states, launched)."""
    dev = x.device
    dtype = x.dtype
    _check_cuda(dev, dtype)
    _require(bool(getattr(env, "FLUID", ())) == (kernel == "swimmer"),
             f"{type(env).__name__} does not run on the {kernel} kernel")
    n, na = env.MODEL.n_dof, env.action_dim
    _require(x.shape[-1] == 2 * n and actions.shape == x.shape[:-1] + (na,),
             f"states {tuple(x.shape)} and actions {tuple(actions.shape)}, want (..., {2 * n}) "
             f"and (..., {na})")
    _require(actions.device == dev and actions.dtype == dtype,
             f"actions must be {dtype} on {dev}")
    xs = x.reshape(-1, 2 * n).contiguous()
    acts = actions.reshape(-1, na).contiguous()
    out = torch.empty_like(xs)
    if xs.shape[0] == 0:
        return out.reshape(x.shape), False
    ints, dbl = _env_model(env)
    fn = _kernel_fn(kernel, "step", dtype)
    with torch.cuda.device(dev):
        rc = fn(ints, len(ints), dbl, len(dbl), xs.data_ptr(), acts.data_ptr(), out.data_ptr(),
                xs.shape[0], torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{kernel}_step kernel launch failed: CUDA error {rc}")
    return out.reshape(x.shape), True


def planar_rollout_costs_tak(env, state0_x, controls_tak):
    """(K,) trajectory costs of controls (T, na, K), already clamped, from
    the state `state0_x` (2n,)."""
    global LAUNCHES
    if controls_tak.device.type == "cpu":
        return planar_rollout_costs_tak_reference(env, state0_x, controls_tak)
    out, launched = _rollout("planar", env, state0_x, controls_tak)
    if launched:
        LAUNCHES += 1
    return out


def planar_step_states(env, x, actions):
    """One control step of the states x (..., 2n) under actions (..., na)
    (clamped to [−1, 1] here); returns the new states (..., 2n)."""
    global STEP_LAUNCHES
    if x.device.type == "cpu":
        return env.plain_step(make_state(x), actions).x
    out, launched = _step("planar", env, x, actions)
    if launched:
        STEP_LAUNCHES += 1
    return out


# the Swimmer's plain version is the planar one: rollout_batch over its step
swimmer_rollout_costs_tak_reference = planar_rollout_costs_tak_reference


def swimmer_rollout_costs_tak(env, state0_x, controls_tak):
    """(K,) Swimmer trajectory costs of controls (T, 2, K), already clamped,
    from the state `state0_x` (10,): the kernel in csrc/swimmer_rollout.cu."""
    global SWIMMER_LAUNCHES
    if controls_tak.device.type == "cpu":
        return swimmer_rollout_costs_tak_reference(env, state0_x, controls_tak)
    out, launched = _rollout("swimmer", env, state0_x, controls_tak)
    if launched:
        SWIMMER_LAUNCHES += 1
    return out


def swimmer_step_states(env, x, actions):
    """One Swimmer control step of the states x (..., 10) under actions
    (..., 2) (clamped to [−1, 1] here); returns the new states (..., 10)."""
    global SWIMMER_STEP_LAUNCHES
    if x.device.type == "cpu":
        return env.plain_step(make_state(x), actions).x
    out, launched = _step("swimmer", env, x, actions)
    if launched:
        SWIMMER_STEP_LAUNCHES += 1
    return out
