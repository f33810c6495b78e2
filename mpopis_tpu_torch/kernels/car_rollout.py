"""Fused car-racing rollout costs (1..4 cars): the CUDA kernel
`csrc/car_rollout.cu`, its plain PyTorch version, and the wrapper.

Counterpart of `mpopis_tpu/kernels/car_rollout.py` (the Pallas TPU kernel
`_make_kernel`). The wrapper takes controls in the kernel's (T, 2·N, K)
layout — a flat (cs, K) candidate matrix reshapes to it for free — and
returns the (K,) trajectory costs Σ_t −reward(s_t):

- a CPU tensor goes to the plain version `car_rollout_costs_tak_reference`;
- a CUDA tensor launches the kernel on the current stream, or raises.

`LAUNCHES` counts kernel launches, and nothing else.
"""

from __future__ import annotations

import ctypes

import torch

from mpopis_tpu_torch.kernels.build import load_library
from mpopis_tpu_torch.models.car_racing import _G, car_reward, step_car_state
from mpopis_tpu_torch.utils.profiling import span

MAX_CARS = 4  # kMaxCars of csrc/car_rollout.cu
LAUNCHES = 0

_ARGTYPES = [
    ctypes.c_void_p,  # state0 (8·N,)
    ctypes.c_void_p,  # track (3, M): xs, ys, widths
    ctypes.c_int,  # M
    ctypes.c_void_p,  # controls (T, 2·N, K)
    ctypes.c_void_p,  # costs (K,)
    ctypes.c_int,  # K
    ctypes.c_int,  # T
    ctypes.c_int,  # N
    ctypes.c_void_p,  # host double[27]: physics constants
    ctypes.c_int,  # substeps per action step
    ctypes.c_void_p,  # cudaStream_t
]
_FNS: dict[torch.dtype, object] = {}


def _kernel_fn(dtype: torch.dtype):
    if not _FNS:
        lib = load_library("car_rollout")
        for name, dt in (
            ("car_rollout_costs_f32", torch.float32),
            ("car_rollout_costs_f64", torch.float64),
        ):
            fn = getattr(lib, name)
            fn.argtypes = _ARGTYPES
            fn.restype = ctypes.c_int
            _FNS[dt] = fn
        lib.car_rollout_max_cars.restype = ctypes.c_int
        lib.car_rollout_num_params.restype = ctypes.c_int
        if lib.car_rollout_max_cars() != MAX_CARS or lib.car_rollout_num_params() != 27:
            raise RuntimeError("car_rollout.cu and its wrapper disagree on the interface")
    return _FNS[dtype]


def _kernel_params(env):
    """Physics constants in the order of the kernel's CarConsts, the derived
    ones computed in double exactly as the plain version computes them."""
    p = env.params
    vals = (
        p.m, p.i_zz, p.h_cm, p.l_f, p.l_r, p.c_d0, p.c_d1, p.c_af, p.c_ar,
        p.mu_f, p.mu_r, p.delta_max, p.delta_dot_max, p.fx_max, p.fx_min,
        p.lambda_brake, p.lambda_drive, p.beta_limit, env.dt, env.ddt,
        p.l_r + p.l_f, p.m * p.l_r * _G, p.m * p.l_f * _G,
        p.c_af**2, p.c_af**3, p.c_ar**2, p.c_ar**3,
    )
    return (ctypes.c_double * len(vals))(*vals)


def car_rollout_costs_tak_reference(env, state0_x, controls_tak, horizon: int):
    """Plain PyTorch version: the batched `step_car_state` / `car_reward`
    of every car, plus the joint pairwise-distance and collision terms."""
    num_cars = getattr(env, "num_cars", 1)
    p = env.params
    k = controls_tak.shape[2]
    pts, widths = env.track.query_arrays(controls_tak.dtype, controls_tak.device)
    cars = [state0_x[8 * c : 8 * c + 8].expand(k, 8) for c in range(num_cars)]
    zero = controls_tak.new_tensor(0.0)
    collision = controls_tak.new_tensor(11000.0)
    cost = controls_tak.new_zeros(k)
    for t in range(horizon):
        cars = [
            step_car_state(p, cars[c], controls_tak[t, 2 * c : 2 * c + 2].T, env.dt, env.ddt)
            for c in range(num_cars)
        ]
        rew = sum(car_reward(p, pts, widths, s) for s in cars)
        for i in range(num_cars):
            for j in range(i + 1, num_cars):
                dx = cars[i][:, 0] - cars[j][:, 0]
                dy = cars[i][:, 1] - cars[j][:, 1]
                dd = torch.sqrt(dx * dx + dy * dy + 1e-30)
                rew = rew - dd
                rew = rew - torch.where(dd <= 4.0, collision, zero)
        cost = cost - rew
    return cost


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"car_rollout_costs_tak: {msg}")


def car_rollout_costs_tak(env, state0_x, controls_tak, horizon: int):
    """(K,) trajectory costs of controls (T, 2·num_cars, K), already clamped,
    from the joint state `state0_x` (8·num_cars,)."""
    global LAUNCHES
    dev = controls_tak.device
    if dev.type == "cpu":
        return car_rollout_costs_tak_reference(env, state0_x, controls_tak, horizon)
    _check(dev.type == "cuda", f"tensors on {dev} (cpu or cuda only)")
    num_cars = getattr(env, "num_cars", 1)
    dtype = controls_tak.dtype
    track = env.track_xyw
    _check(1 <= num_cars <= MAX_CARS, f"{num_cars} cars (the kernel takes 1..{MAX_CARS})")
    _check(dtype in (torch.float32, torch.float64), f"dtype {dtype} (float32/float64 only)")
    _check(
        controls_tak.dim() == 3 and controls_tak.shape[:2] == (horizon, 2 * num_cars),
        f"controls shape {tuple(controls_tak.shape)}, want ({horizon}, {2 * num_cars}, K)",
    )
    _check(controls_tak.is_contiguous(), "controls must be contiguous")
    _check(
        state0_x.device == dev and state0_x.dtype == dtype and state0_x.is_contiguous()
        and state0_x.dim() == 1 and state0_x.shape[0] >= 8 * num_cars,
        f"state0_x must be a contiguous ({8 * num_cars},) {dtype} vector on {dev}",
    )
    _check(
        track.device == dev and track.dtype == dtype,
        f"env holds its track as {track.dtype} on {track.device}; controls are {dtype} on {dev}",
    )
    m_track = track.shape[1]
    _check(3 * m_track * track.element_size() <= 48 * 1024, f"{m_track} track points (too many)")
    k = controls_tak.shape[2]
    out = torch.empty(k, dtype=dtype, device=dev)
    if k == 0:
        return out
    fn = _kernel_fn(dtype)
    params = _kernel_params(env)
    substeps = int(round(env.dt / env.ddt))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        with span("mpopis.rollout.launch"):
            rc = fn(
                state0_x.data_ptr(), track.data_ptr(), m_track, controls_tak.data_ptr(),
                out.data_ptr(), k, horizon, num_cars, ctypes.addressof(params), substeps,
                stream,
            )
    if rc != 0:
        raise RuntimeError(f"car_rollout kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out
