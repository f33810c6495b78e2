"""Chip smoke test of the PyTorch + CUDA port (`mpopis_tpu_torch`).

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py                      # every path: the proof
    python3 chip_smoke.py --only humanoid,standup   # some paths, to iterate

It builds the kernels of `mpopis_tpu_torch/csrc/` with nvcc (one process
per library, all at once) and drives the port's paths (`--only` names
them: car, planar, ais, ant, swimmer, pusher, humanoid, standup, cars,
reacher, pendulums, classic, sharded, resume, gif, host):

- phases 1-5, the car: the car rollout kernel against its plain PyTorch
  version (f32 at the JAX kernel tests' tolerance or, at K=8192 T=50, by
  its median relative error; f64 sample by sample at 1e-9 or within 10x
  the plain version's own spread under a nudge), a car race with CEMPPI at
  K=8192, H=50, 10 AIS iterations, `ss`, λ=10 through the harness (every
  rollout on the kernel, lap 1 clean), the race at K=150, and the kernel's
  time at K=8192 and K=150 against the plain version's;
- phases 6-10, the planar-contact MuJoCo tasks: the planar rollout kernel
  and its control-step entry against their plain versions for HalfCheetah,
  Hopper and Walker2d (f32 at the JAX kernel tests' tolerances, f64 by its
  median relative error beside the plain version's own spread under a
  nudge of its controls), the f64 CEMPPI step through the kernel against
  the plain path, `simulate_mujoco_on_device` for the three tasks (HalfCheetah at
  K=2048, H=15, 3 AIS iterations, `mle`, λ=0.1), and the timings;
- phases 11-15, the policy layer: the CMA and refit kernels' cluster
  sizes and layouts, the AIS-update kernels (masked and weighted refit,
  CMA tail) and the
  Cholesky and forward-solve kernels
  against their plain versions (float32 at the JAX kernel tests'
  tolerances, float64 at 1e-9 relative; the last two at n = 1, 31, 32,
  33, 100, 136, 600 and 1024, and the Cholesky's NaNs from a failing
  pivot at n = 6 and at column 70 of n = 100), the float32 control step
  at K=8192 on the kernel path against the library path under each switch
  (MPOPIS_FUSED_UPDATE=1, MPOPIS_PALLAS_LINALG=1), `simulate_car_racing`
  at full width for all nine policy kinds (CMAMPPI raced on both paths),
  and the timings of each kernel (back to back from Python, and
  device-only from a CUDA graph of the same calls), its plain version, the
  library call or composition it replaces and each kind's control step;
- phases 16-20, the spatial-contact MuJoCo task Ant: the spatial rollout
  kernel and its control-step entry against their plain versions (f32 at
  the JAX kernel tests' tolerances from reset and from the grounded start,
  f64 at 1e-9 relative beside the plain version's own spread under a nudge
  of its controls), the f64 CEMPPI step through the kernel against the
  plain path, `simulate_mujoco_on_device("Ant-v4")` at the JAX package's
  Ant configuration (K=1024, H=10, 2 AIS iterations, `mle`, λ=1) for 100
  steps, and the timings;
- phases 21-24, the Swimmer: its rollout kernel (kernel 3) and step entry
  against their plain versions at K=4096, T=25 from reset and from both
  motor joints past their limits (f64 by the median relative error beside
  the plain version's own spread, f32 by the JAX kernel tests' tolerance
  or its median), the f64 CEMPPI step through the kernel against the plain
  path, `simulate_mujoco_on_device("Swimmer-v4")` at the JAX bench's
  configuration (K=4096, H=25, 3 AIS iterations) for 200 steps, the torso's
  final x from its replayed actions, and the timings;
- phases 25-28, the Pusher: the spatial kernel's Pusher build (Euler,
  slide joints, condim-1 floor contacts, capsule–cylinder pairs, the
  `pusher` reward family) checked the same way at K=1024, T=10 from reset
  and from the fingertips against the object and the table (the condim-1
  and pair rows counted), `simulate_mujoco_on_device("Pusher-v4")` at the
  JAX bench's configuration (K=1024, H=10, 2 AIS iterations) for 100
  steps, its shaped reward at the end against the reset's, and the timings;
- phases 29-32, the Humanoid, and 33-36, the Standup: the spatial kernel's
  Humanoid and Standup builds (23 dofs, 242 rows with 109 capsule–capsule
  self pairs, joint springs; the com-x track or the `standup` family)
  checked the same way at K=1024, T=8 from the reset and from a crouch
  (floor and self-pair rows counted), `simulate_mujoco_on_device` at the
  JAX bench's configurations (K=1024, H=8, 2 AIS iterations, λ=1.0 / 0.3)
  for 50 steps, the torso's height against a zero-action run, and the
  timings;
- phases 37-41, the multi-car race and the car harness's options: kernel
  1's 2-, 3- and 4-car builds through `MultiCarRacingEnv` against the plain
  version (f32 at the JAX multi-car tolerance, rtol 2e-4 / atol 2e-2, and by
  its median at the race's shape; f64 sample by sample at 1e-9 or the nudge
  rule), `simulate_car_racing(num_cars=3, policy_type="cmamppi")` at K=8192,
  H=50, 10 AIS iterations (every rollout on the kernel), the f64 CEMPPI
  step at 3 cars through the kernel against the plain path, the one-car
  race with state noise, the race at 10 control steps a call against one
  (f64, K=150, equal metrics), and the kernel's time at 2, 3 and 4 cars;
- phase 42, the Reacher at the JAX bench's configuration (CEMPPI, K=8192,
  H=15, 3 AIS iterations, λ=0.05, Σ=0.02·I) with the JAX test's criterion
  after 30 steps; phases 43-44, InvertedDoublePendulum (the JAX test's
  K=32, H=15, 2 iterations; reward > 9 a step over 30 steps) and
  InvertedPendulum (healthy at every step); phase 45, MountainCar (2 trials
  × 200 steps at the CLI's defaults, one above 9e4) and CartPole. These
  have no hand-written kernel: their rollouts are plain PyTorch, and no
  kernel may launch on them (scripts/plain_task_times.py times their
  control and env steps and counts their device operations);
- phase 46, checkpoints: a car CEMPPI run at K=150 (H=50, 10 AIS iterations,
  `ss`, λ=10) on the card, checkpointed after 3 steps and resumed for 3,
  equals the 6 uninterrupted steps bit for bit (kernel 1 on the path), with
  PhaseTimer's and timed's times of the policy step; and the host driver's
  f64 policy math on the card against the CPU's under the same normals, at
  BASELINE.md row 1's K, H and iterations over a numpy stand-in for the
  host engine (which needs mujoco);
- phase 47, gifs: the car race at K=150 with `save_gif` (kernel 1 on the
  path, one frame a step, 10 steps), then 2 steps with `plot_traj` (the
  logged rollouts take the plain version, as in the JAX package);
- phase 48, the host MuJoCo engine with the policy math on the card, at
  the reference's published configuration (BASELINE.md row 1: HalfCheetah,
  CEMPPI, K=100, H=50, 5 AIS iterations, λ=1, Σ=0.25·I, frame skip 5, `ss`,
  seed 1, 2 trials × 50 steps): the rewards, control steps/s and the host's
  cores, and each trial's action CSV replayed in gymnasium to its reward.
  Phases 47 and 48 need matplotlib and imageio, and mujoco and gymnasium:
  where the machine lacks one, the path prints the package's name and that
  it was not run;
- phases 49-52, the sample axis over several ranks (`parallel/`; path
  `sharded`, run before `resume`): the car race with CEMPPI at K=8192, H=50,
  10 AIS iterations, `ss`, λ=10 on the `curve` track for 100 steps on a
  one-rank nccl mesh, its metrics bit-equal to the same race without a mesh
  (kernel 1 on the path; without, with, with, without, each timed); then two gloo ranks sharing the card, each
  launching the rollout kernel on its block of samples, their actions,
  costs and U bit-equal to the single-process step: the one-car CEMPPI step
  in f32 and f64 for 20 steps and at K=8191 (blocks 4096 and 4095) for 5,
  the 3-car CMAMPPI step (kernel 1's 3-car build) for 10 and HalfCheetah's
  CEMPPI step (kernel 2; K=2048, H=15, 3 iterations, `mle`) for 5; and the
  control steps/s of each beside its single-process twin's (two ranks
  time-sharing one card: not a scaling figure). The card machine has one
  card, so no multi-GPU scaling is measured.

The f64 comparisons of Ant and the Pusher at the main path's K run the
first 3 of its T steps; each plain version is timed once, the rollouts'
on the comparison's own run. The nudged plain runs of phases 8 and 18 run
only where the rule needs them. Phases 9
(HalfCheetah), 19, 23 (the Swimmer), 27, 31 and 35 also replay ten of the
main path's own rollout launches (launches 20-29, their inputs recorded as
the path ran) for their device time and its share of the control step;
phases 10 and 24 split HalfCheetah's and the Swimmer's control step into the
policy step and the env step; phases 6 and 21 print each planar build's
lanes a sample and warps a block. Phases 19-35 print each path's reward
beside the thread-per-sample kernel 4's; phases 17 and 25 (with 29 and 33)
print the free device memory around each build's first launches.

Every kernel's launch count is set to 0 just before each path and read
just after. Every phase raises on failure; there is no CPU path. The
bound of each kernel (`bound_ms`) is the larger of its operations over the
H100's float32 peak and its bytes over the memory rate, counted as the
comments say. The last two lines are a JSON line of per-kernel numbers and
the result line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

K, H, ITS = 8192, 50, 10
SEED = 1
# the race runs to past lap 1 (at step 483), and the reference config K=150
# for 50 steps: enough to show both on the kernel, short enough to leave the
# time limit to the later paths
RACE_STEPS, RACE150_STEPS = 520, 50
# the planar-contact path: the JAX package's end-to-end contact configuration
PK, PH, PITS, PLAM = 2048, 15, 3, 0.1
# Hopper and Walker2d run 20 steps and the other kinds' races 30: enough to
# show each on its kernels, and short enough to leave the time limit to the
# later paths
CHEETAH_STEPS, OTHER_STEPS = 200, 20
# x[1] lowered so that contacts fire at once: HalfCheetah as the JAX contact
# kernel test, Hopper by 0.1 from its 1.25 (9 contact rows), Walker2d by 0.08
# (18 contact rows, as at 1.15, where one of the JAX test's 5 f32 samples
# switches contact differently in the kernel and the plain version; at 1.19
# the feet sit exactly on the floor)
DROP = {"HalfCheetah-v4": -0.35, "Hopper-v4": 1.15, "Walker2d-v4": 1.17}
# relative nudge of the controls: a few ulps (the states are not nudged, as a
# joint at 0 sits exactly on Hopper's and Walker2d's knee limits)
NUDGE = {torch.float64: 1e-15, torch.float32: 1e-6}
# the policy layer at full width: n = cs = 2·H, m_elite = round(0.2·K)
N_CS, M_ELITE = 2 * H, round(0.2 * K)
CMA_RACE_STEPS, KIND_STEPS = 1000, 30
# the spatial-contact path: the JAX package's end-to-end Ant configuration
# (bench.py:356, :474-476): CEMPPI, K=1024, H=10, 2 AIS iterations, λ=1, Σ=0.25·I₈
AK, AH, AITS, ALAM = 1024, 10, 2, 1.0
ANT_STEPS = 100
# x[2] of the Ant starts (joints at 0): the reset; the torso sphere inside the
# contact margin at the first substep; the JAX kernel tests' grounded start
ANT_Z = {"reset": 0.75, "shallow": 0.26, "grounded": 0.75 - 0.45}
# the Swimmer: the JAX bench's entry (bench.py:355): CEMPPI, K=4096, H=25, 3 AIS
# iterations, `mle`, λ=0.1, Σ=0.25·I₂; and a start with both motor joints past
# their ±100° limits
SK, SH, SITS, SLAM = 4096, 25, 3, 0.1
SWIMMER_STEPS = 200
_LIM = float(np.deg2rad(100.0))
SWIMMER_LIMITS = (0.1, -0.2, 0.3, 1.03 * _LIM, -1.04 * _LIM, 0.5, -0.4, 1.0, 2.0, -1.5)
# the Pusher: the JAX bench's entry (bench.py:357): CEMPPI, K=1024, H=10, 2 AIS
# iterations, `mle`, λ=0.1, Σ=0.25·I₇, contact solver (3, 6); and a start with
# the fingertips pressed into the table against the object's side (the tip
# capsules' axis at z = −0.307, the cylinder's axis 0.068 along x from the
# first one's middle)
UK, UH, UITS, ULAM = 1024, 10, 2, 0.1
PUSHER_STEPS = 100
PUSHER_TOUCH = (-0.307, 0.068)
# the Humanoid and the Standup: the JAX bench's entries (bench.py:358-359):
# CEMPPI, K=1024, H=8, 2 AIS iterations, `mle`, Σ=0.25·I₁₇, contact solver
# (3, 6), λ=1.0 (Humanoid) and 0.3 (Standup); 50 reported steps each
HK, HH, HITS = 1024, 8, 2
HUMANOID_STEPS = 50
# the main path's own rollout launches timed by phases 19, 27, 31 and 35:
# launches 20 .. 29, after the first steps' transient
MAIN_WINDOW = (20, 10)
# the paths `--only` selects, in the order of a full run
PATHS = ("car", "planar", "ais", "ant", "swimmer", "pusher", "humanoid", "standup", "cars",
         "reacher", "pendulums", "classic", "sharded", "resume", "gif", "host")
# the packages beyond torch and numpy that a path needs: where one is
# missing, the path is not run and says so
PACKAGES = {"gif": ("matplotlib", "imageio"), "host": ("mujoco", "gymnasium")}
# the H100's published peaks (float32 outside the tensor cores; HBM3)
PEAK_F32_FLOPS, PEAK_BYTES_S = 67e12, 3.35e12


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    return out.splitlines()[0]


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> np.ndarray:
    g, w = got.double().cpu().numpy(), want.double().cpu().numpy()
    return np.abs(g - w) / np.maximum(np.abs(w), 1e-300)


def _hold(what: str, err: float, err_nudged: float, bound: float) -> None:
    """Require err <= bound; where the plain version itself moves by more than
    `bound` when its controls are nudged by a few ulps (a contact switch turns
    rounding into a different QP iterate), require err within 10x of that."""
    if err_nudged <= bound:
        _require(err <= bound, f"{what}: {err:.3e} > {bound:g}")
    else:
        _require(err <= 10 * err_nudged,
                 f"{what}: {err:.3e} beyond 10x the plain version's own {err_nudged:.3e}")


def _candidates(k, horizon, seed, dtype, cars=1):
    """Clamped candidate controls (T, 2·cars, K) as the CEMPPI step forms
    them in its first iteration: U = 0 plus N(0, diag(0.0625, 0.1)) noise
    for each car."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    std = torch.tensor([0.25, 0.1**0.5] * cars, dtype=dtype, device="cuda")
    z = torch.randn((horizon, 2 * cars, k), generator=g, dtype=dtype, device="cuda")
    return torch.clamp(z * std[None, :, None], -1.0, 1.0).contiguous()


def _uniform(k, horizon, na, seed, dtype):
    ctrl = np.random.default_rng(seed).uniform(-1, 1, size=(horizon, na, k))
    return torch.as_tensor(ctrl, dtype=dtype, device="cuda")


_COUNTERS = {  # kernel name -> (module, counter)
    "car_rollout": ("car_rollout", "LAUNCHES"),
    "planar_rollout": ("planar_step", "LAUNCHES"),
    "planar_step_states": ("planar_step", "STEP_LAUNCHES"),
    "masked_refit": ("ais_update", "MASKED_LAUNCHES"),
    "weighted_refit": ("ais_update", "WEIGHTED_LAUNCHES"),
    "cma_update": ("ais_update", "CMA_LAUNCHES"),
    "cholesky": ("linalg", "CHOL_LAUNCHES"),
    "forward_solve": ("linalg", "SOLVE_LAUNCHES"),
    "spatial_rollout": ("spatial_step", "LAUNCHES"),
    "spatial_step_states": ("spatial_step", "STEP_LAUNCHES"),
    "swimmer_rollout": ("planar_step", "SWIMMER_LAUNCHES"),
    "swimmer_step_states": ("planar_step", "SWIMMER_STEP_LAUNCHES"),
}


def _kernel_module(mod: str):
    return importlib.import_module(f"mpopis_tpu_torch.kernels.{mod}")


def _zero_counts():
    for mod, counter in _COUNTERS.values():
        setattr(_kernel_module(mod), counter, 0)


def _counts() -> dict:
    return {name: getattr(_kernel_module(mod), counter)
            for name, (mod, counter) in _COUNTERS.items()}


def _bound(flops: float, nbytes: float):
    """(bound_ms, bound_by): the larger of the operations over the float32
    peak and the bytes over the memory rate."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


@contextlib.contextmanager
def _env(**values):
    """Set environment variables (None removes one) for the duration."""
    old = {name: os.environ.get(name) for name in values}
    try:
        for name, v in values.items():
            if v is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = v
        yield
    finally:
        for name, v in old.items():
            if v is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = v


@contextlib.contextmanager
def _qp_tally(module, env):
    """Tally the contact QP's multiply-adds in the plain version's calls of
    `module.solve_qp`: per sample with at least one valid row, outer × (cg + 6
    arc trials + 2) applications of J M⁻¹ Jᵀ over its valid rows, 2·R·n + n²
    each; a sample with none skips its QP. Yields [multiply-adds, valid rows
    after the joint limits' (the contact and pair rows), valid cylinder-pair
    rows, all valid rows, valid self-pair rows (the model's last), summed
    over calls and samples]."""
    orig, outer, cg, n = module.solve_qp, env.solver_outer, env.solver_cg, env.MODEL.n_dof
    n_self = len(getattr(env.MODEL, "self_pairs", ()))
    first_row = len(env.MODEL.limits)
    first_self = env.MODEL.n_rows - n_self
    first_pair = first_self - len(env.MODEL.pairs)
    tally = [0.0, 0, 0, 0, 0]

    def counting(jmat, aref, r_reg, active, *args, **kwargs):
        rows = active.sum(-1).double()
        tally[0] += float(torch.where(rows > 0, outer * (cg + 8) * (2.0 * rows * n + n * n),
                                      0.0).sum())
        tally[1] += int(active[..., first_row:].sum())
        tally[2] += int(active[..., first_pair:first_self].sum())
        tally[3] += int(active.sum())
        tally[4] += int(active[..., first_self:].sum())
        return orig(jmat, aref, r_reg, active, *args, **kwargs)

    module.solve_qp = counting
    try:
        yield tally
    finally:
        module.solve_qp = orig


def _contact_ops(env, n_forward: int, factorizations: int, solves: int, qp_macs: float) -> float:
    """Operations of n_forward constrained forward passes: the mass-matrix
    factorizations (n³/3 each) and solves (2n² each), and the QP's tallied
    multiply-adds (2 operations each)."""
    n = env.MODEL.n_dof
    return n_forward * (factorizations * n**3 / 3.0 + solves * 2.0 * n * n) + 2.0 * qp_macs


def _ptxas_lines(log: str):
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            yield line.strip()


def _time_ms(fn, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_ms(fn, reps: int):
    """(ms per call, method): the device time of `reps` calls of `fn` without
    the host between them. The calls are captured once in a CUDA graph and
    its replay is timed by CUDA events; where the capture fails, the sum of
    the device kernels' times in a torch.profiler trace of `reps` calls."""
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps, "CUDA graph"
    except RuntimeError as err:
        print(f"  CUDA graph capture failed ({str(err).splitlines()[0]}); torch.profiler")
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages())
    return us / 1e3 / reps, "torch.profiler kernel sum"


@contextlib.contextmanager
def _recording(module, name: str, first: int, count: int):
    """Record (cloned) the arguments of calls first .. first + count - 1 of
    `module.name`, which runs as before; yields the list of recorded calls."""
    orig, calls, seen = getattr(module, name), [], [0]

    def recording(env, *args):
        if first <= seen[0] < first + count:
            calls.append((env, *(a.clone() for a in args)))
        seen[0] += 1
        return orig(env, *args)

    setattr(module, name, recording)
    try:
        yield calls
    finally:
        setattr(module, name, orig)


def _own_launch_ms(label, calls, kern, counts, rollout, step, steps_per_s, card) -> float:
    """The device time (`_device_ms`) of the main path's own rollout launches
    recorded in a window, replayed on their own inputs, and their share of
    the control step: launches per executed step × mean ms over the step's
    host time (1000 / control steps per second). The time is the whole
    wrapper's device work: the kernel and any PyTorch op the wrapper
    launches beside it. Returns the mean ms."""
    timed = [_device_ms(lambda c=c: kern(*c), 1) for c in calls]
    ms = [t for t, _ in timed]
    how = ", ".join(sorted({h for _, h in timed}))
    mean, per_step = float(np.mean(ms)), counts[rollout] / counts[step]
    step_ms = 1e3 / steps_per_s
    print(f"{label} the main path's own rollout launches ({len(ms)} recorded, from launch "
          f"{MAIN_WINDOW[0]}): device {mean:.4f} ms mean (min {min(ms):.4f}, max {max(ms):.4f}; "
          f"{how}, the wrapper's device work); {per_step:.3f} launches per control step make "
          f"{per_step * mean:.3f} ms, {100 * per_step * mean / step_ms:.1f}% of the "
          f"{step_ms:.3f} ms control step ({card})")
    return mean


def _step_split(label, env_cls, k, horizon, its, lam, rollout_ms) -> None:
    """A main path's control step split into the policy step and the env
    step: host clock around synchronised calls, CEMPPI (`mle`, Σ = 0.25·I)
    at the path's configuration, 20 steps after 3 of warm-up, f32."""
    from mpopis_tpu_torch.policies import PolicyConfig, make_policy

    env = env_cls(dtype=torch.float32, device="cuda")
    pol = make_policy(env, PolicyConfig(kind="cemppi", num_samples=k, horizon=horizon, lam=lam,
                                        opt_its=its, sigma_est="mle"),
                      cov_mat=0.25 * np.eye(env.action_dim))
    s, pstate = env.reset(), pol.init_state(SEED)
    split = {"policy": [], "env": []}
    for i in range(23):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a, pstate, _ = pol.step(s, pstate)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        s, _ = env.step_reward(s, a)
        torch.cuda.synchronize()
        if i >= 3:
            split["policy"].append((t1 - t0) * 1e3)
            split["env"].append((time.perf_counter() - t1) * 1e3)
    print(f"{label} control step over 20 steps (host clock, synchronised): policy step median "
          f"{np.median(split['policy']):.3f} ms (range {min(split['policy']):.3f}-"
          f"{max(split['policy']):.3f}; up to {its} rollout launches of {rollout_ms:.3f} ms), env "
          f"step median {np.median(split['env']):.3f} ms (range {min(split['env']):.3f}-"
          f"{max(split['env']):.3f})")


def _print_launch_shapes(label, envs) -> None:
    """Each planar build's lanes a sample and warps a block, f32 and f64."""
    from mpopis_tpu_torch.kernels import planar_step

    for task, cls in envs.items():
        shapes = {str(dt)[6:]: planar_step.launch_shape(cls(dtype=dt, device="cuda"), dt)
                  for dt in (torch.float32, torch.float64)}
        print(f"{label} {task} build: " + ", ".join(
            f"{name} W = {w} lanes a sample, {nw} warps a block" for name, (w, nw) in
            shapes.items()))


def _rel_norm(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got − want| / max |want|."""
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-300))


def _rel_state_err(got: torch.Tensor, want: torch.Tensor) -> np.ndarray:
    """Per state: max |got − want| over its entries / max |want|."""
    g, w = got.double().cpu().numpy(), want.double().cpu().numpy()
    return np.abs(g - w).max(-1) / np.maximum(np.abs(w).max(-1), 1e-300)


def _planar_path(card: str) -> list:
    """Phases 6-10: the planar-contact kernel and the on-device MuJoCo path.
    Returns the `kernels` entries of planar_rollout and planar_step_states."""
    from mpopis_tpu_torch.harness.simulate import simulate_mujoco_on_device
    from mpopis_tpu_torch.kernels import build, planar_step
    from mpopis_tpu_torch.models import CheetahDeviceEnv, HopperDeviceEnv, Walker2dDeviceEnv
    from mpopis_tpu_torch.models import planar_contact
    from mpopis_tpu_torch.models.base import make_state
    from mpopis_tpu_torch.policies import PolicyConfig, make_policy

    kern = planar_step.planar_rollout_costs_tak
    ref = planar_step.planar_rollout_costs_tak_reference
    envs = {"HalfCheetah-v4": CheetahDeviceEnv, "Hopper-v4": HopperDeviceEnv,
            "Walker2d-v4": Walker2dDeviceEnv}

    # -- phase 6: build ----------------------------------------------------
    t_phase = time.perf_counter()
    build.load_library("planar_rollout")
    info = build.BUILD_INFO["planar_rollout"]
    print(f"phase 6: {info['so']} built in {info['seconds']:.1f} s (in parallel with the car's)")
    for line in _ptxas_lines(info["log"]):
        print("  ptxas:", line)
    _print_launch_shapes("phase 6:", envs)

    def env_x(task, dtype, drop=False, **kw):
        env = envs[task](dtype=dtype, device="cuda", **kw)
        x = env.reset().x.clone()
        if drop:
            x[1] = DROP[task]
        return env, x

    # -- phase 7: kernel against its plain version ----------------------------
    results = {}
    for task in envs:
        na = envs[task].action_dim
        # f32, K=64 T=3, from reset: the JAX kernel tests' rtol 2e-4 / atol 2e-4
        env, x = env_x(task, torch.float32)
        ctrl = _uniform(64, 3, na, 64, torch.float32)
        got, want = kern(env, x, ctrl), ref(env, x, ctrl)
        err = float(torch.max(torch.abs(got - want)))
        ok = bool(torch.allclose(got, want, rtol=2e-4, atol=2e-4))
        print(f"phase 7: {task} f32 K=64 T=3 from reset: max|err| {err:.3e} "
              f"(rtol 2e-4, atol 2e-4) ok={ok}")
        _require(ok, f"{task}: f32 kernel disagrees from reset")

        # f32 from a lowered start, as the JAX package's contact kernel test
        # (K=5, T=4, controls from seed 7, solver (2, 6)): rtol 2e-4 / atol 2e-3
        env, x = env_x(task, torch.float32, drop=True, solver_outer=2, solver_cg=6)
        n_lim, n_con = planar_step.first_substep_active_rows(env, x)
        ctrl = torch.as_tensor(np.random.default_rng(7).uniform(-1, 1, (5, 4, na)),
                               dtype=torch.float32, device="cuda").permute(1, 2, 0).contiguous()
        got, want = kern(env, x, ctrl), ref(env, x, ctrl)
        err = float(torch.max(torch.abs(got - want)))
        ok = bool(torch.all(torch.isfinite(got))) and bool(
            torch.allclose(got, want, rtol=2e-4, atol=2e-3))
        print(f"phase 7: {task} f32 K=5 T=4 from x[1]={DROP[task]}: {n_lim} limit and {n_con} "
              f"contact rows active in the first substep; max|err| {err:.3e} "
              f"(rtol 2e-4, atol 2e-3) ok={ok}")
        _require(n_con > 0, f"{task}: no contact row active at the lowered start")
        _require(ok, f"{task}: f32 kernel disagrees from the lowered start")
        # the same start at K=64 T=3 with the env's solver, against f64 too
        env, x = env_x(task, torch.float32, drop=True)
        env64, x64 = env_x(task, torch.float64, drop=True)
        ctrl = _uniform(64, 3, na, 64, torch.float64)
        k32, p32 = kern(env, x, ctrl.float()), ref(env, x, ctrl.float())
        p64 = ref(env64, x64, ctrl)
        n_over = int((~torch.isclose(k32, p32, rtol=2e-4, atol=2e-3)).sum())
        print(f"phase 7: {task} f32 K=64 T=3 from the lowered start: max|err| kernel vs plain "
              f"{float((k32 - p32).abs().max()):.3e} ({n_over} of 64 beyond rtol 2e-4 / atol "
              f"2e-3); against the plain f64: kernel {float((k32 - p64).abs().max()):.3e}, "
              f"plain f32 {float((p32 - p64).abs().max()):.3e}")

        # f64, K=2048 T=15: median relative error ≤ 1e-9, beside the plain
        # version's own spread under controls·(1 + 1e-15) where the median is
        # beyond it (the nudge rule)
        ctrl64 = _uniform(PK, PH, na, 2048, torch.float64)
        for start in ("reset", "lowered"):
            env64, x64 = env_x(task, torch.float64, drop=start == "lowered")
            want = ref(env64, x64, ctrl64)
            rel = _rel_err(kern(env64, x64, ctrl64), want)
            med, med_pert, spread = float(np.median(rel)), 0.0, "the plain version's own not needed"
            if med > 1e-9:
                rel_pert = _rel_err(ref(env64, x64, ctrl64 * (1 + NUDGE[torch.float64])), want)
                med_pert = float(np.median(rel_pert))
                spread = (f"plain vs plain at controls·(1+1e-15): max {rel_pert.max():.3e} "
                          f"median {med_pert:.3e}, {int(np.sum(rel_pert > 1e-9))} beyond")
            print(f"phase 7: {task} f64 K={PK} T={PH} from {start}: rel err max "
                  f"{rel.max():.3e} median {med:.3e}, {int(np.sum(rel > 1e-9))} of {PK} beyond "
                  f"1e-9; {spread}")
            _hold(f"{task} f64 from {start}: kernel median relative error", med, med_pert, 1e-9)

        # f32, K=2048 T=15, from reset: median relative error < 2e-4; the
        # plain run is timed here for phase 10
        env, x = env_x(task, torch.float32)
        ctrl32 = ctrl64.float()
        got = kern(env, x, ctrl32)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        want = ref(env, x, ctrl32)
        end.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(end)
        rel32 = _rel_err(got, want)
        max_abs = float(torch.max(torch.abs(got - want)))
        print(f"phase 7: {task} f32 K={PK} T={PH} from reset: rel err max {rel32.max():.3e} "
              f"median {np.median(rel32):.3e}, {int(np.sum(rel32 > 2e-4))} of {PK} beyond 2e-4, "
              f"max|err| {max_abs:.3e}")
        _require(bool(torch.all(torch.isfinite(got))), f"{task}: non-finite f32 kernel costs")
        _require(float(np.median(rel32)) < 2e-4, f"{task}: f32 median relative error >= 2e-4")
        results[task] = {"max_abs_err": max_abs, "median_rel_err_f32": float(np.median(rel32)),
                         "plain_ms": plain_ms}

        # planar_step_states against the plain step, 256 lowered states
        for dtype, bound in ((torch.float64, 1e-9), (torch.float32, 2e-4)):
            env, x = env_x(task, dtype, drop=True)
            rng = np.random.default_rng(3)
            xs = x + torch.as_tensor(rng.uniform(-0.05, 0.05, (256, x.numel())), dtype=dtype,
                                     device="cuda")
            acts = torch.as_tensor(rng.uniform(-1, 1, (256, na)), dtype=dtype, device="cuda")
            got = planar_step.planar_step_states(env, xs, acts)
            want = env.plain_step(make_state(xs), acts).x
            rel = _rel_state_err(got, want)
            med, med_pert = float(np.median(rel)), 0.0
            spread = "the plain version's own spread not needed"
            if med > bound:  # the nudged plain step only where the rule needs it
                rel_pert = _rel_state_err(
                    env.plain_step(make_state(xs), acts * (1 + NUDGE[dtype])).x, want)
                med_pert = float(np.median(rel_pert))
                spread = (f"plain vs plain at actions·(1 + {NUDGE[dtype]:g}): max "
                          f"{rel_pert.max():.3e} median {med_pert:.3e}, "
                          f"{int(np.sum(rel_pert > bound))} beyond")
            name = str(dtype)[6:]
            results[task][f"step_max_abs_err_{name}"] = float((got - want).abs().max())
            print(f"phase 7: {task} planar_step_states {name} B=256 from the lowered start "
                  f"±0.05: rel err max {rel.max():.3e} median {med:.3e}, "
                  f"{int(np.sum(rel > bound))} beyond {bound:g}; {spread}")
            _hold(f"{task} {name} step kernel: median relative error", med, med_pert, bound)
    torch.cuda.synchronize()
    print(f"phase 6-7: {time.perf_counter() - t_phase:.1f} s")

    # -- phase 8: the CEMPPI step in f64, kernel path vs plain path -----------
    # The plain path rolls out through `rollout_batch` over the plain step
    # (the env's own step would launch the step kernel on the card).
    class PlainCheetah(CheetahDeviceEnv):
        def step(self, state, action):
            return self.plain_step(state, action)

    t_phase = time.perf_counter()
    z = torch.randn((PITS, 6 * PH, PK), generator=torch.Generator("cuda").manual_seed(5),
                    dtype=torch.float64, device="cuda")

    def cheetah_step(cls, fused, nudge):
        env64 = cls(dtype=torch.float64, device="cuda")
        cfg = PolicyConfig(kind="cemppi", num_samples=PK, horizon=PH, lam=PLAM, opt_its=PITS,
                           sigma_est="mle", use_fused_rollout=fused)
        pol = make_policy(env64, cfg, cov_mat=0.25 * np.eye(6))
        _zero_counts()
        t0 = time.perf_counter()
        a, ps, inf = pol.step(env64.reset(), pol.init_state(0), z=z * (1 + nudge))
        torch.cuda.synchronize()
        return a, ps.U, inf["ais_its"], time.perf_counter() - t0, _counts()

    # the plain path at z·(1 + 1e-15) runs only where the nudge rule needs it
    a_k, u_k, its_k, s_k, n_k = cheetah_step(CheetahDeviceEnv, True, 0.0)
    a_p, u_p, its_p, s_p, n_p = cheetah_step(PlainCheetah, False, 0.0)
    err_a, err_u = _rel_norm(a_k, a_p), _rel_norm(u_k, u_p)
    own_a = own_u = 0.0
    spread = "the plain path's own spread not needed"
    if max(err_a, err_u) > 1e-8:
        a_n, u_n, its_n, _, _ = cheetah_step(PlainCheetah, False, NUDGE[torch.float64])
        own_a, own_u = _rel_norm(a_n, a_p), _rel_norm(u_n, u_p)
        spread = f"plain vs plain at z·(1+1e-15): {its_n} its, action {own_a:.3e}, U {own_u:.3e}"
    print(f"phase 8: HalfCheetah CEMPPI f64 step K={PK} H={PH}: kernel path {its_k} its "
          f"{s_k:.2f} s, launches {json.dumps(n_k)}; plain path {its_p} its {s_p:.2f} s, "
          f"launches {json.dumps(n_p)}; kernel vs plain, max|Δ| / max|plain|: action {err_a:.3e}, "
          f"U {err_u:.3e} (bound 1e-8); {spread} ({time.perf_counter() - t_phase:.1f} s)")
    _require(n_k["planar_rollout"] == its_k and n_k["planar_step_states"] == 0,
             "the kernel path did not roll out on the kernel")
    _require(n_p["planar_rollout"] == n_p["planar_step_states"] == 0,
             "the plain path launched a kernel")
    _require(its_k == its_p, "kernel and plain paths ran different iteration counts")
    _hold("CEMPPI step: action, kernel vs plain path", err_a, own_a, 1e-8)
    _hold("CEMPPI step: U, kernel vs plain path", err_u, own_u, 1e-8)

    # -- phase 9: the main path, simulate_mujoco_on_device ----------------------
    # HalfCheetah's own rollout launches MAIN_WINDOW are recorded as it runs
    counts = {}
    for task, steps in (("HalfCheetah-v4", CHEETAH_STEPS), ("Hopper-v4", OTHER_STEPS),
                        ("Walker2d-v4", OTHER_STEPS)):
        t_phase = time.perf_counter()
        with contextlib.ExitStack() as stack:
            calls = (stack.enter_context(_recording(planar_step, "planar_rollout_costs_tak",
                                                    *MAIN_WINDOW))
                     if task == "HalfCheetah-v4" else [])
            _zero_counts()
            m = simulate_mujoco_on_device(
                task, num_trials=1, num_steps=steps, num_samples=PK, horizon=PH, lam=PLAM,
                ais_its=PITS, ce_sigma_est="mle", seed=SEED, device="cuda", dtype=torch.float32,
            )
            counts[task] = _counts()
        its = int(m["ais_iterations"][0])
        rew, rps = float(m["rewards"][0]), float(m["rewards_per_step"][0])
        sps = float(m["control_steps_per_s"][0])
        print(f"phase 9: {task} K={PK} H={PH} {PITS} its: reward {rew:.4f} over "
              f"{int(m['steps'][0])} steps ({rps:.4f} per step), {sps:.3f} control steps/s, "
              f"ais_iterations {its}, kernel launches {json.dumps(counts[task])} "
              f"({time.perf_counter() - t_phase:.1f} s)")
        _require(counts[task]["planar_rollout"] == its > 0,
                 f"{task}: not every rollout ran on the kernel")
        _require(counts[task]["planar_step_states"] > steps,
                 f"{task}: the env step did not run on the kernel")
        _require(np.isfinite(rew), f"{task}: non-finite reward")
        if task == "HalfCheetah-v4":
            _require(rps > 0, "the cheetah did not run forward")
            own_ms = _own_launch_ms("phase 9: HalfCheetah", calls, kern, counts[task],
                                    "planar_rollout", "planar_step_states", sps, card)

    # -- phase 10: timings by CUDA events ------------------------------------------
    # The rollouts are timed on phase 7's f32 inputs from reset, whose plain
    # run was timed there.
    t_phase = time.perf_counter()
    times = {}
    for task in envs:
        env, x = env_x(task, torch.float32)
        ctrl = _uniform(PK, PH, envs[task].action_dim, 2048, torch.float64).float()
        xs = x[None].contiguous()
        act = torch.zeros((1, envs[task].action_dim), device="cuda")
        times[(task, "rollout")] = _timed(
            f"phase 10: {task} rollout", f"K={PK} T={PH}", lambda: kern(env, x, ctrl), 20,
            results[task]["plain_ms"], card)
        times[(task, "step")] = _timed(
            f"phase 10: {task} step", "one state",
            lambda: planar_step.planar_step_states(env, xs, act), 50,
            lambda: env.plain_step(make_state(xs), act), card)
    k_ms, p_ms = times[("HalfCheetah-v4", "rollout")]

    _step_split("phase 10: HalfCheetah", CheetahDeviceEnv, PK, PH, PITS, PLAM, k_ms)
    print(f"phase 10: {time.perf_counter() - t_phase:.1f} s")

    cheetah = counts["HalfCheetah-v4"]
    ks_ms, ps_ms = times[("HalfCheetah-v4", "step")]
    # Operations counted (_contact_ops): per Euler-implicit substep two
    # mass-matrix factorizations and two solves, and the contact QP's
    # applications of J M⁻¹ Jᵀ over the rows valid in these inputs, tallied
    # from one more plain run on the timed inputs. The mass matrix, bias and
    # constraint rows are not counted. Bytes: the controls read and the costs
    # written.
    env = CheetahDeviceEnv(dtype=torch.float32, device="cuda")
    x = env.reset().x
    ctrl = _uniform(PK, PH, env.action_dim, 2048, torch.float64).float()
    xs, act = x[None].contiguous(), torch.zeros((1, env.action_dim), device="cuda")
    na, n_sub = env.action_dim, PH * PK * env.FRAME_SKIP
    with _qp_tally(planar_contact, env) as tally:
        ref(env, x, ctrl)
    roll_bound = _bound(_contact_ops(env, n_sub, 2, 2, tally[0]), 4.0 * (PH * na * PK + PK))
    with _qp_tally(planar_contact, env) as tally:
        env.plain_step(make_state(xs), act)
    step_bound = _bound(_contact_ops(env, env.FRAME_SKIP, 2, 2, tally[0]),
                        4.0 * (2 * env.state_dim + na))
    print(f"phase 10: bounds, HalfCheetah rollout {roll_bound[0]:.6f} ms ({roll_bound[1]}), "
          f"step {step_bound[0]:.3e} ms ({step_bound[1]})")
    return [{
        "name": "planar_rollout",
        "route": "cuda",
        "source": "mpopis_tpu_torch/csrc/planar_rollout.cu",
        "replaces": "mpopis_tpu/kernels/planar_step.py:47",
        "launches": cheetah["planar_rollout"],
        "max_abs_err": results["HalfCheetah-v4"]["max_abs_err"],
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": roll_bound[0],
        "bound_by": roll_bound[1],
        "library_ms": None,
        "median_rel_err_f32": results["HalfCheetah-v4"]["median_rel_err_f32"],
        "main_path_ms": own_ms,
    }, {
        "name": "planar_step_states",
        "route": "cuda",
        "source": "mpopis_tpu_torch/csrc/planar_rollout.cu",
        "replaces": "mpopis_tpu/kernels/planar_step.py:92",
        "launches": cheetah["planar_step_states"],
        "max_abs_err": results["HalfCheetah-v4"]["step_max_abs_err_float32"],
        "ms": ks_ms,
        "plain_ms": ps_ms,
        "bound_ms": step_bound[0],
        "bound_by": step_bound[1],
        "library_ms": None,
    }]


def _err_ratio(got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float) -> float:
    """max |got − want| / (atol + rtol·|want|): at most 1 within the tolerance;
    a NaN on one side only counts as out."""
    g, w = got.double(), want.double()
    r = (g - w).abs() / (atol + rtol * w.abs())
    r = torch.where(torch.isnan(g) & torch.isnan(w), torch.zeros_like(r), r)
    return float(torch.nan_to_num(r, nan=float("inf")).max())


# float32 tolerances of the JAX kernel tests (rtol, atol) per kernel family
F32_TOL = {"refit": (5e-4, 5e-5), "cma": (5e-3, 5e-4), "solve": (5e-5, 5e-6)}
# the Cholesky and forward-solve kernels' sizes: their panel edges (32
# columns), the car's n = 100, the Humanoid's H·nu = 136, and two sizes
# factored in device memory, up to the switch's n = 1024
CHOL_SIZES = (1, 31, 32, 33, 100, 136, 600, 1024)


def _ais_path(card: str) -> list:
    """Phases 11-15: the AIS-update and small-linalg kernels and the policy
    layer at full width. Returns their `kernels` entries."""
    from mpopis_tpu_torch.harness.simulate import simulate_car_racing
    from mpopis_tpu_torch.kernels import ais_update, build, linalg
    from mpopis_tpu_torch.models import CarRacingEnv
    from mpopis_tpu_torch.ops.covariance import shrinkage_cov_masked, weighted_mean_and_cov
    from mpopis_tpu_torch.policies import POLICY_KINDS, PolicyConfig, make_policy
    from mpopis_tpu_torch.policies.strategies import AISCarry, CMAStrategy, make_strategy

    n, dev = N_CS, "cuda"
    fused, pallas = "MPOPIS_FUSED_UPDATE", "MPOPIS_PALLAS_LINALG"

    # -- phase 11: build ---------------------------------------------------
    for name in ("ais_update", "linalg"):
        build.load_library(name)
        info = build.BUILD_INFO[name]
        print(f"phase 11: {info['so']} built in {info['seconds']:.1f} s (in parallel with the "
              f"others)")
        for line in _ptxas_lines(info["log"]):
            print("  ptxas:", line)

    print("phase 11: the CMA kernel's cluster (blocks; 0: one block from global memory): " +
          ", ".join(f"n={size} {str(dt)[6:]} {ais_update.cma_cluster_size(size, dt)}"
                    for size in (n, 136) for dt in (torch.float32, torch.float64)))
    _require(ais_update.cma_cluster_size(n, torch.float32) > 0,
             f"the CMA kernel runs n={n} float32 on one block, not on its cluster")
    print(f"phase 11: the refit kernels' cluster at K={K} (blocks, where the partial moments "
          f"and the factor sit): " +
          ", ".join(f"n={size} {str(dt)[6:]} {ais_update.refit_layout(size, K, dt)}"
                    for size in (n, 136) for dt in (torch.float32, torch.float64)))
    _require(ais_update.refit_layout(n, K, torch.float32) == (16, "shared"),
             f"the refit kernels do not run n={n} float32 on a cluster in shared memory")

    # -- phase 12: each kernel against its plain version ---------------------
    t_phase = time.perf_counter()
    g = torch.Generator(dev).manual_seed(12)
    e64 = 0.3 * torch.randn((n, K), generator=g, device=dev, dtype=torch.float64)
    mask64 = torch.zeros(K, device=dev, dtype=torch.float64)
    mask64[torch.randperm(K, generator=g, device=dev)[:M_ELITE]] = 1.0
    w64 = torch.rand(K, generator=g, device=dev, dtype=torch.float64) ** 4
    w64 /= w64.sum()
    counts64 = torch.bincount(torch.multinomial(w64, K, replacement=True, generator=g),
                              minlength=K).to(torch.float64)
    consts = CMAStrategy.constants(K, n, 0.8)
    consts_t = tuple(sorted((name, float(consts[name])) for name in ais_update.CMA_CONSTS))
    a64 = 0.05 * torch.randn((n, n), generator=g, device=dev, dtype=torch.float64)
    cma64 = (a64 @ a64.T + 0.3 * torch.eye(n, device=dev, dtype=torch.float64),
             0.3 * torch.randn(n, generator=g, device=dev, dtype=torch.float64),
             0.5 * torch.randn(n, generator=g, device=dev, dtype=torch.float64),
             0.1 * torch.randn(n, generator=g, device=dev, dtype=torch.float64),
             torch.randn(K, generator=g, device=dev, dtype=torch.float64),
             torch.as_tensor(consts["ws"], device=dev),
             torch.tensor(0.8, device=dev, dtype=torch.float64))
    spd64 = {}
    for size in CHOL_SIZES:
        b = 0.2 * torch.randn((size, size), generator=g, device=dev, dtype=torch.float64)
        spd64[size] = b @ b.T + torch.eye(size, device=dev, dtype=torch.float64)
    rhs64 = {size: torch.randn((2, size), generator=g, device=dev, dtype=torch.float64)
             for size in spd64}

    def cases(dt):
        e, mask, w, cnt = (t.to(dt) for t in (e64, mask64, w64, counts64))
        mu_m, mu_w, mu_c = (e @ mask) / M_ELITE, e @ w, e @ (cnt / K)
        cma = tuple(t.to(dt) for t in cma64)
        out = []
        for method in ais_update.METHODS:
            out.append((f"masked_refit {method}", "refit",
                        lambda m=method: ais_update.masked_refit_chol(
                            e, mask, mu_m, M_ELITE, m, 1e-8),
                        lambda m=method: ais_update.masked_refit_chol_reference(
                            e, mask, mu_m, M_ELITE, m, 1e-8)))
        out.append(("weighted_refit", "refit",
                    lambda: ais_update.weighted_refit_chol(e, w, mu_w, False, 1e-8),
                    lambda: ais_update.weighted_refit_chol_reference(e, w, mu_w, False, 1e-8)))
        out.append(("weighted_refit corrected (PMC)", "refit",
                    lambda: ais_update.weighted_refit_chol(e, cnt / K, mu_c, True, 1e-8),
                    lambda: ais_update.weighted_refit_chol_reference(e, cnt / K, mu_c, True, 1e-8)))
        for upd in (True, False):
            out.append((f"cma_update update_chol={upd}", "cma",
                        lambda u=upd: ais_update.cma_update_chol(*cma, 3.0, consts_t, 1e-8,
                                                                 update_chol=u),
                        lambda u=upd: ais_update.cma_update_chol_reference(
                            *cma, 3.0, consts_t, 1e-8, update_chol=u)))
        for size in spd64:
            a = spd64[size].to(dt)
            l_ref = linalg.chol_reference(a)
            rhs = rhs64[size].to(dt)
            out.append((f"cholesky n={size} lda={linalg.chol_lda(size, dt)}", "refit",
                        lambda a=a: linalg.chol_kernel(a), lambda a=a: linalg.chol_reference(a)))
            out.append((f"forward_solve n={size} nrhs=2", "solve",
                        lambda l=l_ref, r=rhs: linalg.fwd_solve_kernel(l, r),
                        lambda l=l_ref, r=rhs: linalg.fwd_solve_reference(l, r)))
        return out

    max_abs = {}
    for dt in (torch.float32, torch.float64):
        for name, family, run_k, run_p in cases(dt):
            got, want = run_k(), run_p()
            if isinstance(got, torch.Tensor):
                got, want = (got,), (want,)
            torch.cuda.synchronize()
            if dt == torch.float32:
                rtol, atol = F32_TOL[family]
                err = max(_err_ratio(gg, ww, rtol, atol) for gg, ww in zip(got, want))
                mabs = max(float((gg - ww).abs().max()) for gg, ww in zip(got, want))
                max_abs[name] = mabs
                print(f"phase 12: {name} f32: max|err| {mabs:.3e}, {err:.3f} of the tolerance "
                      f"(rtol {rtol:g}, atol {atol:g})")
                _require(err <= 1.0, f"{name}: f32 kernel disagrees with its plain version")
            else:
                rel = max(_rel_norm(gg, ww) for gg, ww in zip(got, want))
                print(f"phase 12: {name} f64: max|err| / max|plain| {rel:.3e} (bound 1e-9)")
                _require(rel <= 1e-9, f"{name}: f64 kernel disagrees with its plain version")
    ldas = {(size, dt): linalg.chol_lda(size, dt) for size in CHOL_SIZES
            for dt in (torch.float32, torch.float64)}
    _require(any(lda > size for (size, _), lda in ldas.items()) and
             any(size > 240 for size, _ in ldas),
             "no Cholesky case factored with padded rows in shared memory, or none in memory")
    # not positive definite: the identity with pivot 3 of 6 failing, and the
    # n = 100 matrix with pivot 70 failing (inside the third panel)
    for dt in (torch.float32, torch.float64):
        bad6 = torch.eye(6, device=dev, dtype=dt)
        bad100 = spd64[n].to(dt).clone()
        for bad, piv in ((bad6, 3), (bad100, 70)):
            bad[piv, piv] = -1.0
            l_bad, l_want = linalg.chol_kernel(bad), linalg.chol_reference(bad)
            torch.cuda.synchronize()
            low = torch.tril(torch.ones_like(bad, dtype=torch.bool))
            nan_ok = (bool(torch.equal(torch.isnan(l_bad), torch.isnan(l_want))) and
                      bool(torch.isnan(l_bad[piv:, piv:][low[piv:, piv:]]).all()) and
                      not bool(torch.isnan(l_bad[:, :piv]).any()))
            # columns before it: within the f32 tolerance, or 1e-9 of max|plain| in f64
            if dt == torch.float32:
                before = _err_ratio(l_bad[:, :piv], l_want[:, :piv], *F32_TOL["refit"])
            else:
                before = _rel_norm(l_bad[:, :piv], l_want[:, :piv]) / 1e-9
            print(f"phase 12: cholesky n={bad.shape[0]} ({dt}) with pivot {piv} failing: the "
                  f"plain version's NaN pattern, NaN on and below the diagonal from column "
                  f"{piv}, finite before it: {nan_ok}; columns before it {before:.3f} of the "
                  f"{'f32 tolerance' if dt == torch.float32 else 'f64 bound 1e-9'}")
            _require(nan_ok and before <= 1.0,
                     f"the Cholesky kernel's NaNs for a non-PD matrix (n={bad.shape[0]}, {dt})")
    print(f"phase 12: {time.perf_counter() - t_phase:.1f} s")

    # -- phase 13: the f32 control step, kernel path against library path ----
    t_phase = time.perf_counter()
    env32 = CarRacingEnv(dtype=torch.float32, device=dev)
    gz = torch.Generator(dev).manual_seed(13)
    z = torch.randn((ITS, n, K), generator=gz, device=dev, dtype=torch.float32)
    uni = torch.rand((ITS, K), generator=gz, device=dev, dtype=torch.float32)
    # The early stop is off, so both paths run every iteration. CMA runs 3:
    # with more forced iterations its step size grows without bound at this
    # configuration, on both paths as in the JAX package (PERF.md §6, PR 3),
    # and the main path's CMA stops after 1-3. PMC runs 2: its first
    # iteration's costs, weights and resampling counts are the same on both
    # paths, so the refit that shapes the second iteration's samples starts
    # from the same counts; the second's refit is not kept (the carry
    # freezes on the last iteration's samples). With more iterations a
    # rounding-level difference in the factor moves a uniform across a CDF
    # boundary and the counts part.
    step_cases = (  # (what, kind, switch, iterations, config, family, kernels of the path)
        ("CEMPPI ss", "cemppi", fused, ITS, dict(sigma_est="ss"), "refit", ("masked_refit",)),
        ("μΣ-AIS", "musigmaaismppi", fused, ITS, {}, "refit", ("weighted_refit",)),
        ("PMC", "pmcmppi", fused, 2, {}, "refit", ("weighted_refit",)),
        ("CMAMPPI Newton–Schulz", "cmamppi", fused, 3, dict(cma_fast_sqrt=True), "cma",
         ("cma_update",)),
        ("CEMPPI ss α=0.9", "cemppi", pallas, ITS, dict(sigma_est="ss", alpha=0.9), "refit",
         ("cholesky", "forward_solve")),
    )

    def one_step(kind, switch_on, switch, its, cfg_kw, zz):
        with _env(**{switch: "1" if switch_on else None}):
            cfg = PolicyConfig(kind=kind, num_samples=K, horizon=H, lam=10.0, opt_its=its,
                               elite_stop_tol=0.0, **cfg_kw)
            pol = make_policy(env32, cfg, cov_mat=np.diag([0.0625, 0.1]))
            extra = {"uniforms": uni[:its]} if kind == "pmcmppi" else {}
            _zero_counts()
            a, ps, info = pol.step(env32.reset(), pol.init_state(0), z=zz[:its], **extra)
            torch.cuda.synchronize()
            return a, ps.U, info["ais_its"], _counts()

    for what, kind, switch, its, cfg_kw, family, path_kernels in step_cases:
        rtol, atol = F32_TOL[family]
        a_k, u_k, its_k, n_k = one_step(kind, True, switch, its, cfg_kw, z)
        a_l, u_l, its_l, n_l = one_step(kind, False, switch, its, cfg_kw, z)
        err = max(_err_ratio(a_k, a_l, rtol, atol), _err_ratio(u_k, u_l, rtol, atol))
        print(f"phase 13: {what} f32 step K={K}, {its} its, {switch}=1 against the library "
              f"path: {err:.3f} of the tolerance (rtol {rtol:g}, atol {atol:g}; max|Δaction| "
              f"{float((a_k - a_l).abs().max()):.3e}, max|ΔU| "
              f"{float((u_k - u_l).abs().max()):.3e}); launches "
              f"{ {k: n_k[k] for k in path_kernels} } in {its_k} its, library path "
              f"{ {k: n_l[k] for k in path_kernels} }")
        _require(its_k == its_l == its, f"{what}: the paths ran different iteration counts")
        _require(all(n_k[k] == its_k for k in path_kernels) and
                 all(n_l[k] == 0 for k in path_kernels),
                 f"{what}: the kernel path did not run on the kernel (or the library path did)")
        _require(err <= 1.0, f"{what}: kernel path against library path {err:.3e} of the "
                 f"tolerance")
    print(f"phase 13: {time.perf_counter() - t_phase:.1f} s")

    # -- phase 14: the main path, every kind at full width -------------------
    main_runs = (  # (what, kind, switch, steps, extra, kernels that run once per iteration)
        ("CMAMPPI, library path", "cmamppi", None, CMA_RACE_STEPS, {}, ()),
        ("CMAMPPI, MPOPIS_FUSED_UPDATE=1", "cmamppi", fused, CMA_RACE_STEPS, {}, ("cma_update",)),
        ("CEMPPI, MPOPIS_FUSED_UPDATE=1", "cemppi", fused, KIND_STEPS, {}, ("masked_refit",)),
        ("μΣ-AIS, MPOPIS_FUSED_UPDATE=1", "musigmaaismppi", fused, KIND_STEPS, {},
         ("weighted_refit",)),
        ("PMC, MPOPIS_FUSED_UPDATE=1", "pmcmppi", fused, KIND_STEPS, {}, ("weighted_refit",)),
        ("CEMPPI α=0.9, MPOPIS_PALLAS_LINALG=1", "cemppi", pallas, KIND_STEPS, dict(alpha=0.9),
         ("cholesky", "forward_solve")),
        *((kind.upper(), kind, None, KIND_STEPS, {}, ())
          for kind in ("mppi", "gmppi", "imppi", "muaismppi", "nesmppi")),
    )
    new_kernels = ("masked_refit", "weighted_refit", "cma_update", "cholesky", "forward_solve")
    launches = dict.fromkeys(new_kernels, 0)
    race_sps = {}
    for what, kind, switch, steps, extra, path_kernels in main_runs:
        t_phase = time.perf_counter()
        with _env(**({switch: "1"} if switch else {})):
            _zero_counts()
            m = simulate_car_racing(
                policy_type=kind, num_trials=1, num_steps=steps, num_samples=K, horizon=H,
                lam=10.0, ais_its=ITS, ce_sigma_est="ss", laps=2, seed=SEED, device=dev,
                dtype=torch.float32, print_output=False, **extra,
            )
            counts = _counts()
        its = int(m["ais_iterations"][0])
        sps = float(m["control_steps_per_s"][0])
        race_sps[what] = sps
        print(f"phase 14: {what} K={K}: {int(m['steps'][0])} steps, laps at "
              f"{int(m['lap1_times'][0])} / {int(m['lap2_times'][0])}, "
              f"{int(m['track_violations'][0])} track / {int(m['beta_violations'][0])} β "
              f"violations, reward {float(m['rewards'][0]):.4f}, {sps:.3f} control steps/s, "
              f"AIS iterations {its}, launches "
              f"{json.dumps({k: v for k, v in counts.items() if v})} "
              f"({time.perf_counter() - t_phase:.1f} s)")
        _require(np.isfinite(m["rewards"][0]), f"{what}: non-finite reward")
        _require(counts["car_rollout"] == its > 0, f"{what}: not every rollout ran on the kernel")
        for k in new_kernels:
            want = its if k in path_kernels else 0
            _require(counts[k] == want, f"{what}: {k} launched {counts[k]} times, want {want}")
            launches[k] += counts[k]

    # -- phase 15: timings by CUDA events ------------------------------------
    t_phase = time.perf_counter()
    e, mask, w = e64.float(), mask64.float(), w64.float()
    mu_m, mu_w = (e @ mask) / M_ELITE, e @ w
    cma = tuple(t.float() for t in cma64)
    a100, rhs = spd64[n].float(), rhs64[n].float()
    l100 = linalg.chol_reference(a100)

    def lib_masked():
        sigma = shrinkage_cov_masked(e, mask, M_ELITE, "ss")
        return linalg.cholesky_lower(ais_update.jitter_mat(sigma, 1e-8))

    def lib_weighted():
        return linalg.cholesky_lower(ais_update.jitter_mat(weighted_mean_and_cov(e, w)[1], 1e-8))

    # CMA: the strategy's update on the library path (Newton–Schulz with its
    # convergence read, rank-μ, cuSOLVER Cholesky) against the fused one
    strat = make_strategy(PolicyConfig(kind="cmamppi", num_samples=K, horizon=H,
                                       cma_fast_sqrt=True), n, torch.float32)
    sig0 = torch.as_tensor(np.kron(np.eye(H), np.diag([0.0625, 0.1])), dtype=torch.float32,
                           device=dev)
    carry = AISCarry(U=torch.zeros(n, device=dev), chol=torch.linalg.cholesky(sig0), E=e,
                     costs=torch.rand(K, generator=g, device=dev) * 100.0, trajs=None,
                     extra=strat.make_extra(sig0))

    def cma_strategy(flag):
        def run():
            with _env(**{fused: flag}):
                return strat.update(carry, None, carry.U, 2)
        return run

    timed = {  # name: (kernel, plain, library call or None, library composition, reps)
        "masked_refit": (lambda: ais_update.masked_refit_chol(e, mask, mu_m, M_ELITE, "ss", 1e-8),
                         lambda: ais_update.masked_refit_chol_reference(e, mask, mu_m, M_ELITE,
                                                                        "ss", 1e-8),
                         None, lib_masked),
        "weighted_refit": (lambda: ais_update.weighted_refit_chol(e, w, mu_w, False, 1e-8),
                           lambda: ais_update.weighted_refit_chol_reference(e, w, mu_w, False,
                                                                            1e-8),
                           None, lib_weighted),
        "cma_update": (lambda: ais_update.cma_update_chol(*cma, 3.0, consts_t, 1e-8),
                       lambda: ais_update.cma_update_chol_reference(*cma, 3.0, consts_t, 1e-8),
                       None, cma_strategy(None)),
        "cholesky": (lambda: linalg.chol_kernel(a100), lambda: linalg.chol_reference(a100),
                     lambda: torch.linalg.cholesky_ex(a100), lambda: linalg.cholesky_lower(a100)),
        "forward_solve": (lambda: linalg.fwd_solve_kernel(l100, rhs),
                          lambda: linalg.fwd_solve_reference(l100, rhs),
                          lambda: torch.linalg.solve_triangular(l100, rhs.T, upper=False),
                          lambda: linalg.forward_solve(l100, rhs)),
    }
    times = {}
    for name, (run_k, run_p, run_lib, run_comp) in timed.items():
        for fn in (run_k, run_p, run_comp) + ((run_lib,) if run_lib else ()):
            fn()
        torch.cuda.synchronize()
        p_a = _time_ms(run_p, 3)
        k_a = _time_ms(run_k, 30)
        k_b = _time_ms(run_k, 30)
        p_b = _time_ms(run_p, 3)
        c_a = _time_ms(run_comp, 30)
        lib = (_time_ms(run_lib, 30) + _time_ms(run_lib, 30)) / 2 if run_lib else None
        c_b = _time_ms(run_comp, 30)
        # device-only: the same 30 calls, the kernel's and the library call's
        # alike, timed without the Python caller between them
        k_dev, k_how = _device_ms(run_k, 30)
        lib_dev, lib_how = _device_ms(run_lib, 30) if run_lib else (None, None)
        times[name] = {"ms": (k_a + k_b) / 2, "plain_ms": (p_a + p_b) / 2, "library_ms": lib,
                       "composition_ms": (c_a + c_b) / 2, "device_ms": k_dev,
                       "library_device_ms": lib_dev}
        lib_txt = (f", library call {lib:.4f} ms back to back, {lib_dev:.4f} ms device-only "
                   f"({lib_how})" if lib is not None else "")
        print(f"phase 15: {name} f32 n={n} K={K}: kernel {k_a:.4f} / {k_b:.4f} ms back to back, "
              f"{k_dev:.4f} ms device-only ({k_how}), plain {p_a:.3f} / {p_b:.3f} ms, the "
              f"library composition it replaces {c_a:.4f} / {c_b:.4f} ms{lib_txt} (CUDA "
              f"events; {card})")
    fused_cma = cma_strategy("1")
    fused_cma()
    print(f"phase 15: CMA strategy update, fused path {_time_ms(fused_cma, 30):.4f} ms (the "
          f"library path's is the composition above)")

    # each kind's control step at K=8192: host clock around synchronised steps
    kinds = [(kind, None) for kind in POLICY_KINDS] + [
        ("cemppi", fused), ("musigmaaismppi", fused), ("pmcmppi", fused), ("cmamppi", fused),
        ("cemppi", pallas)]
    for kind, switch in kinds:
        with _env(**({switch: "1"} if switch else {})):
            pol = make_policy(env32, PolicyConfig(kind=kind, num_samples=K, horizon=H, lam=10.0,
                                                  opt_its=ITS, sigma_est="ss",
                                                  alpha=0.9 if switch == pallas else 1.0),
                              cov_mat=np.diag([0.0625, 0.1]))
            s, pstate = env32.reset(), pol.init_state(SEED)
            step_ms, its = [], []
            for i in range(7):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, pstate, info = pol.step(s, pstate)
                torch.cuda.synchronize()
                if i >= 2:
                    step_ms.append((time.perf_counter() - t0) * 1e3)
                    its.append(info["ais_its"])
        label = kind + (f" {switch}=1" if switch else "")
        print(f"phase 15: {label} control step K={K}: median {np.median(step_ms):.3f} ms "
              f"(range {min(step_ms):.3f}-{max(step_ms):.3f}, AIS iterations {its})")
    print(f"phase 15: {time.perf_counter() - t_phase:.1f} s")

    # bounds: float32 operations over 67 TFLOP/s against bytes over 3.35 TB/s.
    # A symmetric moment is n(n+1)/2 multiply-adds per column that counts:
    # the m elite columns of the mask (the others are zeroed), the columns of
    # nonzero weight. All of E is read: the elite columns are spread over
    # E's rows, so the 32-byte sectors holding them cover most of E.
    chol_flops = n**3 / 3.0
    sym_flops = n * (n + 1.0)
    m_run, k_run = int(mask.sum()), int((w != 0).sum())
    refit_bytes = 4.0 * (n * K + K + n + n * n)
    bounds = {
        # ss: A and B over the elite columns, their centring and squares, the Cholesky
        "masked_refit": _bound(m_run * (2 * sym_flops + 2.0 * n) + chol_flops, refit_bytes),
        # the one moment over the weighted columns, centring and weighting, the Cholesky
        "weighted_refit": _bound(k_run * (sym_flops + 2.0 * n) + chol_flops, refit_bytes),
        # 20 Newton–Schulz steps of 3 products, the rank-μ sum over K, the Cholesky
        "cma_update": _bound(60 * 2.0 * n**3 + 8.0 * K + chol_flops,
                             4.0 * (3 * n * n + 4 * n + 2 * K + 2)),
        # the lower triangle read, all of L written
        "cholesky": _bound(chol_flops, 4.0 * (n * n + n * (n + 1) / 2)),
        # the lower triangle of L and b read, y written
        "forward_solve": _bound(2 * n * n, 4.0 * (n * (n + 1) / 2 + 2 * 2 * n)),
    }
    sources = {"masked_refit": ("ais_update", "mpopis_tpu/kernels/ais_update.py:192"),
               "weighted_refit": ("ais_update", "mpopis_tpu/kernels/ais_update.py:219"),
               "cma_update": ("ais_update", "mpopis_tpu/kernels/ais_update.py:329"),
               "cholesky": ("linalg", "mpopis_tpu/kernels/linalg.py:34"),
               "forward_solve": ("linalg", "mpopis_tpu/kernels/linalg.py:53")}
    err_key = {"masked_refit": "masked_refit ss", "weighted_refit": "weighted_refit",
               "cma_update": "cma_update update_chol=True",
               "cholesky": f"cholesky n={n} lda={linalg.chol_lda(n, torch.float32)}",
               "forward_solve": f"forward_solve n={n} nrhs=2"}
    entries = []
    for name, (src, replaces) in sources.items():
        bound_ms, bound_by = bounds[name]
        entries.append({
            "name": name, "route": "cuda", "source": f"mpopis_tpu_torch/csrc/{src}.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max_abs[err_key[name]], "ms": times[name]["ms"],
            "plain_ms": times[name]["plain_ms"], "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": times[name]["library_ms"],
            "composition_ms": times[name]["composition_ms"],
            "device_ms": times[name]["device_ms"],
            "library_device_ms": times[name]["library_device_ms"],
        })
    return entries


def _spatial_path(card: str) -> list:
    """Phases 16-20: the spatial-contact kernel and the on-device Ant path.
    Returns the `kernels` entries of spatial_rollout and spatial_step_states."""
    from mpopis_tpu_torch.harness.simulate import simulate_mujoco_on_device
    from mpopis_tpu_torch.kernels import build, spatial_step
    from mpopis_tpu_torch.models import AntDeviceEnv, spatial_contact
    from mpopis_tpu_torch.models.base import make_state
    from mpopis_tpu_torch.policies import PolicyConfig, make_policy

    kern = spatial_step.spatial_rollout_costs_tak
    ref = spatial_step.spatial_rollout_costs_tak_reference
    na = AntDeviceEnv.action_dim

    # -- phase 16: build ---------------------------------------------------
    t_phase = time.perf_counter()
    build.load_library("spatial_rollout")
    info = build.BUILD_INFO["spatial_rollout"]
    print(f"phase 16: {info['so']} built in {info['seconds']:.1f} s (in parallel with the others)")
    for line in _ptxas_lines(info["log"]):
        print("  ptxas:", line)

    def env_x(dtype, start):
        env = AntDeviceEnv(dtype=dtype, device="cuda")
        x = env.reset().x.clone()
        x[2] = ANT_Z[start]
        return env, x

    # -- phase 17: kernel against its plain version --------------------------
    torch.cuda.synchronize()
    free0 = torch.cuda.mem_get_info()[0]
    for start in ANT_Z:
        # f32, K=64 T=3: the JAX kernel tests' rtol 2e-4 / atol 2e-3
        env, x = env_x(torch.float32, start)
        n_lim, n_con, _ = spatial_step.first_substep_active_rows(env, x)
        ctrl = _uniform(64, 3, na, 64, torch.float32)
        got, want = kern(env, x, ctrl), ref(env, x, ctrl)
        err = float(torch.max(torch.abs(got - want)))
        ok = bool(torch.all(torch.isfinite(got))) and bool(
            torch.allclose(got, want, rtol=2e-4, atol=2e-3))
        print(f"phase 17: Ant f32 K=64 T=3 from {start} (x[2] = {float(x[2]):.2f}): {n_lim} limit "
              f"and {n_con} contact rows active in the first substep; max|err| {err:.3e} "
              f"(rtol 2e-4, atol 2e-3) ok={ok}")
        _require(start != "shallow" or n_con > 0, "Ant: no contact row active at the shallow start")
        _require(ok, f"Ant: f32 kernel disagrees from {start}")

        # f64, K=64 T=3: 1e-9 relative, beside the plain version's own spread
        # under controls·(1 + 1e-15) where the error is beyond it (the nudged
        # plain run is skipped otherwise)
        env64, x64 = env_x(torch.float64, start)
        ctrl64 = _uniform(64, 3, na, 64, torch.float64)
        want = ref(env64, x64, ctrl64)
        rel = _rel_err(kern(env64, x64, ctrl64), want)
        own, spread = 0.0, "the plain version's own spread not needed"
        if rel.max() > 1e-9:
            rel_pert = _rel_err(ref(env64, x64, ctrl64 * (1 + NUDGE[torch.float64])), want)
            own = float(rel_pert.max())
            spread = (f"plain vs plain at controls·(1+1e-15): max {rel_pert.max():.3e} median "
                      f"{np.median(rel_pert):.3e}")
        print(f"phase 17: Ant f64 K=64 T=3 from {start}: rel err max {rel.max():.3e} median "
              f"{np.median(rel):.3e}; {spread}")
        _hold(f"Ant f64 from {start}: kernel max relative error", float(rel.max()), own, 1e-9)

    # CUDA reserves local memory for every thread that can be resident at the
    # largest stack launched so far: the first f64 launch's shows here
    print(f"phase 17: free device memory {free0 / 2**30:.2f} GiB before the Ant build's first "
          f"launch, {torch.cuda.mem_get_info()[0] / 2**30:.2f} GiB after its comparisons")

    # spatial_step_states against the plain step, 256 grounded states
    step_err = {}
    for dtype, bound in ((torch.float64, 1e-9), (torch.float32, 2e-4)):
        env, x = env_x(dtype, "grounded")
        rng = np.random.default_rng(3)
        xs = x + torch.as_tensor(rng.uniform(-0.05, 0.05, (256, x.numel())), dtype=dtype,
                                 device="cuda")
        acts = torch.as_tensor(rng.uniform(-1, 1, (256, na)), dtype=dtype, device="cuda")
        got = spatial_step.spatial_step_states(env, xs, acts)
        want = env.plain_step(make_state(xs), acts).x
        rel = _rel_state_err(got, want)
        med, med_pert = float(np.median(rel)), 0.0
        spread = "the plain version's own spread not needed"
        if med > bound:  # the nudged plain step only where the rule needs it
            rel_pert = _rel_state_err(
                env.plain_step(make_state(xs), acts * (1 + NUDGE[dtype])).x, want)
            med_pert = float(np.median(rel_pert))
            spread = (f"plain vs plain at actions·(1 + {NUDGE[dtype]:g}): max "
                      f"{rel_pert.max():.3e} median {med_pert:.3e}")
        name = str(dtype)[6:]
        step_err[name] = float((got - want).abs().max())
        print(f"phase 17: Ant spatial_step_states {name} B=256 from the grounded start ±0.05: "
              f"rel err max {rel.max():.3e} median {med:.3e}, "
              f"{int(np.sum(rel > bound))} beyond {bound:g}; {spread}")
        _hold(f"Ant {name} step kernel: median relative error", med, med_pert, bound)
    torch.cuda.synchronize()
    print(f"phase 16-17: {time.perf_counter() - t_phase:.1f} s")

    # -- phase 18: the CEMPPI step in f64, kernel path vs plain path -----------
    class PlainAnt(AntDeviceEnv):
        def step(self, state, action):
            return self.plain_step(state, action)

    t_phase = time.perf_counter()
    sk, sh = 64, 4
    z = torch.randn((AITS, na * sh, sk), generator=torch.Generator("cuda").manual_seed(18),
                    dtype=torch.float64, device="cuda")

    def ant_step(cls, fused, nudge):
        env64 = cls(dtype=torch.float64, device="cuda")
        cfg = PolicyConfig(kind="cemppi", num_samples=sk, horizon=sh, lam=ALAM, opt_its=AITS,
                           sigma_est="mle", use_fused_rollout=fused)
        pol = make_policy(env64, cfg, cov_mat=0.25 * np.eye(na))
        _zero_counts()
        a, ps, inf = pol.step(env64.reset(), pol.init_state(0), z=z * (1 + nudge))
        torch.cuda.synchronize()
        return a, ps.U, inf["ais_its"], _counts()

    # the plain path at z·(1 + 1e-15) runs only where the nudge rule needs it
    a_k, u_k, its_k, n_k = ant_step(AntDeviceEnv, True, 0.0)
    a_p, u_p, its_p, n_p = ant_step(PlainAnt, False, 0.0)
    err_a, err_u = _rel_norm(a_k, a_p), _rel_norm(u_k, u_p)
    own_a = own_u = 0.0
    spread = "the plain path's own spread not needed"
    if max(err_a, err_u) > 1e-8:
        a_n, u_n, its_n, _ = ant_step(PlainAnt, False, NUDGE[torch.float64])
        own_a, own_u = _rel_norm(a_n, a_p), _rel_norm(u_n, u_p)
        spread = f"plain vs plain at z·(1+1e-15): {its_n} its, action {own_a:.3e}, U {own_u:.3e}"
    print(f"phase 18: Ant CEMPPI f64 step K={sk} H={sh} {AITS} its: kernel path {its_k} its, "
          f"plain path {its_p} its; kernel vs plain, max|Δ| / max|plain|: action {err_a:.3e}, U "
          f"{err_u:.3e} (bound 1e-8); {spread} ({time.perf_counter() - t_phase:.1f} s)")
    _require(n_k["spatial_rollout"] == its_k and n_k["spatial_step_states"] == 0,
             "the kernel path did not roll out on the kernel")
    _require(n_p["spatial_rollout"] == n_p["spatial_step_states"] == 0,
             "the plain path launched a kernel")
    _require(its_k == its_p, "kernel and plain paths ran different iteration counts")
    _hold("Ant CEMPPI step: action, kernel vs plain path", err_a, own_a, 1e-8)
    _hold("Ant CEMPPI step: U, kernel vs plain path", err_u, own_u, 1e-8)

    # -- phase 19: the main path, simulate_mujoco_on_device at full width -----
    t_phase = time.perf_counter()
    with _recording(spatial_step, "spatial_rollout_costs_tak", *MAIN_WINDOW) as calls:
        _zero_counts()
        m = simulate_mujoco_on_device(
            "Ant-v4", num_trials=1, num_steps=ANT_STEPS, num_samples=AK, horizon=AH, lam=ALAM,
            ais_its=AITS, ce_sigma_est="mle", seed=SEED, device="cuda", dtype=torch.float32,
        )
        counts = _counts()
    its = int(m["ais_iterations"][0])
    rew, rps = float(m["rewards"][0]), float(m["rewards_per_step"][0])
    launches = {k: v for k, v in counts.items() if v}
    print(f"phase 19: Ant-v4 K={AK} H={AH} {AITS} its: reward {rew:.4f} over "
          f"{int(m['steps'][0])} steps ({rps:.4f} per step), "
          f"{float(m['control_steps_per_s'][0]):.3f} control steps/s, ais_iterations {its}, "
          f"kernel launches {json.dumps(launches)} ({time.perf_counter() - t_phase:.1f} s)")
    _require(counts["spatial_rollout"] == its > 0, "Ant: not every rollout ran on the kernel")
    _require(counts["spatial_step_states"] > ANT_STEPS,
             "Ant: the env step did not run on the kernel")
    _require(set(launches) == {"spatial_rollout", "spatial_step_states"},
             f"Ant: other kernels launched: {launches}")
    _require(np.isfinite(rew), "Ant: non-finite reward")
    own_ms = _own_launch_ms("phase 19: Ant", calls, kern, counts, "spatial_rollout",
                            "spatial_step_states", float(m["control_steps_per_s"][0]), card)
    _print_reward("phase 19:", "Ant-v4", m)

    # -- phase 20: the kernel against its plain version at the main path's K
    # (f32 at the main path's T, f64 over its first 3 steps), then timings by
    # CUDA events ----------------------------------------------------------------
    t_phase = time.perf_counter()
    ctrl64 = _uniform(AK, AH, na, 20, torch.float64)
    # the f32 plain run also tallies the QP's work (for the bound) and the
    # contact rows active over the compared rollouts
    res = _kernel_vs_plain("phase 20: Ant", kern, ref, env_x, ("grounded",), ctrl64, 2e-3,
                           spatial_contact, t64=3)["grounded"]
    tally = res["tally"]
    print(f"phase 20: {tally[1]} contact rows active over the plain f32 rollouts' QP calls")
    _require(tally[1] > 0, "Ant: no contact row active in the compared rollouts")
    env, x = env_x(torch.float32, "grounded")
    ctrl = ctrl64.float()
    roll_bound = _bound(_contact_ops(env, AH * AK * env.FRAME_SKIP * 4, 1, 2, tally[0]),
                        4.0 * (AH * na * AK + AK + env.state_dim))
    xs, act = x[None].contiguous(), torch.zeros((1, na), device="cuda")
    times = {
        "rollout": _timed("phase 20: Ant rollout", f"K={AK} T={AH} from the grounded start",
                          lambda: kern(env, x, ctrl), 5, res["plain_ms"], card),
        "step": _timed("phase 20: Ant step", "one grounded state",
                       lambda: spatial_step.spatial_step_states(env, xs, act), 20,
                       lambda: env.plain_step(make_state(xs), act), card),
    }
    max_abs, median32 = res["max_abs_err"], res["median_rel_err_f32"]

    # the control step split in the main path's configuration: host clock
    # around synchronised calls, 20 steps after 3 of warm-up
    env = AntDeviceEnv(dtype=torch.float32, device="cuda")
    pol = make_policy(env, PolicyConfig(kind="cemppi", num_samples=AK, horizon=AH, lam=ALAM,
                                        opt_its=AITS, sigma_est="mle"),
                      cov_mat=0.25 * np.eye(na))
    s, pstate = env.reset(), pol.init_state(SEED)
    split = {"policy": [], "env": []}
    for i in range(23):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a, pstate, _ = pol.step(s, pstate)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        s, _ = env.step_reward(s, a)
        torch.cuda.synchronize()
        if i >= 3:
            split["policy"].append((t1 - t0) * 1e3)
            split["env"].append((time.perf_counter() - t1) * 1e3)
    print(f"phase 20: Ant control step over 20 steps (host clock, synchronised): policy step "
          f"median {np.median(split['policy']):.3f} ms (range {min(split['policy']):.3f}-"
          f"{max(split['policy']):.3f}), env step median {np.median(split['env']):.3f} ms "
          f"(range {min(split['env']):.3f}-{max(split['env']):.3f})")

    # Operations counted as for the planar kernel (_contact_ops): per RK4 stage
    # one mass-matrix factorization and two solves, and the QP's applications
    # of J M⁻¹ Jᵀ over the rows valid in these inputs, tallied from a plain
    # run on the timed inputs (the rollout's above). Bytes: the controls or
    # states read, the costs or states written.
    with _qp_tally(spatial_contact, env) as tally:
        env.plain_step(make_state(xs), act)
    step_bound = _bound(_contact_ops(env, env.FRAME_SKIP * 4, 1, 2, tally[0]),
                        4.0 * (2 * env.state_dim + na))
    print(f"phase 20: bounds, Ant rollout {roll_bound[0]:.6f} ms ({roll_bound[1]}), step "
          f"{step_bound[0]:.3e} ms ({step_bound[1]}) ({time.perf_counter() - t_phase:.1f} s)")
    return [{
        "name": "spatial_rollout",
        "route": "cuda",
        "source": "mpopis_tpu_torch/csrc/spatial_rollout.cu",
        "replaces": "mpopis_tpu/kernels/spatial_step.py:139",
        "launches": counts["spatial_rollout"],
        "max_abs_err": max_abs,
        "ms": times["rollout"][0],
        "plain_ms": times["rollout"][1],
        "bound_ms": roll_bound[0],
        "bound_by": roll_bound[1],
        "library_ms": None,
        "median_rel_err_f32": median32,
        "main_path_ms": own_ms,
    }, {
        "name": "spatial_step_states",
        "route": "cuda",
        "source": "mpopis_tpu_torch/csrc/spatial_rollout.cu",
        "replaces": "mpopis_tpu/kernels/spatial_step.py:52",
        "launches": counts["spatial_step_states"],
        "max_abs_err": step_err["float32"],
        "ms": times["step"][0],
        "plain_ms": times["step"][1],
        "bound_ms": step_bound[0],
        "bound_by": step_bound[1],
        "library_ms": None,
    }]


def _kernel_vs_plain(label, kern, ref, make, starts, ctrl64, atol32, tally_module=None,
                     t64=None):
    """The rollout kernel against its plain version at the main path's K and
    T from each start: f64 by the median relative error (1e-9), beside the
    plain version's own spread under controls·(1 + 1e-15) where the median
    is beyond 1e-9 (the nudge rule; that plain run is skipped otherwise),
    f32 within rtol 2e-4 / atol `atol32` or else by its median relative
    error (< 2e-4) with the samples beyond counted. `t64` cuts the f64
    comparison to the first t64 steps. `make(dtype, start)` gives (env, x).
    With `tally_module`, the f32 plain run tallies the QP (`_qp_tally`).
    Returns per start {max_abs_err, median_rel_err_f32, tally, plain_ms (the
    f32 plain run by CUDA events)}."""
    k, horizon = ctrl64.shape[2], ctrl64.shape[0]
    ctrl32, ctrl64 = ctrl64.float(), ctrl64[:t64].contiguous()
    h64 = ctrl64.shape[0]
    out = {}
    for start in starts:
        env64, x64 = make(torch.float64, start)
        want = ref(env64, x64, ctrl64)
        rel = _rel_err(kern(env64, x64, ctrl64), want)
        med, med_pert = float(np.median(rel)), 0.0
        spread = "the plain version's own spread not needed"
        if med > 1e-9:
            rel_pert = _rel_err(ref(env64, x64, ctrl64 * (1 + NUDGE[torch.float64])), want)
            med_pert = float(np.median(rel_pert))
            spread = (f"plain vs plain at controls·(1+1e-15): max {rel_pert.max():.3e} median "
                      f"{med_pert:.3e}, {int(np.sum(rel_pert > 1e-9))} beyond")
        print(f"{label} f64 K={k} T={h64} from {start}: rel err max {rel.max():.3e} median "
              f"{med:.3e}, {int(np.sum(rel > 1e-9))} of {k} beyond 1e-9; {spread}")
        _hold(f"{label} f64 from {start}: kernel median relative error", med, med_pert, 1e-9)

        env, x = make(torch.float32, start)
        ctrl = ctrl32
        tally = [None]
        with contextlib.ExitStack() as stack:
            if tally_module is not None:
                tally = stack.enter_context(_qp_tally(tally_module, env))
            t_start = torch.cuda.Event(enable_timing=True)
            t_end = torch.cuda.Event(enable_timing=True)
            t_start.record()
            want = ref(env, x, ctrl)
            t_end.record()
        torch.cuda.synchronize()
        plain_ms = t_start.elapsed_time(t_end)
        got = kern(env, x, ctrl)
        rel32 = _rel_err(got, want)
        max_abs = float((got - want).abs().max())
        n_over = int((~torch.isclose(got, want, rtol=2e-4, atol=atol32)).sum())
        print(f"{label} f32 K={k} T={horizon} from {start}: rel err max {rel32.max():.3e} median "
              f"{np.median(rel32):.3e} (quantiles 0.9 / 0.99: {np.quantile(rel32, 0.9):.3e} / "
              f"{np.quantile(rel32, 0.99):.3e}), {n_over} of {k} beyond rtol 2e-4 / atol "
              f"{atol32:g}, max|err| {max_abs:.3e}")
        _require(bool(torch.all(torch.isfinite(got))), f"{label}: non-finite f32 kernel costs")
        _require(n_over == 0 or float(np.median(rel32)) < 2e-4,
                 f"{label}: f32 median relative error >= 2e-4 from {start}")
        out[start] = {"max_abs_err": max_abs, "median_rel_err_f32": float(np.median(rel32)),
                      "tally": tally if tally_module is not None else None,
                      "plain_ms": plain_ms}
    return out


def _step_vs_plain(label, step_fn, make, start, jitter, act_hi, na, n_state_jitter):
    """The step entry against the plain step on 256 states around a start
    (±jitter on the first `n_state_jitter` entries), f64 at 1e-9 and f32 at
    2e-4 by the median per-state relative error beside the plain version's
    own spread under actions·(1 + nudge) where the median is beyond the
    bound (the nudged plain step is skipped otherwise). Returns max|err| per
    dtype name."""
    from mpopis_tpu_torch.models.base import make_state

    errs = {}
    for dtype, bound in ((torch.float64, 1e-9), (torch.float32, 2e-4)):
        env, x = make(dtype, start)
        rng = np.random.default_rng(3)
        dx = np.zeros((256, x.numel()))
        dx[:, :n_state_jitter] = rng.uniform(-jitter, jitter, (256, n_state_jitter))
        xs = x + torch.as_tensor(dx, dtype=dtype, device="cuda")
        acts = torch.as_tensor(rng.uniform(-act_hi, act_hi, (256, na)), dtype=dtype,
                               device="cuda")
        got = step_fn(env, xs, acts)
        want = env.plain_step(make_state(xs), acts).x
        rel = _rel_state_err(got, want)
        med, med_pert = float(np.median(rel)), 0.0
        spread = "the plain version's own spread not needed"
        if med > bound:
            rel_pert = _rel_state_err(
                env.plain_step(make_state(xs), acts * (1 + NUDGE[dtype])).x, want)
            med_pert = float(np.median(rel_pert))
            spread = (f"plain vs plain at actions·(1 + {NUDGE[dtype]:g}): max "
                      f"{rel_pert.max():.3e} median {med_pert:.3e}")
        name = str(dtype)[6:]
        errs[name] = float((got - want).abs().max())
        print(f"{label} step entry {name} B=256 from {start} ±{jitter:g}: rel err max "
              f"{rel.max():.3e} median {med:.3e}, {int(np.sum(rel > bound))} beyond "
              f"{bound:g}; {spread}")
        _hold(f"{label} {name} step kernel: median relative error", med, med_pert, bound)
    return errs


def _cemppi_kernel_vs_plain(label, env_cls, k, horizon, its, lam, rollout, step):
    """The f64 CEMPPI step through the rollout kernel against the plain path
    (`rollout_batch` over the plain step) with the same normals z, at 1e-8
    under the nudge rule (the plain path at z·(1 + 1e-15) runs only where
    the rule needs it); `rollout`/`step` name the kernels' counters."""
    from mpopis_tpu_torch.policies import PolicyConfig, make_policy

    class Plain(env_cls):
        def step(self, state, action):
            return self.plain_step(state, action)

    t_phase = time.perf_counter()
    na = env_cls.action_dim
    z = torch.randn((its, na * horizon, k), generator=torch.Generator("cuda").manual_seed(23),
                    dtype=torch.float64, device="cuda")

    def run(cls, fused, nudge):
        env64 = cls(dtype=torch.float64, device="cuda")
        cfg = PolicyConfig(kind="cemppi", num_samples=k, horizon=horizon, lam=lam, opt_its=its,
                           sigma_est="mle", use_fused_rollout=fused)
        pol = make_policy(env64, cfg, cov_mat=0.25 * np.eye(na))
        _zero_counts()
        a, ps, inf = pol.step(env64.reset(), pol.init_state(0), z=z * (1 + nudge))
        torch.cuda.synchronize()
        return a, ps.U, inf["ais_its"], _counts()

    a_k, u_k, its_k, n_k = run(env_cls, True, 0.0)
    a_p, u_p, its_p, n_p = run(Plain, False, 0.0)
    err_a, err_u = _rel_norm(a_k, a_p), _rel_norm(u_k, u_p)
    own_a = own_u = 0.0
    spread = "the plain path's own spread not needed"
    if max(err_a, err_u) > 1e-8:
        a_n, u_n, its_n, _ = run(Plain, False, NUDGE[torch.float64])
        own_a, own_u = _rel_norm(a_n, a_p), _rel_norm(u_n, u_p)
        spread = f"plain vs plain at z·(1+1e-15): {its_n} its, action {own_a:.3e}, U {own_u:.3e}"
    print(f"{label} CEMPPI f64 step K={k} H={horizon} {its} its: kernel path {its_k} its, plain "
          f"path {its_p} its; kernel vs plain, max|Δ| / max|plain|: action {err_a:.3e}, U "
          f"{err_u:.3e} (bound 1e-8); {spread} ({time.perf_counter() - t_phase:.1f} s)")
    _require(n_k[rollout] == its_k and n_k[step] == 0,
             f"{label}: the kernel path did not roll out on the kernel")
    _require(n_p[rollout] == n_p[step] == 0, f"{label}: the plain path launched a kernel")
    _require(its_k == its_p, f"{label}: kernel and plain paths ran different iteration counts")
    _hold(f"{label} CEMPPI step: action, kernel vs plain path", err_a, own_a, 1e-8)
    _hold(f"{label} CEMPPI step: U, kernel vs plain path", err_u, own_u, 1e-8)


def _main_path(label, task, k, horizon, its, lam, steps, rollout, step, record=None):
    """`simulate_mujoco_on_device(task)` on the card, f32, seed 1, every count
    set to 0 just before and read just after; the executed actions (its CSV)
    replayed through the env's step entry give the states. `record` (module,
    function name) records the MAIN_WINDOW calls of the rollout entry
    (`_recording`). Returns (metrics, the counts, the env, the states from the
    reset on, the recorded calls)."""
    import tempfile

    from mpopis_tpu_torch.harness.simulate import PORTED_MUJOCO_TASKS, simulate_mujoco_on_device

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as acts_dir, contextlib.ExitStack() as stack:
        calls = stack.enter_context(_recording(*record, *MAIN_WINDOW)) if record else []
        _zero_counts()
        m = simulate_mujoco_on_device(
            task, num_trials=1, num_steps=steps, num_samples=k, horizon=horizon, lam=lam,
            ais_its=its, ce_sigma_est="mle", seed=SEED, device="cuda", dtype=torch.float32,
            output_acts_file=True, acts_dir=acts_dir, print_output=False,
        )
        counts = _counts()
        (csv,) = [os.path.join(acts_dir, f) for f in os.listdir(acts_dir)]
        acts = np.loadtxt(csv, delimiter=",", ndmin=2)
    n_its = int(m["ais_iterations"][0])
    rew, rps = float(m["rewards"][0]), float(m["rewards_per_step"][0])
    launches = {name: v for name, v in counts.items() if v}
    print(f"{label} {task} K={k} H={horizon} {its} its: reward {rew:.4f} over "
          f"{int(m['steps'][0])} steps ({rps:.4f} per step), "
          f"{float(m['control_steps_per_s'][0]):.3f} control steps/s, ais_iterations {n_its}, "
          f"kernel launches {json.dumps(launches)} ({time.perf_counter() - t_phase:.1f} s)")
    _require(counts[rollout] == n_its > 0, f"{task}: not every rollout ran on the kernel")
    _require(counts[step] > steps, f"{task}: the env step did not run on the kernel")
    _require(set(launches) == {rollout, step}, f"{task}: other kernels launched: {launches}")
    _require(np.isfinite(rew), f"{task}: non-finite reward")
    env = PORTED_MUJOCO_TASKS[task](dtype=torch.float32, device="cuda")
    states = [env.reset()]
    for a in acts:
        states.append(env.step(states[-1], torch.as_tensor(a, dtype=torch.float32,
                                                           device="cuda")))
    return m, counts, env, states, calls


# the main paths' rewards in the last run of the thread-per-sample kernel 4
# (f32, seed 1; H100 80GB HBM3, 700.00 W)
THREAD_KERNEL_REWARD = {"Ant-v4": 813.32, "Pusher-v4": -31.41, "Humanoid-v4": 318.4792,
              "HumanoidStandup-v4": 8261.7322}


def _print_reward(label, task, m):
    print(f"{label} {task} reward {float(m['rewards'][0]):.4f} (thread-per-sample kernel 4: "
          f"{THREAD_KERNEL_REWARD[task]})")


def _timed(label, shape, run_k, reps_k, plain, card, reps_p=1):
    """CUDA-event times of a kernel, twice after one warm-up, beside its plain
    version's once: `plain` is the ms of the plain run that the comparison
    made on these inputs, or a callable timed here (reps_p calls) after the
    kernel. Returns (kernel ms, plain ms)."""
    run_k()
    torch.cuda.synchronize()
    k_a = _time_ms(run_k, reps_k)
    k_b = _time_ms(run_k, reps_k)
    if callable(plain):
        plain, how = _time_ms(plain, reps_p), "kernel-kernel-plain"
    else:
        how = "the plain time from the comparison's run"
    print(f"{label} f32 {shape}: kernel {k_a:.4f} / {k_b:.4f} ms, plain {plain:.3f} ms (CUDA "
          f"events, {how}; {card})")
    return (k_a + k_b) / 2, plain


def _swimmer_path(card: str) -> list:
    """Phases 21-24: kernel 3 (the Swimmer's rollout kernel) and the
    on-device Swimmer path. Returns the `kernels` entries of swimmer_rollout
    and swimmer_step_states."""
    from mpopis_tpu_torch.kernels import build, planar_step
    from mpopis_tpu_torch.models import SwimmerDeviceEnv, planar_contact
    from mpopis_tpu_torch.models.base import make_state

    kern = planar_step.swimmer_rollout_costs_tak
    ref = planar_step.swimmer_rollout_costs_tak_reference
    na = SwimmerDeviceEnv.action_dim

    def make(dtype, start):
        env = SwimmerDeviceEnv(dtype=dtype, device="cuda")
        x = env.reset().x if start == "reset" else env.tensor(SWIMMER_LIMITS)
        return env, x.contiguous()

    # -- phase 21: build, and kernel 3 against its plain version ---------------
    t_phase = time.perf_counter()
    build.load_library("swimmer_rollout")
    info = build.BUILD_INFO["swimmer_rollout"]
    print(f"phase 21: {info['so']} built in {info['seconds']:.1f} s (in parallel with the others)")
    for line in _ptxas_lines(info["log"]):
        print("  ptxas:", line)
    _print_launch_shapes("phase 21:", {"Swimmer-v4": SwimmerDeviceEnv})
    env, x = make(torch.float32, "limits")
    print(f"phase 21: Swimmer limit start: {planar_step.first_substep_active_rows(env, x)[0]} "
          f"limit rows active in the first substep")
    ctrl64 = _uniform(SK, SH, na, 21, torch.float64)
    res = _kernel_vs_plain("phase 21: Swimmer", kern, ref, make, ("reset", "limits"), ctrl64,
                           2e-5, planar_contact)
    n_lim_rows = res["limits"]["tally"][3]
    print(f"phase 21: {res['reset']['tally'][3]} / {n_lim_rows} limit rows active over the plain "
          f"f32 rollouts' QP calls from reset / from the limit start")
    _require(n_lim_rows > 0, "Swimmer: the limit start ran no limit QP")
    step_err = _step_vs_plain("phase 21: Swimmer", planar_step.swimmer_step_states, make,
                              "limits", 0.05, 1.0, na, 10)
    torch.cuda.synchronize()
    print(f"phase 21: {time.perf_counter() - t_phase:.1f} s")

    # -- phase 22: the CEMPPI step in f64, kernel path vs plain path -----------
    # (H=10: the plain path's time grows with H, and phase 21 held the kernel
    # over the main path's 25 steps)
    _cemppi_kernel_vs_plain("phase 22: Swimmer", SwimmerDeviceEnv, 512, 10, SITS, SLAM,
                            "swimmer_rollout", "swimmer_step_states")

    # -- phase 23: the main path -----------------------------------------------
    m, counts, env, (*_, s), calls = _main_path(
        "phase 23:", "Swimmer-v4", SK, SH, SITS, SLAM, SWIMMER_STEPS, "swimmer_rollout",
        "swimmer_step_states", record=(planar_step, "swimmer_rollout_costs_tak"))
    own_ms = _own_launch_ms("phase 23: Swimmer", calls, kern, counts, "swimmer_rollout",
                            "swimmer_step_states", float(m["control_steps_per_s"][0]), card)
    x_final = float(s.x[0])
    print(f"phase 23: the replayed actions leave the torso at x = {x_final:.4f} (from 0)")
    _require(x_final > 0, "the swimmer did not swim forward")

    # -- phase 24: timings and bounds -------------------------------------------
    # The rollouts are timed on phase 21's f32 inputs from reset, whose plain
    # run tallied the QP. Operations counted (_contact_ops): per RK4 stage one
    # mass-matrix factorization and two solves, and the limit QP's
    # applications of J M⁻¹ Jᵀ over the rows valid in these inputs; the fluid
    # force, mass matrix and bias are not counted. Bytes: the controls read
    # and the costs written.
    t_phase = time.perf_counter()
    env, x = make(torch.float32, "reset")
    ctrl = ctrl64.float()
    xs, act = x[None].contiguous(), torch.zeros((1, na), device="cuda")
    n_forward = SH * SK * env.FRAME_SKIP * 4
    roll_bound = _bound(_contact_ops(env, n_forward, 1, 2, res["reset"]["tally"][0]),
                        4.0 * (SH * na * SK + SK))
    with _qp_tally(planar_contact, env) as tally:
        env.plain_step(make_state(xs), act)
    step_bound = _bound(_contact_ops(env, env.FRAME_SKIP * 4, 1, 2, tally[0]),
                        4.0 * (2 * env.state_dim + na))
    roll = _timed("phase 24: Swimmer rollout", f"K={SK} T={SH} from reset",
                  lambda: kern(env, x, ctrl), 10, res["reset"]["plain_ms"], card)
    stp = _timed("phase 24: Swimmer step", "one state",
                 lambda: planar_step.swimmer_step_states(env, xs, act), 50,
                 lambda: env.plain_step(make_state(xs), act), card, reps_p=2)
    _step_split("phase 24: Swimmer", SwimmerDeviceEnv, SK, SH, SITS, SLAM, roll[0])
    print(f"phase 24: bounds, Swimmer rollout {roll_bound[0]:.6f} ms ({roll_bound[1]}), step "
          f"{step_bound[0]:.3e} ms ({step_bound[1]}) ({time.perf_counter() - t_phase:.1f} s)")
    return [{
        "name": "swimmer_rollout",
        "route": "cuda",
        "source": "mpopis_tpu_torch/csrc/swimmer_rollout.cu",
        "replaces": "mpopis_tpu/kernels/planar_step.py:228",
        "launches": counts["swimmer_rollout"],
        "max_abs_err": res["reset"]["max_abs_err"],
        "ms": roll[0],
        "plain_ms": roll[1],
        "bound_ms": roll_bound[0],
        "bound_by": roll_bound[1],
        "library_ms": None,
        "median_rel_err_f32": res["reset"]["median_rel_err_f32"],
        "main_path_ms": own_ms,
    }, {
        "name": "swimmer_step_states",
        "route": "cuda",
        "source": "mpopis_tpu_torch/csrc/swimmer_rollout.cu",
        "replaces": "mpopis_tpu/kernels/planar_step.py:207",
        "launches": counts["swimmer_step_states"],
        "max_abs_err": step_err["float32"],
        "ms": stp[0],
        "plain_ms": stp[1],
        "bound_ms": step_bound[0],
        "bound_by": step_bound[1],
        "library_ms": None,
    }]


def _pusher_path(card: str) -> list:
    """Phases 25-28: the Pusher's build of the spatial rollout kernel
    (kernel 4's Euler, slide-joint, condim-1 and capsule–cylinder branches)
    and the on-device Pusher path. Returns the `kernels` entries of the
    Pusher's rollout and step."""
    from mpopis_tpu_torch.kernels import build, spatial_step
    from mpopis_tpu_torch.models import PusherDeviceEnv, pusher_device, spatial_contact
    from mpopis_tpu_torch.models.base import make_state

    kern = spatial_step.spatial_rollout_costs_tak
    ref = spatial_step.spatial_rollout_costs_tak_reference
    na = PusherDeviceEnv.action_dim

    def make(dtype, start):
        env = PusherDeviceEnv(dtype=dtype, device="cuda")
        if start == "reset":
            return env, env.reset().x
        qv = np.random.default_rng(4).uniform(-0.3, 0.3, 11)
        return env, pusher_device.touching_state(*PUSHER_TOUCH, qv).to("cuda", dtype)

    # -- phase 25: the build, and the kernel against its plain version ---------
    t_phase = time.perf_counter()
    build.load_library("spatial_rollout")
    log = build.BUILD_INFO["spatial_rollout"]["log"].splitlines()
    for i, line in enumerate(log):  # the Pusher build's entries: (n_dof, n_q) = (11, 11)
        if "Compiling entry" in line and "Li11ELi11E" in line:
            for ptx in log[i:i + 6]:
                if "registers" in ptx or "spill" in ptx or "Compiling entry" in ptx:
                    print("  ptxas (Pusher build):", ptx.strip())
    torch.cuda.synchronize()
    free0 = torch.cuda.mem_get_info()[0]
    env, x = make(torch.float32, "touch")
    n_lim, n_con, _ = spatial_step.first_substep_active_rows(env, x)
    print(f"phase 25: Pusher touching start: {n_lim} limit and {n_con} floor and pair rows "
          f"active in the first substep")
    ctrl64 = torch.as_tensor(np.random.default_rng(25).uniform(-2, 2, (UH, na, UK)),
                             dtype=torch.float64, device="cuda")
    res = _kernel_vs_plain("phase 25: Pusher", kern, ref, make, ("reset", "touch"), ctrl64,
                           2e-3, spatial_contact, t64=3)
    tally = res["touch"]["tally"]
    print(f"phase 25: over the plain f32 rollouts' QP calls from the touching start: "
          f"{tally[1] - tally[2]} condim-1 floor rows and {tally[2]} capsule–cylinder pair rows "
          f"active (from reset: {res['reset']['tally'][1] - res['reset']['tally'][2]} and "
          f"{res['reset']['tally'][2]})")
    print(f"phase 25: free device memory {free0 / 2**30:.2f} GiB before the Pusher build's "
          f"first launch, {torch.cuda.mem_get_info()[0] / 2**30:.2f} GiB after its comparisons")
    _require(tally[1] - tally[2] > 0 and tally[2] > 0,
             "Pusher: no condim-1 or no pair row active in the compared rollouts")
    step_err = _step_vs_plain("phase 25: Pusher", spatial_step.spatial_step_states, make,
                              "touch", 0.01, 2.4, na, 22)
    torch.cuda.synchronize()
    print(f"phase 25: {time.perf_counter() - t_phase:.1f} s")

    # -- phase 26: the CEMPPI step in f64, kernel path vs plain path -----------
    _cemppi_kernel_vs_plain("phase 26: Pusher", PusherDeviceEnv, 256, UH, UITS, ULAM,
                            "spatial_rollout", "spatial_step_states")

    # -- phase 27: the main path -----------------------------------------------
    m, counts, env, (*_, s), calls = _main_path(
        "phase 27:", "Pusher-v4", UK, UH, UITS, ULAM, PUSHER_STEPS, "spatial_rollout",
        "spatial_step_states", record=(spatial_step, "spatial_rollout_costs_tak"))
    own_ms = _own_launch_ms("phase 27: Pusher", calls, kern, counts, "spatial_rollout",
                            "spatial_step_states", float(m["control_steps_per_s"][0]), card)
    _print_reward("phase 27:", "Pusher-v4", m)
    r0, r1 = float(env.reward(env.reset())), float(env.reward(s))
    print(f"phase 27: the replayed actions take the shaped reward −|obj − goal| − "
          f"0.5·|obj − tips| from {r0:.4f} at reset to {r1:.4f}")
    _require(r1 > r0, "the Pusher's shaped reward did not improve")

    # -- phase 28: timings and bounds -------------------------------------------
    # The rollouts are timed on phase 25's f32 inputs from reset, whose plain
    # run tallied the QP. Operations counted as for the planar kernel's Euler
    # tasks (_contact_ops): per substep two mass-matrix factorizations and two
    # solves, and the QP's applications of J M⁻¹ Jᵀ over the rows valid in
    # these inputs; the bisections, mass matrix and bias are not counted.
    # Bytes: the controls or states read, the costs or states written.
    t_phase = time.perf_counter()
    env, x = make(torch.float32, "reset")
    ctrl = ctrl64.float()
    xs, act = x[None].contiguous(), torch.zeros((1, na), device="cuda")
    roll_bound = _bound(_contact_ops(env, UH * UK * env.FRAME_SKIP, 2, 2,
                                     res["reset"]["tally"][0]),
                        4.0 * (UH * na * UK + UK + env.state_dim))
    with _qp_tally(spatial_contact, env) as tally:
        env.plain_step(make_state(xs), act)
    step_bound = _bound(_contact_ops(env, env.FRAME_SKIP, 2, 2, tally[0]),
                        4.0 * (2 * env.state_dim + na))
    roll = _timed("phase 28: Pusher rollout", f"K={UK} T={UH} from reset",
                  lambda: kern(env, x, ctrl), 10, res["reset"]["plain_ms"], card)
    stp = _timed("phase 28: Pusher step", "one state",
                 lambda: spatial_step.spatial_step_states(env, xs, act), 50,
                 lambda: env.plain_step(make_state(xs), act), card, reps_p=2)
    print(f"phase 28: bounds, Pusher rollout {roll_bound[0]:.6f} ms ({roll_bound[1]}), step "
          f"{step_bound[0]:.3e} ms ({step_bound[1]}) ({time.perf_counter() - t_phase:.1f} s)")
    return [{
        "name": "spatial_rollout_pusher",
        "route": "cuda",
        "source": "mpopis_tpu_torch/csrc/spatial_rollout.cu",
        "replaces": "mpopis_tpu/kernels/spatial_step.py:139",
        "launches": counts["spatial_rollout"],
        "max_abs_err": res["touch"]["max_abs_err"],
        "ms": roll[0],
        "plain_ms": roll[1],
        "bound_ms": roll_bound[0],
        "bound_by": roll_bound[1],
        "library_ms": None,
        "median_rel_err_f32": res["touch"]["median_rel_err_f32"],
        "main_path_ms": own_ms,
    }, {
        "name": "spatial_step_states_pusher",
        "route": "cuda",
        "source": "mpopis_tpu_torch/csrc/spatial_rollout.cu",
        "replaces": "mpopis_tpu/kernels/spatial_step.py:52",
        "launches": counts["spatial_step_states"],
        "max_abs_err": step_err["float32"],
        "ms": stp[0],
        "plain_ms": stp[1],
        "bound_ms": step_bound[0],
        "bound_by": step_bound[1],
        "library_ms": None,
    }]


def _humanoid_path(card: str, which: str) -> list:
    """Phases 29-32 (`humanoid`) or 33-36 (`standup`): kernel 4's Humanoid or
    Standup build (23 dofs, 242 rows: 109 capsule–capsule self pairs, joint
    springs; the com-x track or the `standup` family) and the on-device
    Humanoid-v4 or HumanoidStandup-v4 path. Returns the `kernels` entries of
    its rollout and step."""
    from mpopis_tpu_torch.kernels import build, spatial_step
    from mpopis_tpu_torch.models import (
        HumanoidDeviceEnv,
        HumanoidStandupDeviceEnv,
        humanoid_device,
        spatial_contact,
    )
    from mpopis_tpu_torch.models.base import make_state

    humanoid = which == "humanoid"
    cls = HumanoidDeviceEnv if humanoid else HumanoidStandupDeviceEnv
    task = "Humanoid-v4" if humanoid else "HumanoidStandup-v4"
    label = "Humanoid" if humanoid else "Standup"
    first = 29 if humanoid else 33
    lam = 1.0 if humanoid else 0.3
    # the start whose rows the compared rollouts must exercise: the Humanoid's
    # crouch (floor and self-pair rows at once), the Standup's supine reset
    touch = "crouch" if humanoid else "reset"
    kern = spatial_step.spatial_rollout_costs_tak
    ref = spatial_step.spatial_rollout_costs_tak_reference
    na = cls.action_dim

    def make(dtype, start):
        env = cls(dtype=dtype, device="cuda")
        if start == "reset":
            return env, env.reset().x
        q = humanoid_device.crouched_qpos(env.MODEL)
        qv = torch.as_tensor(np.random.default_rng(4).uniform(-0.3, 0.3, 23))
        carry = humanoid_device.com_x(q)[None] if humanoid else torch.zeros(1, dtype=q.dtype)
        return env, torch.cat([q, qv, carry]).to("cuda", dtype)

    # -- the build, and the kernel against its plain version -------------------
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    free0 = torch.cuda.mem_get_info()[0]
    build.load_library("spatial_rollout")
    log = build.BUILD_INFO["spatial_rollout"]["log"].splitlines()
    mangled = f"Li23ELi24ELi{spatial_step.select_build(cls.MODEL, cls.FAMILY, cls.TRACK)}E"
    for i, line in enumerate(log):  # this build's entries: (n_dof, n_q, mask)
        if "Compiling entry" in line and mangled in line:
            for ptx in log[i:i + 6]:
                if "registers" in ptx or "spill" in ptx or "Compiling entry" in ptx:
                    print(f"  ptxas ({label} build):", ptx.strip())
    for start in ("reset", "crouch"):
        env, x = make(torch.float32, start)
        n_lim, n_con, n_self = spatial_step.first_substep_active_rows(env, x)
        print(f"phase {first}: {label} {start} start (z = {float(x[2]):.4f}): {n_lim} limit, "
              f"{n_con} floor and {n_self} self-pair rows active in the first substep")
    ctrl64 = torch.as_tensor(np.random.default_rng(first).uniform(-0.4, 0.4, (HH, na, HK)),
                             dtype=torch.float64, device="cuda")
    res = _kernel_vs_plain(f"phase {first}: {label}", kern, ref, make, ("reset", "crouch"),
                           ctrl64, 2e-3, spatial_contact)
    for start in ("reset", "crouch"):
        tl = res[start]["tally"]
        print(f"phase {first}: over the plain f32 rollouts' QP calls from {start}: "
              f"{tl[3] - tl[1]} limit, {tl[1] - tl[4]} floor and {tl[4]} self-pair rows active")
    # CUDA reserves local memory for every thread that can be resident
    # at the largest stack launched so far: the f64 build's shows here
    print(f"phase {first}: free device memory {free0 / 2**30:.2f} GiB before this build's "
          f"first launch, {torch.cuda.mem_get_info()[0] / 2**30:.2f} GiB after its comparisons")
    tl = res[touch]["tally"]
    _require(tl[1] - tl[4] > 0 and tl[4] > 0,
             f"{label}: no floor or no self-pair row active in the compared rollouts")
    step_err = _step_vs_plain(f"phase {first}: {label}", spatial_step.spatial_step_states, make,
                              touch, 0.01, 0.5, na, 47)
    torch.cuda.synchronize()
    print(f"phase {first}: {time.perf_counter() - t_phase:.1f} s")

    # -- the CEMPPI step in f64, kernel path vs plain path ----------------------
    _cemppi_kernel_vs_plain(f"phase {first + 1}: {label}", cls, 64, 4, HITS, lam,
                            "spatial_rollout", "spatial_step_states")

    # -- the main path, against a zero-action run --------------------------------
    # The torso is held to the JAX package's criteria at their depth, 6 control
    # steps (tests/test_humanoid_device.py:259-260,
    # tests/test_humanoidstandup_device.py:283-284). Over 50 steps the
    # Humanoid's objective (5 + 1.25·com-x velocity − 0.1·Σa², no
    # termination) pays for a forward dive, so its torso is only reported
    # there; the controller must beat the zero-action run's reward per step.
    m, counts, env, states, calls = _main_path(
        f"phase {first + 2}:", task, HK, HH, HITS, lam, HUMANOID_STEPS, "spatial_rollout",
        "spatial_step_states", record=(spatial_step, "spatial_rollout_costs_tak"))
    own_ms = _own_launch_ms(f"phase {first + 2}: {label}", calls, kern, counts, "spatial_rollout",
                            "spatial_step_states", float(m["control_steps_per_s"][0]), card)
    _print_reward(f"phase {first + 2}:", task, m)
    executed = 10 * -(-(HUMANOID_STEPS + 1) // 10)  # whole chunks of 10 steps
    _require(counts["spatial_step_states"] == executed,
             f"{task}: {counts['spatial_step_states']} step launches for {executed} steps")
    zero = torch.zeros(na, dtype=torch.float32, device="cuda")
    zero_states, zero_rew = [env.reset()], 0.0
    for i in range(len(states) - 1):
        s0, r0 = env.step_reward(zero_states[-1], zero)
        zero_states.append(s0)
        zero_rew += float(r0) if i < HUMANOID_STEPS else 0.0
    z6, z6_0 = float(states[6].x[2]), float(zero_states[6].x[2])
    z, z0 = float(states[-1].x[2]), float(zero_states[-1].x[2])
    rps, rps0 = float(m["rewards_per_step"][0]), zero_rew / HUMANOID_STEPS
    print(f"phase {first + 2}: the torso from z = {float(states[0].x[2]):.4f}: after 6 steps "
          f"{z6:.4f} (zero action {z6_0:.4f}), after {len(states) - 1} {z:.4f} (zero action "
          f"{z0:.4f}); reward per step {rps:.4f}, zero action {rps0:.4f}")
    if humanoid:
        _require(z6 > 0.6 and z6 > z6_0 - 0.25, "the humanoid's torso fell in 6 steps")
    else:
        _require(z6 >= z6_0 - 0.02 and z6 > 0.08, "the standup's torso went down in 6 steps")
    _require(rps > rps0, f"{task}: the controller's reward per step is under the zero action's")

    # -- timings and bounds -----------------------------------------------------
    # The rollouts are timed on the compared f32 inputs from the contact
    # start, whose plain run was timed and tallied the QP. Operations counted
    # as for Ant (_contact_ops): per RK4 stage one mass-matrix factorization
    # and two solves, and the QP's applications of J M⁻¹ Jᵀ over the rows
    # valid in these inputs; frames, mass matrix, bias and pair geometry are
    # not counted. Bytes: the controls or states read, the costs or states
    # written.
    t_phase = time.perf_counter()
    env, x = make(torch.float32, touch)
    ctrl = ctrl64.float()
    xs, act = x[None].contiguous(), torch.zeros((1, na), device="cuda")
    roll_bound = _bound(_contact_ops(env, HH * HK * env.FRAME_SKIP * 4, 1, 2,
                                     res[touch]["tally"][0]),
                        4.0 * (HH * na * HK + HK + env.state_dim))
    with _qp_tally(spatial_contact, env) as tally:
        t_start = torch.cuda.Event(enable_timing=True)
        t_end = torch.cuda.Event(enable_timing=True)
        t_start.record()
        env.plain_step(make_state(xs), act)
        t_end.record()
    torch.cuda.synchronize()
    step_bound = _bound(_contact_ops(env, env.FRAME_SKIP * 4, 1, 2, tally[0]),
                        4.0 * (2 * env.state_dim + na))
    roll = _timed(f"phase {first + 3}: {label} rollout", f"K={HK} T={HH} from {touch}",
                  lambda: kern(env, x, ctrl), 3, res[touch]["plain_ms"], card)
    stp = _timed(f"phase {first + 3}: {label} step", f"one {touch} state",
                 lambda: spatial_step.spatial_step_states(env, xs, act), 20,
                 t_start.elapsed_time(t_end), card)
    print(f"phase {first + 3}: bounds, {label} rollout {roll_bound[0]:.6f} ms ({roll_bound[1]}), "
          f"step {step_bound[0]:.3e} ms ({step_bound[1]}) ({time.perf_counter() - t_phase:.1f} s)")
    return [{
        "name": f"spatial_rollout_{which}",
        "route": "cuda",
        "source": "mpopis_tpu_torch/csrc/spatial_rollout.cu",
        "replaces": "mpopis_tpu/kernels/spatial_step.py:139",
        "launches": counts["spatial_rollout"],
        "max_abs_err": res[touch]["max_abs_err"],
        "ms": roll[0],
        "plain_ms": roll[1],
        "bound_ms": roll_bound[0],
        "bound_by": roll_bound[1],
        "library_ms": None,
        "median_rel_err_f32": res[touch]["median_rel_err_f32"],
        "main_path_ms": own_ms,
    }, {
        "name": f"spatial_step_states_{which}",
        "route": "cuda",
        "source": "mpopis_tpu_torch/csrc/spatial_rollout.cu",
        "replaces": "mpopis_tpu/kernels/spatial_step.py:52",
        "launches": counts["spatial_step_states"],
        "max_abs_err": step_err["float32"],
        "ms": stp[0],
        "plain_ms": stp[1],
        "bound_ms": step_bound[0],
        "bound_by": step_bound[1],
        "library_ms": None,
    }]


# the libraries each path builds
_LIBRARIES = {"car": ("car_rollout",), "planar": ("planar_rollout",),
              "ais": ("ais_update", "linalg"), "ant": ("spatial_rollout",),
              "swimmer": ("swimmer_rollout",), "pusher": ("spatial_rollout",),
              "humanoid": ("spatial_rollout",), "standup": ("spatial_rollout",),
              "cars": ("car_rollout",), "reacher": (), "pendulums": (), "classic": (),
              "sharded": ("car_rollout", "planar_rollout"), "resume": ("car_rollout",), "gif": ("car_rollout",), "host": ()}


def _missing_packages(path: str) -> list:
    import importlib.util

    return [p for p in PACKAGES.get(path, ()) if importlib.util.find_spec(p) is None]


def _parse_paths(argv) -> tuple:
    """The paths to run: all of PATHS, or those `--only a,b` names."""
    import argparse

    ap = argparse.ArgumentParser(description="Chip smoke test of the PyTorch + CUDA port.")
    ap.add_argument("--only", default=None, metavar="PATHS",
                    help=f"comma-separated paths to run, of {','.join(PATHS)} (default: all; "
                    "only the default run is the proof)")
    args = ap.parse_args(argv)
    if args.only is None:
        return PATHS
    only = tuple(p.strip() for p in args.only.split(",") if p.strip())
    bad = sorted(set(only) - set(PATHS))
    if bad or not only:
        ap.error(f"--only {args.only!r}: unknown paths {bad}; choose from {','.join(PATHS)}")
    return tuple(p for p in PATHS if p in only)


def main(argv=None) -> int:
    paths = _parse_paths(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    try:
        from mpopis_tpu_torch.kernels import build
    except ModuleNotFoundError as e:  # the script without the checkout beside it
        print(f"chip_smoke: {e}; run it from the root of a checkout of the repo",
              file=sys.stderr)
        return 3

    # -- phase 0: the card -------------------------------------------------
    card = _card()
    print(f"phase 0: card {card!r}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}; paths {','.join(paths)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- phase 1: build (every library at once, one nvcc each) ---------------
    t0 = time.perf_counter()
    build.build_all(sorted({lib for p in paths for lib in _LIBRARIES[p]}))
    build_s = time.perf_counter() - t0
    print(f"phase 1: the libraries of {','.join(paths)} built in parallel in {build_s:.1f} s")
    for _, info in sorted(build.BUILD_INFO.items()):
        print(f"phase 1: {info['so']} built in {info['seconds']:.1f} s")
    kernels = []
    for path, run in (("car", _car_path), ("planar", _planar_path), ("ais", _ais_path),
                      ("ant", _spatial_path), ("swimmer", _swimmer_path),
                      ("pusher", _pusher_path),
                      ("humanoid", lambda c: _humanoid_path(c, "humanoid")),
                      ("standup", lambda c: _humanoid_path(c, "standup")),
                      ("cars", _cars_path), ("reacher", _reacher_path),
                      ("pendulums", _pendulums_path), ("classic", _classic_path),
                      ("sharded", _sharded_path), ("resume", _resume_path), ("gif", _gif_path), ("host", _host_path)):
        if path in paths:
            missing = _missing_packages(path)
            if missing:
                print(f"path {path}: not run: the machine lacks {', '.join(missing)}")
                continue
            t_path = time.perf_counter()
            for entry in run(card):
                # a kernel that runs on several paths: the later path's numbers
                # join the first one's entry under "multi_car" (the multi-car
                # race) or the key the entry names ("under"); where that one
                # did not run, such an entry stands alone as its name and
                # that key
                under = entry.pop("under", None)
                same = [e for e in kernels if e["name"] == entry["name"]]
                numbers = {k: v for k, v in entry.items() if k != "name"}
                if same:
                    same[0][under or "multi_car"] = numbers
                elif under is None:
                    kernels.append(entry)
                else:
                    kernels.append({"name": entry["name"], under: numbers})
            print(f"path {path}: {time.perf_counter() - t_path:.1f} s")

    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


def _car_path(card: str) -> list:
    """Phases 1-5: the car rollout kernel and the car race. Returns the
    `kernels` entry of car_rollout."""
    from mpopis_tpu_torch.harness.simulate import simulate_car_racing
    from mpopis_tpu_torch.kernels import build, car_rollout
    from mpopis_tpu_torch.models import CarRacingEnv, MultiCarRacingEnv
    from mpopis_tpu_torch.policies import PolicyConfig, make_policy

    build.load_library("car_rollout")
    info = build.BUILD_INFO["car_rollout"]
    built = f"built in {info['seconds']:.1f} s" if info["seconds"] else "already built"
    print(f"phase 1: {info['so']} {built} (in parallel with the others)")
    for line in _ptxas_lines(info["log"]):
        print("  ptxas:", line)

    # -- phase 2: kernel vs plain version ---------------------------------
    ref = car_rollout.car_rollout_costs_tak_reference
    kern = car_rollout.car_rollout_costs_tak

    env32 = CarRacingEnv(dtype=torch.float32, device="cuda")
    env64 = CarRacingEnv(dtype=torch.float64, device="cuda")
    x32, x64 = env32.reset().x, env64.reset().x
    for k, t in ((64, 12), (150, 5)):
        ctrl = _uniform(k, t, 2, k, torch.float32)
        got, want = kern(env32, x32, ctrl, t), ref(env32, x32, ctrl, t)
        torch.cuda.synchronize()
        err = float(torch.max(torch.abs(got - want)))
        ok = bool(torch.allclose(got, want, rtol=2e-4, atol=2e-3))
        print(f"phase 2: f32 K={k} T={t}: max|err| {err:.3e} (rtol 2e-4, atol 2e-3) ok={ok}")
        _require(ok, f"f32 kernel disagrees at K={k} T={t}")
    env3 = MultiCarRacingEnv(num_cars=3, dtype=torch.float32, device="cuda")
    x3 = env3.reset().x
    ctrl = _uniform(40, 6, 6, 7, torch.float32)
    got, want = kern(env3, x3, ctrl, 6), ref(env3, x3, ctrl, 6)
    err = float(torch.max(torch.abs(got - want)))
    ok = bool(torch.allclose(got, want, rtol=2e-4, atol=2e-2))
    print(f"phase 2: f32 3 cars K=40 T=6: max|err| {err:.3e} (rtol 2e-4, atol 2e-2) ok={ok}")
    _require(ok, "f32 three-car kernel disagrees")

    # f64 sample by sample: within 1e-9, or within 10x the most the plain
    # version's own cost moves under controls·(1 ± 1e-15) or x0·(1 + 1e-15)
    # (the kernel's identities are exact up to rounding, and an off-track or
    # sideslip step of the reward turns rounding into a jump of 1e6 or 5000)
    ctrl64 = _candidates(K, H, 2, torch.float64)
    got, want = kern(env64, x64, ctrl64, H), ref(env64, x64, ctrl64, H)
    rel64 = _rel_err(got, want)
    max_abs_f64 = float(torch.max(torch.abs(got - want)))
    far = np.flatnonzero(rel64 > 1e-9)
    ratio = 0.0
    if len(far):
        runs = (ref(env64, x64, ctrl64 * (1 + 1e-15), H), ref(env64, x64, ctrl64 * (1 - 1e-15), H),
                ref(env64, x64 * (1 + 1e-15), ctrl64, H))
        own = np.max([_rel_err(r, want)[far] for r in runs], axis=0)
        ratio = float(np.max(rel64[far] / np.maximum(own, 1e-300)))
    print(f"phase 2: f64 K={K} T={H}: max rel {rel64.max():.3e}, median {np.median(rel64):.3e}, "
          f"max|err| {max_abs_f64:.3e}; {len(far)} samples beyond 1e-9, the largest at "
          f"{ratio:.3f}x its own spread under a nudge (bound 10x)")
    _require(ratio <= 10.0, "f64 kernel disagrees beyond the plain version's own spread")

    ctrl32 = ctrl64.float()
    got, want = kern(env32, x32, ctrl32, H), ref(env32, x32, ctrl32, H)
    rel32 = _rel_err(got, want)
    max_abs_f32 = float(torch.max(torch.abs(got - want)))
    n_over = int(np.sum(rel32 > 2e-4))
    print(f"phase 2: f32 K={K} T={H}: rel err max {rel32.max():.3e} median "
          f"{np.median(rel32):.3e}, {n_over} of {K} samples beyond 2e-4, "
          f"max|err| {max_abs_f32:.3e}")
    _require(float(np.median(rel32)) < 2e-4, "f32 kernel median relative error >= 2e-4")

    # -- phase 3: the CEMPPI step, kernel path vs plain path, f64 -----------
    z = torch.randn((ITS, 2 * H, K), generator=torch.Generator("cuda").manual_seed(3),
                    dtype=torch.float64, device="cuda")
    outs = []
    for fused in (True, False):
        cfg = PolicyConfig(kind="cemppi", num_samples=K, horizon=H, lam=10.0,
                           opt_its=ITS, sigma_est="ss", use_fused_rollout=fused)
        pol = make_policy(env64, cfg, cov_mat=np.diag([0.0625, 0.1]))
        t0 = time.perf_counter()
        a, ps, inf = pol.step(env64.reset(), pol.init_state(0), z=z)
        torch.cuda.synchronize()
        outs.append((a, ps.U, inf["ais_its"], time.perf_counter() - t0))
    (a_k, u_k, its_k, s_k), (a_p, u_p, its_p, s_p) = outs
    err_a = float(np.max(_rel_err(a_k, a_p)))
    err_u = float(torch.max(torch.abs(u_k - u_p)))
    print(f"phase 3: CEMPPI f64 step K={K}: kernel path {its_k} its {s_k:.2f} s, plain path "
          f"{its_p} its {s_p:.2f} s; action rel err {err_a:.3e}, max|dU| {err_u:.3e} (rtol 1e-8)")
    _require(its_k == its_p, "kernel and plain paths ran different iteration counts")
    _require(bool(torch.allclose(a_k, a_p, rtol=1e-8, atol=0.0))
             and bool(torch.allclose(u_k, u_p, rtol=1e-8, atol=1e-12)),
             "kernel and plain CEMPPI steps disagree")

    # -- phase 4: the main path through the harness -------------------------
    phase_t = time.perf_counter()
    _zero_counts()
    m = simulate_car_racing(
        num_trials=1, num_steps=RACE_STEPS, num_samples=K, horizon=H, lam=10.0,
        ais_its=ITS, ce_sigma_est="ss", laps=2, seed=SEED, device="cuda",
        dtype=torch.float32,
    )
    car_counts = _counts()
    launches = car_counts["car_rollout"]
    calls = int(m["ais_iterations"].sum())
    sps = float(m["control_steps_per_s"][0])
    print(f"phase 4: race K={K}: {int(m['steps'][0])} steps, lap 1 at "
          f"{int(m['lap1_times'][0])}, lap 2 at {int(m['lap2_times'][0])}, "
          f"{int(m['track_violations'][0])} track / {int(m['beta_violations'][0])} β "
          f"violations, {sps:.2f} control steps/s, kernel launches {launches}, "
          f"rollout calls {calls}")
    print(f"phase 4: kernel launches during the race {json.dumps(car_counts)}")
    _require(launches > 0 and launches == calls, "the race did not run every rollout on the kernel")
    _require(m["lap1_times"][0] > 0, "lap 1 not completed")
    _require(m["track_violations"][0] == 0, "track violations in the race")
    _require(np.isfinite(m["rewards"][0]), "non-finite race reward")
    m150 = simulate_car_racing(
        num_trials=1, num_steps=RACE150_STEPS, num_samples=150, horizon=H, lam=10.0,
        ais_its=ITS, ce_sigma_est="ss", laps=2, seed=SEED, device="cuda",
        dtype=torch.float32,
    )
    sps150 = float(m150["control_steps_per_s"][0])
    print(f"phase 4: reference config K=150: {sps150:.2f} control steps/s over "
          f"{int(m150['steps'][0])} steps ({time.perf_counter() - phase_t:.1f} s)")

    # -- phase 5: timings, kernel vs plain, f32 at K=8192 T=50 --------------
    def run_kernel():
        kern(env32, x32, ctrl32, H)

    def run_plain():
        ref(env32, x32, ctrl32, H)

    ctrl150 = ctrl32[:, :, :150].contiguous()

    def run_kernel150():
        kern(env32, x32, ctrl150, H)

    run_kernel()
    run_kernel150()
    run_plain()
    torch.cuda.synchronize()
    plain_a = _time_ms(run_plain, 1)
    kern_a = _time_ms(run_kernel, 50)
    kern_b = _time_ms(run_kernel, 50)
    plain_b = _time_ms(run_plain, 1)
    kernel_ms, plain_ms = (kern_a + kern_b) / 2, (plain_a + plain_b) / 2
    k150 = (_time_ms(run_kernel150, 50), _time_ms(run_kernel150, 50))
    print(f"phase 5: f32 K={K} T={H}: kernel {kern_a:.4f} / {kern_b:.4f} ms, "
          f"plain {plain_a:.2f} / {plain_b:.2f} ms (CUDA events, plain-kernel-kernel-plain); "
          f"K=150 T={H}: kernel {k150[0]:.4f} / {k150[1]:.4f} ms")

    # The early stop's host read. Both configs run all 10 iterations:
    # tolerance 0 never reads the flag back, 1e-30 reads it every iteration
    # and never stops. Host clock over 10 steps, in turns, after warm-up.
    pols, states, step_ms = {}, {}, {0.0: [], 1e-30: []}
    for tol in step_ms:
        cfg = PolicyConfig(kind="cemppi", num_samples=K, horizon=H, lam=10.0,
                           opt_its=ITS, sigma_est="ss", elite_stop_tol=tol)
        pols[tol] = make_policy(env32, cfg, cov_mat=np.diag([0.0625, 0.1]))
        states[tol] = pols[tol].init_state(5)
        for _ in range(5):
            _, states[tol], _ = pols[tol].step(env32.reset(), states[tol])
    for tol in (0.0, 1e-30, 1e-30, 0.0):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            _, states[tol], inf = pols[tol].step(env32.reset(), states[tol])
        torch.cuda.synchronize()
        _require(inf["ais_its"] == ITS, "the early stop fired in the host-read timing")
        step_ms[tol].append((time.perf_counter() - t0) * 100.0)
    no_read, read = np.median(step_ms[0.0]), np.median(step_ms[1e-30])
    print(f"phase 5: CEMPPI f32 step K={K}, {ITS} its: median {no_read:.3f} ms without "
          f"the stop read, {read:.3f} ms with it ({(read - no_read) / ITS:.4f} ms per "
          f"read); per-run ms {json.dumps(step_ms)}")

    # Operations counted per sample and action step: the substeps' arithmetic
    # (~120 operations and ~15 transcendentals each, counted as one operation
    # apiece, from step_car_state) and the reward's sweep over the M track
    # points (6 per point) plus ~40 more; bytes: controls read, costs written.
    n_sub = int(round(env32.dt / env32.ddt))
    m_track = env32.track_xyw.shape[1]
    car_bound = _bound(K * H * (n_sub * 135.0 + 6.0 * m_track + 40.0),
                       4.0 * (2 * H * K + K + 3 * m_track + 8))

    return [{
        "name": "car_rollout",
        "route": "cuda",
        "source": "mpopis_tpu_torch/csrc/car_rollout.cu",
        "replaces": "mpopis_tpu/kernels/car_rollout.py:79",
        "launches": launches,
        "max_abs_err": max_abs_f32,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": car_bound[0],
        "bound_by": car_bound[1],
        "library_ms": None,
        "max_abs_err_f64": max_abs_f64,
        "median_rel_err_f32": float(np.median(rel32)),
        "ms_k150": sum(k150) / 2,
    }]


# -- the multi-car race and the car harness's options ------------------------

# the multi-car race: the reference's multi-car example (CMAMPPI, 3 cars) at
# the car path's width (K=8192, H=50, 10 AIS iterations) for 40 steps; the
# CEMPPI f64 step at 3 cars at K=1024, H=20, 3 iterations; the noisy race and
# the chunked race as the car path's
CARS_STEPS, NOISE_STEPS, CHUNK_STEPS = 40, 20, 30
CK, CH, CITS = 1024, 20, 3


def _car_ops_bytes(env, k, horizon, num_cars, m_track):
    """(operations, bytes) of kernel 1 at N cars, counted as for one car
    (phase 5) per car, plus ~8 operations per pair and action step."""
    n_sub = int(round(env.dt / env.ddt))
    pairs = num_cars * (num_cars - 1) // 2
    ops = k * horizon * (num_cars * (n_sub * 135.0 + 6.0 * m_track + 40.0) + 8.0 * pairs)
    nbytes = 4.0 * (2 * num_cars * horizon * k + k + 3 * m_track + 8 * num_cars)
    return ops, nbytes


def _cars_path(card: str) -> list:
    """Phases 37-41: kernel 1's 2-, 3- and 4-car builds through
    MultiCarRacingEnv, the 3-car CMAMPPI race, the f64 CEMPPI step at 3 cars,
    the one-car race with state noise and the chunked loop against one step
    a call. Returns kernel 1's entry for the 3-car race, with its ms at 2,
    3 and 4 cars."""
    from mpopis_tpu_torch.harness.simulate import simulate_car_racing
    from mpopis_tpu_torch.kernels import build, car_rollout
    from mpopis_tpu_torch.models import MultiCarRacingEnv
    from mpopis_tpu_torch.policies import PolicyConfig, make_policy

    build.load_library("car_rollout")
    ref = car_rollout.car_rollout_costs_tak_reference
    kern = car_rollout.car_rollout_costs_tak

    # -- phase 37: the N-car builds against the plain version ------------------
    t_phase = time.perf_counter()
    results = {}
    for n in (2, 3, 4):
        env32 = MultiCarRacingEnv(num_cars=n, dtype=torch.float32, device="cuda")
        env64 = MultiCarRacingEnv(num_cars=n, dtype=torch.float64, device="cuda")
        x32, x64 = env32.reset().x, env64.reset().x
        # f32 from the staggered reset, K=256 T=10: the JAX multi-car tolerance
        ctrl = _uniform(256, 10, 2 * n, 37 + n, torch.float32)
        got, want = kern(env32, x32, ctrl, 10), ref(env32, x32, ctrl, 10)
        err = float(torch.max(torch.abs(got - want)))
        ok = bool(torch.allclose(got, want, rtol=2e-4, atol=2e-2))
        print(f"phase 37: {n} cars f32 K=256 T=10 from the reset: max|err| {err:.3e} (rtol 2e-4, "
              f"atol 2e-2) ok={ok}")
        _require(ok, f"f32 {n}-car kernel disagrees")
        # f64 sample by sample (1e-9 or the nudge rule) on the CEMPPI step's
        # first candidates; the race's shape at 3 cars
        k, t = (K, H) if n == 3 else (1024, 20)
        ctrl64 = _candidates(k, t, 370 + n, torch.float64, cars=n)
        got, want = kern(env64, x64, ctrl64, t), ref(env64, x64, ctrl64, t)
        rel64 = _rel_err(got, want)
        far = np.flatnonzero(rel64 > 1e-9)
        ratio = 0.0
        if len(far):
            runs = (ref(env64, x64, ctrl64 * (1 + 1e-15), t), ref(env64, x64, ctrl64 * (1 - 1e-15), t),
                    ref(env64, x64 * (1 + 1e-15), ctrl64, t))
            own = np.max([_rel_err(r, want)[far] for r in runs], axis=0)
            ratio = float(np.max(rel64[far] / np.maximum(own, 1e-300)))
        print(f"phase 37: {n} cars f64 K={k} T={t}: max rel {rel64.max():.3e}, median "
              f"{np.median(rel64):.3e}; {len(far)} samples beyond 1e-9, the largest at "
              f"{ratio:.3f}x its own spread under a nudge (bound 10x)")
        _require(bool(torch.all(torch.isfinite(got))), f"{n}-car f64 kernel: non-finite costs")
        _require(ratio <= 10.0, f"f64 {n}-car kernel disagrees beyond the plain version's spread")
        results[n] = {"max_abs_err_f64": float(torch.max(torch.abs(got - want)))}
        # f32 at the race's shape on the first candidates: median relative
        # error, and the plain time
        ctrl32 = _candidates(K, H, 3700 + n, torch.float32, cars=n)
        got = kern(env32, x32, ctrl32, H)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        want = ref(env32, x32, ctrl32, H)
        end.record()
        torch.cuda.synchronize()
        rel32 = _rel_err(got, want)
        results[n].update(max_abs_err=float(torch.max(torch.abs(got - want))),
                          median_rel_err_f32=float(np.median(rel32)),
                          plain_ms=start.elapsed_time(end), env=env32, x=x32, ctrl=ctrl32)
        print(f"phase 37: {n} cars f32 K={K} T={H}: rel err max {rel32.max():.3e} median "
              f"{np.median(rel32):.3e}, max|err| {results[n]['max_abs_err']:.3e}")
        _require(float(np.median(rel32)) < 2e-4, f"{n}-car f32 median relative error >= 2e-4")
    print(f"phase 37: {time.perf_counter() - t_phase:.1f} s")

    # -- phase 38: the 3-car CMAMPPI race (the reference's multi-car example) --
    t_phase = time.perf_counter()
    _zero_counts()
    m = simulate_car_racing(
        num_trials=1, num_steps=CARS_STEPS, num_cars=3, policy_type="cmamppi", num_samples=K,
        horizon=H, lam=10.0, ais_its=ITS, laps=2, seed=SEED, device="cuda",
        dtype=torch.float32, print_output=False,
    )
    counts = _counts()
    launches, calls = counts["car_rollout"], int(m["ais_iterations"][0])
    race_sps = float(m["control_steps_per_s"][0])
    print(f"phase 38: CMAMPPI 3 cars K={K} H={H} {ITS} its: {int(m['steps'][0])} steps, reward "
          f"{float(m['rewards'][0]):.4f}, {int(m['crash_violations'][0])} C / "
          f"{int(m['beta_violations'][0])} β / {int(m['track_violations'][0])} track violations, "
          f"mean V {float(m['mean_vs'][0]):.2f}, {race_sps:.3f} control steps/s, rollout calls "
          f"{calls}, kernel launches {json.dumps({k: v for k, v in counts.items() if v})} "
          f"({time.perf_counter() - t_phase:.1f} s)")
    _require(launches == calls > 0, "the 3-car race did not run every rollout on the kernel")
    _require(set(k for k, v in counts.items() if v) == {"car_rollout"}, "other kernels launched")
    _require(np.isfinite(m["rewards"][0]), "non-finite 3-car race reward")

    # -- phase 39: the CEMPPI step at 3 cars, kernel path vs plain path, f64 ----
    t_phase = time.perf_counter()
    env64 = MultiCarRacingEnv(num_cars=3, dtype=torch.float64, device="cuda")
    z = torch.randn((CITS, 6 * CH, CK), generator=torch.Generator("cuda").manual_seed(39),
                    dtype=torch.float64, device="cuda")

    def step(fused, nudge):
        cfg = PolicyConfig(kind="cemppi", num_samples=CK, horizon=CH, lam=10.0, opt_its=CITS,
                           sigma_est="ss", use_fused_rollout=fused)
        pol = make_policy(env64, cfg, cov_mat=np.diag([0.0625, 0.1] * 3))
        _zero_counts()
        a, ps, inf = pol.step(env64.reset(), pol.init_state(0), z=z * (1 + nudge))
        torch.cuda.synchronize()
        return a, ps.U, inf["ais_its"], _counts()["car_rollout"]

    a_k, u_k, its_k, n_k = step(True, 0.0)
    a_p, u_p, its_p, n_p = step(False, 0.0)
    err_a, err_u = _rel_norm(a_k, a_p), _rel_norm(u_k, u_p)
    own_a = own_u = 0.0
    spread = "the plain path's own spread not needed"
    if max(err_a, err_u) > 1e-8:
        a_n, u_n, its_n, _ = step(False, NUDGE[torch.float64])
        own_a, own_u = _rel_norm(a_n, a_p), _rel_norm(u_n, u_p)
        spread = f"plain vs plain at z·(1+1e-15): {its_n} its, action {own_a:.3e}, U {own_u:.3e}"
    print(f"phase 39: CEMPPI f64 step, 3 cars K={CK} H={CH} {CITS} its: kernel path {its_k} its "
          f"({n_k} launches), plain path {its_p} its ({n_p} launches); kernel vs plain, max|Δ| / "
          f"max|plain|: action {err_a:.3e}, U {err_u:.3e} (bound 1e-8); {spread} "
          f"({time.perf_counter() - t_phase:.1f} s)")
    _require(n_k == its_k and n_p == 0, "the 3-car CEMPPI step's rollouts are not where they belong")
    _require(its_k == its_p, "kernel and plain paths ran different iteration counts")
    _hold("3-car CEMPPI step: action, kernel vs plain path", err_a, own_a, 1e-8)
    _hold("3-car CEMPPI step: U, kernel vs plain path", err_u, own_u, 1e-8)

    # -- phase 40: the one-car race with state noise; chunked against per step --
    t_phase = time.perf_counter()
    _zero_counts()
    m = simulate_car_racing(
        num_trials=1, num_steps=NOISE_STEPS, num_samples=K, horizon=H, lam=10.0, ais_its=ITS,
        ce_sigma_est="ss", state_x_sigma=0.1, state_y_sigma=0.1, state_psi_sigma=0.1, seed=SEED,
        device="cuda", dtype=torch.float32, print_output=False,
    )
    noise_launches = _counts()["car_rollout"]
    print(f"phase 40: the race with state noise σ = 0.1 (x, y, ψ) K={K}: "
          f"{int(m['steps'][0])} steps, reward {float(m['rewards'][0]):.4f}, mean V "
          f"{float(m['mean_vs'][0]):.2f}, {int(m['track_violations'][0])} track / "
          f"{int(m['beta_violations'][0])} β violations, "
          f"{float(m['control_steps_per_s'][0]):.3f} control steps/s, kernel launches "
          f"{noise_launches} for {int(m['ais_iterations'][0])} rollout calls")
    _require(noise_launches == m["ais_iterations"][0] > 0, "the noisy race left the kernel")
    _require(np.isfinite(m["rewards"][0]), "non-finite noisy race reward")
    runs = {}
    for chunk in (10, 1):
        _zero_counts()
        runs[chunk] = simulate_car_racing(
            num_trials=1, num_steps=CHUNK_STEPS, num_samples=150, horizon=H, lam=10.0,
            ais_its=ITS, ce_sigma_est="ss", seed=SEED, device="cuda", dtype=torch.float64,
            print_output=False, steps_per_call=chunk,
        )
        _require(_counts()["car_rollout"] == runs[chunk]["ais_iterations"][0],
                 f"steps_per_call {chunk}: not every rollout on the kernel")
    keys = ("rewards", "steps", "lap_times", "mean_vs", "max_vs", "mean_betas", "max_betas",
            "beta_violations", "track_violations")
    diff = max(float(np.max(np.abs(runs[10][k] - runs[1][k]))) for k in keys)
    print(f"phase 40: f64 K=150, {CHUNK_STEPS} steps: 10 steps a call {runs[10]['rewards'][0]:.6f} "
          f"at {float(runs[10]['control_steps_per_s'][0]):.3f} control steps/s, one a call "
          f"{runs[1]['rewards'][0]:.6f} at {float(runs[1]['control_steps_per_s'][0]):.3f}; max "
          f"|Δ| over the metrics {diff:.3e} ({time.perf_counter() - t_phase:.1f} s)")
    for key in keys:
        _require(np.allclose(runs[10][key], runs[1][key], rtol=1e-12, atol=0.0),
                 f"the chunked race's {key} differs from one step a call")

    # -- phase 41: kernel 1's times at 2, 3 and 4 cars --------------------------
    ms = {}
    for n in (2, 3, 4):
        r = results[n]

        def run(r=r):
            kern(r["env"], r["x"], r["ctrl"], H)

        run()
        torch.cuda.synchronize()
        ms[n] = (_time_ms(run, 20) + _time_ms(run, 20)) / 2
        print(f"phase 41: {n} cars f32 K={K} T={H}: kernel {ms[n]:.4f} ms, plain "
              f"{r['plain_ms']:.2f} ms (CUDA events, the plain time from the comparison's run; "
              f"{card})")
    env3 = results[3]["env"]
    ops, nbytes = _car_ops_bytes(env3, K, H, 3, env3.track_xyw.shape[1])
    bound = _bound(ops, nbytes)
    print(f"phase 41: bound at 3 cars {bound[0]:.6f} ms ({bound[1]})")
    return [{
        "name": "car_rollout",
        "route": "cuda",
        "source": "mpopis_tpu_torch/csrc/car_rollout.cu",
        "replaces": "mpopis_tpu/kernels/car_rollout.py:79",
        "launches": launches,
        "max_abs_err": results[3]["max_abs_err"],
        "ms": ms[3],
        "plain_ms": results[3]["plain_ms"],
        "bound_ms": bound[0],
        "bound_by": bound[1],
        "library_ms": None,
        "cars": 3,
        "ms_cars": {str(n): ms[n] for n in (2, 3, 4)},
        "plain_ms_cars": {str(n): results[n]["plain_ms"] for n in (2, 3, 4)},
        "max_abs_err_f64_cars": {str(n): results[n]["max_abs_err_f64"] for n in (2, 3, 4)},
        "median_rel_err_f32_cars": {str(n): results[n]["median_rel_err_f32"] for n in (2, 3, 4)},
    }]


# -- the contact-free MuJoCo tasks and the classic tasks (plain PyTorch) ------

# the Reacher: the JAX bench's entry (bench.py:317-329): CEMPPI, K=8192, H=15,
# 3 AIS iterations, λ=0.05, Σ=0.02·I, `mle`; the pendulums: the JAX tests'
# CEMPPI (tests/test_pendulum_device.py:105-117): K=32, H=15, 2 AIS
# iterations, λ=0.1, Σ=0.1; 30 steps each
RK, RH, RITS, RLAM = 8192, 15, 3, 0.05
PEND_K, PEND_H, PEND_ITS, PEND_LAM = 32, 15, 2, 0.1
PLAIN_STEPS = 30


def _plain_task(label, task, k, horizon, its, lam, cov, steps, seed, card):
    """`simulate_mujoco_on_device(task)` on the card for `steps` executed
    control steps (three chunks of 10 for 30), f32, CEMPPI `mle`: no
    hand-written kernel may launch (these tasks have none; their rollouts
    are the plain batched rollout). Replays the executed actions through the
    env's step, and prints the control steps/s (scripts/plain_task_times.py
    splits the step and counts its device operations). Returns (metrics,
    env, states, step rewards)."""
    import tempfile

    from mpopis_tpu_torch.harness.simulate import PORTED_MUJOCO_TASKS, simulate_mujoco_on_device

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as acts_dir:
        _zero_counts()
        m = simulate_mujoco_on_device(
            task, num_trials=1, num_steps=steps - 1, num_samples=k, horizon=horizon, lam=lam,
            ais_its=its, ce_sigma_est="mle", cov_mat=cov, seed=seed, device="cuda",
            dtype=torch.float32, output_acts_file=True, acts_dir=acts_dir, print_output=False,
        )
        counts = _counts()
        (csv,) = [os.path.join(acts_dir, f) for f in os.listdir(acts_dir)]
        acts = np.loadtxt(csv, delimiter=",", ndmin=2)
    _require(len(acts) == steps, f"{task}: {len(acts)} executed steps for {steps}")
    sps = float(m["control_steps_per_s"][0])
    print(f"{label} {task} K={k} H={horizon} {its} its: reward {float(m['rewards'][0]):.4f} "
          f"over {len(acts)} executed steps, {sps:.3f} control steps/s ({1e3 / sps:.3f} ms a "
          f"control step; {card}), ais_iterations {int(m['ais_iterations'][0])} "
          f"({time.perf_counter() - t_phase:.1f} s)")
    _require(not any(counts.values()), f"{task}: a kernel launched: {counts}")
    _require(np.isfinite(m["rewards"][0]), f"{task}: non-finite reward")
    env = PORTED_MUJOCO_TASKS[task](dtype=torch.float32, device="cuda")
    states, rews = [env.reset()], []
    for a in acts:
        s2, r = env.step_reward(states[-1], torch.as_tensor(a, dtype=torch.float32, device="cuda"))
        states.append(s2)
        rews.append(float(r))
    return m, env, states, rews


def _reacher_path(card: str) -> list:
    """Phase 42: the Reacher at the JAX bench's configuration, the JAX test's
    criterion after 30 steps (the fingertip's distance under half its start
    and under 0.03)."""
    m, env, states, _ = _plain_task("phase 42:", "Reacher-v4", RK, RH, RITS, RLAM, (0.02, 0.02),
                                    PLAIN_STEPS, 2, card)
    d0, d1 = -float(env.reward(states[0])), -float(env.reward(states[PLAIN_STEPS]))
    print(f"phase 42: the fingertip's distance to the target {d0:.4f} at the reset, {d1:.4f} "
          f"after {PLAIN_STEPS} steps (criterion: < {0.5 * d0:.4f} and < 0.03)")
    _require(d1 < 0.5 * d0 and d1 < 0.03, "the Reacher did not reach its target")
    return []


def _pendulums_path(card: str) -> list:
    """Phases 43-44: InvertedDoublePendulum with the JAX test's criterion
    (reward > 9·30 over 30 steps) and InvertedPendulum healthy at every
    step."""
    m, env, states, rews = _plain_task("phase 43:", "InvertedDoublePendulum-v4", PEND_K, PEND_H,
                                       PEND_ITS, PEND_LAM, (0.1,), PLAIN_STEPS, 3, card)
    total = float(np.sum(rews[:PLAIN_STEPS]))
    print(f"phase 43: InvertedDoublePendulum reward over {PLAIN_STEPS} steps {total:.4f} "
          f"(criterion > {9.0 * PLAIN_STEPS}); the poles at {float(states[PLAIN_STEPS].x[1]):.4f}"
          f" / {float(states[PLAIN_STEPS].x[2]):.4f} rad, the cart at "
          f"{float(states[PLAIN_STEPS].x[0]):.4f}")
    _require(total > 9.0 * PLAIN_STEPS, "the double pendulum fell")
    m, env, states, rews = _plain_task("phase 44:", "InvertedPendulum-v4", PEND_K, PEND_H,
                                       PEND_ITS, PEND_LAM, (0.1,), PLAIN_STEPS, 3, card)
    worst = max(abs(float(s.x[1])) for s in states)
    print(f"phase 44: InvertedPendulum healthy at {int(sum(rews))} of {len(rews)} steps, "
          f"max |θ| {worst:.4f}")
    _require(sum(rews) == len(rews) and m["rewards"][0] == len(rews),
             "the pendulum left its healthy range")
    return []


def _classic_path(card: str) -> list:
    """Phase 45: MountainCar and CartPole at the CLI's defaults (CEMPPI,
    K=20, H=15, λ=0.1, 5 AIS iterations, λ_ais=0.1, `mle`, Σ=1.5)."""
    from mpopis_tpu_torch.harness.simulate import simulate_cartpole, simulate_mountaincar

    common = dict(policy_type="cemppi", num_samples=20, horizon=15, lam=0.1, ais_its=5,
                  lambda_ais=0.1, ce_sigma_est="mle", seed=SEED, device="cuda",
                  dtype=torch.float32, print_output=False)
    for name, run, trials in (("MountainCar", simulate_mountaincar, 2),
                              ("CartPole", simulate_cartpole, 1)):
        t_phase = time.perf_counter()
        _zero_counts()
        m = run(num_trials=trials, num_steps=200, **common)
        print(f"phase 45: {name}: rewards {json.dumps([round(float(r), 4) for r in m['rewards']])}"
              f" over {json.dumps([int(s) for s in m['steps']])} steps, control steps/s "
              f"{json.dumps([round(float(r), 3) for r in m['control_steps_per_s']])} "
              f"({time.perf_counter() - t_phase:.1f} s; {card})")
        _require(not any(_counts().values()), f"{name}: a kernel launched")
        _require(bool(np.all(np.isfinite(m["rewards"]))), f"{name}: non-finite rewards")
        if name == "MountainCar":
            _require(float(np.max(m["rewards"])) > 9e4, "no MountainCar trial reached the goal")
    return []


# -- the sample axis over several ranks ---------------------------------------

# phase 49 races on a one-rank nccl mesh; phases 50-51 run two gloo ranks that
# share the card, each launching the rollout kernels on its block of samples
SHARDED_RACE_STEPS = 100
SHARDED_TIMEOUT = 300.0


def _sharded_runs() -> list:
    """The two-rank runs of phases 50-51: the one-car CEMPPI step (f32 and
    f64, 20 steps; at K − 1, blocks of uneven size, 5 steps), the 3-car
    CMAMPPI race's step (10 steps) and HalfCheetah's CEMPPI step (5 steps),
    each at the car or planar path's configuration."""
    car = dict(kind="cemppi", horizon=H, lam=10.0, opt_its=ITS, sigma_est="ss")
    cov = np.diag([0.0625, 0.1])
    runs = [dict(id=f"car {name} K={n}", task="car", dtype=dtype, cov=cov, steps=steps,
                 cfg=dict(car, num_samples=n))
            for n, steps in ((K, 20), (K - 1, 5))
            for name, dtype in (("f32", torch.float32), ("f64", torch.float64))]
    runs.append(dict(id=f"3 cars CMAMPPI K={K}", task="cars3", dtype=torch.float32,
                     cov=np.diag([0.0625, 0.1] * 3), steps=10,
                     cfg=dict(kind="cmamppi", num_samples=K, horizon=H, lam=10.0,
                              opt_its=ITS, cma_sigma=0.75)))
    runs.append(dict(id=f"HalfCheetah CEMPPI K={PK}", task="cheetah", dtype=torch.float32,
                     cov=[0.25] * 6, steps=5,
                     cfg=dict(kind="cemppi", num_samples=PK, horizon=PH, lam=PLAM,
                              opt_its=PITS, sigma_est="mle")))
    return runs


def _sharded_env(task, dtype, device):
    from mpopis_tpu_torch.models import CarRacingEnv, CheetahDeviceEnv, MultiCarRacingEnv

    if task == "car":
        return CarRacingEnv(dtype=dtype, device=device)
    if task == "cars3":
        return MultiCarRacingEnv(num_cars=3, dtype=dtype, device=device)
    return CheetahDeviceEnv(dtype=dtype, device=device)


def _closed_loop(pol, env, steps, device):
    """`steps` control steps from the reset (policy seed SEED): per step the
    action, the next U, the K costs and the iterations run; and each step's
    seconds."""
    s, ps, recs, secs = env.reset(), pol.init_state(SEED), [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        a, ps, info = pol.step(s, ps)
        s = env.step(s, a)
        _sync(device)
        secs.append(time.perf_counter() - t0)
        recs.append({"action": a.cpu().numpy(), "U": ps.U.cpu().numpy(),
                     "costs": info["costs"].cpu().numpy(), "ais_its": info["ais_its"]})
    return recs, secs


def _sharded_rank(rank, world_size, init_method, runs, out_dir):
    """One gloo rank of phases 50-51, every rank on the one card: each
    run's steps on the mesh (the kernel counts read around them), then rank
    0's single-process twin, alone while the others wait; pickled into
    `out_dir/rank<r>.pkl`."""
    import datetime
    import pickle

    import torch.distributed as dist

    from mpopis_tpu_torch.parallel import distributed_init, make_sample_mesh
    from mpopis_tpu_torch.policies import PolicyConfig, make_policy

    distributed_init("gloo", init_method=init_method, world_size=world_size, rank=rank,
                     timeout=datetime.timedelta(seconds=SHARDED_TIMEOUT))
    try:
        mesh = make_sample_mesh(device="cuda:0")
        probe = torch.full((2,), rank + 1.0, device=mesh.device)
        dist.all_reduce(probe, group=mesh.group)
        want = world_size * (world_size + 1) / 2
        # one write a line: the ranks share the parent's stdout
        print(f"phase 50: rank {rank}: gloo all_reduce of a tensor on {mesh.device}: "
              f"{probe.tolist()} (want {want:g})\n", end="", flush=True)
        _require(bool(torch.all(probe == want)), f"gloo all_reduce on {mesh.device}")
        out = {}
        for run in runs:
            env = _sharded_env(run["task"], run["dtype"], mesh.device)
            cfg = PolicyConfig(**run["cfg"])
            pol = make_policy(env, cfg, cov_mat=run["cov"], sample_mesh=mesh)
            _zero_counts()
            rec = {"block": mesh.block(cfg.num_samples)}
            rec["sharded"], rec["seconds"] = _closed_loop(pol, env, run["steps"], mesh.device)
            rec["counts"] = _counts()
            dist.barrier(group=mesh.group)
            if rank == 0:
                _zero_counts()
                twin = make_policy(env, cfg, cov_mat=run["cov"])
                rec["twin"], rec["twin_seconds"] = _closed_loop(twin, env, run["steps"],
                                                                mesh.device)
                rec["twin_counts"] = _counts()
            dist.barrier(group=mesh.group)
            out[run["id"]] = rec
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def _steps_per_s(secs) -> float:
    """Control steps/s from the median step after the first."""
    return 1.0 / float(np.median(secs[1:] if len(secs) > 1 else secs))


def _sharded_report(runs, ranks, card) -> None:
    """Phases 50-52 from the ranks' records: every rank's actions, costs and
    U equal the single-process twin's bit for bit, and each rank launched
    its kernel once an AIS iteration; then the timings."""
    kernel = {"car": "car_rollout", "cars3": "car_rollout", "cheetah": "planar_rollout"}
    for run in runs:
        twin = ranks[0][run["id"]]["twin"]
        equal = []
        for out in ranks:
            rec = out[run["id"]]["sharded"]
            same = len(rec) == len(twin)
            for got, want in zip(rec, twin):
                same = same and got["ais_its"] == want["ais_its"] and all(
                    np.array_equal(got[key], want[key]) for key in ("action", "U", "costs"))
            equal.append(same)
        calls = [sum(r["ais_its"] for r in out[run["id"]]["sharded"]) for out in ranks]
        launches = [out[run["id"]]["counts"][kernel[run["task"]]] for out in ranks]
        blocks = [out[run["id"]]["block"] for out in ranks]
        phase = 51 if run["task"] != "car" else 50
        print(f"phase {phase}: {run['id']} ({run['dtype']}), {run['steps']} steps on "
              f"{len(ranks)} gloo ranks, blocks {json.dumps(blocks)}: actions, costs and U "
              f"bit-equal to the single-process step: {equal}; {kernel[run['task']]} launches "
              f"per rank {launches}, rollout calls {calls}")
        _require(all(equal), f"{run['id']}: a rank differs from the single-process step")
        _require(launches == calls and min(launches) > 0,
                 f"{run['id']}: a rank did not run its rollouts on {kernel[run['task']]}")
    for run in runs:
        rates = [_steps_per_s(out[run["id"]]["seconds"]) for out in ranks]
        alone = _steps_per_s(ranks[0][run["id"]]["twin_seconds"])
        print(f"phase 52: {run['id']}: {' / '.join(f'{r:.3f}' for r in rates)} control steps/s "
              f"on ranks {'/'.join(str(r) for r in range(len(ranks)))} (two ranks time-sharing "
              f"one card — not a scaling figure) beside {alone:.3f} single-process ({card})")


def _sharded_path(card: str) -> list:
    """Phases 49-52: the race on a one-rank nccl mesh bit for bit against
    the race without one; two gloo ranks sharing the card against the
    single-process step; the timings. Returns the launches on the mesh, to
    join kernels 1 and 2's entries under "sharded"."""
    import pickle
    import tempfile

    import torch.distributed as dist

    from mpopis_tpu_torch.harness.simulate import simulate_car_racing
    from mpopis_tpu_torch.kernels import build
    from mpopis_tpu_torch.parallel import distributed_init, make_sample_mesh
    from mpopis_tpu_torch.parallel.mesh import spawn_ranks

    build.load_library("car_rollout")
    build.load_library("planar_rollout")

    # -- phase 49: the race on a one-rank nccl mesh -----------------------------
    # in turns, without and with the mesh: plain, mesh, mesh, plain
    t_phase = time.perf_counter()
    race = dict(num_trials=1, num_steps=SHARDED_RACE_STEPS, num_samples=K, horizon=H, lam=10.0,
                ais_its=ITS, ce_sigma_est="ss", laps=2, seed=SEED, track="curve",
                device="cuda", dtype=torch.float32, print_output=False)
    races, counts = [], []
    with tempfile.TemporaryDirectory() as d:
        distributed_init("nccl", init_method=f"file://{os.path.join(d, 'group')}",
                         world_size=1, rank=0)
        try:
            mesh = make_sample_mesh()
            for sample_mesh in (None, mesh, mesh, None):
                _zero_counts()
                races.append(simulate_car_racing(sample_mesh=sample_mesh, **race))
                counts.append(_counts()["car_rollout"])
        finally:
            dist.destroy_process_group()
    timing = ("exec_times", "control_steps_per_s")
    differ = sorted({name for m in races[1:] for name in m if name not in timing
                     and not np.array_equal(races[0][name], m[name], equal_nan=True)})
    calls = [int(m["ais_iterations"].sum()) for m in races]
    m_mesh = races[1]
    print(f"phase 49: race K={K} H={H} {ITS} its f32, {SHARDED_RACE_STEPS} steps on a one-rank "
          f"nccl mesh ({mesh.device}): laps {json.dumps(m_mesh['lap_times'][:, 0].tolist())}, "
          f"{int(m_mesh['track_violations'][0])} track / {int(m_mesh['beta_violations'][0])} β "
          f"violations, reward {float(m_mesh['rewards'][0]):.4f}; metrics of the mesh's races "
          f"bit-equal to the races without one: {not differ} {differ}; kernel 1 launches "
          f"{counts}, rollout calls {calls} (without, with, with, without); control steps/s "
          f"{json.dumps([round(float(m['control_steps_per_s'][0]), 3) for m in races])} ({card}) "
          f"({time.perf_counter() - t_phase:.1f} s)")
    _require(not differ, f"the one-rank mesh's race differs in {differ}")
    _require(counts == calls and min(counts) > 0, "a race did not run every rollout on kernel 1")

    # -- phases 50-52: two gloo ranks sharing the card --------------------------
    t_phase = time.perf_counter()
    runs = _sharded_runs()
    with tempfile.TemporaryDirectory() as d:
        spawn_ranks(_sharded_rank, 2, args=(2, f"file://{os.path.join(d, 'group')}", runs, d),
                    timeout=SHARDED_TIMEOUT)
        ranks = []
        for r in range(2):
            with open(os.path.join(d, f"rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
    _sharded_report(runs, ranks, card)
    print(f"phase 50: two ranks {time.perf_counter() - t_phase:.1f} s")
    # the launches of each kernel on the mesh: phase 49's first race on the
    # one-rank mesh, and each of the two ranks in phases 50-51 (runs summed)
    two = {name: [sum(out[run["id"]]["counts"][name] for run in runs) for out in ranks]
           for name in ("car_rollout", "planar_rollout")}
    return [{"name": "car_rollout", "under": "sharded", "launches": counts[1],
             "launches_per_rank_two_ranks": two["car_rollout"]},
            {"name": "planar_rollout", "under": "sharded",
             "launches_per_rank_two_ranks": two["planar_rollout"]}]


# -- checkpoints, gifs and the host engine ----------------------------------

# the reference's car configuration (car_example.jl; bench.py:243-264):
# CEMPPI, K=150, H=50, 10 AIS iterations, `ss`, λ=10, Σ=diag(0.0625, 0.1)
RK150 = dict(kind="cemppi", num_samples=150, horizon=H, lam=10.0, opt_its=ITS, sigma_est="ss")
RESUME_STEPS, GIF_STEPS, PLOT_STEPS, HOST_STEPS = 3, 10, 2, 5
# BASELINE.md row 1, the reference's one published result: HalfCheetah-v4,
# CEMPPI, K=100, H=50, 5 AIS iterations, λ=1, Σ=0.25·I₆, frame skip 5, `ss`,
# seed 1, 2 trials × 50 steps
BASELINE_ROW1 = dict(frame_skip=5, num_trials=2, num_steps=50, policy_type="cemppi",
                     num_samples=100, horizon=50, lam=1.0, ais_its=5, ce_sigma_est="ss",
                     seed=1, cov_mat=0.25 * np.eye(6))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def resume_run(device, cfg_kw, steps, dtype=torch.float32):
    """A car run of 2·`steps` control steps, checkpointed after `steps` and
    resumed from the file for `steps` more: returns (the uninterrupted run's
    actions, the resumed run's, the kernel counts of the uninterrupted run,
    the PhaseTimer report of its steps and the resumed ones after a warm-up
    step, timed's ms of a policy step)."""
    import tempfile

    from mpopis_tpu_torch.models import CarRacingEnv
    from mpopis_tpu_torch.policies import PolicyConfig, make_policy
    from mpopis_tpu_torch.utils import PhaseTimer, load_checkpoint, save_checkpoint, timed

    env = CarRacingEnv(dtype=dtype, device=device)
    pol = make_policy(env, PolicyConfig(**cfg_kw), cov_mat=np.diag([0.0625, 0.1]))
    # one step of another seed first, so that the timer holds no first-call set-up
    env.step(env.reset(), pol.step(env.reset(), pol.init_state(SEED + 1))[0])
    timer = PhaseTimer()

    def run(s, ps, n):
        acts = []
        for _ in range(n):
            with timer.phase("policy step"):
                a, ps, _ = pol.step(s, ps)
                _sync(device)
            with timer.phase("env step"):
                s = env.step(s, a)
                _sync(device)
            acts.append(a.cpu().numpy())
        return acts, s, ps

    _zero_counts()
    first, s, ps = run(env.reset(), pol.init_state(SEED), steps)
    with tempfile.TemporaryDirectory() as d:
        path = save_checkpoint(os.path.join(d, "ck"), ps, s, step=steps)
        direct, s_direct, _ = run(s, ps, steps)
        counts = _counts()
        ps_r, s_r, step, _ = load_checkpoint(path, dtype=dtype, device=device)
    _require(step == steps, f"the checkpoint's step {step} for {steps}")
    resumed, s_resumed, ps_r = run(s_r, ps_r, steps)
    _require(bool(torch.equal(s_resumed.x, s_direct.x)), "the resumed state differs")
    step_s = timed(pol.step, s_resumed, ps_r, iters=5, warmup=2)
    return (np.stack(first + direct), np.stack(first + resumed), counts, timer.report(),
            1e3 * step_s)


class HostStub:
    """A numpy stand-in for the host engine's surface (num_envs, action_dim,
    action bounds, step, snapshot, restore): K point masses driven by their
    actions, each paying its distance from a target. For the host driver
    where mujoco is missing."""

    def __init__(self, num_envs: int, action_dim: int = 6):
        self.num_envs, self.action_dim = num_envs, action_dim
        self.action_low, self.action_high = -np.ones(action_dim), np.ones(action_dim)
        self.target = np.linspace(-0.5, 0.5, action_dim)
        self.x = np.zeros((num_envs, action_dim))
        self.rews = np.zeros(num_envs)
        self._snap = None

    def step(self, actions):
        actions = np.asarray(actions, dtype=np.float64)
        if actions.ndim == 1:
            actions = np.tile(actions, (self.num_envs, 1))
        self.x = self.x + 0.1 * actions
        self.rews = -np.sum((self.x - self.target) ** 2, axis=1)
        return self.x, self.rews

    def snapshot(self):
        self._snap = self.x.copy()

    def restore(self):
        self.x = self._snap.copy()


def host_policy_run(device, kind, k, horizon, its, steps):
    """`steps` closed-loop host-driver steps (f64 policy math on `device`) on
    a `HostStub`, with normals drawn by numpy: returns the actions."""
    from mpopis_tpu_torch.policies import PolicyConfig
    from mpopis_tpu_torch.policies.host_driver import make_host_policy

    env = HostStub(k)
    cfg = PolicyConfig(kind=kind, num_samples=k, horizon=horizon, lam=1.0, opt_its=its,
                       sigma_est="ss")
    pol = make_host_policy(env, cfg, cov_mat=0.25 * np.eye(6), device=device)
    ps, rng, acts = pol.init_state(SEED), np.random.default_rng(SEED), []
    shape = (k, horizon, 6) if kind == "mppi" else (its, 6 * horizon, k)
    for _ in range(steps):
        act, ps, _ = pol.step(ps, z=torch.as_tensor(rng.standard_normal(shape), device=device))
        env.step(act)
        acts.append(act)
    return np.stack(acts)


def gif_run(device, cfg_kw, gif_steps, plot_steps, out_dir, dtype=torch.float32):
    """The car race with `save_gif` for `gif_steps` control steps, then with
    `plot_traj` for `plot_steps`: returns (the gif's path, its frames, the
    kernel counts of each run, the metrics of each run)."""
    import imageio.v2 as imageio

    from mpopis_tpu_torch.harness.simulate import simulate_car_racing

    race = dict(num_trials=1, policy_type=cfg_kw["kind"], num_samples=cfg_kw["num_samples"],
                horizon=cfg_kw["horizon"], lam=cfg_kw["lam"], ais_its=cfg_kw["opt_its"],
                ce_sigma_est=cfg_kw["sigma_est"], seed=SEED, device=device, dtype=dtype,
                print_output=False)
    gif = os.path.join(out_dir, "race.gif")
    _zero_counts()
    m_gif = simulate_car_racing(num_steps=gif_steps - 1, save_gif=True, gif_name=gif, **race)
    c_gif = _counts()
    _zero_counts()
    m_plot = simulate_car_racing(num_steps=plot_steps - 1, plot_traj=True, **race)
    c_plot = _counts()
    return gif, len(imageio.mimread(gif)), (c_gif, c_plot), (m_gif, m_plot)


def replay_in_gymnasium(csv_path: str, env_name: str) -> float:
    """Total reward of an action CSV stepped through gymnasium from the
    engine's deterministic reset."""
    import gymnasium

    actions = np.loadtxt(csv_path, delimiter=",", ndmin=2)
    try:
        env = gymnasium.make(env_name, reset_noise_scale=0.0)
    except TypeError:
        env = gymnasium.make(env_name)
    env.reset(seed=1)
    env.unwrapped.set_state(env.unwrapped.init_qpos, env.unwrapped.init_qvel)
    total = 0.0
    for a in actions:
        _, r, term, trunc, _ = env.step(a)
        total += float(r)
        if term or trunc:
            break
    env.close()
    return total


def host_run(device, config, acts_dir):
    """`simulate_mujoco("HalfCheetah-v4", **config)` with the policy math on
    `device`: returns (metrics, each trial's gymnasium replay reward, the
    kernel counts)."""
    from mpopis_tpu_torch.harness.simulate_mujoco import simulate_mujoco

    _zero_counts()
    m = simulate_mujoco("HalfCheetah-v4", output_acts_file=True, acts_dir=acts_dir,
                        print_output=False, device=device, **config)
    counts = _counts()
    csvs = sorted(os.listdir(acts_dir), key=lambda f: int(f.rsplit("trial-", 1)[1][:-4]))
    _require(len(csvs) == config["num_trials"], f"{len(csvs)} action CSVs")
    replays = [replay_in_gymnasium(os.path.join(acts_dir, f), "HalfCheetah-v4") for f in csvs]
    return m, replays, counts


def _resume_path(card: str) -> list:
    """Phase 46: a checkpointed and resumed car run on the card equals the
    uninterrupted one bit for bit."""
    t_phase = time.perf_counter()
    uninterrupted, resumed, counts, report, step_ms = resume_run("cuda", RK150, RESUME_STEPS)
    _require(counts["car_rollout"] > 0, f"kernel 1 did not launch: {counts}")
    same = bool(np.array_equal(uninterrupted, resumed))
    print(f"phase 46: car CEMPPI K=150 H={H} {ITS} its f32: {RESUME_STEPS} steps, a checkpoint, "
          f"{RESUME_STEPS} more; resumed from the file: actions bit-equal={same} (max |diff| "
          f"{float(np.max(np.abs(uninterrupted - resumed))):.3e}); kernel 1 launched "
          f"{counts['car_rollout']} times in the uninterrupted run")
    for line in report.splitlines():
        print(f"phase 46: PhaseTimer: {line}")
    print(f"phase 46: timed(policy step) {step_ms:.3f} ms a call (5 calls after 2; {card}) "
          f"({time.perf_counter() - t_phase:.1f} s)")
    _require(same, "the resumed run differs from the uninterrupted one")
    hk, hh, hits = (BASELINE_ROW1[n] for n in ("num_samples", "horizon", "ais_its"))
    for kind in ("cemppi", "mppi"):
        t0 = time.perf_counter()
        on_card = host_policy_run("cuda", kind, hk, hh, hits, HOST_STEPS)
        card_s = time.perf_counter() - t0
        on_cpu = host_policy_run("cpu", kind, hk, hh, hits, HOST_STEPS)
        err = float(np.max(np.abs(on_card - on_cpu)))
        print(f"phase 46: host driver {kind} K={hk} H={hh} {hits} its f64 on the card over the "
              f"numpy stand-in, {HOST_STEPS} steps ({1e3 * card_s / HOST_STEPS:.1f} ms a step): "
              f"max |action - the CPU's| {err:.3e} (bound 1e-9)")
        _require(err <= 1e-9, f"the host driver's {kind} on the card differs from the CPU's")
    return []


def _gif_path(card: str) -> list:
    """Phase 47: the car race's gif (kernel 1 on the path) and its
    trajectory plots (the plain rollout, as in the JAX package)."""
    import tempfile

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        gif, n_frames, (c_gif, c_plot), (m_gif, m_plot) = gif_run(
            "cuda", RK150, GIF_STEPS, PLOT_STEPS, d)
        size = os.path.getsize(gif)
    print(f"phase 47: car race K=150 with save_gif: {n_frames} frames for {GIF_STEPS} steps "
          f"({size} bytes), reward {float(m_gif['rewards'][0]):.4f}, kernel 1 launched "
          f"{c_gif['car_rollout']} times; {PLOT_STEPS} steps with plot_traj: reward "
          f"{float(m_plot['rewards'][0]):.4f}, kernel 1 launched {c_plot['car_rollout']} times "
          f"({time.perf_counter() - t_phase:.1f} s)")
    _require(n_frames == GIF_STEPS, f"{n_frames} gif frames for {GIF_STEPS} steps")
    _require(c_gif["car_rollout"] >= GIF_STEPS, f"kernel 1 did not carry the gif race: {c_gif}")
    _require(c_plot["car_rollout"] == 0, "the logged rollouts launched kernel 1")
    _require(bool(np.all(np.isfinite(m_gif["rewards"]))) and m_plot["steps"][0] == PLOT_STEPS - 1,
             "the gif races did not run")
    return []


def _host_path(card: str) -> list:
    """Phase 48: the host engine at BASELINE.md row 1, the policy math on the
    card; each trial's action CSV replays in gymnasium to its reward."""
    import tempfile

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        m, replays, counts = host_run("cuda", BASELINE_ROW1, d)
    print(f"phase 48: host engine HalfCheetah-v4 CEMPPI K=100 H=50 5 its (BASELINE.md row 1), "
          f"policy math f64 on the card: rewards {json.dumps([float(r) for r in m['rewards']])} "
          f"over {json.dumps([int(s) for s in m['steps']])} steps, control steps/s "
          f"{json.dumps([float(r) for r in m['control_steps_per_s']])}, host cores "
          f"{os.cpu_count()} ({card}); gymnasium replays {json.dumps(replays)} "
          f"({time.perf_counter() - t_phase:.1f} s)")
    _require(not any(counts.values()), f"a kernel launched on the host path: {counts}")
    _require(bool(np.all(np.isfinite(m["rewards"]))), "non-finite rewards")
    _require(bool(np.allclose(replays, m["rewards"], rtol=1e-9, atol=1e-9)),
             "the gymnasium replays differ from the trials' rewards")
    return []


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
