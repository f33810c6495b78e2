"""Chip smoke test of the PyTorch + CUDA port (`mpopis_tpu_torch`).

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the kernels of `mpopis_tpu_torch/csrc/` with nvcc (one process
per library, all at once) and drives the port's two paths:

- phases 1-5, the car: the car rollout kernel against its plain PyTorch
  version, a car race with CEMPPI at K=8192, H=50, 10 AIS iterations,
  `ss`, λ=10 through the harness (every rollout on the kernel, clean
  laps), and the kernel's time against the plain version's;
- phases 6-10, the planar-contact MuJoCo tasks: the planar rollout kernel
  and its control-step entry against their plain versions for HalfCheetah,
  Hopper and Walker2d (f32 at the JAX kernel tests' tolerances, f64 by its
  median relative error beside the plain version's own spread under a
  nudge of its controls), the f64 CEMPPI step through the kernel against
  the plain path, `simulate_mujoco_on_device` for the three tasks (HalfCheetah at
  K=2048, H=15, 3 AIS iterations, `mle`, λ=0.1), and the timings.

Every kernel's launch count is set to 0 just before each path and read
just after. Every phase raises on failure; there is no CPU path. The last
two lines are a JSON line of per-kernel numbers and the result line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

K, H, ITS = 8192, 50, 10
SEED = 1
RACE_STEPS = 1000
# the planar-contact path: the JAX package's end-to-end contact configuration
PK, PH, PITS, PLAM = 2048, 15, 3, 0.1
CHEETAH_STEPS, OTHER_STEPS = 200, 50
# x[1] lowered so that contacts fire at once: HalfCheetah as the JAX contact
# kernel test, Hopper by 0.1 from its 1.25 (9 contact rows), Walker2d by 0.08
# (18 contact rows, as at 1.15, where one of the JAX test's 5 f32 samples
# switches contact differently in the kernel and the plain version; at 1.19
# the feet sit exactly on the floor)
DROP = {"HalfCheetah-v4": -0.35, "Hopper-v4": 1.15, "Walker2d-v4": 1.17}
# relative nudge of the controls: a few ulps (the states are not nudged, as a
# joint at 0 sits exactly on Hopper's and Walker2d's knee limits)
NUDGE = {torch.float64: 1e-15, torch.float32: 1e-6}


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


def _candidates(k, horizon, seed, dtype):
    """Clamped candidate controls (T, 2, K) as the CEMPPI step forms them
    in its first iteration: U = 0 plus N(0, diag(0.0625, 0.1)) noise."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    std = torch.tensor([0.25, 0.1**0.5], dtype=dtype, device="cuda")
    z = torch.randn((horizon, 2, k), generator=g, dtype=dtype, device="cuda")
    return torch.clamp(z * std[None, :, None], -1.0, 1.0).contiguous()


def _uniform(k, horizon, na, seed, dtype):
    ctrl = np.random.default_rng(seed).uniform(-1, 1, size=(horizon, na, k))
    return torch.as_tensor(ctrl, dtype=dtype, device="cuda")


def _zero_counts():
    from mpopis_tpu_torch.kernels import car_rollout, planar_step

    car_rollout.LAUNCHES = 0
    planar_step.LAUNCHES = 0
    planar_step.STEP_LAUNCHES = 0


def _counts() -> dict:
    from mpopis_tpu_torch.kernels import car_rollout, planar_step

    return {"car_rollout": car_rollout.LAUNCHES, "planar_rollout": planar_step.LAUNCHES,
            "planar_step_states": planar_step.STEP_LAUNCHES}


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

        # f64, K=2048 T=15: median relative error ≤ 1e-9, with the plain
        # version's own spread under controls·(1 + 1e-15) beside it
        ctrl64 = _uniform(PK, PH, na, 2048, torch.float64)
        for start in ("reset", "lowered"):
            env64, x64 = env_x(task, torch.float64, drop=start == "lowered")
            want = ref(env64, x64, ctrl64)
            rel = _rel_err(kern(env64, x64, ctrl64), want)
            rel_pert = _rel_err(ref(env64, x64, ctrl64 * (1 + NUDGE[torch.float64])), want)
            med, med_pert = float(np.median(rel)), float(np.median(rel_pert))
            print(f"phase 7: {task} f64 K={PK} T={PH} from {start}: rel err max {rel.max():.3e} "
                  f"median {med:.3e}, {int(np.sum(rel > 1e-9))} of {PK} beyond 1e-9; "
                  f"plain vs plain at controls·(1+1e-15): "
                  f"max {rel_pert.max():.3e} median {med_pert:.3e}, "
                  f"{int(np.sum(rel_pert > 1e-9))} beyond")
            _hold(f"{task} f64 from {start}: kernel median relative error", med, med_pert, 1e-9)

        # f32, K=2048 T=15, from reset: median relative error < 2e-4
        env, x = env_x(task, torch.float32)
        ctrl32 = ctrl64.float()
        got, want = kern(env, x, ctrl32), ref(env, x, ctrl32)
        rel32 = _rel_err(got, want)
        max_abs = float(torch.max(torch.abs(got - want)))
        print(f"phase 7: {task} f32 K={PK} T={PH} from reset: rel err max {rel32.max():.3e} "
              f"median {np.median(rel32):.3e}, {int(np.sum(rel32 > 2e-4))} of {PK} beyond 2e-4, "
              f"max|err| {max_abs:.3e}")
        _require(bool(torch.all(torch.isfinite(got))), f"{task}: non-finite f32 kernel costs")
        _require(float(np.median(rel32)) < 2e-4, f"{task}: f32 median relative error >= 2e-4")
        results[task] = {"max_abs_err": max_abs, "median_rel_err_f32": float(np.median(rel32))}

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
            rel_pert = _rel_state_err(env.plain_step(make_state(xs), acts * (1 + NUDGE[dtype])).x,
                                      want)
            name = str(dtype)[6:]
            results[task][f"step_max_abs_err_{name}"] = float((got - want).abs().max())
            print(f"phase 7: {task} planar_step_states {name} B=256 from the lowered start "
                  f"±0.05: rel err max {rel.max():.3e} median {np.median(rel):.3e}, "
                  f"{int(np.sum(rel > bound))} beyond {bound:g}; plain vs plain at actions·(1 + "
                  f"{NUDGE[dtype]:g}): max {rel_pert.max():.3e} median {np.median(rel_pert):.3e}, "
                  f"{int(np.sum(rel_pert > bound))} beyond")
            _hold(f"{task} {name} step kernel: median relative error", float(np.median(rel)),
                  float(np.median(rel_pert)), bound)
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
    outs = []
    for cls, fused, nudge in ((CheetahDeviceEnv, True, 0.0), (PlainCheetah, False, 0.0),
                              (PlainCheetah, False, NUDGE[torch.float64])):
        env64 = cls(dtype=torch.float64, device="cuda")
        cfg = PolicyConfig(kind="cemppi", num_samples=PK, horizon=PH, lam=PLAM, opt_its=PITS,
                           sigma_est="mle", use_fused_rollout=fused)
        pol = make_policy(env64, cfg, cov_mat=0.25 * np.eye(6))
        _zero_counts()
        t0 = time.perf_counter()
        a, ps, inf = pol.step(env64.reset(), pol.init_state(0), z=z * (1 + nudge))
        torch.cuda.synchronize()
        outs.append((a, ps.U, inf["ais_its"], time.perf_counter() - t0, _counts()))
    (a_k, u_k, its_k, s_k, n_k), (a_p, u_p, its_p, s_p, n_p), (a_n, u_n, its_n, _, _) = outs
    err_a, err_u = _rel_norm(a_k, a_p), _rel_norm(u_k, u_p)
    own_a, own_u = _rel_norm(a_n, a_p), _rel_norm(u_n, u_p)
    print(f"phase 8: HalfCheetah CEMPPI f64 step K={PK} H={PH}: kernel path {its_k} its "
          f"{s_k:.2f} s, launches {json.dumps(n_k)}; plain path {its_p} its {s_p:.2f} s, "
          f"launches {json.dumps(n_p)}; kernel vs plain, max|Δ| / max|plain|: action {err_a:.3e}, "
          f"U {err_u:.3e} (bound 1e-8); plain vs plain at z·(1+1e-15): {its_n} its, action "
          f"{own_a:.3e}, U {own_u:.3e} ({time.perf_counter() - t_phase:.1f} s)")
    _require(n_k["planar_rollout"] == its_k and n_k["planar_step_states"] == 0,
             "the kernel path did not roll out on the kernel")
    _require(n_p["planar_rollout"] == n_p["planar_step_states"] == 0,
             "the plain path launched a kernel")
    _require(its_k == its_p, "kernel and plain paths ran different iteration counts")
    _hold("CEMPPI step: action, kernel vs plain path", err_a, own_a, 1e-8)
    _hold("CEMPPI step: U, kernel vs plain path", err_u, own_u, 1e-8)

    # -- phase 9: the main path, simulate_mujoco_on_device ----------------------
    counts = {}
    for task, steps in (("HalfCheetah-v4", CHEETAH_STEPS), ("Hopper-v4", OTHER_STEPS),
                        ("Walker2d-v4", OTHER_STEPS)):
        t_phase = time.perf_counter()
        _zero_counts()
        m = simulate_mujoco_on_device(
            task, num_trials=1, num_steps=steps, num_samples=PK, horizon=PH, lam=PLAM,
            ais_its=PITS, ce_sigma_est="mle", seed=SEED, device="cuda", dtype=torch.float32,
        )
        counts[task] = _counts()
        its = int(m["ais_iterations"][0])
        rew, rps = float(m["rewards"][0]), float(m["rewards_per_step"][0])
        print(f"phase 9: {task} K={PK} H={PH} {PITS} its: reward {rew:.4f} over "
              f"{int(m['steps'][0])} steps ({rps:.4f} per step), "
              f"{float(m['control_steps_per_s'][0]):.3f} control steps/s, ais_iterations {its}, "
              f"kernel launches {json.dumps(counts[task])} "
              f"({time.perf_counter() - t_phase:.1f} s)")
        _require(counts[task]["planar_rollout"] == its > 0,
                 f"{task}: not every rollout ran on the kernel")
        _require(counts[task]["planar_step_states"] > steps,
                 f"{task}: the env step did not run on the kernel")
        _require(np.isfinite(rew), f"{task}: non-finite reward")
        if task == "HalfCheetah-v4":
            _require(rps > 0, "the cheetah did not run forward")

    # -- phase 10: timings by CUDA events, plain-kernel-kernel-plain ------------
    t_phase = time.perf_counter()
    times = {}
    for task in envs:
        env, x = env_x(task, torch.float32)
        ctrl = _uniform(PK, PH, envs[task].action_dim, 10, torch.float32)
        xs = x[None].contiguous()
        act = torch.zeros((1, envs[task].action_dim), device="cuda")
        runs = {
            "rollout": (lambda: kern(env, x, ctrl), lambda: ref(env, x, ctrl), 20, 1),
            "step": (lambda: planar_step.planar_step_states(env, xs, act),
                     lambda: env.plain_step(make_state(xs), act), 50, 5),
        }
        for name, (run_k, run_p, reps_k, reps_p) in runs.items():
            run_k()
            run_p()
            torch.cuda.synchronize()
            p_a = _time_ms(run_p, reps_p)
            k_a = _time_ms(run_k, reps_k)
            k_b = _time_ms(run_k, reps_k)
            p_b = _time_ms(run_p, reps_p)
            times[(task, name)] = ((k_a + k_b) / 2, (p_a + p_b) / 2)
            shape = f"K={PK} T={PH}" if name == "rollout" else "one state"
            print(f"phase 10: {task} {name} f32 {shape}: kernel {k_a:.4f} / {k_b:.4f} ms, "
                  f"plain {p_a:.3f} / {p_b:.3f} ms (CUDA events, plain-kernel-kernel-plain; "
                  f"{card})")
    k_ms, p_ms = times[("HalfCheetah-v4", "rollout")]

    # HalfCheetah's control step split in the main path's configuration:
    # host clock around synchronised calls, 20 steps after 3 of warm-up
    env = CheetahDeviceEnv(dtype=torch.float32, device="cuda")
    pol = make_policy(env, PolicyConfig(kind="cemppi", num_samples=PK, horizon=PH, lam=PLAM,
                                        opt_its=PITS, sigma_est="mle"),
                      cov_mat=0.25 * np.eye(6))
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
    print(f"phase 10: HalfCheetah control step over 20 steps (host clock, synchronised): "
          f"policy step median {np.median(split['policy']):.3f} ms (range "
          f"{min(split['policy']):.3f}-{max(split['policy']):.3f}; {PITS} rollout launches of "
          f"{k_ms:.3f} ms), env step median {np.median(split['env']):.3f} ms (range "
          f"{min(split['env']):.3f}-{max(split['env']):.3f})")
    print(f"phase 10: {time.perf_counter() - t_phase:.1f} s")

    cheetah = counts["HalfCheetah-v4"]
    ks_ms, ps_ms = times[("HalfCheetah-v4", "step")]
    return [{
        "name": "planar_rollout",
        "route": "cuda",
        "source": "mpopis_tpu_torch/csrc/planar_rollout.cu",
        "replaces": "mpopis_tpu/kernels/planar_step.py:47",
        "launches": cheetah["planar_rollout"],
        "max_abs_err": results["HalfCheetah-v4"]["max_abs_err"],
        "ms": k_ms,
        "plain_ms": p_ms,
        "median_rel_err_f32": results["HalfCheetah-v4"]["median_rel_err_f32"],
    }, {
        "name": "planar_step_states",
        "route": "cuda",
        "source": "mpopis_tpu_torch/csrc/planar_rollout.cu",
        "replaces": "mpopis_tpu/kernels/planar_step.py:92",
        "launches": cheetah["planar_step_states"],
        "max_abs_err": results["HalfCheetah-v4"]["step_max_abs_err_float32"],
        "ms": ks_ms,
        "plain_ms": ps_ms,
    }]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    from mpopis_tpu_torch.harness.simulate import simulate_car_racing
    from mpopis_tpu_torch.kernels import build, car_rollout, planar_step
    from mpopis_tpu_torch.models import CarRacingEnv
    from mpopis_tpu_torch.policies import PolicyConfig, make_policy

    # -- phase 0: the card -------------------------------------------------
    card = _card()
    print(f"phase 0: card {card!r}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- phase 1: build (every library at once, one nvcc each) ---------------
    t0 = time.perf_counter()
    build.build_all(["car_rollout", "planar_rollout"])
    build_s = time.perf_counter() - t0
    build.load_library("car_rollout")
    info = build.BUILD_INFO["car_rollout"]
    built = f"built in {info['seconds']:.1f} s" if info["seconds"] else "already built"
    print(f"phase 1: {info['so']} {built} (all libraries built in parallel in {build_s:.1f} s)")
    for line in _ptxas_lines(info["log"]):
        print("  ptxas:", line)

    # -- phase 2: kernel vs plain version ---------------------------------
    ref = car_rollout.car_rollout_costs_tak_reference
    kern = car_rollout.car_rollout_costs_tak

    class ThreeCars(CarRacingEnv):
        num_cars = 3

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
    env3 = ThreeCars(dtype=torch.float32, device="cuda")
    x3 = torch.tensor(
        [0, 0, np.deg2rad(90.0), 10, 0, 0, 0, 0, 5, 0, np.deg2rad(90.0), 10, 0, 0, 0, 0,
         -5, 0, np.deg2rad(90.0), 10, 0, 0, 0, 0], dtype=torch.float32, device="cuda",
    )
    ctrl = _uniform(40, 6, 6, 7, torch.float32)
    got, want = kern(env3, x3, ctrl, 6), ref(env3, x3, ctrl, 6)
    err = float(torch.max(torch.abs(got - want)))
    ok = bool(torch.allclose(got, want, rtol=2e-4, atol=2e-2))
    print(f"phase 2: f32 3 cars K=40 T=6: max|err| {err:.3e} (rtol 2e-4, atol 2e-2) ok={ok}")
    _require(ok, "f32 three-car kernel disagrees")

    ctrl64 = _candidates(K, H, 2, torch.float64)
    got, want = kern(env64, x64, ctrl64, H), ref(env64, x64, ctrl64, H)
    rel64 = _rel_err(got, want)
    max_abs_f64 = float(torch.max(torch.abs(got - want)))
    print(f"phase 2: f64 K={K} T={H}: max rel {rel64.max():.3e}, max|err| {max_abs_f64:.3e} "
          f"(rtol 1e-9)")
    _require(bool(torch.allclose(got, want, rtol=1e-9, atol=0.0)), "f64 kernel disagrees")

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
        num_trials=1, num_steps=100, num_samples=150, horizon=H, lam=10.0,
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

    run_kernel()
    run_plain()
    torch.cuda.synchronize()
    plain_a = _time_ms(run_plain, 3)
    kern_a = _time_ms(run_kernel, 50)
    kern_b = _time_ms(run_kernel, 50)
    plain_b = _time_ms(run_plain, 3)
    kernel_ms, plain_ms = (kern_a + kern_b) / 2, (plain_a + plain_b) / 2
    print(f"phase 5: f32 K={K} T={H}: kernel {kern_a:.4f} / {kern_b:.4f} ms, "
          f"plain {plain_a:.2f} / {plain_b:.2f} ms (CUDA events, plain-kernel-kernel-plain)")

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
    for tol in (0.0, 1e-30, 1e-30, 0.0) * 3:
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

    planar = _planar_path(card)

    print(card)
    print(json.dumps({"kernels": [{
        "name": "car_rollout",
        "route": "cuda",
        "source": "mpopis_tpu_torch/csrc/car_rollout.cu",
        "replaces": "mpopis_tpu/kernels/car_rollout.py:79",
        "launches": launches,
        "max_abs_err": max_abs_f32,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "max_abs_err_f64": max_abs_f64,
        "median_rel_err_f32": float(np.median(rel32)),
    }, *planar]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
