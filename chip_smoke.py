"""Chip smoke test of the PyTorch + CUDA port (`mpopis_tpu_torch`).

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the car rollout kernel from `mpopis_tpu_torch/csrc/` with nvcc,
holds it against its plain PyTorch version, drives the main path — a car
race with CEMPPI at K=8192, H=50, 10 AIS iterations, `ss`, λ=10 — through
the harness, checks that the race went through the kernel and lapped
cleanly, and times the kernel against the plain version. Every phase
raises on failure; there is no CPU path. The last two lines are a JSON
line of per-kernel numbers and the result line
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


def _time_ms(fn, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    from mpopis_tpu_torch.harness.simulate import simulate_car_racing
    from mpopis_tpu_torch.kernels import build, car_rollout
    from mpopis_tpu_torch.models import CarRacingEnv
    from mpopis_tpu_torch.policies import PolicyConfig, make_policy

    # -- phase 0: the card -------------------------------------------------
    card = _card()
    print(f"phase 0: card {card!r}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- phase 1: build ----------------------------------------------------
    t0 = time.perf_counter()
    build.load_library("car_rollout")
    info = build.BUILD_INFO["car_rollout"]
    built = f"built in {info['seconds']:.1f} s" if info["seconds"] else "already built"
    print(f"phase 1: {info['so']} {built} (build + load {time.perf_counter() - t0:.1f} s)")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())

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
    car_rollout.LAUNCHES = 0
    m = simulate_car_racing(
        num_trials=1, num_steps=RACE_STEPS, num_samples=K, horizon=H, lam=10.0,
        ais_its=ITS, ce_sigma_est="ss", laps=2, seed=SEED, device="cuda",
        dtype=torch.float32,
    )
    launches = car_rollout.LAUNCHES
    calls = int(m["ais_iterations"].sum())
    sps = float(m["control_steps_per_s"][0])
    print(f"phase 4: race K={K}: {int(m['steps'][0])} steps, lap 1 at "
          f"{int(m['lap1_times'][0])}, lap 2 at {int(m['lap2_times'][0])}, "
          f"{int(m['track_violations'][0])} track / {int(m['beta_violations'][0])} β "
          f"violations, {sps:.2f} control steps/s, kernel launches {launches}, "
          f"rollout calls {calls}")
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
          f"{int(m150['steps'][0])} steps")

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
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
