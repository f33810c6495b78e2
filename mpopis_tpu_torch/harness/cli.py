"""Command-line interface of the port:

    python -m mpopis_tpu_torch car --samples 8192 --horizon 50 --ais-its 10
    python -m mpopis_tpu_torch mujoco --on-device --env-name HalfCheetah-v4 \
        --samples 2048 --horizon 15 --ais-its 3 --lam 0.1 --ce-sigma-est mle

`car` and `mujoco` take the flags and defaults of the JAX package's
(`python -m mpopis_tpu ...`), plus `--device` (default `cuda`). `mujoco`
runs with `--on-device` for the tasks of `harness.simulate.PORTED_MUJOCO_TASKS`
(Ant-v4, HalfCheetah-v4, Hopper-v4, Humanoid-v4, HumanoidStandup-v4,
Pusher-v4, Swimmer-v4, Walker2d-v4); the other on-device tasks, the host
engine (no `--on-device`) and the other subcommands exit with "not yet
ported".
"""

from __future__ import annotations

import argparse
import warnings

from mpopis_tpu_torch.policies.config import POLICY_KINDS

_NOT_PORTED = ("mountaincar", "cartpole")


def _common(p: argparse.ArgumentParser, samples: int, horizon: int, lam: float,
            ais_its: int = 10, lambda_ais: float = 20.0,
            ce_sigma_est: str = "ss"):
    p.add_argument("--policy", default="cemppi", help=f"one of {POLICY_KINDS}")
    p.add_argument("--trials", type=int, default=1)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--samples", type=int, default=samples)
    p.add_argument("--horizon", type=int, default=horizon)
    p.add_argument("--lam", type=float, default=lam)
    p.add_argument("--alpha", type=float, default=1.0)
    p.add_argument("--ais-its", type=int, default=ais_its)
    p.add_argument("--lambda-ais", type=float, default=lambda_ais)
    p.add_argument("--ce-elite-threshold", type=float, default=0.8)
    p.add_argument("--ce-sigma-est", default=ce_sigma_est)
    p.add_argument("--cma-sigma", type=float, default=0.75)
    p.add_argument("--cma-elite-threshold", type=float, default=0.8)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--f64", action="store_true", help="use float64")
    p.add_argument(
        "--steps-per-call", type=int, default=None,
        help="control steps per host read-back (car: 1 only, other values are not yet "
        "ported; on-device mujoco: default 10)",
    )
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="mpopis_tpu_torch", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    car = sub.add_parser("car", help="car racing")
    _common(car, 150, 50, 10.0)
    car.add_argument("--cars", type=int, default=1)
    car.add_argument("--laps", type=int, default=2)
    car.add_argument("--track", default="curve")
    car.add_argument("--state-x-sigma", type=float, default=0.0)
    car.add_argument("--state-y-sigma", type=float, default=0.0)
    car.add_argument("--state-psi-sigma", type=float, default=0.0)
    car.add_argument("--save-gif", action="store_true")
    car.add_argument("--plot-traj", action="store_true")
    car.add_argument(
        "--sharded", action="store_true",
        help="shard the K rollouts across devices (not yet ported)",
    )

    from mpopis_tpu_torch.harness.simulate import PORTED_MUJOCO_TASKS

    mj = sub.add_parser("mujoco", help="MuJoCo tasks (on-device dynamics with --on-device)")
    _common(mj, 100, 50, 1.0)
    mj.add_argument("--env-name", default="HalfCheetah-v4")
    mj.add_argument("--frame-skip", type=int, default=None,
                    help="host engine only (not yet ported); on-device tasks use their gym value")
    mj.add_argument("--output-acts-file", action="store_true")
    mj.add_argument("--log-runs", action="store_true")
    mj.add_argument("--no-native", action="store_true",
                    help="host engine only (not yet ported)")
    mj.add_argument(
        "--on-device", action="store_true",
        help=f"run the dynamics on the card (ported: {', '.join(PORTED_MUJOCO_TASKS)}; "
        "without it the host engine is not yet ported)",
    )
    mj.add_argument(
        "--solver-iters", default=None, metavar="OUTER,CG",
        help="on-device contact tasks: fixed iteration counts of the contact QP solve "
        "(default 3,6, control grade; 6,40 matches mj_step to solver tolerance)",
    )

    for name in _NOT_PORTED:
        sub.add_parser(name, help="not yet ported")
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args, unknown = ap.parse_known_args(argv)
    if args.cmd in _NOT_PORTED:
        raise SystemExit(f"mpopis_tpu_torch {args.cmd}: not yet ported")
    if unknown:
        ap.error(f"unrecognized arguments: {' '.join(unknown)}")
    if args.cmd == "mujoco":
        return _mujoco(args)
    if args.sharded:
        raise SystemExit("mpopis_tpu_torch car --sharded: not yet ported")
    if args.steps_per_call not in (None, 1):
        raise SystemExit("mpopis_tpu_torch car --steps-per-call > 1: not yet ported")
    import torch

    from mpopis_tpu_torch.harness.simulate import simulate_car_racing

    simulate_car_racing(
        num_trials=args.trials,
        num_steps=args.steps,
        num_cars=args.cars,
        policy_type=args.policy,
        laps=args.laps,
        num_samples=args.samples,
        horizon=args.horizon,
        lam=args.lam,
        alpha=args.alpha,
        ais_its=args.ais_its,
        lambda_ais=args.lambda_ais,
        ce_elite_threshold=args.ce_elite_threshold,
        ce_sigma_est=args.ce_sigma_est,
        cma_sigma=args.cma_sigma,
        cma_elite_threshold=args.cma_elite_threshold,
        state_x_sigma=args.state_x_sigma,
        state_y_sigma=args.state_y_sigma,
        state_psi_sigma=args.state_psi_sigma,
        seed=args.seed,
        save_gif=args.save_gif,
        plot_traj=args.plot_traj,
        track=args.track,
        dtype=torch.float64 if args.f64 else torch.float32,
        device=args.device,
    )
    return 0


def _mujoco(args) -> int:
    if not args.on_device:
        raise SystemExit("mpopis_tpu_torch mujoco without --on-device (host engine): "
                         "not yet ported")
    import torch

    from mpopis_tpu_torch.harness.simulate import (
        ON_DEVICE_MUJOCO_TASKS,
        PORTED_MUJOCO_TASKS,
        simulate_mujoco_on_device,
    )

    if args.env_name in ON_DEVICE_MUJOCO_TASKS and args.env_name not in PORTED_MUJOCO_TASKS:
        raise SystemExit(f"mpopis_tpu_torch mujoco --on-device --env-name {args.env_name}: "
                         "not yet ported")
    for flag, name in ((args.frame_skip is not None, "--frame-skip"),
                       (args.no_native, "--no-native")):
        if flag:
            warnings.warn(
                f"{name} applies to the host engine only and is ignored with --on-device "
                "(on-device tasks use their gym frame_skip)",
                stacklevel=1,
            )
    solver_iters = None
    if args.solver_iters is not None:
        outer, cg = (int(v) for v in args.solver_iters.split(","))
        solver_iters = (outer, cg)
    simulate_mujoco_on_device(
        args.env_name,
        num_trials=args.trials,
        num_steps=args.steps,
        policy_type=args.policy,
        num_samples=args.samples,
        horizon=args.horizon,
        lam=args.lam,
        alpha=args.alpha,
        ais_its=args.ais_its,
        lambda_ais=args.lambda_ais,
        ce_elite_threshold=args.ce_elite_threshold,
        ce_sigma_est=args.ce_sigma_est,
        cma_sigma=args.cma_sigma,
        cma_elite_threshold=args.cma_elite_threshold,
        seed=args.seed,
        steps_per_call=args.steps_per_call,
        solver_iters=solver_iters,
        output_acts_file=args.output_acts_file,
        dtype=torch.float64 if args.f64 else torch.float32,
        device=args.device,
    )
    return 0
