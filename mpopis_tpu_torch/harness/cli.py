"""Command-line interface of the port:

    python -m mpopis_tpu_torch car --samples 8192 --horizon 50 --ais-its 10

The `car` subcommand takes the flags and defaults of the JAX package's
(`python -m mpopis_tpu car`), plus `--device` (default `cuda`). The other
subcommands exit with "not yet ported".
"""

from __future__ import annotations

import argparse

from mpopis_tpu_torch.policies.config import POLICY_KINDS

_NOT_PORTED = ("mountaincar", "cartpole", "mujoco")


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
        help="control steps per device call; the port runs one (other values "
        "are not yet ported)",
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
