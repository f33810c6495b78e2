"""Command-line interface of the port:

    python -m mpopis_tpu_torch car --samples 8192 --horizon 50 --ais-its 10
    python -m mpopis_tpu_torch car --cars 3 --policy cmamppi --samples 8192
    python -m mpopis_tpu_torch mountaincar --policy cemppi --trials 2
    python -m mpopis_tpu_torch cartpole --policy cemppi
    python -m mpopis_tpu_torch mujoco --on-device --env-name HalfCheetah-v4 \
        --samples 2048 --horizon 15 --ais-its 3 --lam 0.1 --ce-sigma-est mle
    python -m mpopis_tpu_torch mujoco --env-name HalfCheetah-v4 --samples 100 \
        --horizon 50 --ais-its 5 --seed 1 --output-acts-file

Every subcommand takes the flags and defaults of the JAX package's
(`python -m mpopis_tpu ...`), plus `--device` (default `cuda`). `mujoco`
steps the host MuJoCo engine with the policy math on `--device`, or with
`--on-device` runs the dynamics on the card too, for all 11 tasks of
`harness.simulate.ON_DEVICE_MUJOCO_TASKS`. `--save-gif` and `--plot-traj`
write gifs and trajectory plots (`mujoco --on-device` as well). Still not
ported, and exiting with "not yet ported": `car --sharded`.
"""

from __future__ import annotations

import argparse
import warnings

from mpopis_tpu_torch.policies.config import POLICY_KINDS

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
        help="control steps per host read-back (default: 10, or 1 when state noise "
        "or logging needs the host every step)",
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

    # the JAX package's mountaincar/cartpole defaults: 5 AIS iterations,
    # λ_ais = 0.1, `mle`
    mc = sub.add_parser("mountaincar", help="continuous mountain car")
    _common(mc, 20, 15, 0.1, ais_its=5, lambda_ais=0.1, ce_sigma_est="mle")
    mc.add_argument("--save-gif", action="store_true")

    cp = sub.add_parser("cartpole", help="continuous cart-pole")
    _common(cp, 20, 15, 0.1, ais_its=5, lambda_ais=0.1, ce_sigma_est="mle")
    cp.add_argument("--save-gif", action="store_true")

    from mpopis_tpu_torch.harness.simulate import PORTED_MUJOCO_TASKS

    mj = sub.add_parser("mujoco", help="MuJoCo tasks: the host engine, or on-device dynamics "
                        "with --on-device")
    _common(mj, 100, 50, 1.0)
    mj.add_argument("--env-name", default="HalfCheetah-v4")
    mj.add_argument("--frame-skip", type=int, default=None,
                    help="host engine only (default: 5); on-device tasks use their gym value")
    mj.add_argument("--output-acts-file", action="store_true")
    mj.add_argument("--log-runs", action="store_true")
    mj.add_argument("--no-native", action="store_true", help="use the Python engine")
    mj.add_argument(
        "--on-device", action="store_true",
        help=f"run the dynamics on the card ({', '.join(PORTED_MUJOCO_TASKS)}; "
        "without it the K rollouts step the host engine)",
    )
    mj.add_argument("--save-gif", action="store_true",
                    help="--on-device with --plot-traj: a gif of the sampled rollouts")
    mj.add_argument("--plot-traj", action="store_true",
                    help="--on-device: log and plot the sampled rollouts")
    mj.add_argument(
        "--solver-iters", default=None, metavar="OUTER,CG",
        help="on-device contact tasks: fixed iteration counts of the contact QP solve "
        "(default 3,6, control grade; 6,40 matches mj_step to solver tolerance)",
    )

    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd == "mujoco":
        return _mujoco(args)
    if getattr(args, "sharded", False):
        raise SystemExit(f"mpopis_tpu_torch {args.cmd} --sharded: not yet ported")
    import torch

    from mpopis_tpu_torch.harness import simulate

    common = dict(
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
        dtype=torch.float64 if args.f64 else torch.float32,
        device=args.device,
        save_gif=args.save_gif,
    )
    if args.cmd == "mountaincar":
        simulate.simulate_mountaincar(**common)
        return 0
    if args.cmd == "cartpole":
        simulate.simulate_cartpole(**common)
        return 0

    simulate.simulate_car_racing(
        num_cars=args.cars,
        laps=args.laps,
        track=args.track,
        state_x_sigma=args.state_x_sigma,
        state_y_sigma=args.state_y_sigma,
        state_psi_sigma=args.state_psi_sigma,
        plot_traj=args.plot_traj,
        **common,
    )
    return 0


def _mujoco(args) -> int:
    common = dict(
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
        output_acts_file=args.output_acts_file,
        device=args.device,
    )
    if not args.on_device:
        for flag, name in ((args.save_gif, "--save-gif"), (args.plot_traj, "--plot-traj")):
            if flag:
                raise SystemExit(f"mpopis_tpu_torch mujoco {name} needs --on-device "
                                 "(the host engine renders nothing)")
        from mpopis_tpu_torch.harness.simulate_mujoco import simulate_mujoco

        # the host engine's policy math is float64 whatever --f64 says
        simulate_mujoco(
            args.env_name,
            frame_skip=args.frame_skip if args.frame_skip is not None else 5,
            log_runs=args.log_runs,
            native=not args.no_native,
            **common,
        )
        return 0
    import torch

    from mpopis_tpu_torch.harness.simulate import simulate_mujoco_on_device

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
        steps_per_call=args.steps_per_call,
        solver_iters=solver_iters,
        save_gif=args.save_gif,
        plot_traj=args.plot_traj,
        dtype=torch.float64 if args.f64 else torch.float32,
        **common,
    )
    return 0
