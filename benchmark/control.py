"""Readings that the comparison's limits are set from, on the card.

    python3 benchmark/control.py --workload <name> --seeds <n,n,...> [--tf32]

For each seed, in one process: the cell's closed loop from its set-up, run
until every step that the seed's sample checks has run, then the numbers
that `run.py` compares, for the program and, with `--tf32`, for the
control (the plain reference in float32 with TF32 matrix products, in the
program's place), both against the float64 reference. Prints one JSON line
per seed and side. The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


COST_TAUS = (1e-4, 1e-3, 1e-2, 5e-2, 2e-1)
STATE_TAUS = (1e-5, 1e-4, 1e-3, 1e-2)


def tails(got, want) -> dict:
    """The upper quantiles of the cost and state gaps, and the share of
    each above a few levels: what a fault in part of the batch moves."""
    import numpy as np
    import torch

    from benchmark import check

    out = {}
    gaps = {"cost": check.rel_gap(got.costs, want.costs).cpu().numpy()}
    if want.next_states is not None:
        gaps["state"] = torch.max(check.rel_gap(got.next_states, want.next_states),
                                  dim=-1).values.cpu().numpy()
    for name, taus in (("cost", COST_TAUS), ("state", STATE_TAUS)):
        g = gaps.get(name)
        if g is None or len(g) == 0:
            continue
        out[f"{name}_gap_q75_q90_max"] = [float(q) for q in np.quantile(g, [0.75, 0.9, 1.0])]
        out[f"{name}_gap_share_above"] = {f"{t:g}": float(np.mean(g > t)) for t in taus}
    return out


def planted(program, columns, num_samples: int, env_records) -> dict:
    """The program's outputs with two faults planted in what the comparison
    reads, at the cell's own size: the costs of the second half of K zero,
    and the env step returning its state unchanged on one checked step in
    four. (The CPU tests plant them underneath the timed path.)"""
    import dataclasses

    import torch

    flat = [c for cols in columns for col in cols for c in col]
    half = torch.as_tensor([c >= num_samples // 2 for c in flat], device=program.costs.device)
    out = {"fault_half_k_zero": dataclasses.replace(
        program, costs=torch.where(half, torch.zeros_like(program.costs), program.costs))}
    if program.next_states is not None:
        nxt = program.next_states.clone()
        for i in range(0, len(env_records), 4):
            nxt[i] = env_records[i].x
        out["fault_env_quarter"] = dataclasses.replace(program, next_states=nxt)
    return out


def readings(cell, seeds, device: str, tf32: bool, out=print):
    import torch

    from benchmark import check, loop

    traffic = cell.traffic
    closed = loop.ClosedLoop(cell, seeds[0], device)
    closed.warm_up()
    policy, task, bounds = check.reference_for(cell, closed.env)
    rows = []
    for seed in seeds:
        closed.seed = int(seed)
        checks = loop.draw_checks(seed, cell.check, traffic["num_samples"], traffic["ais_its"])
        t0 = time.perf_counter()
        w = closed.run(0.0, checks)
        columns = [checks["columns"][g][:r.its] for g, r in zip(w.record_steps,
                                                                 w.policy_records)]
        z = check.normals(w.policy_records, policy.cs, policy.num_samples, device)
        its = [r.its for r in w.policy_records]
        args = (policy, task, w.policy_records, w.env_records, columns, bounds, z, device)
        t1 = time.perf_counter()
        want = check.outputs_reference(*args)
        t2 = time.perf_counter()
        program = check.outputs_program(w.policy_records, w.env_records, columns)
        sides = {"program": program, **planted(program, columns, policy.num_samples,
                                                     w.env_records)}
        if tf32:
            sides["control"] = check.outputs_reference(*args, dtype=torch.float32, tf32=True)
        for side, got in sides.items():
            numbers = check.compare(got, want, its, policy.opt_its)
            row = {"seed": int(seed), "side": side, **numbers, **tails(got, want),
                   "its": its, "steps": w.caught_up, "loop_s": t1 - t0, "reference_s": t2 - t1}
            rows.append(row)
            out(json.dumps(row))
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--tf32", action="store_true")
    args = p.parse_args(argv)
    from benchmark import run, spec

    run._prepare_environment()
    import torch

    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    cell = spec.resolve(spec.load_spec(ROOT), args.workload, ROOT)
    readings(cell, [int(s) for s in args.seeds.split(",")], "cuda", args.tf32,
             out=lambda line: print(line, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
