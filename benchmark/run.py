"""Run one cell of the port's benchmark and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Set-up builds the env and the policy of the
cell's configuration and traffic through the program's own factory and
warms the cell's shapes; the window then drives the closed loop for
`--seconds`; once it has closed, the plain reference checks a sample of
what the window produced (`benchmark/check.py`). The last line of standard
output is one JSON object: `correct`, `attempted`, `failed`, `metrics`,
`device`, with `--trace 1` the per-layer metrics, `busy_s`, `window_s` and
`breakdown`, and last the numbers compared, each beside its limit.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every build and kernel cache at a fixed path inside the checkout; the
# program's own (mpopis_tpu_torch/_build/) is there already
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions",
          "CUDA_CACHE_PATH": "cuda"}
FORBIDDEN = {"jax", "jaxlib", "flax", "mpopis_tpu"}


def _prepare_environment() -> None:
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "_bench_cache" / sub)
    # the program's opt-in switches stay off: the default path is measured
    for var in [v for v in os.environ if v.startswith("MPOPIS_")]:
        del os.environ[var]
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def forbidden_modules(names) -> list[str]:
    """The loaded modules whose name before the first dot is JAX's, flax's or
    the JAX package's (compared whole: `mpopis_tpu_torch` is not
    `mpopis_tpu`)."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def _card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=False).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi not read: {exc}"
    return out.splitlines()[0] if out else "nvidia-smi printed nothing"


def _guard(stage: str) -> None:
    found = forbidden_modules(sys.modules)
    if found:
        print(f"benchmark: {stage}: loaded {found}; the port's benchmark imports none of "
              f"{sorted(FORBIDDEN)}", file=sys.stderr)
        raise SystemExit(3)


@dataclasses.dataclass
class RunData:
    """What a metric's reader reads (`benchmark/metrics/<name>.py`)."""

    cell: object  # spec.Cell
    setup_s: float
    window: object  # loop.Window
    trace: object  # trace.Trace, or None in an untraced run
    # (operations, bytes) of one rollout call at the cell's shapes, from the
    # configuration's `rollout_work`; None where it counts none
    rollout_work: tuple | None


def _parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, device: str | None = None, cell=None) -> int:
    """Run a cell. `device` and `cell` are for the CPU tests, which skip the
    look for a card and may give a cell of their own."""
    args = _parse(argv)
    _prepare_environment()
    import torch

    from benchmark import check, loop, spec
    from benchmark.trace import read_profile

    torch.set_num_threads(1)
    bench = spec.load_spec(ROOT)
    bad = spec.problems(bench)
    if bad:
        print(f"benchmark: BENCHMARK.json: {bad}", file=sys.stderr)
        return 2
    cell = cell or spec.resolve(bench, args.workload, ROOT)
    if args.seed < 0:
        print("benchmark: --seed must be a whole number >= 0", file=sys.stderr)
        return 2
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"benchmark: {cell.name} needs {cell.chips} CUDA device(s), found {n}",
                  file=sys.stderr)
            return 2
        device = "cuda"
        print(f"benchmark: card {torch.cuda.get_device_name(0)}, "
              f"{torch.cuda.device_count()} visible; nvidia-smi: {_card_line()}",
              file=sys.stderr, flush=True)
        torch.cuda.reset_peak_memory_stats()
    on_card = device == "cuda"
    cfg, traffic = cell.config, cell.traffic

    closed = loop.ClosedLoop(cell, args.seed, device)
    closed.warm_up()
    _guard("after set-up")
    checks = loop.draw_checks(args.seed, cell.check, traffic["num_samples"], traffic["ais_its"])
    trace_at = (traffic["trace_from_step"], traffic["trace_steps"]) if args.trace else None
    t_setup_end = time.perf_counter()
    w = closed.run(args.seconds, checks, trace_at)
    setup_s = t_setup_end - T_PROCESS
    _guard("after the window")
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    trace = None
    if args.trace:
        keep = ROOT / "_bench_out" / f"{cell.name}-{args.seed}.trace.json.gz"
        trace = read_profile(w.prof, keep=keep)
        w.prof = None
    policy, task, bounds = check.reference_for(cell, closed.env)
    del closed
    if on_card:
        torch.cuda.empty_cache()

    # the plain reference, after the window and the memory peak
    t_ref = time.perf_counter()
    columns = [checks["columns"][g][:rec.its] for g, rec in zip(w.record_steps,
                                                                 w.policy_records)]
    z = check.normals(w.policy_records, policy.cs, policy.num_samples, device)
    work = getattr(cell.reference_module(), "rollout_work", None)
    tally = work(cfg, traffic) if work else None
    want = check.outputs_reference(policy, task, w.policy_records, w.env_records, columns,
                                   bounds, z, device, tally=tally)
    got = check.outputs_program(w.policy_records, w.env_records, columns)
    numbers = check.compare(got, want, [r.its for r in w.policy_records], policy.opt_its)
    ok, lines, shown = check.judge(numbers, cell.check["limits"])
    n_traj = sum(len(c) for cols in columns for c in cols)
    ref_s = time.perf_counter() - t_ref

    run = RunData(cell=cell, setup_s=setup_s, window=w, trace=trace,
                  rollout_work=tally.per_call(n_traj) if tally else None)
    metrics = {}
    for m in (cell.per_layer if args.trace else cell.end_to_end):
        value = spec.metric_reader(cell, m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                   "count": cell.chips, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": bool(ok and w.failed == 0), "attempted": w.steps, "failed": w.failed,
              "metrics": metrics, "device": device_info}
    if trace is not None:
        device_info["busy_s"] = trace.busy_s
        device_info["window_s"] = trace.window_s
        result["breakdown"] = trace.breakdown()
    result["checks"] = shown
    print(f"benchmark: window {w.steps} steps in {w.seconds!r} s over {w.trials} trials "
          f"({w.caught_up} more after it for the sampled steps); set-up {setup_s!r} s; "
          f"reference {ref_s!r} s over {len(w.policy_records)} policy steps, {n_traj} "
          f"rollouts, {len(w.env_records)} env steps", file=sys.stderr)
    if trace is not None:
        print(f"benchmark: traced {trace.steps} steps, {len(trace.device_ops)} device ops, "
              f"{trace.unmatched} without a launch in the trace", file=sys.stderr)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    _guard("before the result")  # the reference and the metrics' readers loaded since
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
