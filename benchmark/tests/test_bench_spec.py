"""BENCHMARK.json's format, and cells found from their files by name."""

import json
import shutil

import pytest

from benchmark import spec

ALLOWED_NAME = r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}"


def test_benchmark_json_is_sound():
    assert spec.problems(spec.load_spec()) == []


def test_every_name_and_unit_uses_the_allowed_characters():
    import re

    bench = spec.load_spec()
    names = [e["name"] for g in ("configs", "workloads", "end_to_end", "per_layer")
             for e in bench[g]]
    names += [w[k] for w in bench["workloads"] for k in ("config", "traffic")]
    names += [k for c in bench["configs"] for k in c["reduced"]]
    assert all(re.fullmatch(ALLOWED_NAME, n) for n in names), names
    units = [m["unit"] for g in ("end_to_end", "per_layer") for m in bench[g]]
    assert all(re.fullmatch(r"[A-Za-z0-9_/%.-]{1,16}", u) for u in units), units
    assert len(json.dumps(bench).encode()) <= 64 * 1024


@pytest.mark.parametrize("bad", [
    {"name": "has space"}, {"name": "a/b"}, {"name": "é"}, {"unit": "tokens per s"},
    {"unit": "µs"}, {"better": "up"}, {"source": "guess"}, {"extra": 1},
])
def test_a_malformed_metric_is_refused(bad):
    bench = spec.load_spec()
    bench["per_layer"][0] = dict(bench["per_layer"][0], **bad)
    assert spec.problems(bench)


@pytest.mark.parametrize("name", [w["name"] for w in spec.load_spec()["workloads"]])
def test_each_cell_resolves_from_its_files(name):
    cell = spec.resolve(spec.load_spec(), name)
    assert cell.config["name"] == cell.config_name
    assert cell.traffic["name"] == cell.traffic_name
    assert set(cell.check["limits"]) >= {"cost_gap_geomean", "state_gap_geomean", "action_gap"}
    assert [m["name"] for m in cell.end_to_end][-1] == "setup_s"
    assert cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(spec.metric_reader(cell, m["name"]))
    assert hasattr(cell.reference_module(), "task")


# a configuration module of its own: the cheetah's model table, but the
# harness's hooks written anew here, the contact solver at other iterations
# and no roofline count
_THIRD_MODULE_HOOKS = """

def task(config):
    return PlanarTask(model=MODEL, frame_skip=_FRAME_SKIP, healthy=0.0, ctrl_w=0.1,
                      init_qpos=(0.0,) * 9, action_dim=6, solver_outer=config["solver_outer"],
                      solver_cg=config["solver_cg"])


def env_kwargs(config):
    return {"solver_outer": config["solver_outer"], "solver_cg": config["solver_cg"]}


def facts(env):
    return {"n_dof": env.MODEL.n_dof, "action_dim": env.action_dim}


def policy_step(config, traffic, action_dim):
    return ce.policy_step(config, traffic, action_dim)
"""


def test_a_new_cell_is_found_from_new_files_alone(tmp_path, capsys):
    """A third cell, its configuration with a module of its own, its traffic,
    limits and a per-layer metric of its own, added as files beside copies
    of the benchmark's; then run on the CPU at a tiny size."""
    from benchmark import run

    shutil.copytree(spec.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    configs = tmp_path / "benchmark" / "configs"
    bench = spec.load_spec()
    cfg = json.loads((spec.BENCH_DIR / "configs" / "halfcheetah-v4.json").read_text())
    cfg.update(name="halfcheetah-v4-qp24", reference="halfcheetah-v4-qp24.py", solver_outer=2,
               solver_cg=4)
    (configs / "halfcheetah-v4-qp24.json").write_text(json.dumps(cfg))
    table = (spec.BENCH_DIR / "configs" / "halfcheetah-v4.py").read_text()
    (configs / "halfcheetah-v4-qp24.py").write_text(
        table[:table.index("def task(")] + _THIRD_MODULE_HOOKS)
    traffic = {"name": "cemppi.k100-h50", "num_samples": 100, "horizon": 50, "ais_its": 5,
               "lam": 1.0, "cov": 0.25, "sigma_est": "ss", "trial_steps": 50, "trials": 4,
               "trial_seed": 7, "warmup_steps": 3, "trace_from_step": 10, "trace_steps": 50}
    (tmp_path / "benchmark" / "traffic" / "cemppi.k100-h50.json").write_text(json.dumps(traffic))
    checks = json.loads((spec.BENCH_DIR / "checks" /
                         "halfcheetah.cemppi.k2048-h15.json").read_text())
    (tmp_path / "benchmark" / "checks" / "third.cell.json").write_text(json.dumps(checks))
    (tmp_path / "benchmark" / "metrics" / "third_metric.py").write_text(
        "def read(run):\n    return 42.0\n")
    bench["configs"].append({"name": "halfcheetah-v4-qp24", "source": "https://example.org/x",
                             "file": "benchmark/configs/halfcheetah-v4-qp24.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "third.cell", "config": "halfcheetah-v4-qp24",
                               "traffic": "cemppi.k100-h50", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "third_metric", "unit": "ms", "better": "lower",
                               "source": "program_span", "layer": "a layer",
                               "moves": "control_steps_per_s", "workloads": ["third.cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    loaded = spec.load_spec(tmp_path)
    assert spec.problems(loaded) == []
    cell = spec.resolve(loaded, "third.cell", tmp_path)
    assert cell.config["name"] == "halfcheetah-v4-qp24"
    assert cell.traffic["num_samples"] == 100
    assert cell.check == checks
    assert "third_metric" in [m["name"] for m in cell.per_layer]
    assert spec.metric_reader(cell, "third_metric")(None) == 42.0
    # the metric listed for the new cell alone stays out of the others
    old = spec.resolve(loaded, "halfcheetah.cemppi.k2048-h15", tmp_path)
    assert "third_metric" not in [m["name"] for m in old.per_layer]

    # the harness runs it as it is, at a tiny size (K = 128 keeps the CE
    # refit's elites above the plan's dimensions)
    cell.traffic.update(num_samples=128, horizon=3, ais_its=2, trial_steps=6, warmup_steps=1,
                        sigma_est="mle")
    cell.check.update(policy_steps=2, env_steps=4, columns=8, within_steps=10)
    assert run.main(["--workload", "third.cell", "--seed", "2147483811", "--seconds", "1",
                     "--trace", "0"], device="cpu", cell=cell) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
