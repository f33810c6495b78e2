"""The import guard and the harness's refusals."""

import ast
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import spec
from benchmark.run import forbidden_modules


def test_the_guard_compares_whole_top_level_names():
    assert forbidden_modules(["mpopis_tpu_torch", "mpopis_tpu_torch.models", "jaxtyping",
                              "benchmark", "torch"]) == []
    found = forbidden_modules(["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
                               "mpopis_tpu", "mpopis_tpu.models.base"])
    assert len(found) == 6


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_nothing_under_benchmark_imports_jax_or_the_jax_package():
    files = [p for p in spec.BENCH_DIR.rglob("*.py") if "tests" not in p.parts]
    for path in files:
        names = list(_imports(path))
        assert forbidden_modules(names) == [], path
        assert "bench" not in [n.split(".")[0] for n in names], path


def test_the_reference_imports_nothing_of_the_program():
    files = list((spec.BENCH_DIR / "reference").glob("*.py"))
    files += list((spec.BENCH_DIR / "configs").glob("*.py"))
    for path in files:
        for name in _imports(path):
            assert name.split(".")[0] in {"__future__", "dataclasses", "functools", "types",
                                          "numpy", "torch", "benchmark"}, (path, name)
            assert name.split(".")[:2] in (["benchmark", "reference"], ["benchmark", "roofline"]) \
                or name.split(".")[0] != "benchmark", (path, name)


def test_without_the_program_it_exits_and_prints_no_result(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark's files."""
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                           "halfcheetah.cemppi.k2048-h15", "--seed", "2147483901",
                           "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "{" not in proc.stdout


def test_without_a_card_it_exits_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                           "ant.cemppi.k1024-h10", "--seed", "3", "--seconds", "1",
                           "--trace", "0"], cwd=spec.ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA device" in proc.stderr
