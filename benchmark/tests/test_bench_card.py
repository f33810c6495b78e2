"""On the card: a short traced run of each cell prints a sound result line.
Run there with `python -m pytest -m cuda benchmark/tests/test_bench_card.py`."""

import json
import subprocess
import sys

import pytest

from benchmark import spec


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in spec.load_spec()["workloads"]])
def test_a_short_traced_run_is_correct(card, name):
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", name, "--seed",
                           "2147483999", "--seconds", "4", "--trace", "1"], cwd=spec.ROOT,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    cell = spec.resolve(spec.load_spec(), name)
    assert set(result["metrics"]) == {m["name"] for m in cell.per_layer}
    assert result["metrics"]["rollout_roofline_pct"]["value"] <= 100.0
    device = result["device"]
    assert device["platform"] == "gpu" and device["count"] == 1
    assert 0.0 < device["busy_s"] <= device["window_s"]
    assert len(result["breakdown"]["device_ops"]) <= 10
