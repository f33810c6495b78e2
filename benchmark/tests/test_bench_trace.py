"""The per-layer metrics read from a synthetic chrome trace of two control
steps: spans, launches matched by correlation id, busy and idle time."""

import types

import pytest

from benchmark import spec
from benchmark.trace import Trace


def _x(cat, name, ts, dur, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


EVENTS = [
    _x("user_annotation", "bench.control_step", 0, 100),
    _x("user_annotation", "bench.control_step", 100, 100),
    _x("user_annotation", "bench.policy_step", 0, 80),
    _x("user_annotation", "bench.policy_step", 100, 80),
    _x("user_annotation", "bench.rollout", 10, 20),
    _x("user_annotation", "bench.rollout", 110, 20),
    _x("cpu_op", "aten::sort", 40, 20),
    _x("cpu_op", "aten::copy_", 180, 15),
    _x("cuda_runtime", "cudaLaunchKernel", 15, 1, 1),
    _x("cuda_runtime", "cudaLaunchKernel", 50, 1, 2),
    _x("cuda_runtime", "cudaLaunchKernel", 90, 1, 3),
    _x("cuda_runtime", "cudaLaunchKernel", 115, 1, 4),
    _x("cuda_runtime", "cudaLaunchKernel", 150, 1, 5),
    _x("kernel", "planar_rollout", 20, 30, 1),
    _x("kernel", "sort", 55, 10, 2),
    _x("gpu_memcpy", "Memcpy DtoH", 95, 5, 3),
    _x("kernel", "planar_rollout", 120, 30, 4),
    _x("kernel", "sort", 160, 10, 5),
    _x("kernel", "orphan", 185, 5, 99),
    {"ph": "i", "name": "marker", "ts": 7},
]


def test_spans_attribute_each_operation_by_its_launch():
    t = Trace(EVENTS)
    assert t.steps == 2 and t.window == (0.0, 200.0) and t.window_s == pytest.approx(2e-4)
    assert [op[0] for op in t.ops_in("bench.rollout")] == ["planar_rollout"] * 2
    assert [op[0] for op in t.ops_in("bench.policy_step", "bench.rollout")] == ["sort"] * 2
    assert len(t.ops_in("bench.control_step")) == 5
    assert t.unmatched == 1
    assert t.busy_s == pytest.approx(90e-6)
    b = t.breakdown()
    assert b["device_ops"][0] == ["planar_rollout", pytest.approx(60e-6)]
    # each gap goes to the shortest host event over its middle
    assert dict(b["idle_gaps"]) == pytest.approx({
        "bench.policy_step": 55e-6, "bench.rollout": 40e-6, "aten::copy_": 10e-6,
        "aten::sort": 5e-6})


def test_the_readers_take_their_numbers_from_the_trace():
    cell = spec.resolve(spec.load_spec(), "halfcheetah.cemppi.k2048-h15")
    run = types.SimpleNamespace(cell=cell, trace=Trace(EVENTS), rollout_work=(3.35e6, 1e3),
                                window=types.SimpleNamespace(
                                    steps=4, seconds=0.2, step_ms=[1, 2, 3, 4],
                                    ais_its=[3, 3, 2, 3]))

    def read(name):
        return spec.metric_reader(cell, name)(run)

    assert read("device_ops_per_step") == 2.5
    assert read("rollout_device_ms_per_step") == pytest.approx(0.030)
    assert read("update_device_ms_per_step") == pytest.approx(0.010)
    assert read("device_idle_pct") == pytest.approx(55.0)
    assert read("ais_its_per_step") == 2.75
    # 3.35e6 operations bound a call at 0.05 us; two calls in 60 us of rollout
    assert read("rollout_roofline_pct") == pytest.approx(100.0 * 2 * 3.35e6 / 67e12 / 60e-6)
    run.rollout_work = None
    assert read("rollout_roofline_pct") is None
    run.rollout_work = (1.0, 1.0)
    run.trace = None
    assert read("rollout_roofline_pct") is None and read("device_idle_pct") is None
