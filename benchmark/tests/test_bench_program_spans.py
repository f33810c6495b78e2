"""The per-layer metrics that read the program's own spans (`mpopis.*`),
from a synthetic chrome trace: `test_bench_trace.py`'s two control steps
with the spans the port opens added, each reader against a hand count, and
each silent on a trace without program spans."""

import types

import pytest

from benchmark import program_spans, spec
from benchmark.trace import Trace

NEW = ["sampling_device_ms_per_step", "strategy_update_device_ms_per_step",
       "env_step_device_ms_per_step", "rollout_host_self_ms_per_step", "host_syncs_per_step",
       "sync_wait_ms_per_step", "policy_idle_ms_per_step"]


def _x(cat, name, ts, dur, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


# test_bench_trace.py's EVENTS
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

# the program's spans in those two steps: step 1 samples on the device
# (launch 6), rolls out (launch 1 inside the launch span), updates (launch 2),
# reads the stop flag, and after the policy step steps the plant (launch 3);
# step 2 samples nothing on the device, steps an env inside the policy step
# (launch 7, a plain rollout's and not the plant's), updates (launch 5) and reads
# the flag; one more read lies after the traced window and is not counted
SPANS = [
    _x("user_annotation", "mpopis.policy_step", 1, 78),
    _x("user_annotation", "mpopis.sample", 2, 6),
    _x("cuda_runtime", "cudaLaunchKernel", 5, 1, 6),
    _x("kernel", "randn", 8, 4, 6),
    _x("user_annotation", "mpopis.rollout", 9, 23),
    _x("user_annotation", "mpopis.rollout.launch", 14, 3),
    _x("user_annotation", "mpopis.update", 40, 22),
    _x("user_annotation", "mpopis.sync.stop_flag", 63, 7),
    _x("user_annotation", "mpopis.env_step", 85, 13),
    _x("user_annotation", "mpopis.policy_step", 101, 78),
    _x("user_annotation", "mpopis.sample", 102, 6),
    _x("user_annotation", "mpopis.rollout", 109, 23),
    _x("user_annotation", "mpopis.rollout.launch", 114, 3),
    _x("user_annotation", "mpopis.env_step", 133, 1),
    _x("cuda_runtime", "cudaLaunchKernel", 133.5, 0.2, 7),
    _x("kernel", "plain_step", 152, 2, 7),
    _x("user_annotation", "mpopis.update", 140, 25),
    _x("user_annotation", "mpopis.sync.stop_flag", 166, 12),
    _x("user_annotation", "mpopis.sync.stop_flag", 250, 5),
]


def _run(events):
    cell = spec.resolve(spec.load_spec(), "halfcheetah.cemppi.k2048-h15")
    return types.SimpleNamespace(cell=cell, trace=Trace(events), rollout_work=None,
                                 window=types.SimpleNamespace(steps=4, seconds=0.2,
                                                              step_ms=[1, 2, 3, 4],
                                                              ais_its=[1, 1, 1, 1]))


def _read(run, name):
    return spec.metric_reader(run.cell, name)(run)


def test_the_cells_report_the_new_metrics():
    bench = spec.load_spec()
    for w in bench["workloads"]:
        names = [m["name"] for m in spec.resolve(bench, w["name"]).per_layer]
        assert set(NEW) <= set(names)


def test_each_reader_against_a_hand_count():
    run = _run(EVENTS + SPANS)
    # randn, 4 us over 2 steps
    assert _read(run, "sampling_device_ms_per_step") == pytest.approx(0.002)
    # the two sorts, 10 us each
    assert _read(run, "strategy_update_device_ms_per_step") == pytest.approx(0.010)
    # the plant's DtoH copy (5 us); the plain rollout's step is inside the policy step
    assert _read(run, "env_step_device_ms_per_step") == pytest.approx(0.0025)
    # rollouts 2 x 23 us less launches 2 x 3 us
    assert _read(run, "rollout_host_self_ms_per_step") == pytest.approx(0.020)
    # two reads inside the traced steps, 7 + 12 us
    assert _read(run, "host_syncs_per_step") == 1.0
    assert _read(run, "sync_wait_ms_per_step") == pytest.approx(0.0095)
    # idle inside the policy steps: 7 + 8 + 5 + 14 us, then 19 + 2 + 6 + 9 us
    assert _read(run, "policy_idle_ms_per_step") == pytest.approx(0.035)
    # the launch span holds exactly what the benchmark's rollout span holds
    t = run.trace
    assert program_spans.ops_in(t, "mpopis.rollout.launch") == t.ops_in("bench.rollout")
    assert program_spans.device_ms(program_spans.ops_in(t, "mpopis.rollout.launch")) / t.steps \
        == pytest.approx(_read(run, "rollout_device_ms_per_step"))


@pytest.mark.parametrize("name", NEW)
def test_each_reader_is_silent_without_program_spans(name):
    run = _run(EVENTS)
    assert not program_spans.has_spans(run.trace)
    assert _read(run, name) is None
    run.trace = None
    assert _read(run, name) is None


def test_overlap_of_interval_lists():
    assert program_spans.overlap_us([(0, 10), (20, 30)], [(5, 25)]) == 10
    assert program_spans.overlap_us([(0, 1)], [(2, 3)]) == 0
    assert program_spans.overlap_us([], [(0, 1)]) == 0
