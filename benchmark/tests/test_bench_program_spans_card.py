"""On the card: the program's spans (`mpopis.*`) in a short traced window of
each cell. The rollout kernel is launched inside `mpopis.rollout.launch`,
whose device time is the benchmark's own rollout span's (one clock); every
blocking runtime call inside `mpopis.policy_step` lies inside an
`mpopis.sync.*` span; and the syncs count one a step per AIS iteration.
Run there with `python -m pytest -m cuda benchmark/tests/test_bench_program_spans_card.py`."""

import statistics

import pytest

from benchmark import loop, program_spans, spec
from benchmark.trace import read_profile

SEED = 2147483999
SYNCS = {"cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
         "cuStreamSynchronize", "cuCtxSynchronize", "cuEventSynchronize"}


def blocking(name: str) -> bool:
    """A runtime or driver call that waits for the device: a synchronize, or
    a copy that is not the asynchronous form."""
    return name in SYNCS or (name.startswith(("cudaMemcpy", "cuMemcpy")) and "Async" not in name)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    # the first profiler of a process drops its first ~0.3 s (CUPTI's start)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in spec.load_spec()["workloads"]])
def test_the_program_spans_on_the_card(card, name):
    cell = spec.resolve(spec.load_spec(), name)
    traffic = cell.traffic
    closed = loop.ClosedLoop(cell, SEED, "cuda")
    closed.warm_up()
    first, steps = traffic["trace_from_step"], 20
    checks = {"policy": {0}, "env": {0}, "columns": {0: [[0]] * traffic["ais_its"]}}
    w = closed.run(4.0, checks, (first, steps))
    t = read_profile(w.prof)
    assert t.steps == steps and program_spans.has_spans(t)

    rollout = t.ops_in("bench.rollout")
    launch = program_spans.intervals(t, "mpopis.rollout.launch")
    assert rollout and all(launch.holds(op[3]) for op in rollout)
    inside = program_spans.device_ms(program_spans.ops_in(t, "mpopis.rollout.launch"))
    outside = program_spans.device_ms(t.ops_in("bench.rollout"))
    assert inside == pytest.approx(outside, rel=0.01)

    policy = program_spans.intervals(t, "mpopis.policy_step")
    syncs = program_spans.intervals(t, lambda n: n.startswith(program_spans.SYNC))
    waits = [(n, s, d) for n, s, d in t.host if blocking(n) and policy.holds(s)]
    loose = [h for h in waits if not (syncs.holds(h[1]) and syncs.holds(h[1] + h[2]))]
    assert not loose, loose[:10]

    its = statistics.mean(w.ais_its[first:first + steps])
    assert len(syncs) / t.steps == its
    print(f"{name}: {len(waits)} blocking calls in the policy steps, all in "
          f"{len(syncs)} sync spans; {its} AIS its a step")
