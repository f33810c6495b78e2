"""The rollout layer's share of its roofline: the least time the H100 could
take for the traced rollout calls' work, the larger of their operations over
67 TFLOP/s (float32) and their bytes over 3.35 TB/s, over the device time of
everything launched inside the rollout spans, in percent.

The work of one call is the configuration's (`rollout_work` in its module,
for the contact tasks `roofline.ContactWork`, as chip_smoke counts it): the
algorithm's at the cell's shapes, whatever kernel computes it."""

from benchmark.roofline import bound_ms


def read(run):
    t = run.trace
    if t is None or not t.steps or run.rollout_work is None:
        return None
    rollout_ms = sum(d for _n, _s, d, _l in t.ops_in("bench.rollout")) / 1e3
    calls = len(t.spans["bench.rollout"])
    if rollout_ms <= 0.0 or calls == 0:
        return None
    return 100.0 * calls * bound_ms(*run.rollout_work)[0] / rollout_ms
