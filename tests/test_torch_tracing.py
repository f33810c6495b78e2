"""The port's spans (`utils.span`, the `mpopis.*` names): a shared no-op with
no profiler, one profiler range each with one; where the policy step opens
them and how they nest; and that recording them changes no number."""

import dataclasses
import json
import os

import pytest
import torch

from mpopis_tpu_torch.harness.factory import get_policy
from mpopis_tpu_torch.models.cheetah_device import CheetahDeviceEnv
from mpopis_tpu_torch.policies.driver import make_policy
from mpopis_tpu_torch.utils import profiling, span, trace

K, H, ITS = 32, 4, 3


@pytest.fixture(scope="module")
def env():
    return CheetahDeviceEnv(dtype=torch.float32, device="cpu")


def _policy(env, kind, **cfg):
    pol = get_policy(kind, env, K, H, 0.1, 1.0, [0.0] * env.action_dim,
                     [0.25] * env.action_dim, ais_its=ITS)
    if cfg:
        pol = make_policy(env, dataclasses.replace(pol.cfg, **cfg), pol.u0_flat, pol.sigma)
    return pol


def _traced(fn, log_dir):
    """fn()'s result under `utils.trace`, and (name, start_us, end_us) of
    every `mpopis.*` range in the chrome trace it wrote, in order."""
    with trace(str(log_dir)) as d:
        out = fn()
    with open(os.path.join(d, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((float(e["ts"]), e["name"], float(e["ts"]) + float(e["dur"]))
                   for e in events if e.get("cat") == "user_annotation"
                   and e.get("ph") == "X" and e["name"].startswith("mpopis."))
    return out, [(n, a, b) for a, n, b in spans]


@pytest.fixture(scope="module")
def cemppi_step(env, tmp_path_factory):
    """One CEMPPI step at seed 11 untraced, then the same step and the env
    step after it traced."""
    pol = _policy(env, "cemppi")
    s = env.reset()
    untraced = pol.step(s, pol.init_state(11))

    def control_step():
        out = pol.step(s, pol.init_state(11))
        env.step_reward(s, out[0])
        return out

    traced, spans = _traced(control_step, tmp_path_factory.mktemp("cemppi"))
    return untraced, traced, spans


def test_span_is_a_shared_no_op_without_a_profiler():
    assert not torch._C._autograd._profiler_enabled()
    assert span("mpopis.a") is span("mpopis.b") is profiling._OFF
    with span("mpopis.a"):
        pass


def test_span_records_one_range_of_its_name_under_the_profiler(tmp_path):
    def body():
        with span("mpopis.test"):
            return torch.ones(3).sum()

    _, spans = _traced(body, tmp_path)
    assert [s[0] for s in spans] == ["mpopis.test"]


def test_a_cemppi_step_opens_each_span_once_per_ais_iteration(cemppi_step):
    _, (_, _, info), spans = cemppi_step
    its = info["ais_its"]
    names = [n for n, _, _ in spans]
    assert 1 <= its <= ITS
    assert names.count("mpopis.policy_step") == 1
    for name in ("mpopis.sample", "mpopis.rollout", "mpopis.update", "mpopis.sync.stop_flag"):
        assert names.count(name) == its, name
    assert names.count("mpopis.env_step") == 1
    (_, t0, t1), = [s for s in spans if s[0] == "mpopis.policy_step"]
    for name, a, b in spans:
        if name != "mpopis.policy_step":
            assert (t0 <= a and b <= t1) == (name != "mpopis.env_step"), name
    # one iteration's spans follow each other in this order
    order = [n for n in names if n in ("mpopis.sample", "mpopis.rollout", "mpopis.update",
                                       "mpopis.sync.stop_flag")]
    assert order == ["mpopis.sample", "mpopis.rollout", "mpopis.update",
                     "mpopis.sync.stop_flag"] * its


@pytest.mark.parametrize("kind", ["gmppi", "mppi"])
def test_a_strategy_that_cannot_stop_reads_nothing_back(env, kind, tmp_path):
    pol = _policy(env, kind)
    _, spans = _traced(lambda: pol.step(env.reset(), pol.init_state(3)), tmp_path)
    names = [n for n, _, _ in spans]
    assert names.count("mpopis.policy_step") == 1
    assert names.count("mpopis.sample") == names.count("mpopis.rollout") == 1
    assert not [n for n in names if n.startswith("mpopis.sync.")]


def test_the_cma_square_root_test_is_a_sync_inside_the_update(env, tmp_path):
    pol = _policy(env, "cmamppi", cma_fast_sqrt=True, elite_stop_tol=0.0)
    (_, _, info), spans = _traced(lambda: pol.step(env.reset(), pol.init_state(3)), tmp_path)
    syncs = [s for s in spans if s[0].startswith("mpopis.sync.")]
    updates = [s for s in spans if s[0] == "mpopis.update"]
    assert [s[0] for s in syncs] == ["mpopis.sync.ns_converged"] * info["ais_its"]
    assert len(updates) == info["ais_its"] == ITS
    assert all(u[1] <= a and b <= u[2] for (_, a, b), u in zip(syncs, updates))


def test_recording_the_spans_changes_no_number(cemppi_step):
    (act0, ps0, info0), (act1, ps1, info1), spans = cemppi_step
    assert spans and info0["ais_its"] == info1["ais_its"]
    assert torch.equal(act0, act1) and torch.equal(ps0.U, ps1.U)
    assert torch.equal(info0["costs"], info1["costs"])
