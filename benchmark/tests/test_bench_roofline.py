"""The frozen roofline counts against chip_smoke's own functions, on the same
plain rollouts, for both cells' families; and chip_smoke's printed bounds
from their parts."""

import pytest
import torch

from benchmark import loop, spec
from benchmark.roofline import PEAK_BYTES_S, PEAK_F32_FLOPS, bound_ms, contact_ops

CELLS = ("halfcheetah.cemppi.k2048-h15", "ant.cemppi.k1024-h10")


def test_the_peaks_are_the_data_sheets():
    import chip_smoke

    assert (PEAK_F32_FLOPS, PEAK_BYTES_S) == (chip_smoke.PEAK_F32_FLOPS, chip_smoke.PEAK_BYTES_S)
    assert bound_ms(67e9, 1.0) == (1.0, "operations")
    assert bound_ms(1.0, 3.35e9) == (1.0, "bytes")


@pytest.mark.parametrize("name", CELLS)
def test_the_counts_equal_chip_smokes(name):
    import chip_smoke
    from mpopis_tpu_torch.models import planar_contact, spatial_contact

    cell = spec.resolve(spec.load_spec(), name)
    cfg = dict(cell.config, dtype="float32")
    module = cell.reference_module()
    env = loop.build_env(cfg, module, "cpu")
    task = module.task(cfg)
    gen = torch.Generator().manual_seed(8)
    k, h = 6, 2
    ctrl = torch.rand((h, env.action_dim, k), generator=gen) * 2 - 1
    x0 = env.reset().x
    port_module = planar_contact if cfg["integrator"] == "euler_implicit" else spatial_contact
    with chip_smoke._qp_tally(port_module, env) as theirs:
        env.fused_rollout_costs_tak(env.reset(), ctrl)
    with module.rollout_work(cfg, dict(cell.traffic, num_samples=k, horizon=h)) as ours:
        task.rollout_costs(x0.expand(k, -1), ctrl.permute(2, 0, 1))
    assert ours.macs == theirs[0] and ours.rows == theirs[3]
    assert ours.macs > 0
    roof = cfg["roofline"]
    n_fwd = h * k * cfg["frame_skip"] * roof["forwards_per_substep"]
    theirs_ops = chip_smoke._contact_ops(env, n_fwd, roof["factorizations"], roof["solves"],
                                         theirs[0])
    assert contact_ops(cfg["n_dof"], n_fwd, roof["factorizations"], roof["solves"],
                       ours.macs) == theirs_ops
    # one call's work: the tally over k rollouts, per rollout, times K = k
    ops, nbytes = ours.per_call(k)
    assert ops == pytest.approx(theirs_ops, rel=1e-12)
    assert nbytes == 4 * (h * env.action_dim * k + k + env.state_dim)


@pytest.mark.parametrize("name, k, h, bound", [
    # chip_smoke's printed rollout bounds (PERF.md's kernel table, rows 2 and 4),
    # at their K and T, with the QP's multiply-adds that they imply
    ("halfcheetah.cemppi.k2048-h15", 2048, 15, 0.016407),
    ("ant.cemppi.k1024-h10", 1024, 10, 0.075597),
])
def test_chip_smokes_bounds_split_into_fixed_work_and_the_qp(name, k, h, bound):
    """The part of each printed bound that needs no tally (factorizations
    and solves) lies under it, and the QP's share that remains is positive:
    the frozen arithmetic reads chip_smoke's figures the way it wrote them."""
    cfg = spec.resolve(spec.load_spec(), name).config
    roof = cfg["roofline"]
    n_fwd = h * k * cfg["frame_skip"] * roof["forwards_per_substep"]
    fixed = contact_ops(cfg["n_dof"], n_fwd, roof["factorizations"], roof["solves"], 0.0)
    total = bound * 1e-3 * PEAK_F32_FLOPS
    assert 0.0 < fixed < total
    macs = (total - fixed) / 2.0
    assert bound_ms(contact_ops(cfg["n_dof"], n_fwd, roof["factorizations"], roof["solves"],
                                macs), 0.0)[0] == pytest.approx(bound, rel=1e-9)
