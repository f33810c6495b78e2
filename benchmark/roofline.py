"""The H100's published peaks and the rollout's operation and byte counts.

Frozen from `chip_smoke.py` at commit 3b1bee442fec (`PEAK_F32_FLOPS`,
`PEAK_BYTES_S`, `_bound`, `_qp_tally` as a class, `_contact_ops`): the counts are
those of the algorithm at the cell's shapes, whatever kernel computes it.
"""

from __future__ import annotations

import torch

# NVIDIA's data sheet, H100 SXM: float32 outside the tensor cores, HBM3
PEAK_F32_FLOPS, PEAK_BYTES_S = 67e12, 3.35e12


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    """(ms, what bounds it): the larger of the operations over the float32
    peak and the bytes over the memory rate."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


class QPTally:
    """Tally the contact QP's multiply-adds in the plain `module.solve_qp`
    calls made inside it (a context manager): per sample with at least one
    valid row, outer × (cg + 6 arc trials + 2) applications of J M⁻¹ Jᵀ over
    its valid rows, 2·R·n + n² each; a sample with none skips its QP. `macs`
    and `rows` (valid rows) sum over calls and samples."""

    def __init__(self, module, outer: int, cg: int, n: int):
        self.module, self.outer, self.cg, self.n = module, outer, cg, n
        self.macs, self.rows = 0.0, 0

    def __enter__(self):
        self.orig = orig = self.module.solve_qp
        outer, cg, n = self.outer, self.cg, self.n

        def counting(jmat, aref, r_reg, active, *args, **kwargs):
            rows = active.sum(-1).double()
            self.macs += float(torch.where(rows > 0, outer * (cg + 8) * (2.0 * rows * n + n * n),
                                           0.0).sum())
            self.rows += int(active.sum())
            return orig(jmat, aref, r_reg, active, *args, **kwargs)

        self.module.solve_qp = counting
        return self

    def __exit__(self, *exc):
        self.module.solve_qp = self.orig
        return False


def contact_ops(n: int, n_forward: float, factorizations: int, solves: int,
                qp_macs: float) -> float:
    """Operations of n_forward constrained forward passes of an n-dof model:
    the mass-matrix factorizations (n³/3 each) and solves (2n² each), and the
    QP's tallied multiply-adds (2 operations each)."""
    return n_forward * (factorizations * n**3 / 3.0 + solves * 2.0 * n * n) + 2.0 * qp_macs


class ContactWork(QPTally):
    """The work of one K-sample rollout call of a contact task at the cell's
    shapes, for the rollout's roofline. As a context manager it tallies the
    QP over the plain reference's checked rollouts (`QPTally`); `per_call`
    scales that to K and adds the mass-matrix factorizations and solves of
    every forward pass (the configuration's `roofline` gives the passes per
    substep, 4 for RK4, and the factorizations and solves of each) and the
    bytes: the controls and the start state read, the costs written."""

    def __init__(self, module, config: dict, traffic: dict):
        super().__init__(module, config["solver_outer"], config["solver_cg"], config["n_dof"])
        self.config, self.traffic = config, traffic

    def per_call(self, n_rollouts: int) -> tuple[float, float] | None:
        """(operations, bytes) of one call, or None if nothing was tallied."""
        if n_rollouts <= 0:
            return None
        cfg, k, h = self.config, self.traffic["num_samples"], self.traffic["horizon"]
        roof = cfg["roofline"]
        n_forward = h * k * cfg["frame_skip"] * roof["forwards_per_substep"]
        ops = contact_ops(cfg["n_dof"], n_forward, roof["factorizations"], roof["solves"],
                          self.macs / n_rollouts * k)
        dtype_bytes = torch.finfo(getattr(torch, cfg["dtype"])).bits // 8
        return ops, dtype_bytes * (h * cfg["action_dim"] * k + k + cfg["state_dim"])
