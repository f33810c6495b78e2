"""Adaptive-importance-sampling strategies.

Counterpart of `mpopis_tpu/policies/strategies.py`: given the current AIS
carry (mean U, sampling-covariance factor, this iteration's samples E and
costs), a strategy produces the next carry and an early-stop flag. Ported:
plain GMPPI (no adaptation) and cross-entropy (CEMPPI); the other kinds
raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from mpopis_tpu_torch.kernels.linalg import cholesky_lower
from mpopis_tpu_torch.ops.covariance import shrinkage_cov_masked


@dataclasses.dataclass(frozen=True)
class AISCarry:
    U: torch.Tensor  # (cs,) current AIS mean
    chol: torch.Tensor  # (cs,cs) lower factor of the current sampling cov
    E: torch.Tensor  # (cs,K) last iteration's samples
    costs: torch.Tensor  # (K,) last iteration's trajectory costs
    trajs: Any  # (K,T,ss) logged states or None

    def replace(self, **changes) -> "AISCarry":
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True, eq=False)
class Strategy:
    """A no-op strategy (plain GMPPI: single-iteration, no adaptation)."""

    cfg: Any
    cs: int
    num_samples: int
    dtype: Any

    def init_chol(self, chol0: torch.Tensor) -> torch.Tensor:
        return chol0

    @property
    def can_stop(self) -> bool:
        """True when update() can ever return stop=True; only then does the
        driver read the stop flag back to the host each iteration."""
        return False

    def update(self, carry: AISCarry, generator, u_orig, it_index):
        """Returns (updated carry, stop_now as a 0-dim bool tensor or None).
        `carry` already holds this iteration's E/costs/trajs; `it_index` is
        the 1-based iteration number."""
        return carry, None


def _jittered(sigma: torch.Tensor, jitter: float) -> torch.Tensor:
    """Diagonal jitter before Cholesky: the reference's fixed 1e-8·I plus a
    dtype-scaled floor that keeps a rank-deficient refit (m_elite < cs
    with `mle`) positive definite in f32 too."""
    scale = torch.mean(torch.diagonal(sigma))
    eps_floor = 100.0 * torch.finfo(sigma.dtype).eps * scale
    eye = torch.eye(sigma.shape[0], dtype=sigma.dtype, device=sigma.device)
    return sigma + (jitter + eps_floor) * eye


@dataclasses.dataclass(frozen=True, eq=False)
class CrossEntropyStrategy(Strategy):
    """CE-MPOPI: elite selection, shrinkage Σ refit, elite-mean shift, and
    early stop on flat elite costs."""

    m_elite: int = 10

    @property
    def can_stop(self) -> bool:
        return float(self.cfg.elite_stop_tol) > 0.0

    def update(self, carry, generator, u_orig, it_index):
        # A value sort gives the sorted elite costs (the stop test); the
        # refit runs K-dense through a 0/1 mask whose ties at the threshold
        # are taken in index order — the reference's stable sortperm.
        m = self.m_elite
        costs = carry.costs
        sorted_costs = torch.sort(costs).values
        elite_costs = sorted_costs[:m]
        stop = torch.max(torch.abs(torch.diff(elite_costs))) < self.cfg.elite_stop_tol
        thresh = sorted_costs[m - 1]
        lt = costs < thresh
        tie = costs == thresh
        n_take = m - torch.sum(lt, dtype=torch.int32)
        tie_rank = torch.cumsum(tie.to(torch.int32), dim=0)
        mask = (lt | (tie & (tie_rank <= n_take))).to(costs.dtype)
        mu = (carry.E @ mask) / m
        sigma = shrinkage_cov_masked(carry.E, mask, m, self.cfg.sigma_est)
        chol = cholesky_lower(_jittered(sigma, self.cfg.cov_jitter))
        return carry.replace(U=carry.U + mu, chol=chol), stop


def make_strategy(cfg, cs: int, dtype) -> Strategy:
    """Build the strategy for cfg.kind (gmppi and cemppi so far)."""
    k = cfg.num_samples
    base = dict(cfg=cfg, cs=cs, num_samples=k, dtype=dtype)
    kind = cfg.kind
    if kind == "gmppi":
        return Strategy(**base)
    if kind == "cemppi":
        m_elite = int(round(k * (1.0 - cfg.ce_elite_threshold)))
        return CrossEntropyStrategy(**base, m_elite=max(m_elite, 2))
    raise NotImplementedError(f"policy kind {kind!r}: not yet ported")
