"""Adaptive-importance-sampling strategies.

Counterpart of `mpopis_tpu/policies/strategies.py`: given the current AIS
carry (mean U, sampling-covariance factor, this iteration's samples E and
costs), a strategy produces the next carry and an early-stop flag — plain
GMPPI (no adaptation), IMPPI and μ-AIS (mean only), μΣ-AIS (mean and
covariance), PMC (multinomial resampling), CE, CMA-ES and NES. With
`MPOPIS_FUSED_UPDATE=1` in float32, CE, μΣ-AIS, PMC and CMA run their
update through the fused kernels of `kernels/ais_update.py`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from mpopis_tpu_torch.kernels.ais_update import (
    cma_update_chol,
    fused_update_enabled,
    inv_sqrt_newton_schulz,
    jitter_mat,
    masked_refit_chol,
    weighted_refit_chol,
)
from mpopis_tpu_torch.kernels.linalg import cholesky_lower
from mpopis_tpu_torch.ops.covariance import shrinkage_cov_masked, weighted_mean_and_cov
from mpopis_tpu_torch.ops.sampling import multinomial_resample_counts
from mpopis_tpu_torch.ops.weights import information_theoretic_weights
from mpopis_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class AISCarry:
    U: torch.Tensor  # (cs,) current AIS mean
    chol: torch.Tensor  # (cs,cs) lower factor of the current sampling cov
    E: torch.Tensor  # (cs,K) last iteration's samples
    costs: torch.Tensor  # (K,) last iteration's trajectory costs
    trajs: Any  # (K,T,ss) logged states or None
    extra: Any = None  # strategy-specific state (CMA's Σ, σ and paths; NES's A)

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

    def update(self, carry: AISCarry, generator, u_orig, it_index, uniforms=None):
        """Returns (updated carry, stop_now as a 0-dim bool tensor or None).
        `carry` already holds this iteration's E/costs/trajs; `it_index` is
        the 1-based iteration number; `uniforms` (K,) replaces PMC's draws
        from `generator`."""
        return carry, None


def _eigh_inv_sqrt(sigma: torch.Tensor, guards: bool) -> torch.Tensor:
    """C = Σ^−1/2 by eigendecomposition, with a relative eigenvalue floor
    under the guards (the scalar rank-μ quirk can leave Σ indefinite)."""
    evals, evecs = torch.linalg.eigh(sigma)
    if guards:
        eps = torch.finfo(sigma.dtype).eps
        floor = torch.clamp(torch.clamp(evals[-1], min=0.0) * eps * 10.0, min=1e-30)
    else:
        floor = 1e-30
    inv_sqrt = 1.0 / torch.sqrt(torch.clamp(evals, min=floor))
    return (evecs * inv_sqrt[None, :]) @ evecs.T


@dataclasses.dataclass(frozen=True, eq=False)
class MeanOnlyStrategy(Strategy):
    """IMPPI (λ = policy λ) and μ-AIS (decoupled λ_ais): weighted moment
    matching of the mean only; Σ stays fixed."""

    inner_lam: float = 1.0

    def update(self, carry, generator, u_orig, it_index, uniforms=None):
        ws = information_theoretic_weights(carry.costs, self.inner_lam)
        return carry.replace(U=carry.U + carry.E @ ws), None


@dataclasses.dataclass(frozen=True, eq=False)
class MeanCovStrategy(Strategy):
    """μΣ-AIS: weighted moment matching of mean and covariance with jitter."""

    inner_lam: float = 20.0

    def update(self, carry, generator, u_orig, it_index, uniforms=None):
        ws = information_theoretic_weights(carry.costs, self.inner_lam)
        if fused_update_enabled(self.dtype):
            mu = carry.E @ ws
            chol = weighted_refit_chol(carry.E, ws, mu, corrected=False,
                                       jitter=float(self.cfg.cov_jitter))
        else:
            mu, sigma = weighted_mean_and_cov(carry.E, ws)
            chol = cholesky_lower(jitter_mat(sigma, self.cfg.cov_jitter))
        return carry.replace(U=carry.U + mu, chol=chol), None


@dataclasses.dataclass(frozen=True, eq=False)
class PMCStrategy(Strategy):
    """Population Monte Carlo: multinomial resampling of the sample columns,
    then the unweighted corrected moments of the resampled set, taken
    through the draw counts (the same statistics as gathering the columns)."""

    inner_lam: float = 20.0

    def update(self, carry, generator, u_orig, it_index, uniforms=None):
        ws = information_theoretic_weights(carry.costs, self.inner_lam)
        k = self.num_samples
        if uniforms is None:
            uniforms = torch.rand(k, generator=generator, dtype=ws.dtype, device=ws.device)
        counts = multinomial_resample_counts(ws, uniforms)
        mu = carry.E @ (counts / k)
        if fused_update_enabled(self.dtype):
            chol = weighted_refit_chol(carry.E, counts / k, mu, corrected=True,
                                       jitter=float(self.cfg.cov_jitter))
        else:
            xc = carry.E - mu[:, None]
            sigma = (xc * counts[None, :]) @ xc.T / (k - 1)
            chol = cholesky_lower(jitter_mat(sigma, self.cfg.cov_jitter))
        return carry.replace(U=carry.U + mu, chol=chol), None


@dataclasses.dataclass(frozen=True, eq=False)
class CrossEntropyStrategy(Strategy):
    """CE-MPOPI: elite selection, shrinkage Σ refit, elite-mean shift, and
    early stop on flat elite costs."""

    m_elite: int = 10

    @property
    def can_stop(self) -> bool:
        return float(self.cfg.elite_stop_tol) > 0.0

    def update(self, carry, generator, u_orig, it_index, uniforms=None):
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
        if fused_update_enabled(self.dtype):
            chol = masked_refit_chol(carry.E, mask, mu, m, self.cfg.sigma_est,
                                     float(self.cfg.cov_jitter))
        else:
            sigma = shrinkage_cov_masked(carry.E, mask, m, self.cfg.sigma_est)
            chol = cholesky_lower(jitter_mat(sigma, self.cfg.cov_jitter))
        return carry.replace(U=carry.U + mu, chol=chol), stop


@dataclasses.dataclass(frozen=True, eq=False)
class CMAStrategy(Strategy):
    """CMA-ES adaptation per control step. The constants (log-rank weights,
    μ_eff, c_σ, d_σ, c_Σ, c1, c_μ, E‖N(0, I)‖) follow the reference's
    constructor. The rank-μ term reproduces the reference's degenerate
    scalar form by default (it linearly indexes the cs × m_elite elite
    matrix with sample ranks up to K, so a scalar is added to every Σ
    entry); `cma_rank_mu_quirk=False` takes the textbook outer-product form.
    """

    sigma0: float = 1.0
    m_elite: int = 10
    ws: np.ndarray = None  # (K,)
    mu_eff: float = 0.0
    c_sigma: float = 0.0
    d_sigma: float = 0.0
    c_Sigma: float = 0.0
    c1: float = 0.0
    c_mu: float = 0.0
    e_norm: float = 0.0

    @staticmethod
    def constants(num_samples: int, cs: int, elite_perc_threshold: float):
        m = num_samples
        n = cs
        m_elite = int(round((1.0 - elite_perc_threshold) * m))
        ws = np.log((m + 1) / 2.0) - np.log(np.arange(1, m + 1))
        ws[:m_elite] = ws[:m_elite] / np.sum(ws[:m_elite])
        mu_eff = 1.0 / np.sum(ws[:m_elite] ** 2)
        c_sigma = (mu_eff + 2.0) / (n + mu_eff + 5.0)
        d_sigma = 1.0 + 2.0 * max(0.0, np.sqrt((mu_eff - 1.0) / (n + 1.0)) - 1.0) + c_sigma
        c_Sigma = (4.0 + mu_eff / n) / (n + 4.0 + 2.0 * mu_eff / n)
        c1 = 2.0 / ((n + 1.3) ** 2 + mu_eff)
        c_mu = min(1.0 - c1, 2.0 * (mu_eff - 2.0 + 1.0 / mu_eff) / ((n + 2.0) ** 2 + mu_eff))
        tail = ws[m_elite:]
        ws[m_elite:] = tail * (-(1.0 + c1 / c_mu) / np.sum(tail))
        e_norm = n**0.5 * (1.0 - 1.0 / (4.0 * n) + 1.0 / (21.0 * n**2))
        return dict(m_elite=m_elite, ws=ws, mu_eff=mu_eff, c_sigma=c_sigma, d_sigma=d_sigma,
                    c_Sigma=c_Sigma, c1=c1, c_mu=c_mu, e_norm=e_norm)

    def make_extra(self, sigma0_mat: torch.Tensor):
        return dict(
            Sigma=sigma0_mat,
            sigma=torch.tensor(self.sigma0, dtype=self.dtype, device=sigma0_mat.device),
            p_sigma=torch.zeros(self.cs, dtype=self.dtype, device=sigma0_mat.device),
            p_Sigma=torch.zeros(self.cs, dtype=self.dtype, device=sigma0_mat.device),
        )

    def init_chol(self, chol0: torch.Tensor) -> torch.Tensor:
        # samples from N(0, σ²Σ) when there is more than one iteration
        if self.cfg.opt_its > 1:
            return self.sigma0 * chol0
        return chol0

    @property
    def can_stop(self) -> bool:
        return float(self.cfg.elite_stop_tol) > 0.0

    def _consts(self):
        return tuple(sorted((name, float(getattr(self, name))) for name in
                            ("c1", "c_Sigma", "c_mu", "c_sigma", "d_sigma", "e_norm", "mu_eff")))

    def update(self, carry, generator, u_orig, it_index, uniforms=None):
        cfg = self.cfg
        cs = self.cs
        ex = carry.extra
        sigma_s, Sigma = ex["sigma"], ex["Sigma"]
        ws = torch.as_tensor(self.ws, dtype=self.dtype, device=carry.E.device)

        # stable, as the JAX package's argsort: ties keep sample order
        order = torch.argsort(carry.costs, stable=True)
        elite_idx = order[: self.m_elite]
        elite_costs = carry.costs[elite_idx]
        stop = torch.max(torch.abs(torch.diff(elite_costs))) < cfg.elite_stop_tol

        kk = self.num_samples
        if fused_update_enabled(self.dtype) and cfg.cma_rank_mu_quirk and kk <= cs * self.m_elite:
            # δw without the elite-column gather: the rank weights scattered
            # back to sample order, then one product; svals = ds_flat[order]
            # decomposed as E[i % cs, order[i // cs]] / σ for i = order[j]
            # (valid because K ≤ cs·m_elite)
            rank_w = torch.where(torch.arange(kk, device=ws.device) < self.m_elite, ws, 0.0)
            wp = torch.zeros(kk, dtype=self.dtype, device=ws.device)
            wp[order] = rank_w
            dw = carry.E @ wp
            u_new = carry.U + sigma_s * dw
            svals = carry.E[order % cs, order[order // cs]] / sigma_s
            chol_new, Sigma_new, p_sigma, p_Sigma, sigma_new = cma_update_chol(
                Sigma, dw, ex["p_sigma"], ex["p_Sigma"], svals, ws, sigma_s, float(it_index),
                self._consts(), jitter=float(cfg.cov_jitter), guards=cfg.cma_stability_guards,
                update_chol=cfg.opt_its > 1,
            )
            if cfg.opt_its <= 1:
                chol_new = carry.chol
            extra = dict(Sigma=Sigma_new, sigma=sigma_new, p_sigma=p_sigma, p_Sigma=p_Sigma)
            return carry.replace(U=u_new, chol=chol_new, extra=extra), stop

        elite_e = carry.E[:, elite_idx]
        ds = elite_e / sigma_s
        dw = elite_e @ ws[: self.m_elite]
        u_new = carry.U + sigma_s * dw

        # C = Σ^−1/2. `cma_fast_sqrt` takes Newton–Schulz and falls back to
        # eigh when it has not converged; the convergence test is a host read.
        if cfg.cma_fast_sqrt:
            c_ns, ns_err = inv_sqrt_newton_schulz(Sigma)
            with span("mpopis.sync.ns_converged"):
                converged = bool(torch.isfinite(ns_err) & (ns_err < 1e-3))
            if converged:
                c_mat = c_ns
            else:
                c_mat = _eigh_inv_sqrt(Sigma, cfg.cma_stability_guards)
        else:
            c_mat = _eigh_inv_sqrt(Sigma, cfg.cma_stability_guards)

        p_sigma = (1.0 - self.c_sigma) * ex["p_sigma"] + math.sqrt(
            self.c_sigma * (2.0 - self.c_sigma) * self.mu_eff
        ) * (c_mat @ dw)
        norm_ps = torch.sqrt(torch.sum(p_sigma**2))
        # f32 guards on the step-size exponent and σ; they never bind in the
        # stable regime, `cma_stability_guards=False` gives the raw reference
        step_exp = self.c_sigma / self.d_sigma * (norm_ps / self.e_norm - 1.0)
        if cfg.cma_stability_guards:
            step_exp = torch.clamp(step_exp, -20.0, 20.0)
        sigma_new = sigma_s * torch.exp(step_exp)
        if cfg.cma_stability_guards:
            sigma_new = torch.clamp(sigma_new, 1e-10, 1e10)

        # h_σ uses the 1-based iteration number
        it_f = torch.as_tensor(float(it_index), dtype=self.dtype, device=ws.device)
        denom = torch.sqrt(1.0 - torch.pow(1.0 - self.c_sigma, 2.0 * it_f))
        h_sigma = (norm_ps / denom < (1.4 + 2.0 / (cs + 1.0)) * self.e_norm).to(self.dtype)
        p_Sigma = (1.0 - self.c_Sigma) * ex["p_Sigma"] + h_sigma * math.sqrt(
            self.c_Sigma * (2.0 - self.c_Sigma) * self.mu_eff
        ) * dw

        if cfg.cma_rank_mu_quirk:
            # δs[order[ii]] is a scalar: a column-major linear index into the
            # cs × m_elite elite matrix with a sample rank up to K. Past its
            # end (K > cs·m_elite) the JAX package's gather clamps the index
            # to the last entry; so does this one.
            ds_flat = ds.T.reshape(-1)
            svals = ds_flat[torch.clamp(order, max=ds_flat.shape[0] - 1)]
            norm_c2 = torch.sum(c_mat * c_mat)
            w0 = torch.where(ws >= 0.0, ws,
                             it_f * ws / torch.clamp(norm_c2 * svals**2, min=1e-30))
            rank_mu = torch.sum(w0 * svals**2)
        else:
            y = carry.E[:, order] / sigma_s
            cy = c_mat @ y
            ncy2 = torch.sum(cy * cy, dim=0)
            w0 = torch.where(ws >= 0.0, ws, cs * ws / torch.clamp(ncy2, min=1e-30))
            rank_mu = (y * w0[None, :]) @ y.T

        Sigma_new = (
            (1.0 - self.c1 - self.c_mu) * Sigma
            + self.c1 * (torch.outer(p_Sigma, p_Sigma)
                         + (1.0 - h_sigma) * self.c_Sigma * (2.0 - self.c_Sigma) * Sigma)
            + self.c_mu * rank_mu
        )
        Sigma_new = torch.triu(Sigma_new) + torch.triu(Sigma_new, 1).T

        if cfg.opt_its > 1:
            chol_new = sigma_new * cholesky_lower(jitter_mat(Sigma_new, cfg.cov_jitter))
        else:
            chol_new = carry.chol
        extra = dict(Sigma=Sigma_new, sigma=sigma_new, p_sigma=p_sigma, p_Sigma=p_Sigma)
        return carry.replace(U=u_new, chol=chol_new, extra=extra), stop


@dataclasses.dataclass(frozen=True, eq=False)
class NESStrategy(Strategy):
    """Natural evolution strategies: analytic log-density gradients with
    respect to μ and A = √Σ, gradient descent with `nes_step_factor`, early
    stop on flat costs."""

    def make_extra(self, a0_mat: torch.Tensor):
        return dict(A=a0_mat)

    @property
    def can_stop(self) -> bool:
        return float(self.cfg.elite_stop_tol) > 0.0

    def update(self, carry, generator, u_orig, it_index, uniforms=None):
        cfg = self.cfg
        k = self.num_samples
        # early stop on raw (unsorted) adjacent cost differences
        stop = torch.max(torch.abs(torch.diff(carry.costs))) < cfg.elite_stop_tol
        a_mat = carry.extra["A"]
        eye = torch.eye(self.cs, dtype=self.dtype, device=a_mat.device)
        sigma_inv = torch.cholesky_solve(eye, carry.chol, upper=False)
        e = carry.E
        c = carry.costs
        g_mu = sigma_inv @ (e @ c)  # Σ_k Σ⁻¹ E_k c_k
        g = (e * c[None, :]) @ e.T  # Σ_k c_k E_k E_kᵀ
        m = 0.5 * (sigma_inv @ g @ sigma_inv) - 0.5 * torch.sum(c) * sigma_inv
        grad_a = a_mat @ (m + m.T)
        a_new = a_mat - (cfg.nes_step_factor / k) * grad_a / k  # the reference divides by K twice
        sigma_new = a_new.T @ a_new
        u_new = carry.U - (cfg.nes_step_factor / k) * g_mu
        chol_new = cholesky_lower(jitter_mat(sigma_new, cfg.cov_jitter))
        return carry.replace(U=u_new, chol=chol_new, extra=dict(A=a_new)), stop


def make_strategy(cfg, cs: int, dtype) -> Strategy:
    """Build the strategy for cfg.kind (every kind but plain `mppi`)."""
    k = cfg.num_samples
    base = dict(cfg=cfg, cs=cs, num_samples=k, dtype=dtype)
    kind = cfg.kind
    if kind == "gmppi":
        return Strategy(**base)
    if kind == "imppi":
        return MeanOnlyStrategy(**base, inner_lam=cfg.lam)
    if kind == "muaismppi":
        return MeanOnlyStrategy(**base, inner_lam=cfg.lambda_ais)
    if kind == "musigmaaismppi":
        return MeanCovStrategy(**base, inner_lam=cfg.lambda_ais)
    if kind == "pmcmppi":
        return PMCStrategy(**base, inner_lam=cfg.lambda_ais)
    if kind == "cemppi":
        m_elite = int(round(k * (1.0 - cfg.ce_elite_threshold)))
        return CrossEntropyStrategy(**base, m_elite=max(m_elite, 2))
    if kind == "cmamppi":
        consts = CMAStrategy.constants(k, cs, cfg.cma_elite_threshold)
        return CMAStrategy(**base, sigma0=cfg.cma_sigma, **consts)
    if kind == "nesmppi":
        return NESStrategy(**base)
    raise ValueError(f"no AIS strategy for kind {kind!r}")
