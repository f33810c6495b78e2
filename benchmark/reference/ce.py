"""The CEMPPI control step, plain, driven by given costs.

Frozen from `mpopis_tpu_torch/policies/driver.py` (`_make_gmppi_step`),
`policies/strategies.py` (`CrossEntropyStrategy.update`, the CE branch of
`make_strategy`), `ops/weights.py`, `ops/controls.py` (`roll_controls`) and
`kernels/ais_update.py` (`jitter_mat`) at commit 3b1bee442fec.

The reference cannot draw its own costs for the elite selection: an f32
cost that sits next to the elite threshold swaps sides under rounding. So it
follows the program step by step: it forms each iteration's candidates
itself from the step's inputs, and refits from the costs that the program
returned for those candidates, which the benchmark checks apart against its
own rollouts of a sample of them.

`tf32=True` gives the control: the same arithmetic in float32 with every
matrix product's operands rounded to TF32's 10-bit mantissa, the precision
that the configuration's float32 with TF32 off would drop to.
"""

from __future__ import annotations

import dataclasses

import torch

from benchmark.reference.covariance import _MASKED_ESTIMATORS


def round_tf32(a: torch.Tensor) -> torch.Tensor:
    """float32 `a` rounded to TF32 (10 explicit mantissa bits), to nearest."""
    bits = a.contiguous().view(torch.int32)
    rounded = (bits + 0x1000) & ~0x1FFF
    return rounded.view(torch.float32)


def matmul(a: torch.Tensor, b: torch.Tensor, tf32: bool) -> torch.Tensor:
    if tf32:
        return round_tf32(a) @ round_tf32(b)
    return a @ b


def it_weights(costs: torch.Tensor, lam: float) -> torch.Tensor:
    """Softmax importance weights exp(-(c - min c)/λ), normalized."""
    w = torch.exp(-(costs - torch.min(costs)) / lam)
    return w / torch.sum(w)


def jitter_mat(sigma: torch.Tensor, jitter: float, eps: float) -> torch.Tensor:
    """σ + (jitter + 100·eps·mean(diag σ))·I, eps that of the configuration's
    dtype (the program scales its floor by the dtype it computes in)."""
    scale = torch.mean(torch.diagonal(sigma))
    eps_floor = 100.0 * eps * scale
    return sigma + (jitter + eps_floor) * torch.eye(sigma.shape[0], dtype=sigma.dtype,
                                                    device=sigma.device)


def roll_controls(wc: torch.Tensor, u0: torch.Tensor, action_dim: int) -> torch.Tensor:
    """The receding-horizon shift with the reference's one-element-longer
    refill from U0."""
    cs = wc.shape[0]
    if cs == action_dim:
        return wc
    shifted = torch.cat([wc[action_dim:], u0[cs - action_dim:]])
    shifted[cs - action_dim - 1] = u0[cs - action_dim - 1]
    return shifted


@dataclasses.dataclass(frozen=True)
class CEStep:
    """CEMPPI's hyperparameters as the driver reads them."""

    num_samples: int
    horizon: int
    action_dim: int
    lam: float
    elite_threshold: float
    sigma_est: str
    cov: float  # Σ = cov·I over the horizon
    opt_its: int
    jitter_eps: float  # the machine epsilon of the configuration's dtype
    elite_stop_tol: float = 1e-2
    cov_jitter: float = 1e-8

    @property
    def cs(self) -> int:
        return self.action_dim * self.horizon

    @property
    def m_elite(self) -> int:
        return max(int(round(self.num_samples * (1.0 - self.elite_threshold))), 2)

    def elite_mask(self, costs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(0/1 mask of the m lowest costs, ties at the threshold taken in
        index order; the early-stop flag on the sorted elite costs)."""
        m = self.m_elite
        sorted_costs = torch.sort(costs).values
        stop = torch.max(torch.abs(torch.diff(sorted_costs[:m]))) < self.elite_stop_tol
        thresh = sorted_costs[m - 1]
        lt = costs < thresh
        tie = costs == thresh
        n_take = m - torch.sum(lt, dtype=torch.int32)
        tie_rank = torch.cumsum(tie.to(torch.int32), dim=0)
        return (lt | (tie & (tie_rank <= n_take))).to(costs.dtype), stop

    def refit(self, e: torch.Tensor, costs: torch.Tensor, dtype, tf32: bool):
        """(mean shift (cs,), new lower factor (cs, cs), stop) from the
        samples e (cs, K) and their costs."""
        mask, stop = self.elite_mask(costs)
        mask = mask.to(dtype)
        m = self.m_elite
        mu = matmul(e, mask[:, None], tf32)[:, 0] / m
        xc = ((e - mu[:, None]) * mask[None, :]).T
        est = _MASKED_ESTIMATORS[self.sigma_est]
        if tf32 and self.sigma_est == "mle":
            sigma = matmul(xc.T, xc, True) / m
        else:
            sigma = est(xc, m)
        sigma = jitter_mat(sigma, self.cov_jitter, self.jitter_eps)
        return mu, torch.linalg.cholesky(sigma), bool(stop)

    def run(self, u: torch.Tensor, z: list, costs: list, low, high, u0, dtype, tf32=False):
        """The control step from the plan u (cs,) with the normals z[n]
        (cs, K) and the program's costs[n] (K,) of each iteration run.

        Returns a dict: `candidates` [(cs, K)] each iteration's clamped
        candidates, `stops` [bool] the stop flag after each iteration, the
        `action` (as,) and the next plan `u_next` (cs,)."""
        low_f = low.repeat(self.horizon)[:, None]
        high_f = high.repeat(self.horizon)[:, None]
        u_orig = u
        u_cur = u
        chol = torch.eye(self.cs, dtype=dtype, device=u.device) * self.cov ** 0.5
        cands, stops = [], []
        e = None
        for n in range(len(costs)):
            e = matmul(chol, z[n], tf32)
            cands.append(torch.clamp(u_cur[:, None] + e, low_f, high_f))
            if n < len(costs) - 1:
                mu, chol, stop = self.refit(e, costs[n], dtype, tf32)
                stops.append(stop)
                u_cur = u_cur + mu
            else:
                stops.append(bool(self.elite_mask(costs[n])[1]))
        e_final = e + (u_cur - u_orig)[:, None]
        w = it_weights(costs[-1], self.lam)
        wc = u_orig + matmul(e_final, w[:, None], tf32)[:, 0]
        action = torch.clamp(wc[:self.action_dim], low, high)
        return {"candidates": cands, "stops": stops, "action": action,
                "u_next": roll_controls(wc, u0, self.action_dim)}


def policy_step(config: dict, traffic: dict, action_dim: int) -> CEStep:
    """The CEMPPI step of a configuration that names `cemppi`, at the
    traffic's sample budget."""
    if config["policy"] != "cemppi":
        raise ValueError(f"configuration {config['name']}: policy {config['policy']!r}, "
                         "and this reference is CEMPPI's")
    return CEStep(num_samples=traffic["num_samples"], horizon=traffic["horizon"],
                  action_dim=action_dim, lam=traffic["lam"],
                  elite_threshold=config["ce_elite_threshold"], sigma_est=traffic["sigma_est"],
                  cov=traffic["cov"], opt_its=traffic["ais_its"],
                  jitter_eps=torch.finfo(getattr(torch, config["dtype"])).eps)
