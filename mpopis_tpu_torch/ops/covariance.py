"""Linear-shrinkage covariance estimators over masked sample columns.

Counterpart of `mpopis_tpu/ops/covariance.py::shrinkage_cov_masked` and
the five estimators behind the CE refit's `sigma_est` (`mle`, `lw`, `ss`,
`rblw`, `oas`): Ledoit & Wolf 2004 (diagonal-unequal-variance target),
Schäfer & Strimmer 2005 (Target D), and Chen, Wiesel, Eldar & Hero 2009
(RBLW / OAS, diagonal-common-variance target). Each takes centered data
`xc` (n_rows, p) whose unselected rows are zero and the selected count n.
"""

from __future__ import annotations

import torch


def _offdiag_sum(m: torch.Tensor) -> torch.Tensor:
    return torch.sum(m) - torch.sum(torch.diagonal(m))


def _offdiag_sum_sq(m: torch.Tensor) -> torch.Tensor:
    return torch.sum(m * m) - torch.sum(torch.diagonal(m) ** 2)


def _tiny(t: torch.Tensor) -> float:
    return torch.finfo(t.dtype).tiny


def _mle_from_centered(xc: torch.Tensor, n: int) -> torch.Tensor:
    return (xc.T @ xc) / n


def _lw_from_centered(xc: torch.Tensor, n: int) -> torch.Tensor:
    """Ledoit–Wolf: λ = Σ_{i≠j} Var̂(S_ij) / Σ_{i≠j} S_ij², target diag(S)."""
    s = (xc.T @ xc) / n
    prod_sq = ((xc * xc).T @ (xc * xc)) / n  # E[(x_i x_j)^2]
    var_s = (prod_sq - s * s) / n
    num = _offdiag_sum(var_s)
    den = _offdiag_sum_sq(s)
    lam = torch.clamp(num / torch.clamp(den, min=_tiny(s)), 0.0, 1.0)
    f = torch.diag(torch.diagonal(s))
    return (1.0 - lam) * s + lam * f


def _ss_from_centered(xc: torch.Tensor, n: int) -> torch.Tensor:
    """Schäfer–Strimmer Target D: shrink the off-diagonal correlations toward
    zero with the paper's unbiased small-sample constants, keep the
    variances (rescaled by the uncorrected MLE standard deviations)."""
    p = xc.shape[1]
    tiny = _tiny(xc)
    v = torch.sum(xc * xc, dim=0) / (n - 1)  # unbiased variances
    sd = torch.sqrt(torch.clamp(v, min=tiny))
    xs = xc / sd[None, :]
    wbar = (xs.T @ xs) / n  # mean of w_kij
    r = (n / (n - 1)) * wbar
    # Σ_k (w_kij - w̄)² = Σ_k w² - n w̄²
    sum_w2 = (xs * xs).T @ (xs * xs)
    var_r = (n / (n - 1) ** 3) * (sum_w2 - n * wbar * wbar)
    num = _offdiag_sum(var_r)
    den = _offdiag_sum_sq(r)
    lam = torch.clamp(num / torch.clamp(den, min=tiny), 0.0, 1.0)
    r_shrunk = (1.0 - lam) * r
    eye = torch.eye(p, dtype=xc.dtype, device=xc.device)
    r_shrunk = r_shrunk - torch.diag(torch.diagonal(r_shrunk)) + eye
    v_mle = torch.sum(xc * xc, dim=0) / n
    sd_mle = torch.sqrt(torch.clamp(v_mle, min=tiny))
    return r_shrunk * sd_mle[:, None] * sd_mle[None, :]


def _common_variance_from_centered(xc: torch.Tensor, n: int, rho_fn) -> torch.Tensor:
    p = xc.shape[1]
    s = (xc.T @ xc) / n
    tr_s = torch.trace(s)
    tr_s2 = torch.sum(s * s)  # tr(S²) for symmetric S
    f = (tr_s / p) * torch.eye(p, dtype=xc.dtype, device=xc.device)
    rho = torch.clamp(rho_fn(n, p, tr_s, tr_s2), 0.0, 1.0)
    return (1.0 - rho) * s + rho * f


def _rho_rblw(n, p, tr_s, tr_s2):
    """Rao-Blackwellized Ledoit-Wolf (Chen et al. 2009, eq. 17)."""
    num = ((n - 2.0) / n) * tr_s2 + tr_s**2
    den = (n + 2.0) * (tr_s2 - tr_s**2 / p)
    return num / torch.clamp(den, min=_tiny(tr_s))


def _rho_oas(n, p, tr_s, tr_s2):
    """Oracle-Approximating Shrinkage (Chen et al. 2009, eq. 23)."""
    num = (1.0 - 2.0 / p) * tr_s2 + tr_s**2
    den = (n + 1.0 - 2.0 / p) * (tr_s2 - tr_s**2 / p)
    return num / torch.clamp(den, min=_tiny(tr_s))


_MASKED_ESTIMATORS = {
    "mle": _mle_from_centered,
    "lw": _lw_from_centered,
    "ss": _ss_from_centered,
    "rblw": lambda xc, n: _common_variance_from_centered(xc, n, _rho_rblw),
    "oas": lambda xc, n: _common_variance_from_centered(xc, n, _rho_oas),
}


def shrinkage_cov_masked(
    e: torch.Tensor, mask: torch.Tensor, m: int, method: str = "mle"
) -> torch.Tensor:
    """Shrinkage covariance over the masked COLUMNS of e (d, K): `mask` (K,)
    selects exactly `m` columns (0/1 in e's dtype). The masked columns are
    centered then zeroed, so every sample sum picks up only the selected
    columns — the same estimate as on the gathered (m, d) elite matrix."""
    try:
        est = _MASKED_ESTIMATORS[method]
    except KeyError:
        raise ValueError(
            f"unknown Σ estimation method {method!r}; options: "
            f"{sorted(_MASKED_ESTIMATORS)}"
        ) from None
    mu = (e @ mask) / m
    xc = ((e - mu[:, None]) * mask[None, :]).T  # (K, d), zeros off-mask
    return est(xc, m)
