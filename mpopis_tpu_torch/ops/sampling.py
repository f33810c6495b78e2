"""Gaussian control-noise sampling and multinomial resampling.

Counterpart of `mpopis_tpu/ops/sampling.py`. The JAX package draws from
counter-based keys; the port draws from a `torch.Generator`, so the two
give different numbers from one seed. Both resampling functions therefore
take their uniforms as an argument: the policy draws them from its
generator, a test hands both packages the same ones.
"""

from __future__ import annotations

import torch


def cholesky_psd(sigma: torch.Tensor, jitter: float = 0.0) -> torch.Tensor:
    """Lower Cholesky factor with optional diagonal jitter."""
    if jitter:
        sigma = sigma + jitter * torch.eye(sigma.shape[0], dtype=sigma.dtype, device=sigma.device)
    return torch.linalg.cholesky(sigma)


def mvnormal_samples(chol: torch.Tensor, num_samples: int, generator=None,
                     z: torch.Tensor | None = None) -> torch.Tensor:
    """(d, K) samples of N(0, L Lᵀ) as E = L @ Z; `z` (d, K) standard
    normals may be injected, otherwise they are drawn from `generator`."""
    if z is None:
        z = torch.randn((chol.shape[0], num_samples), generator=generator, dtype=chol.dtype,
                        device=chol.device)
    return chol @ z


def _cdf(weights: torch.Tensor) -> torch.Tensor:
    cdf = torch.cumsum(weights, dim=0)
    return cdf / cdf[-1]


def multinomial_resample_indices(weights: torch.Tensor, uniforms: torch.Tensor) -> torch.Tensor:
    """One Categorical(weights) draw per uniform in [0, 1), by inverse CDF:
    the first index whose normalized cumulative weight is ≥ u."""
    return torch.searchsorted(_cdf(weights), uniforms, side="left").to(torch.int32)


def multinomial_resample_counts(weights: torch.Tensor, uniforms: torch.Tensor) -> torch.Tensor:
    """Draw counts per category (K,), in the weights' dtype, of the draws
    `multinomial_resample_indices` makes from the same uniforms. The JAX
    package counts p_k = #{u ≤ cdf_k} with a (K, draws) compare and takes
    differences; `searchsorted(side="left")` + `bincount` buckets each draw
    the same way without the K × draws intermediate."""
    k = weights.shape[0]
    idx = torch.searchsorted(_cdf(weights), uniforms, side="left")
    # a draw past the last bucket (impossible for u < 1) is dropped, as the
    # compare drops it
    return torch.bincount(idx, minlength=k + 1)[:k].to(weights.dtype)
