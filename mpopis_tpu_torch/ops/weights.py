"""Importance weights; counterpart of `mpopis_tpu/ops/weights.py`."""

from __future__ import annotations

import torch


def information_theoretic_weights(costs: torch.Tensor, lam) -> torch.Tensor:
    """Softmax importance weights: w_k = exp(-(c_k - min c)/λ), normalized.
    `costs` (K,) → (K,) summing to 1."""
    rho = torch.min(costs)
    w = torch.exp(-(costs - rho) / lam)
    return w / torch.sum(w)


def cross_entropy_weights(costs: torch.Tensor, num_elite: int) -> torch.Tensor:
    """Uniform weights over the `num_elite` lowest-cost samples: the
    reference declares this weight method without implementing it, and the
    JAX package completes it so. Ties at the threshold may select more than
    `num_elite`; the weights are normalized by the count selected."""
    thresh = torch.sort(costs).values[num_elite - 1]
    w = (costs <= thresh).to(costs.dtype)
    return w / torch.sum(w)
