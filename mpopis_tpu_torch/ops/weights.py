"""Importance weights; counterpart of `mpopis_tpu/ops/weights.py`."""

from __future__ import annotations

import torch


def information_theoretic_weights(costs: torch.Tensor, lam) -> torch.Tensor:
    """Softmax importance weights: w_k = exp(-(c_k - min c)/λ), normalized.
    `costs` (K,) → (K,) summing to 1."""
    rho = torch.min(costs)
    w = torch.exp(-(costs - rho) / lam)
    return w / torch.sum(w)
