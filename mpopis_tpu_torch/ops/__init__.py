from mpopis_tpu_torch.ops.controls import clamp_controls, roll_controls
from mpopis_tpu_torch.ops.covariance import shrinkage_cov_masked
from mpopis_tpu_torch.ops.weights import information_theoretic_weights

__all__ = [
    "clamp_controls",
    "roll_controls",
    "shrinkage_cov_masked",
    "information_theoretic_weights",
]
