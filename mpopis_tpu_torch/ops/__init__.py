from mpopis_tpu_torch.ops.controls import (
    action_bounds_tiled,
    block_diag_repeat,
    clamp_controls,
    controls_from_flat,
    roll_controls,
)
from mpopis_tpu_torch.ops.covariance import (
    mean_and_cov,
    shrinkage_cov,
    shrinkage_cov_masked,
    weighted_mean_and_cov,
)
from mpopis_tpu_torch.ops.sampling import (
    cholesky_psd,
    multinomial_resample_counts,
    multinomial_resample_indices,
    mvnormal_samples,
)
from mpopis_tpu_torch.ops.weights import cross_entropy_weights, information_theoretic_weights

__all__ = [
    "action_bounds_tiled",
    "block_diag_repeat",
    "clamp_controls",
    "controls_from_flat",
    "roll_controls",
    "mean_and_cov",
    "shrinkage_cov",
    "shrinkage_cov_masked",
    "weighted_mean_and_cov",
    "cholesky_psd",
    "multinomial_resample_counts",
    "multinomial_resample_indices",
    "mvnormal_samples",
    "cross_entropy_weights",
    "information_theoretic_weights",
]
