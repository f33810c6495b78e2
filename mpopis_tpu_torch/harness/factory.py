"""Policy factory: maps the reference's policy symbols and kwargs onto
PolicyConfig + make_policy. Counterpart of `mpopis_tpu/harness/factory.py`."""

from __future__ import annotations

from mpopis_tpu_torch.models.base import Env
from mpopis_tpu_torch.policies import Policy, PolicyConfig, make_policy


def get_policy(
    policy_type,
    env: Env,
    num_samples: int,
    horizon: int,
    lam: float,
    alpha: float,
    u0,
    cov_mat,
    pol_log: bool = False,
    ais_its: int = 10,
    lambda_ais: float = 20.0,
    ce_elite_threshold: float = 0.8,
    ce_sigma_est="mle",
    cma_sigma: float = 0.75,
    cma_elite_threshold: float = 0.8,
    nes_step_factor: float = 0.01,
    use_fused_rollout: bool = True,
    sample_mesh=None,
) -> Policy:
    cfg = PolicyConfig(
        kind=str(policy_type),
        num_samples=num_samples,
        horizon=horizon,
        lam=lam,
        alpha=alpha,
        opt_its=ais_its,
        lambda_ais=lambda_ais,
        ce_elite_threshold=ce_elite_threshold,
        sigma_est=str(ce_sigma_est).lstrip(":"),
        cma_sigma=cma_sigma,
        cma_elite_threshold=cma_elite_threshold,
        nes_step_factor=nes_step_factor,
        log=pol_log,
        use_fused_rollout=use_fused_rollout,
    )
    return make_policy(env, cfg, u0=u0, cov_mat=cov_mat, sample_mesh=sample_mesh)
