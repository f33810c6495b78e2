"""Policy configuration and state.

Counterpart of `mpopis_tpu/policies/config.py`. `PolicyConfig` is a copy
of the JAX package's table (a test pins fields and defaults to it). The
persistent policy state is (U, generator): the receding-horizon mean and
an explicit `torch.Generator` on the policy's device in place of the JAX
key. The generator is mutable — drawing from it advances it — so a
`PolicyState` returned by a step shares its generator with the one passed in.
"""

from __future__ import annotations

import dataclasses

import torch

POLICY_KINDS = (
    "mppi",
    "gmppi",
    "imppi",
    "cemppi",
    "cmamppi",
    "muaismppi",
    "musigmaaismppi",
    "pmcmppi",
    "nesmppi",
)

# Aliases accepting the reference's unicode symbols.
KIND_ALIASES = {
    "μaismppi": "muaismppi",
    "μσaismppi": "musigmaaismppi",
    "μΣaismppi": "musigmaaismppi",
    "cem": "cemppi",
    "cma": "cmamppi",
}


def canonical_kind(kind: str) -> str:
    k = str(kind).lstrip(":").lower()
    k = KIND_ALIASES.get(k, k)
    if k not in POLICY_KINDS:
        raise ValueError(f"unknown policy kind {kind!r}; options {POLICY_KINDS}")
    return k


@dataclasses.dataclass(frozen=True)
class PolicyConfig:
    """Static policy hyperparameters."""

    kind: str = "cemppi"
    num_samples: int = 50  # K
    horizon: int = 50  # T
    lam: float = 1.0  # λ, IT inverse temperature
    alpha: float = 1.0  # α, control-cost parameter (γ = λ(1-α))
    opt_its: int = 10  # N, AIS iterations
    lambda_ais: float = 20.0  # decoupled AIS inverse temperature
    ce_elite_threshold: float = 0.8
    sigma_est: str = "mle"  # :mle,:lw,:ss,:rblw,:oas
    cma_sigma: float = 1.0
    cma_elite_threshold: float = 0.8
    nes_step_factor: float = 0.01
    log: bool = False  # capture K trajectories/costs/weights per step
    use_fused_rollout: bool = True  # the env's rollout kernel when it has one

    # Reference-quirk reproduction flags: defaults keep parity with MPOPIS.
    shift_quirk: bool = True  # off-by-one tail refill of the shift
    cma_rank_mu_quirk: bool = True  # scalar rank-μ term
    elite_stop_tol: float = 1e-2  # reference literal 10e-3
    cov_jitter: float = 1e-8  # reference literal 10e-9
    # CMA's f32 guards and Newton–Schulz Σ^{-1/2} (CMA is not ported yet)
    cma_stability_guards: bool = True
    cma_fast_sqrt: bool = False

    def __post_init__(self):
        object.__setattr__(self, "kind", canonical_kind(self.kind))

    @property
    def gamma(self) -> float:
        return self.lam * (1.0 - self.alpha)


@dataclasses.dataclass(frozen=True)
class PolicyState:
    """Carried across control steps: receding-horizon mean + generator."""

    U: torch.Tensor  # (cs,) flat nominal control sequence
    generator: torch.Generator


def init_policy_state(u0_flat: torch.Tensor, seed: int) -> PolicyState:
    """U = `u0_flat`; a generator on U's device seeded with `seed`."""
    gen = torch.Generator(device=u0_flat.device)
    gen.manual_seed(int(seed))
    return PolicyState(U=u0_flat, generator=gen)
