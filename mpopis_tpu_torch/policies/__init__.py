from mpopis_tpu_torch.policies.config import (
    POLICY_KINDS,
    PolicyConfig,
    PolicyState,
    canonical_kind,
    init_policy_state,
)
from mpopis_tpu_torch.policies.driver import Policy, make_policy

__all__ = [
    "POLICY_KINDS",
    "PolicyConfig",
    "PolicyState",
    "canonical_kind",
    "init_policy_state",
    "Policy",
    "make_policy",
]
