"""Batched trajectory rollouts: a T-step Python loop over a (K, ·) batch.

Counterpart of `mpopis_tpu/models/rollout.py`, where `jax.vmap` over K and
`lax.scan` over T become a written-out batch dimension and a loop.
"""

from __future__ import annotations

import torch

from mpopis_tpu_torch.models.base import Env, EnvState


def rollout_batch(env: Env, state0: EnvState, controls: torch.Tensor, log_states: bool = False,
                  step_reward=None):
    """Roll K control sequences (K, T, as) from a shared state0.

    Returns (base_costs (K,), states (K, T, state_dim) or None) with
    base_cost = Σ_t −reward_t, reward_t from `step_reward` (default
    `env.step_reward`).
    """
    step_reward = env.step_reward if step_reward is None else step_reward
    k, horizon = controls.shape[0], controls.shape[1]
    s = state0.replace(x=state0.x.expand(k, *state0.x.shape))
    rews, xs = [], []
    for t in range(horizon):
        s, r = step_reward(s, controls[:, t])
        rews.append(r)
        if log_states:
            xs.append(s.x)
    costs = -torch.sum(torch.stack(rews, dim=1), dim=1)
    return costs, (torch.stack(xs, dim=1) if log_states else None)
