"""Policy steps.

Counterpart of `mpopis_tpu/policies/driver.py`: classic MPPI (a per-step
`as`-dimensional Gaussian) and the GMPPI family (a joint cs-dimensional
Gaussian and one of the AIS strategies). One GMPPI control step runs the
AIS loop sample → rollout → update, then the final IT-weighted update and
the receding-horizon roll. PyTorch runs eagerly, so the JAX package's
`lax.while_loop` becomes a Python loop.

Early stop: a stop-capable strategy's flag is read back to the host after
every iteration (one device sync per iteration) and the loop breaks, like
the reference's host-loop `break`. Strategies that can never stop
(or `elite_stop_tol <= 0`) run all iterations without reading anything
back. Either way the carry freezes at the stopping or last iteration on
that iteration's samples and costs, not on its update — the strategy's
`extra` state (CMA's, NES's) included.

Spans (`utils.span`, recorded only while a profiler runs): the whole step
`mpopis.policy_step`; per AIS iteration `mpopis.sample` (the normals and
the candidates' noise), `mpopis.rollout` (`compute_costs`), `mpopis.update`
and, where the strategy can stop, `mpopis.sync.stop_flag` around the read.

On a sample mesh (`sample_mesh=`, `parallel.make_sample_mesh`) the rollouts
are sharded and the update replicated: every rank draws the same (cs, K)
normals from its identically seeded generator and forms all K candidates,
rolls out only its own block of them (`SampleMesh.block`; one kernel launch
per rank per iteration), and one all_reduce gives every rank all K costs
(`gather_sample_costs`, exact). Everything after the rollout — the update,
the early-stop test, the final weights and the roll — then runs unchanged
on every rank, which so takes the same decisions as every other. Only the
K costs cross between ranks, never the sample matrix.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from mpopis_tpu_torch.kernels.linalg import forward_solve
from mpopis_tpu_torch.models.base import Env, EnvState
from mpopis_tpu_torch.models.rollout import rollout_batch
from mpopis_tpu_torch.ops.controls import clamp_controls, roll_controls
from mpopis_tpu_torch.ops.weights import information_theoretic_weights
from mpopis_tpu_torch.parallel.collectives import gather_sample_costs
from mpopis_tpu_torch.policies.config import PolicyConfig, PolicyState, init_policy_state
from mpopis_tpu_torch.policies.strategies import (
    AISCarry,
    CMAStrategy,
    NESStrategy,
    make_strategy,
)
from mpopis_tpu_torch.utils.profiling import span


def _prepare_u0(u0, action_dim: int, cs: int) -> np.ndarray:
    if u0 is None:
        return np.zeros(cs)
    u0 = np.asarray(u0, dtype=float).reshape(-1)
    if u0.shape[0] == action_dim:
        return np.tile(u0, cs // action_dim)
    if u0.shape[0] == cs:
        return u0
    raise ValueError(
        f"U0 must have length action_dim ({action_dim}) or cs ({cs}), got {u0.shape[0]}"
    )


def _prepare_cov(cov, action_dim: int) -> np.ndarray:
    """An (as,) variance vector or a covariance matrix; None is I_as."""
    if cov is None:
        return np.eye(action_dim)
    cov = np.asarray(cov, dtype=float)
    if cov.ndim == 1:
        cov = np.diag(cov)
    return cov


def _principal_sqrtm(sigma: np.ndarray) -> np.ndarray:
    """Principal square root of a symmetric PSD matrix by eigendecomposition
    (the reference's sqrt(Σ), NES's initial A)."""
    w, v = np.linalg.eigh(sigma)
    return (v * np.sqrt(np.maximum(w, 0.0))[None, :]) @ v.T


@dataclasses.dataclass(frozen=True, eq=False)
class Policy:
    """A policy: its step function plus its construction data."""

    env: Env
    cfg: PolicyConfig
    u0_flat: np.ndarray  # (cs,)
    sigma: np.ndarray  # (cs,cs) for the GMPPI family, (as,as) for mppi
    step: Callable[..., tuple]
    """step(env_state, pol_state, z=None[, uniforms=None]) -> (action (as,),
    new_pol_state, info)"""

    def init_state(self, seed: int) -> PolicyState:
        return init_policy_state(self.env.tensor(self.u0_flat), seed)


def make_policy(env: Env, cfg: PolicyConfig, u0=None, cov_mat=None,
                sample_mesh=None) -> Policy:
    """Build the policy step for `cfg.kind` on `env`.

    `cov_mat` may be an (as,) variance vector, an (as,as) per-step block
    (expanded block-diagonally over the horizon for the GMPPI family) or a
    full (cs,cs) joint covariance; `mppi` takes the (as,as) block only.
    `sample_mesh` (a `parallel.SampleMesh`, the JAX package's
    `sample_sharding`) spreads the K rollouts over its ranks; every rank of
    the mesh builds the same policy and steps it in lockstep.
    """
    if sample_mesh is not None:
        if torch.device(env.device).type != sample_mesh.device.type:
            raise ValueError(f"env on {env.device}, the sample mesh on {sample_mesh.device}")
        if cfg.num_samples < sample_mesh.world_size:
            raise ValueError(f"{cfg.num_samples} samples over {sample_mesh.world_size} ranks")
    if torch.device(env.device).type == "cuda":
        # cs=100 products must stay full f32, as in the JAX package
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    action_dim = env.action_dim
    cs = action_dim * cfg.horizon
    u0_flat = _prepare_u0(u0, action_dim, cs)
    cov_block = _prepare_cov(cov_mat, action_dim)
    if cfg.kind == "mppi":
        if cov_block.shape[0] != action_dim:
            raise ValueError("mppi expects an (as, as) covariance")
        sigma = cov_block
        step = _make_mppi_step(env, cfg, u0_flat, sigma, sample_mesh)
    else:
        if cov_block.shape[0] == action_dim:
            sigma = np.kron(np.eye(cfg.horizon), cov_block)
        elif cov_block.shape[0] == cs:
            sigma = cov_block
        else:
            raise ValueError("covariance must be (as,as)-block or (cs,cs)")
        step = _make_gmppi_step(env, cfg, u0_flat, sigma, sample_mesh)
    return Policy(env=env, cfg=cfg, u0_flat=u0_flat, sigma=sigma, step=step)


def _uses_kernel_rollout(env, cfg) -> bool:
    """The env's rollout kernel when it has one (and nothing is logged);
    an env without one (the Reacher, the pendulums, the classic tasks)
    rolls out through the plain `rollout_batch`."""
    return cfg.use_fused_rollout and not cfg.log and hasattr(env, "fused_rollout_costs_tak")


def _gather(costs, trajs, k, sample_mesh):
    """All K costs (and logged trajectories) from each rank's block."""
    if sample_mesh is None:
        return costs, trajs
    if trajs is not None:
        trajs = gather_sample_costs(trajs, k, sample_mesh)
    return gather_sample_costs(costs, k, sample_mesh), trajs


def _make_gmppi_step(env, cfg, u0_flat, sigma0, sample_mesh):
    dtype, device = env.dtype, env.device
    action_dim = env.action_dim
    k_samples = cfg.num_samples
    horizon = cfg.horizon
    cs = action_dim * horizon
    gamma = cfg.gamma
    low, high = env.control_bounds
    low_f = low.repeat(horizon)[:, None]
    high_f = high.repeat(horizon)[:, None]
    u0_t = env.tensor(u0_flat)
    chol0 = torch.linalg.cholesky(env.tensor(sigma0))

    strategy = make_strategy(cfg, cs, dtype)
    if isinstance(strategy, NESStrategy):
        extra0 = strategy.make_extra(env.tensor(_principal_sqrtm(sigma0)))
    elif isinstance(strategy, CMAStrategy):
        extra0 = strategy.make_extra(env.tensor(sigma0))
    else:
        extra0 = None
    use_fused = _uses_kernel_rollout(env, cfg)
    n_its = cfg.opt_its if cfg.kind != "gmppi" else 1
    start, stop = (0, k_samples) if sample_mesh is None else sample_mesh.block(k_samples)

    def compute_costs(env_state, u_cur, e, chol, u_orig, z_n):
        v = u_cur[:, None] + e[:, start:stop]  # (cs, K_r), this rank's unclamped candidates
        if use_fused:
            # clamp in the flat layout; (cs, K_r) -> (T, as, K_r) is a free
            # reshape of the contiguous block into the rollout kernel's layout
            vc = clamp_controls(v, low_f, high_f).contiguous().reshape(
                horizon, action_dim, stop - start)
            base, trajs = env.fused_rollout_costs_tak(env_state, vc), None
        else:
            controls = v.T.reshape(stop - start, horizon, action_dim)
            base, trajs = rollout_batch(
                env, env_state, clamp_controls(controls, low, high), cfg.log
            )
        base, trajs = _gather(base, trajs, k_samples, sample_mesh)
        if gamma != 0.0:
            # γ·U_origᵀ Σ⁻¹ (V_k − U_orig) with the current sampling Σ = LLᵀ:
            # with V − U_orig = d + L·z and y₀ = L⁻¹U_orig, y₁ = L⁻¹d the
            # term is γ·(y₁ᵀy₀ + zᵀy₀) — two forward substitutions
            ys = forward_solve(chol, torch.stack([u_orig, u_cur - u_orig]))
            base = base + gamma * (torch.dot(ys[1], ys[0]) + z_n.T @ ys[0])
        return base, trajs

    def policy_step(env_state: EnvState, pol_state: PolicyState, z=None, uniforms=None):
        """z: optional (opt_its, cs, K) standard normals, and uniforms:
        optional (opt_its, K) uniforms for PMC's resampling, in place of
        the policy's generator — the exact-match hooks for comparing
        implementations."""
        with span("mpopis.policy_step"):
            return _policy_step(env_state, pol_state, z, uniforms)

    def _policy_step(env_state, pol_state, z, uniforms):
        u_orig = pol_state.U
        gen = pol_state.generator
        carry = AISCarry(
            U=u_orig,
            chol=strategy.init_chol(chol0),
            E=torch.zeros((cs, k_samples), dtype=dtype, device=device),
            costs=torch.zeros((k_samples,), dtype=dtype, device=device),
            trajs=None,
            extra=extra0,
        )
        its = 0
        for n in range(n_its):
            with span("mpopis.sample"):
                if z is None:
                    z_n = torch.randn(
                        (cs, k_samples), generator=gen, dtype=dtype, device=device
                    )
                else:
                    z_n = z[n]
                e = carry.chol @ z_n
            with span("mpopis.rollout"):
                costs, trajs = compute_costs(env_state, carry.U, e, carry.chol, u_orig, z_n)
            base = carry.replace(E=e, costs=costs, trajs=trajs)
            u_n = None if uniforms is None else uniforms[n]
            with span("mpopis.update"):
                new, stop = strategy.update(base, gen, u_orig, n + 1, uniforms=u_n)
            its += 1
            stopped = False
            if strategy.can_stop:
                # host read of the stop flag: the one sync per iteration
                with span("mpopis.sync.stop_flag"):
                    stopped = bool(stop)
            carry = base if (stopped or n == n_its - 1) else new
            if stopped:
                break

        # Translate the noise so it is relative to the original mean, then
        # apply the final softmax-weighted update.
        e_final = carry.E + (carry.U - u_orig)[:, None]
        weights = information_theoretic_weights(carry.costs, cfg.lam)
        weighted_controls = u_orig + e_final @ weights
        action = clamp_controls(weighted_controls[:action_dim], low, high)
        u_next = roll_controls(weighted_controls, u0_t, action_dim, cfg.shift_quirk)
        info = {"costs": carry.costs, "weights": weights, "ais_its": its}
        if cfg.log:
            info["trajectories"] = carry.trajs
        return action, PolicyState(U=u_next, generator=gen), info

    return policy_step


def _make_mppi_step(env, cfg, u0_flat, sigma_as, sample_mesh):
    """Classic MPPI: one rollout of K sequences whose per-step noise is
    N(0, Σ_as), then the IT-weighted update of the noise."""
    dtype, device = env.dtype, env.device
    action_dim = env.action_dim
    k_samples = cfg.num_samples
    horizon = cfg.horizon
    cs = action_dim * horizon
    gamma = cfg.gamma
    low, high = env.control_bounds
    u0_t = env.tensor(u0_flat)
    sigma_t = env.tensor(sigma_as)
    chol_as = torch.linalg.cholesky(sigma_t)
    sigma_inv = torch.linalg.inv(sigma_t)
    use_fused = _uses_kernel_rollout(env, cfg)
    start, stop = (0, k_samples) if sample_mesh is None else sample_mesh.block(k_samples)

    def policy_step(env_state: EnvState, pol_state: PolicyState, z=None):
        """z: optional (K, T, as) standard normals in place of the policy's
        generator (the exact-match hook)."""
        with span("mpopis.policy_step"):
            return _policy_step(env_state, pol_state, z)

    def _policy_step(env_state, pol_state, z):
        gen = pol_state.generator
        with span("mpopis.sample"):
            if z is None:
                z = torch.randn((k_samples, horizon, action_dim), generator=gen, dtype=dtype,
                                device=device)
            e = z @ chol_as.T  # E[k, t] ~ N(0, Σ_as)
        u_mat = pol_state.U.reshape(horizon, action_dim)
        with span("mpopis.rollout"):
            # this rank's rows
            controls = clamp_controls(u_mat[None, :, :] + e[start:stop], low, high)
            if use_fused:
                costs, trajs = env.fused_rollout_costs(env_state, controls), None
            else:
                costs, trajs = rollout_batch(env, env_state, controls, cfg.log)
            costs, trajs = _gather(costs, trajs, k_samples, sample_mesh)
            if gamma != 0.0:
                # γ·Σ_t u_tᵀ Σ⁻¹ ε_kt
                costs = costs + gamma * torch.einsum("ta,ab,ktb->k", u_mat, sigma_inv, e)
        weights = information_theoretic_weights(costs, cfg.lam)
        weighted_controls = pol_state.U + torch.einsum("k,kta->ta", weights, e).reshape(cs)
        action = clamp_controls(weighted_controls[:action_dim], low, high)
        u_next = roll_controls(weighted_controls, u0_t, action_dim, cfg.shift_quirk)
        info = {"costs": costs, "weights": weights, "ais_its": 1}
        if cfg.log:
            info["trajectories"] = trajs
        return action, PolicyState(U=u_next, generator=gen), info

    return policy_step
