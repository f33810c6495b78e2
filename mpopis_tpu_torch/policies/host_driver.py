"""Host-environment policy driver.

Counterpart of `mpopis_tpu/policies/host_driver.py`. For environments whose
dynamics run on the host (real MuJoCo through the native envpool_lite
engine) the AIS loop is a host loop: the policy math is the port's own
strategies, run as torch ops in float64 on `device` (the card unless the
caller asks for the CPU), while the rollouts step the K host environments
in lockstep, with O(1) snapshot/restore. The clamped (K, T, as) candidates
go to the host once per AIS iteration and the (K,) costs come back once;
nothing is copied per time step.

As in the JAX package, the last AIS iteration takes no strategy update, and
the early stop reads the strategy's flag back to the host after each
update. `step(pol_state, z=None, uniforms=None)` takes injected standard
normals and PMC uniforms in place of the policy's generator: the
exact-match hooks for comparing implementations.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mpopis_tpu_torch.ops.controls import roll_controls
from mpopis_tpu_torch.ops.weights import information_theoretic_weights
from mpopis_tpu_torch.policies.config import PolicyConfig, PolicyState, init_policy_state
from mpopis_tpu_torch.policies.driver import _prepare_cov, _prepare_u0, _principal_sqrtm
from mpopis_tpu_torch.policies.strategies import (
    AISCarry,
    CMAStrategy,
    NESStrategy,
    make_strategy,
)


@dataclasses.dataclass(eq=False)
class HostPolicy:
    """The surface of `Policy` (init_state / step) over a host env.

    `env` must expose: num_envs, action_dim, action_low/high, step(actions
    (K, nu)) -> (obs, rews), snapshot(), restore().
    """

    env: object
    cfg: PolicyConfig
    u0_flat: np.ndarray
    sigma: np.ndarray
    device: torch.device | str = "cuda"

    def __post_init__(self):
        cfg = self.cfg
        self._as = self.env.action_dim
        self._cs = self._as * cfg.horizon
        if cfg.num_samples != self.env.num_envs:
            raise ValueError(
                f"num_samples ({cfg.num_samples}) must equal env.num_envs "
                f"({self.env.num_envs}) for host-batched rollouts"
            )
        t = self._tensor
        self._low, self._high = t(self.env.action_low), t(self.env.action_high)
        self._u0 = t(self.u0_flat)
        sigma = t(self.sigma)
        self._chol = torch.linalg.cholesky(sigma)
        self._extra0 = None
        if cfg.kind == "mppi":
            self._sigma_inv = torch.linalg.inv(sigma)
            self._strategy = None
        else:
            self._strategy = make_strategy(cfg, self._cs, torch.float64)
            if isinstance(self._strategy, NESStrategy):
                self._extra0 = self._strategy.make_extra(t(_principal_sqrtm(self.sigma)))
            elif isinstance(self._strategy, CMAStrategy):
                self._extra0 = self._strategy.make_extra(sigma)

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float64, device=self.device)

    def init_state(self, seed: int) -> PolicyState:
        return init_policy_state(self._u0, seed)

    # ------------------------------------------------------------------
    def _rollout(self, controls: torch.Tensor) -> torch.Tensor:
        """Costs of the (K, T, as) clamped candidates on the host env: one
        copy to the host, T batched env steps, one copy of the costs back;
        the pre-rollout state is restored afterwards."""
        ctrl = controls.cpu().numpy()
        k, t, _ = ctrl.shape
        costs = np.zeros(k)
        for ti in range(t):
            _, rews = self.env.step(ctrl[:, ti, :])
            costs -= rews
        self.env.restore()
        return self._tensor(costs)

    def _clamp(self, v_ktas: torch.Tensor) -> torch.Tensor:
        return torch.clamp(v_ktas, self._low, self._high)

    def step(self, pol_state: PolicyState, z=None, uniforms=None):
        """-> (action (as,) numpy, new PolicyState, info). z: optional
        standard normals, (opt_its, cs, K) for the GMPPI family and (K, T,
        as) for mppi; uniforms: optional (opt_its, K) for PMC's resampling."""
        if self.cfg.kind == "mppi":
            return self._step_mppi(pol_state, z)
        return self._step_gmppi(pol_state, z, uniforms)

    def _finish(self, pol_state, weighted_controls, costs, weights):
        as_ = self._as
        action = self._clamp(weighted_controls[:as_]).cpu().numpy()
        u_next = roll_controls(weighted_controls, self._u0, as_, self.cfg.shift_quirk)
        info = {"costs": costs.cpu().numpy(), "weights": weights.cpu().numpy()}
        return action, PolicyState(U=u_next, generator=pol_state.generator), info

    def _step_gmppi(self, pol_state: PolicyState, z=None, uniforms=None):
        cfg = self.cfg
        k, t, as_, cs = cfg.num_samples, cfg.horizon, self._as, self._cs
        gamma = cfg.gamma
        strategy = self._strategy
        gen = pol_state.generator
        u_orig = pol_state.U
        carry = AISCarry(
            U=u_orig,
            chol=strategy.init_chol(self._chol),
            E=torch.zeros((cs, k), dtype=torch.float64, device=self.device),
            costs=torch.zeros((k,), dtype=torch.float64, device=self.device),
            trajs=None,
            extra=self._extra0,
        )
        self.env.snapshot()
        for n in range(cfg.opt_its):
            if z is None:
                z_n = torch.randn((cs, k), generator=gen, dtype=torch.float64,
                                  device=self.device)
            else:
                z_n = self._tensor(z[n])
            e = carry.chol @ z_n
            v = carry.U[:, None] + e  # (cs, K)
            costs = self._rollout(self._clamp(v.T.reshape(k, t, as_)))
            if gamma != 0.0:
                zsol = torch.cholesky_solve(u_orig[:, None], carry.chol)[:, 0]
                costs = costs + gamma * ((v - u_orig[:, None]).T @ zsol)
            base = carry.replace(E=e, costs=costs)
            if n == cfg.opt_its - 1:
                carry = base
                break
            u_n = None if uniforms is None else self._tensor(uniforms[n])
            new, stop = strategy.update(base, gen, u_orig, n + 1, uniforms=u_n)
            # host read of the stop flag, as in the JAX package
            if stop is not None and bool(stop):
                carry = base
                break
            carry = new

        e_final = carry.E + (carry.U - u_orig)[:, None]
        weights = information_theoretic_weights(carry.costs, cfg.lam)
        weighted_controls = u_orig + e_final @ weights
        return self._finish(pol_state, weighted_controls, carry.costs, weights)

    def _step_mppi(self, pol_state: PolicyState, z=None):
        cfg = self.cfg
        k, t, as_ = cfg.num_samples, cfg.horizon, self._as
        gamma = cfg.gamma
        if z is None:
            z = torch.randn((k, t, as_), generator=pol_state.generator, dtype=torch.float64,
                            device=self.device)
        e = self._tensor(z) @ self._chol.T
        u_mat = pol_state.U.reshape(t, as_)
        self.env.snapshot()
        costs = self._rollout(self._clamp(u_mat[None] + e))
        if gamma != 0.0:
            costs = costs + gamma * torch.einsum("ta,ab,ktb->k", u_mat, self._sigma_inv, e)
        weights = information_theoretic_weights(costs, cfg.lam)
        noise = torch.einsum("k,kta->ta", weights, e).reshape(-1)
        return self._finish(pol_state, pol_state.U + noise, costs, weights)


def make_host_policy(env, cfg: PolicyConfig, u0=None, cov_mat=None,
                     device="cuda") -> HostPolicy:
    """A `HostPolicy` on `env`, its policy math in float64 on `device`.
    `cov_mat` as for `make_policy`: an (as,) variance vector, an (as, as)
    block (expanded block-diagonally over the horizon for the GMPPI family)
    or a full (cs, cs) covariance."""
    as_ = env.action_dim
    cs = as_ * cfg.horizon
    u0_flat = _prepare_u0(u0, as_, cs)
    cov_block = _prepare_cov(cov_mat, as_)
    if cfg.kind == "mppi" or cov_block.shape[0] != as_:
        sigma = cov_block
    else:
        sigma = np.kron(np.eye(cfg.horizon), cov_block)
    return HostPolicy(env=env, cfg=cfg, u0_flat=u0_flat, sigma=sigma, device=device)
