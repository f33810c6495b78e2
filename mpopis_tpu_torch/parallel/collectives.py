"""Collective forms of the cross-sample reductions, for code that holds only
its rank's block of the K samples.

Counterpart of `mpopis_tpu/parallel/collectives.py`, with the same maths:
JAX's pmin, psum and pmax become `all_reduce` with MIN, SUM and MAX over the
mesh's process group. The global minimum cost is the softmax baseline, cost
and moment sums are sums of each rank's share (the weighted covariance as a
sum of per-rank outer products Σ wᵢεᵢεᵢᵀ, never gathering the (cs, K)
sample matrix), and the global elite is each rank's top k re-selected.
`gather_sample_costs` is the one the policy step uses: it gives every rank
all K costs.

Each function reduces fresh tensors: `all_reduce` works in place, and the
caller's tensors are left as they were.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from mpopis_tpu_torch.parallel.mesh import SampleMesh

_SUM, _MIN, _MAX = dist.ReduceOp.SUM, dist.ReduceOp.MIN, dist.ReduceOp.MAX


def _all_reduce(t: torch.Tensor, op, mesh: SampleMesh) -> torch.Tensor:
    dist.all_reduce(t, op=op, group=mesh.group)
    return t


def gather_sample_costs(block: torch.Tensor, k: int, mesh: SampleMesh) -> torch.Tensor:
    """All K rows from each rank's block of rows (K_r, ...) — the (K_r,)
    costs of `mesh.block(k)`, or its (K_r, T, state) trajectories.

    The block is placed in a zeroed (K, ...) buffer and the buffers are
    summed: each value is added only to zeros, so the result is the same
    bits on every rank (a −0.0 comes back as +0.0).
    """
    start, stop = mesh.block(k)
    if block.shape[0] != stop - start:
        raise ValueError(f"rank {mesh.rank} holds rows {start}:{stop} of {k}, "
                         f"got a block of {block.shape[0]}")
    out = block.new_zeros((k, *block.shape[1:]))
    out[start:stop] = block
    return _all_reduce(out, _SUM, mesh)


def global_it_weights(costs_block: torch.Tensor, lam, mesh: SampleMesh) -> torch.Tensor:
    """Information-theoretic softmax weights over the mesh's costs: this
    rank's (K_r,) costs in, its (K_r,) weights out, normalised so that all
    ranks' weights sum to 1. MIN of the minima is the baseline, SUM of the
    sums the normaliser."""
    rho = _all_reduce(torch.min(costs_block), _MIN, mesh)
    w = torch.exp(-(costs_block - rho) / lam)
    eta = _all_reduce(torch.sum(w), _SUM, mesh)
    return w / eta


def global_weighted_mean_cov(e_block: torch.Tensor, w_block: torch.Tensor, mesh: SampleMesh):
    """Probability-weighted mean and covariance of the columns of all ranks'
    (d, K_r) blocks, the (K_r,) weights summing to 1 over the mesh. Every
    rank gets (μ (d,), Σ (d, d)), in the E[w x xᵀ] − μμᵀ form: a SUM of each
    rank's Σ wᵢxᵢ and of its Σ wᵢxᵢxᵢᵀ."""
    s1 = _all_reduce(e_block @ w_block, _SUM, mesh)
    s2 = _all_reduce((e_block * w_block[None, :]) @ e_block.T, _SUM, mesh)
    return s1, s2 - torch.outer(s1, s1)


def global_mean_cov(e_block: torch.Tensor, mesh: SampleMesh, k_global: int,
                    corrected: bool = True):
    """Unweighted mean and covariance (corrected: divided by K − 1) of the
    columns of all ranks' (d, K_r) blocks, K = `k_global` in all."""
    s1 = _all_reduce(torch.sum(e_block, dim=1), _SUM, mesh) / k_global
    xc = e_block - s1[:, None]
    s2 = _all_reduce(xc @ xc.T, _SUM, mesh)
    return s1, s2 / ((k_global - 1) if corrected else k_global)


def global_top_k(costs_block: torch.Tensor, k: int, mesh: SampleMesh):
    """The k smallest costs over the mesh and their global indices:
    (values (k,), indices (k,)), the same on every rank.

    Each rank offers its min(k, K_r) smallest, padded to k slots with +inf
    losers of index −1 when k > K_r, which keeps the result exact (every
    member of the global top k is in some rank's offer). The offers meet
    by placement, as in the JAX package: each rank writes its row of an
    (n, k) buffer, filled elsewhere with the value that loses, and one MAX
    all_reduce of the negated values and one SUM of the indices give every
    rank all rows (gloo reduces CUDA tensors with `all_reduce` and
    `broadcast` only). The index buffer also carries each rank's block
    size, from which the global offsets of uneven blocks follow. The
    re-selection sorts stably, so equal costs keep the lower global index,
    as `lax.top_k` does.

    A pad slot carries index −1: where a genuine cost is +inf it ties the
    pads and the result may hold a pad for it, so callers treat −1 as "no
    sample" and never gather with it.
    """
    k_local, n, r = costs_block.shape[0], mesh.world_size, mesh.rank
    m = min(k, k_local)
    order = torch.sort(costs_block, stable=True).indices[:m]
    val_buf = torch.full((n, k), -torch.inf, dtype=costs_block.dtype, device=costs_block.device)
    val_buf[r, :m] = -costs_block[order]
    idx_buf = torch.zeros((n, k + 1), dtype=torch.int64, device=costs_block.device)
    idx_buf[r, :k] = -1
    idx_buf[r, :m] = order
    idx_buf[r, k] = k_local
    all_vals = -_all_reduce(val_buf, _MAX, mesh).reshape(-1)
    idx_buf = _all_reduce(idx_buf, _SUM, mesh)
    offsets = torch.cumsum(idx_buf[:, k], 0) - idx_buf[:, k]
    all_idx = torch.where(idx_buf[:, :k] >= 0, idx_buf[:, :k] + offsets[:, None], -1).reshape(-1)
    pos = torch.sort(all_vals, stable=True).indices[:k]
    return all_vals[pos], all_idx[pos]
