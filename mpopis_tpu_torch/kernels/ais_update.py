"""Fused AIS distribution updates: the CUDA kernels `csrc/ais_update.cu`,
their plain PyTorch versions, the wrappers and the switch.

Counterpart of `mpopis_tpu/kernels/ais_update.py` (the Pallas TPU kernels
`_masked_refit_kernel`, `_weighted_refit_kernel` and `_cma_kernel`), with
the same signatures minus `interpret`:

- `masked_refit_chol`: cholesky_lower(jitter(shrinkage_cov_masked(E, mask,
  m, method))), the CEMPPI elite refit, five estimators;
- `weighted_refit_chol`: the probability-weighted refit of μΣ-AIS and, with
  `corrected`, of PMC;
- `cma_update_chol`: the CMA tail from δw on (Newton–Schulz Σ^−1/2, paths,
  step size, scalar rank-μ, symmetrization, σ·chol).

`fused_update_enabled(dtype)` is the JAX package's switch
(`MPOPIS_FUSED_UPDATE=1`, float32 only), read at call time. Each wrapper
takes a CPU tensor to its plain version — the fused switch off the card
runs the plain versions, as the JAX package runs its interpreter off the
TPU — and a CUDA tensor to the kernel, or raises. `MASKED_LAUNCHES`,
`WEIGHTED_LAUNCHES` and `CMA_LAUNCHES` count wrapper calls that launched
their kernels, one launch a call each (the refits a cluster of 16 blocks).
"""

from __future__ import annotations

import ctypes
import math
import os

import torch

from mpopis_tpu_torch.kernels.build import load_library
from mpopis_tpu_torch.kernels.linalg import check_arg, check_tensor, chol_reference

MASKED_LAUNCHES = 0
WEIGHTED_LAUNCHES = 0
CMA_LAUNCHES = 0

METHODS = ("mle", "lw", "ss", "rblw", "oas")  # method ids 0..4 of the kernel; 5 = weighted
CMA_CONSTS = ("c1", "c_Sigma", "c_mu", "c_sigma", "d_sigma", "e_norm", "mu_eff")

_FNS: dict = {}


def fused_update_enabled(dtype) -> bool:
    """MPOPIS_FUSED_UPDATE=1 turns the fused updates on for float32."""
    return os.environ.get("MPOPIS_FUSED_UPDATE", "").strip() == "1" and dtype == torch.float32


def _lib():
    if not _FNS:
        lib = load_library("ais_update")
        ptr, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        refit_args = [ptr, ptr, ptr, i32, i32, i32, f64, f64, i32, ptr, ptr, ptr]
        cma_args = [ptr] * 7 + [i32, i32, ptr, f64, f64, i32, i32, i32] + [ptr] * 7
        for suffix, dt in (("f32", torch.float32), ("f64", torch.float64)):
            for op, args in (("refit_chol", refit_args), ("cma_update", cma_args)):
                fn = getattr(lib, f"ais_{op}_{suffix}")
                fn.argtypes = args
                fn.restype = ctypes.c_int
                _FNS[(op, dt)] = fn
        lib.ais_refit_scratch_elems.argtypes = [i32, i32, i32]
        lib.ais_refit_scratch_elems.restype = ctypes.c_longlong
        lib.ais_refit_layout.argtypes = [i32, i32, i32]
        lib.ais_refit_layout.restype = ctypes.c_int
        lib.ais_refit_cluster_size.restype = ctypes.c_int
        lib.ais_cma_scratch_elems.argtypes = [i32]
        lib.ais_cma_scratch_elems.restype = ctypes.c_longlong
        lib.ais_num_cma_consts.restype = ctypes.c_int
        lib.ais_cma_cluster_size.argtypes = [i32, i32]
        lib.ais_cma_cluster_size.restype = ctypes.c_int
        if lib.ais_num_cma_consts() != len(CMA_CONSTS):
            raise RuntimeError("ais_update.cu and its wrapper disagree on the interface")
        _FNS["lib"] = lib
    return _FNS


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _eye_like(a: torch.Tensor) -> torch.Tensor:
    return torch.eye(a.shape[0], dtype=a.dtype, device=a.device)


def jitter_mat(sigma: torch.Tensor, jitter: float) -> torch.Tensor:
    """σ + (jitter + 100·eps·mean(diag σ))·I: diagonal jitter before a
    Cholesky, the JAX kernels' `_jitter_mat` and strategies' `_jittered` —
    the reference's fixed jitter plus a dtype-scaled floor that keeps a
    rank-deficient refit (m_elite < cs with `mle`) positive definite in f32."""
    scale = torch.mean(torch.diagonal(sigma))
    eps_floor = 100.0 * torch.finfo(sigma.dtype).eps * scale
    return sigma + (jitter + eps_floor) * _eye_like(sigma)


def shrink_finalize(a: torch.Tensor, b, m: int, method: str) -> torch.Tensor:
    """Shrinkage estimate from the moment sums a = Xc Xcᵀ and
    b = (Xc∘Xc)(Xc∘Xc)ᵀ (or None) over m samples, in the TPU kernel's
    standardization-free form (`_shrink_finalize`)."""
    n = a.shape[0]
    eye = _eye_like(a)
    tiny = torch.finfo(a.dtype).tiny
    s = a / m
    if method == "mle":
        return s
    if method == "lw":
        var_s = (b / m - s * s) / m
        num = torch.sum(var_s) - torch.sum(var_s * eye)
        den = torch.sum(s * s) - torch.sum((s * eye) ** 2)
        lam = torch.clamp(num / torch.clamp(den, min=tiny), 0.0, 1.0)
        return (1.0 - lam) * s + lam * (s * eye)
    if method == "ss":
        v = torch.sum(a * eye, dim=1) / (m - 1)
        inv_sd = 1.0 / torch.sqrt(torch.clamp(v, min=tiny))
        wbar = (a / m) * inv_sd[:, None] * inv_sd[None, :]
        r = (m / (m - 1)) * wbar
        inv_v = inv_sd * inv_sd
        sum_w2 = b * inv_v[:, None] * inv_v[None, :]
        var_r = (m / (m - 1) ** 3) * (sum_w2 - m * wbar * wbar)
        num = torch.sum(var_r) - torch.sum(var_r * eye)
        den = torch.sum(r * r) - torch.sum((r * eye) ** 2)
        lam = torch.clamp(num / torch.clamp(den, min=tiny), 0.0, 1.0)
        r_shrunk = (1.0 - lam) * r
        r_shrunk = r_shrunk * (1.0 - eye) + eye
        sd_mle = torch.sqrt(torch.clamp(torch.sum(a * eye, dim=1) / m, min=tiny))
        return r_shrunk * sd_mle[:, None] * sd_mle[None, :]
    p = n
    tr_s = torch.sum(s * eye)
    tr_s2 = torch.sum(s * s)
    if method == "rblw":
        num = ((m - 2.0) / m) * tr_s2 + tr_s**2
        den = (m + 2.0) * (tr_s2 - tr_s**2 / p)
    elif method == "oas":
        num = (1.0 - 2.0 / p) * tr_s2 + tr_s**2
        den = (m + 1.0 - 2.0 / p) * (tr_s2 - tr_s**2 / p)
    else:
        raise ValueError(f"unknown sigma_est {method!r}")
    rho = torch.clamp(num / torch.clamp(den, min=tiny), 0.0, 1.0)
    return (1.0 - rho) * s + rho * ((tr_s / p) * eye)


def masked_refit_chol_reference(e, mask, mu, m, method="mle", jitter=1e-8):
    """Plain version of the masked refit kernel."""
    xc = (e - mu[:, None]) * mask[None, :]
    a = xc @ xc.T
    b = None
    if method in ("lw", "ss"):
        x2 = xc * xc
        b = x2 @ x2.T
    return chol_reference(jitter_mat(shrink_finalize(a, b, m, method), jitter))


def weighted_refit_chol_reference(e, w, mu, corrected=False, jitter=1e-8):
    """Plain version of the weighted refit kernel."""
    k = e.shape[1]
    xc = e - mu[:, None]
    sigma = (xc * w[None, :]) @ xc.T
    if corrected:
        sigma = sigma * (k / (k - 1.0))
    return chol_reference(jitter_mat(sigma, jitter))


def inv_sqrt_newton_schulz(sigma: torch.Tensor, its: int = 20):
    """Σ^−1/2 by the coupled Newton–Schulz iteration with s = tr Σ:
    Y → (Σ/s)^½, Z → (Σ/s)^−½. Returns (C, err) with err = max|ZY − I|,
    the unfused CMA step's convergence test."""
    eye = _eye_like(sigma)
    s = torch.trace(sigma)
    y, z = sigma / s, eye
    for _ in range(its):
        t = 1.5 * eye - 0.5 * (z @ y)
        y, z = y @ t, t @ z
    return z / torch.sqrt(s), torch.max(torch.abs(z @ y - eye))


def cma_update_chol_reference(Sigma, dw, p_sigma, p_Sigma, svals, ws, sigma_s, it_f, consts_t,
                              jitter, guards=True, ns_its=20, quirk=True, update_chol=True):
    """Plain version of the CMA kernel (`_cma_kernel`). Returns
    (chol_scaled, Sigma_new, p_sigma, p_Sigma, sigma_new)."""
    if not quirk:
        raise ValueError("the fused CMA update covers the quirk rank-μ form only")
    c = dict(consts_t)
    n = Sigma.shape[0]
    dtype = Sigma.dtype
    c_mat, _ = inv_sqrt_newton_schulz(Sigma, ns_its)
    c_dw = torch.sum(c_mat * dw[None, :], dim=1)
    ps = (1.0 - c["c_sigma"]) * p_sigma + math.sqrt(
        c["c_sigma"] * (2.0 - c["c_sigma"]) * c["mu_eff"]) * c_dw
    norm_ps = torch.sqrt(torch.sum(ps * ps))
    step_exp = c["c_sigma"] / c["d_sigma"] * (norm_ps / c["e_norm"] - 1.0)
    if guards:
        step_exp = torch.clamp(step_exp, -20.0, 20.0)
    sigma_new = sigma_s * torch.exp(step_exp)
    if guards:
        sigma_new = torch.clamp(sigma_new, 1e-10, 1e10)
    it_t = torch.as_tensor(float(it_f), dtype=dtype, device=Sigma.device)
    decay = torch.exp(2.0 * it_t * math.log(1.0 - c["c_sigma"]))
    denom = torch.sqrt(1.0 - decay)
    h_sigma = (norm_ps / denom < (1.4 + 2.0 / (n + 1.0)) * c["e_norm"]).to(dtype)
    pS = (1.0 - c["c_Sigma"]) * p_Sigma + h_sigma * math.sqrt(
        c["c_Sigma"] * (2.0 - c["c_Sigma"]) * c["mu_eff"]) * dw
    norm_c2 = torch.sum(c_mat * c_mat)
    w0 = torch.where(ws >= 0.0, ws, it_t * ws / torch.clamp(norm_c2 * svals * svals, min=1e-30))
    rank_mu = torch.sum(w0 * svals * svals)
    s_new = (
        (1.0 - c["c1"] - c["c_mu"]) * Sigma
        + c["c1"] * (pS[:, None] * pS[None, :]
                     + (1.0 - h_sigma) * c["c_Sigma"] * (2.0 - c["c_Sigma"]) * Sigma)
        + c["c_mu"] * rank_mu
    )
    s_new = torch.triu(s_new) + torch.triu(s_new, 1).T
    if update_chol:
        chol = sigma_new * chol_reference(jitter_mat(s_new, jitter))
    else:
        chol = torch.zeros_like(Sigma)
    return chol, s_new, ps, pS, sigma_new


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check_operands(fn: str, dev, dtype, **tensors):
    check_arg(fn, dev.type == "cuda", f"tensors on {dev} (cpu or cuda only)")
    check_arg(fn, dtype in (torch.float32, torch.float64), f"dtype {dtype} (float32/float64 only)")
    for name, t in tensors.items():
        check_tensor(fn, name, t, dev, dtype)


def _refit_launch(fn_name, e, w, mu, method_id, m, jitter, corrected):
    dev, dtype = e.device, e.dtype
    _check_operands(fn_name, dev, dtype, e=e, w=w, mu=mu)
    check_arg(fn_name, e.dim() == 2 and e.shape[0] >= 1 and e.shape[1] >= 1,
              f"E shape {tuple(e.shape)}, want (n, K)")
    n, k = e.shape
    check_arg(fn_name, tuple(w.shape) == (k,), f"weights shape {tuple(w.shape)}, want ({k},)")
    check_arg(fn_name, tuple(mu.shape) == (n,), f"mu shape {tuple(mu.shape)}, want ({n},)")
    fns = _lib()
    f64 = int(dtype == torch.float64)
    check_arg(fn_name, fns["lib"].ais_refit_layout(n, k, f64) >= 0,
              f"n={n}, K={k}: the refit's staging does not fit a block's shared memory")
    elems = int(fns["lib"].ais_refit_scratch_elems(n, k, f64))
    scratch = torch.empty(elems, dtype=dtype, device=dev) if elems else None
    out = torch.empty((n, n), dtype=dtype, device=dev)
    with torch.cuda.device(dev):
        rc = fns[("refit_chol", dtype)](
            e.data_ptr(), w.data_ptr(), mu.data_ptr(), n, k, method_id, float(m), float(jitter),
            int(corrected), scratch.data_ptr() if elems else None, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"{fn_name}: ais_update kernel launch failed: CUDA error {rc}")
    return out


def masked_refit_chol(e, mask, mu, m: int, method: str = "mle", jitter: float = 1e-8):
    """Fused cholesky_lower(jitter_mat(shrinkage_cov_masked(e, mask, m))): e
    (cs, K) samples, mask (K,) 0/1 selecting exactly m columns, mu (cs,) the
    elite mean. The plain version for a CPU tensor, the kernel for a CUDA one."""
    global MASKED_LAUNCHES
    if method not in METHODS:
        raise ValueError(f"unknown sigma_est {method!r}; options {METHODS}")
    if e.device.type == "cpu":
        return masked_refit_chol_reference(e, mask, mu, m, method, jitter)
    out = _refit_launch("masked_refit_chol", e, mask, mu, METHODS.index(method), m, jitter,
                        False)
    MASKED_LAUNCHES += 1
    return out


def weighted_refit_chol(e, w, mu, corrected: bool = False, jitter: float = 1e-8):
    """Fused cholesky_lower(jitter_mat(Σ_k w_k (x_k − μ)(x_k − μ)ᵀ [· K/(K−1)]))
    for μΣ-AIS and (`corrected`, w = counts/K) PMC. The plain version for a
    CPU tensor, the kernel for a CUDA one."""
    global WEIGHTED_LAUNCHES
    if e.device.type == "cpu":
        return weighted_refit_chol_reference(e, w, mu, corrected, jitter)
    out = _refit_launch("weighted_refit_chol", e, w, mu, len(METHODS), e.shape[1], jitter,
                        corrected)
    WEIGHTED_LAUNCHES += 1
    return out


def refit_layout(n: int, k: int, dtype: torch.dtype) -> tuple[int, str]:
    """(blocks, where) of the refit kernel on (n, K) in `dtype`: the blocks
    of its cluster (16), and "shared" where each block's partial moments and
    block 0's factor sit in the cluster's shared memory, "global" where they
    sit in global memory, "none" where no layout fits (the wrapper raises).
    Decided from n, K and the dtype's size; a card that cannot schedule the
    cluster fails the launch."""
    lib = _lib()["lib"]
    where = lib.ais_refit_layout(n, k, int(dtype == torch.float64))
    return int(lib.ais_refit_cluster_size()), {1: "shared", 0: "global"}.get(where, "none")


def cma_cluster_size(n: int, dtype: torch.dtype) -> int:
    """The blocks of the cluster the CMA kernel runs an n x n update on in
    `dtype` (16), or 0 where the cluster's shared memory does not hold n and
    one block runs it from global memory. Decided from n and the dtype's
    size; a card that cannot schedule the cluster fails the launch."""
    return int(_lib()["lib"].ais_cma_cluster_size(n, int(dtype == torch.float64)))


def cma_update_chol(Sigma, dw, p_sigma, p_Sigma, svals, ws, sigma_s, it_f, consts_t, jitter,
                    guards=True, ns_its=20, quirk=True, update_chol=True):
    """Fused CMA covariance / step-size / path update and scaled Cholesky,
    Σ^−1/2 by Newton–Schulz. `sigma_s` is a 0-dim tensor, `it_f` the
    1-based iteration number, `consts_t` the CMAStrategy constants as
    (name, value) pairs. Returns (chol_scaled, Sigma_new, p_sigma, p_Sigma,
    sigma_new). The plain version for a CPU tensor, the kernel for a CUDA one."""
    global CMA_LAUNCHES
    if Sigma.device.type == "cpu":
        return cma_update_chol_reference(Sigma, dw, p_sigma, p_Sigma, svals, ws, sigma_s, it_f,
                                         consts_t, jitter, guards, ns_its, quirk, update_chol)
    fn_name = "cma_update_chol"
    check_arg(fn_name, quirk, "the fused CMA update covers the quirk rank-μ form only")
    dev, dtype = Sigma.device, Sigma.dtype
    _check_operands(fn_name, dev, dtype, Sigma=Sigma, dw=dw, p_sigma=p_sigma, p_Sigma=p_Sigma,
                    svals=svals, ws=ws, sigma_s=sigma_s)
    check_arg(fn_name, Sigma.dim() == 2 and Sigma.shape[0] == Sigma.shape[1] >= 1,
              f"Sigma shape {tuple(Sigma.shape)}, want (n, n)")
    n = Sigma.shape[0]
    for name, t in (("dw", dw), ("p_sigma", p_sigma), ("p_Sigma", p_Sigma)):
        check_arg(fn_name, tuple(t.shape) == (n,), f"{name} shape {tuple(t.shape)}, want ({n},)")
    k = svals.shape[0]
    check_arg(fn_name, svals.dim() == 1 and k >= 1 and tuple(ws.shape) == (k,),
              f"svals {tuple(svals.shape)} and ws {tuple(ws.shape)}, want (K,) each")
    check_arg(fn_name, sigma_s.numel() == 1, "sigma_s must hold one value")
    consts = dict(consts_t)
    cvals = (ctypes.c_double * len(CMA_CONSTS))(*(float(consts[name]) for name in CMA_CONSTS))
    fns = _lib()
    scratch = torch.empty(int(fns["lib"].ais_cma_scratch_elems(n)), dtype=dtype, device=dev)
    chol = torch.empty((n, n), dtype=dtype, device=dev)
    sigma_out = torch.empty((n, n), dtype=dtype, device=dev)
    ps_out = torch.empty(n, dtype=dtype, device=dev)
    pS_out = torch.empty(n, dtype=dtype, device=dev)
    sig_out = torch.empty((), dtype=dtype, device=dev)
    with torch.cuda.device(dev):
        rc = fns[("cma_update", dtype)](
            Sigma.data_ptr(), dw.data_ptr(), p_sigma.data_ptr(), p_Sigma.data_ptr(),
            svals.data_ptr(), ws.data_ptr(), sigma_s.data_ptr(), n, k, ctypes.addressof(cvals),
            float(it_f), float(jitter), int(guards), int(ns_its), int(update_chol),
            scratch.data_ptr(), chol.data_ptr(), sigma_out.data_ptr(), ps_out.data_ptr(),
            pS_out.data_ptr(), sig_out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"{fn_name}: ais_update kernel launch failed: CUDA error {rc}")
    CMA_LAUNCHES += 1
    return chol, sigma_out, ps_out, pS_out, sig_out
