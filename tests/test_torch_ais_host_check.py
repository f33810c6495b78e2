"""The covariance-refit kernel's arithmetic (csrc/refit_math.cuh) built for the
host with g++ through tests/ais_host_check.cpp, held against the plain PyTorch
versions on the CPU: `masked_refit_chol_reference` for the five estimators
and `weighted_refit_chol_reference` in the μΣ-AIS and PMC forms, in float32
at the JAX kernel tests' refit tolerance (rtol 5e-4, atol 5e-5) and float64
at rtol 1e-9. The host build runs the kernel's steps in its order: the
columns that count and the 16 blocks' shares of them, the moments chunk by
chunk in 8 x 8 or 4 x 4 tiles (column groups in registers, or each chunk
added to the partial where the tiles outnumber the threads), the sums over
the blocks in rank order, the estimator over the lower triangle and the
jitter; only the factor is the plain loop.
It also prints the kernel's layout, so the choice of shared or global memory
per n, K and dtype is held here too. Skips where there is no g++.
"""

import shutil
import struct
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from mpopis_tpu_torch.kernels import ais_update
from mpopis_tpu_torch.kernels.build import CSRC_DIR

TOL = {torch.float32: (5e-4, 5e-5), torch.float64: (1e-9, 1e-12)}


@pytest.fixture(scope="module")
def host_check(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the refit's arithmetic for the host")
    exe = tmp_path_factory.mktemp("host") / "ais_host_check"
    src = Path(__file__).with_name("ais_host_check.cpp")
    subprocess.run([gxx, "-O1", "-std=c++17", "-Wno-unknown-pragmas", f"-I{CSRC_DIR}", "-o",
                    str(exe), str(src)], check=True, capture_output=True, timeout=300)
    return exe


def _run(exe, tag, dtype, method_id, m, e, w, mu, corrected=False, layout_only=False):
    n, k = e.shape
    data = struct.pack("6i", int(dtype == torch.float64), n, k, method_id, int(corrected),
                       int(layout_only))
    data += np.asarray([m, 1e-8], np.float64).tobytes()
    if not layout_only:
        data += np.concatenate([np.ravel(e), w, mu]).astype(np.float64).tobytes()
    path = Path(f"{exe}.{tag}.in")
    path.write_bytes(data)
    lines = subprocess.run([str(exe), str(path)], capture_output=True, text=True, check=True,
                           timeout=120).stdout.strip().splitlines()
    in_smem, cols, nbytes, scratch = (int(v) for v in lines[0].split())
    layout = {"in_smem": in_smem, "cols": cols, "bytes": nbytes, "scratch": scratch}
    if layout_only:
        return layout
    return layout, np.array([[float(v) for v in line.split()] for line in lines[1:]])


def _data(n, k, m, seed, counts=False):
    """E (n, K) = 0.3·N(0, 1); a mask of m random columns; weights w^4
    normalised, or PMC's multinomial counts / K (zero for many columns)."""
    rng = np.random.default_rng(seed)
    e = 0.3 * rng.standard_normal((n, k))
    mask = np.zeros(k)
    mask[rng.permutation(k)[:m]] = 1.0
    w = rng.uniform(size=k) ** 4
    w /= w.sum()
    if counts:
        w = np.bincount(rng.choice(k, size=k, p=w), minlength=k) / k
    return e, mask, w


def _hold(got, want, dtype):
    rtol, atol = TOL[dtype]
    np.testing.assert_allclose(got, want.double().numpy(), rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("method", ais_update.METHODS)
@pytest.mark.parametrize("n,k,m", [(37, 300, 61), (40, 512, 512), (112, 64, 40)])
def test_masked_refit_built_for_the_host_matches_the_plain_version(host_check, n, k, m, method,
                                                                  dtype):
    """Five estimators at a ragged n (37: the last tile rows part empty)
    with 61 elite columns (shares of 3 and 4 over 16 blocks), at n = 40 with
    every column elite (two chunks of 32 a block), and at n = 112, where
    lw's and ss's 406 tiles of 4 x 4 outnumber a block's 384 threads."""
    e, mask, _ = _data(n, k, m, seed=n + m)
    mu = (e @ mask) / m
    _, got = _run(host_check, f"{method}.{n}.{m}.{dtype}", dtype, ais_update.METHODS.index(method),
                  m, e, mask, mu)
    t = lambda a: torch.as_tensor(a, dtype=dtype)  # noqa: E731
    _hold(got, ais_update.masked_refit_chol_reference(t(e), t(mask), t(mu), m, method, 1e-8),
          dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m", [1, 5, 31])
def test_masked_mle_refit_few_elites_built_for_the_host_matches_the_plain_version(host_check, m,
                                                                                  dtype):
    """m < n elite columns (one, a few, a warp less one): a rank-deficient
    estimate that only the jitter's floor keeps positive definite."""
    n, k = 33, 400
    e, mask, _ = _data(n, k, m, seed=m)
    mu = (e @ mask) / m
    _, got = _run(host_check, f"mle.few.{m}.{dtype}", dtype, 0, m, e, mask, mu)
    t = lambda a: torch.as_tensor(a, dtype=dtype)  # noqa: E731
    _hold(got, ais_update.masked_refit_chol_reference(t(e), t(mask), t(mu), m, "mle", 1e-8), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("form", ["weighted", "pmc"])
def test_weighted_refit_built_for_the_host_matches_the_plain_version(host_check, form, dtype):
    """μΣ-AIS's weights (every column counts) and PMC's corrected refit over
    multinomial counts / K (about a third of the columns are zero)."""
    n, k = 40, 512
    e, _, w = _data(n, k, 1, seed=7, counts=form == "pmc")
    if form == "pmc":
        assert 0 < np.count_nonzero(w) < k
    mu = e @ w
    corrected = form == "pmc"
    _, got = _run(host_check, f"{form}.{dtype}", dtype, len(ais_update.METHODS), k, e, w, mu,
                  corrected)
    t = lambda a: torch.as_tensor(a, dtype=dtype)  # noqa: E731
    _hold(got, ais_update.weighted_refit_chol_reference(t(e), t(w), t(mu), corrected, 1e-8), dtype)


@pytest.mark.parametrize("n,dtype,where", [
    (100, torch.float32, "shared"),   # the car's n: the cluster's shared memory
    (136, torch.float32, "shared"),   # the humanoids' H·nu
    (100, torch.float64, "shared"),
    (136, torch.float64, "global"),   # A and B alone are 2 x 136^2 x 8 B = 296 KB
    (200, torch.float32, "global"),
])
def test_refit_layout_per_size(host_check, n, dtype, where):
    """The kernel's layout at K = 8192: partials and factor in shared memory
    where they fit a block's 227 KB, else in global scratch, with whole
    stages of 32 columns either way."""
    e = np.zeros((n, 8192))
    lay = _run(host_check, f"layout.{n}.{dtype}", dtype, 2, 1638, e, None, None,
               layout_only=True)
    assert lay["in_smem"] == (where == "shared")
    assert lay["cols"] == 32
    assert 0 < lay["bytes"] <= 227 * 1024 - 1024
    assert (lay["scratch"] > 0) == (where == "global")
