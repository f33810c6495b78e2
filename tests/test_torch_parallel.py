"""The sample axis over several ranks (`mpopis_tpu_torch/parallel/`), on
four gloo ranks of this CPU, started once for the file.

- The four collectives against the JAX package's under `shard_map` over a
  4-device mesh of the forced 8-device CPU topology, on the same numpy
  inputs: IT weights and both moment forms at rtol 1e-12 / atol 1e-12, the
  global top k by its values exactly and its indices as a set (the −1
  pads included); and `gather_sample_costs` exactly, on blocks of uneven
  size.
- The slice against the JAX package: the port's car CEMPPI step on the
  4-rank mesh against the JAX package's `sample_sharding` step under the
  same injected normals (f64, K=32, H=10, 2 iterations, `ss`), at rtol
  1e-12.
- Every policy kind on the mesh against the same policy without one (f64,
  the car, K=30 in blocks of 8, 8, 7 and 7; PMC's resampling through the
  `uniforms=` hook) bit for bit, the logged trajectories, MountainCar's
  μ-AIS (the plain rollout) and HalfCheetah's CEMPPI (the rollout kernel's
  plain version) bit for bit or at rtol 1e-12; every rank the same as every
  other bit for bit.
"""

import functools
import pickle
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch_parallel_ranks import run_cases

from mpopis_tpu.models import CarRacingEnv as JCarRacingEnv
from mpopis_tpu.parallel import (
    SAMPLE_AXIS,
    global_it_weights,
    global_mean_cov,
    global_top_k,
    global_weighted_mean_cov,
)
from mpopis_tpu.parallel import make_sample_mesh as jmake_sample_mesh
from mpopis_tpu.parallel import sample_sharding
from mpopis_tpu.policies import PolicyConfig as JPolicyConfig
from mpopis_tpu.policies import make_policy as jmake_policy

from mpopis_tpu_torch.parallel import SampleMesh
from mpopis_tpu_torch.parallel.mesh import spawn_ranks
from mpopis_tpu_torch.policies import POLICY_KINDS

WORLD = 4
COV = np.diag([0.0625, 0.1])
_rng = np.random.default_rng(20)

# the collectives' cases: name, inputs
_w = _rng.uniform(size=64)
COLLECTIVES = {
    "it_weights": dict(name="it_weights", data=dict(costs=_rng.normal(size=64), lam=3.0)),
    "weighted_mean_cov": dict(name="weighted_mean_cov",
                              data=dict(e=_rng.normal(size=(6, 64)), w=_w / _w.sum())),
    "mean_cov": dict(name="mean_cov", data=dict(e=_rng.normal(size=(4, 40)))),
}
TOP_K = {
    f"{n}-{k}": dict(name="top_k", data=dict(costs=_rng.permutation(n).astype(float), k=k))
    for n, k in ((64, 5), (152, 30), (64, 20), (160, 8))
}
# 22 of 32 costs +inf, none in rank 0's block, k = 16 > K_r = 8: rank 0's
# pads tie the genuine +inf costs ahead of them and reach the result
_inf = _rng.permutation(32).astype(float)
_inf[10:] = np.inf
TOP_K["32-16-inf"] = dict(name="top_k", data=dict(costs=_inf, k=16))
GATHER = {
    "costs-30": dict(name="gather", data=dict(x=_rng.normal(size=30))),
    "trajectories-30": dict(name="gather", data=dict(x=_rng.normal(size=(30, 4, 8)))),
    "costs-64": dict(name="gather", data=dict(x=_rng.normal(size=64))),
}

# the slice against the JAX package: two chained steps under injected normals
JK, JH, JITS, JSTEPS = 32, 10, 2, 2
JCFG = dict(kind="cemppi", num_samples=JK, horizon=JH, lam=10.0, opt_its=JITS, sigma_est="ss")
JZ = _rng.standard_normal((JSTEPS, JITS, 2 * JH, JK))
SLICE = dict(task="car", cfg=JCFG, cov=COV, steps=JSTEPS, z=JZ)

# every kind on the car at K=30 (blocks 8, 8, 7, 7), two chained steps
KK, KSTEPS = 30, 2
KINDS = {
    kind: dict(task="car", cov=COV, steps=KSTEPS, seed=3,
               cfg=dict(kind=kind, num_samples=KK, horizon=8, lam=10.0, opt_its=2,
                        sigma_est="ss", cma_sigma=0.75),
               uniforms=(_rng.uniform(size=(KSTEPS, 2, KK)) if kind == "pmcmppi" else None))
    for kind in POLICY_KINDS
}
OTHERS = {
    "car-logged": dict(task="car", cov=COV, steps=2, seed=4,
                       cfg=dict(kind="cemppi", num_samples=KK, horizon=6, lam=10.0, opt_its=2,
                                sigma_est="ss", log=True)),
    "mountaincar-muaismppi": dict(task="mountaincar", cov=[1.5], steps=2, seed=5,
                                  cfg=dict(kind="muaismppi", num_samples=16, horizon=8, lam=0.1,
                                           opt_its=2, lambda_ais=0.1)),
    "halfcheetah-cemppi": dict(task="cheetah", cov=[0.25] * 6, steps=2, seed=6,
                               cfg=dict(kind="cemppi", num_samples=16, horizon=2, lam=0.1,
                                        opt_its=2, sigma_est="mle")),
}


def _cases():
    cases = []
    for group in (COLLECTIVES, TOP_K, GATHER, KINDS, OTHERS):
        cases += [dict(case, id=name) for name, case in group.items()]
    race = dict(num_trials=2, num_steps=3, num_cars=2, policy_type="cmamppi", num_samples=KK,
                horizon=5, ais_its=2)
    return cases + [dict(SLICE, id="slice", twin=False), dict(id="race", race=race)]


def _jax_refs() -> dict:
    """The JAX package's results on the same inputs, on a 4-device mesh."""
    mesh = jmake_sample_mesh(WORLD)

    def sharded(fn, in_specs, out_specs, *args, **kw):
        f = jax.shard_map(functools.partial(fn, axis=SAMPLE_AXIS, **kw), mesh=mesh,
                          in_specs=in_specs, out_specs=out_specs)
        return jax.tree.map(np.asarray, f(*(jnp.asarray(a) for a in args)))

    data = {name: case["data"] for name, case in COLLECTIVES.items()}
    refs = {
        "it_weights": sharded(global_it_weights, P(SAMPLE_AXIS), P(SAMPLE_AXIS),
                              data["it_weights"]["costs"], lam=data["it_weights"]["lam"]),
        "weighted_mean_cov": sharded(global_weighted_mean_cov,
                                     (P(None, SAMPLE_AXIS), P(SAMPLE_AXIS)), (P(), P()),
                                     data["weighted_mean_cov"]["e"],
                                     data["weighted_mean_cov"]["w"]),
        "mean_cov": sharded(global_mean_cov, P(None, SAMPLE_AXIS), (P(), P()),
                            data["mean_cov"]["e"], k_global=data["mean_cov"]["e"].shape[1]),
    }
    for name, case in TOP_K.items():
        refs[name] = sharded(global_top_k, P(SAMPLE_AXIS), (P(), P()), case["data"]["costs"],
                             k=case["data"]["k"])
    env = JCarRacingEnv(dtype=jnp.float64)
    pol = jmake_policy(env, JPolicyConfig(**JCFG), cov_mat=COV,
                       sample_sharding=sample_sharding(mesh, ndim=3))
    s, ps = env.reset(), pol.init_state(0)
    refs["slice"] = []
    for i in range(JSTEPS):
        a, ps, info = pol.step(s, ps, z=jnp.asarray(JZ[i]))
        refs["slice"].append({"action": np.asarray(a), "U": np.asarray(ps.U),
                              "costs": np.asarray(info["costs"])})
        s = env.step(s, a)
    return refs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(The four ranks' pickled results rank by rank, the JAX package's
    results): the ranks run while JAX computes."""
    d = tmp_path_factory.mktemp("ranks")
    with ThreadPoolExecutor(1) as pool:
        done = pool.submit(spawn_ranks, run_cases, WORLD,
                           args=(WORLD, f"file://{d / 'group'}", _cases(), str(d)),
                           timeout=240.0)
        refs = _jax_refs()
        done.result()
    ranks = []
    for r in range(WORLD):
        with open(d / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ranks, refs


@pytest.fixture(scope="module")
def ranks(runs):
    return runs[0]


@pytest.fixture(scope="module")
def jax_refs(runs):
    return runs[1]


def _close(got, want):
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("k,n", [(30, 4), (32, 4), (7, 3), (8192, 2), (8191, 2), (5, 5)])
def test_blocks_partition_the_samples(k, n):
    """Contiguous blocks of ⌈K/n⌉ or ⌊K/n⌋ samples, the larger first."""
    blocks = [SampleMesh(None, r, n, torch.device("cpu")).block(k) for r in range(n)]
    assert blocks[0][0] == 0 and blocks[-1][1] == k
    assert all(a[1] == b[0] for a, b in zip(blocks, blocks[1:]))
    sizes = [stop - start for start, stop in blocks]
    assert sizes == sorted(sizes, reverse=True) and set(sizes) <= {k // n, -(-k // n)}


def test_each_rank_holds_its_mesh(ranks):
    for r, out in enumerate(ranks):
        assert out["mesh"] == (r, WORLD, "cpu")
        assert out["block"] == ((0, 8), (8, 16), (16, 23), (23, 30))[r]
        assert out.get("cuda default refused", True)  # set where no card is visible


def test_it_weights_match_jax(ranks, jax_refs):
    got = np.concatenate([out["it_weights"]["w"] for out in ranks])
    _close(got, jax_refs["it_weights"])
    assert all(out["it_weights"]["inputs_kept"] for out in ranks)


@pytest.mark.parametrize("case", ["weighted_mean_cov", "mean_cov"])
def test_mean_and_cov_match_jax(ranks, jax_refs, case):
    mu, cov = jax_refs[case]
    for out in ranks:
        _close(out[case]["mu"], mu)
        _close(out[case]["cov"], cov)
        assert out[case]["inputs_kept"]


@pytest.mark.parametrize("case", sorted(TOP_K))
def test_global_top_k_matches_jax(ranks, jax_refs, case):
    """Values exactly; indices as a set, as the JAX package's own test
    holds them (−1 for a pad)."""
    data = TOP_K[case]["data"]
    vals, idx = jax_refs[case]
    order = np.argsort(data["costs"], kind="stable")[: data["k"]]
    for out in ranks:
        got = out[case]
        np.testing.assert_array_equal(got["vals"], np.asarray(vals))
        np.testing.assert_array_equal(got["vals"], data["costs"][order])
        np.testing.assert_array_equal(np.sort(got["idx"]), np.sort(np.asarray(idx)))
        assert got["inputs_kept"]
    if case.endswith("inf"):
        assert (np.asarray(idx) == -1).any()
    else:
        np.testing.assert_array_equal(np.sort(ranks[0][case]["idx"]), np.sort(order))


@pytest.mark.parametrize("case", sorted(GATHER))
def test_gather_sample_costs_is_exact(ranks, case):
    for out in ranks:
        np.testing.assert_array_equal(out[case]["x"], GATHER[case]["data"]["x"])
        assert out[case]["inputs_kept"]


def _same_steps(got, want, bitwise=True):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys() and g["ais_its"] == w["ais_its"]
        for key in g.keys() - {"ais_its"}:
            if bitwise:
                np.testing.assert_array_equal(g[key], w[key], err_msg=key)
            else:
                _close(g[key], w[key])


def _ranks_agree(ranks, case, bitwise=True):
    """Every rank's steps equal rank 0's bit for bit, and rank 0's equal the
    steps without a mesh (bit for bit, or at rtol 1e-12)."""
    for out in ranks:
        _same_steps(out[case]["sharded"], ranks[0][case]["sharded"])
    _same_steps(ranks[0][case]["sharded"], ranks[0][case]["twin"], bitwise)


@pytest.mark.parametrize("kind", POLICY_KINDS)
def test_sharded_kind_equals_unsharded(ranks, kind):
    _ranks_agree(ranks, kind)


@pytest.mark.parametrize("case", sorted(OTHERS))
def test_sharded_task_equals_unsharded(ranks, case):
    """The car's logged rollout (`rollout_batch`) and HalfCheetah's plain
    rollout on the CPU round a few samples' last bit differently on a block
    of another length (PyTorch's CPU kernels, not the mesh: the costs are
    gathered exactly), so these hold at rtol 1e-12; MountainCar's holds bit
    for bit."""
    _ranks_agree(ranks, case, bitwise=case.startswith("mountaincar"))
    if case == "car-logged":
        assert ranks[0][case]["sharded"][0]["trajectories"].shape == (KK, 6, 8)


def test_sharded_race_without_a_seed_is_one_race(ranks):
    """`simulate_car_racing` on the mesh with no seed: every rank races
    rank 0's random seed (2 cars, CMAMPPI, 2 trials), and so every rank
    gets the same metrics."""
    want = ranks[0]["race"]
    assert list(want["steps"]) == [3, 3] and want["rewards"][0] != want["rewards"][1]
    for out in ranks[1:]:
        assert out["race"].keys() == want.keys()
        for key, value in out["race"].items():
            np.testing.assert_array_equal(value, want[key], err_msg=key)


def test_sharded_step_matches_jax_sample_sharding(ranks, jax_refs):
    """The port's CEMPPI step on the 4-rank mesh against the JAX package's
    GSPMD-sharded step on a 4-device mesh, under the same normals: action,
    costs and U at rtol 1e-12, over two chained steps."""
    assert len(jax.devices()) == 8 and len(jax_refs["slice"]) == JSTEPS
    for out in ranks:
        for got, w in zip(out["slice"]["sharded"], jax_refs["slice"]):
            for key in ("action", "U", "costs"):
                _close(got[key], w[key])
