"""The port's host MuJoCo path on the CPU: its envpool_lite engine is the JAX
package's, bit for bit; its `HostPolicy` gives the JAX `HostPolicy`'s
actions under injected normals (f64); `simulate_mujoco` and the `mujoco`
CLI run, and the action CSV replays in gymnasium to the trial's reward."""

import warnings

warnings.filterwarnings("ignore")

import ctypes
import os

import numpy as np
import pytest
import torch

mujoco = pytest.importorskip("mujoco")
gymnasium = pytest.importorskip("gymnasium")

import jax
import jax.numpy as jnp

from mpopis_tpu.models.mujoco_host import MujocoBatchedEnv as JMujocoBatchedEnv
from mpopis_tpu.policies.config import PolicyConfig as JPolicyConfig
from mpopis_tpu.policies.host_driver import make_host_policy as jmake_host_policy

from mpopis_tpu_torch.harness.cli import main
from mpopis_tpu_torch.harness.simulate_mujoco import simulate_mujoco
from mpopis_tpu_torch.models.mujoco_host import MujocoBatchedEnv
from mpopis_tpu_torch.native import build as native_build
from mpopis_tpu_torch.policies.config import PolicyConfig
from mpopis_tpu_torch.policies.host_driver import make_host_policy

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def engines():
    """The JAX package's engine and the port's, each from its own library."""
    j = JMujocoBatchedEnv("HalfCheetah-v4", num_envs=4, frame_skip=5)
    p = MujocoBatchedEnv("HalfCheetah-v4", num_envs=4, frame_skip=5)
    yield j, p
    j.close()
    p.close()


def test_engine_source_is_the_jax_package_s_byte_for_byte():
    with open(os.path.join(_REPO, "mpopis_tpu", "native", "envpool_lite.cc"), "rb") as f:
        theirs = f.read()
    assert native_build.SRC.read_bytes() == theirs


def test_engine_builds_into_the_build_directory_by_hash(engines):
    _, p = engines
    so = native_build.build()
    assert os.path.dirname(so) == str(native_build.BUILD_DIR)
    assert os.path.basename(so).startswith("libenvpool_lite_") and os.path.exists(so)
    assert p._backend == "native" and native_build.build() == so  # built once, then reused
    assert (p.obs_dim, p.action_dim, p.dt) == (17, 6, pytest.approx(0.05))


def test_both_libraries_load_apart_in_one_process(engines):
    """The JAX copy and the port's export the same epl_* symbols; each env
    calls its own library (ctypes' RTLD_LOCAL keeps them apart)."""
    j, p = engines
    assert j._lib._name != p._lib._name
    assert os.path.dirname(p._lib._name) == str(native_build.BUILD_DIR)
    pj = ctypes.cast(j._lib.epl_step, ctypes.c_void_p).value
    pp = ctypes.cast(p._lib.epl_step, ctypes.c_void_p).value
    assert pj != pp


@pytest.mark.parametrize("task", ["HalfCheetah-v4", "Hopper-v4", "Ant-v4"])
def test_engine_bit_equal_to_the_jax_engine(task):
    """Reset, 5 steps, a snapshot, a step, a restore and the step again: the
    two engines' observations and rewards are bit-equal throughout. The
    replayed step equals the first up to the solver's warm start, which a
    snapshot does not hold (bit-equal without contacts)."""
    j = JMujocoBatchedEnv(task, num_envs=3, frame_skip=5)
    p = MujocoBatchedEnv(task, num_envs=3, frame_skip=5)
    np.testing.assert_array_equal(p.reset(), j.reset())
    rng = np.random.default_rng(4)
    for _ in range(5):
        a = rng.uniform(p.action_low, p.action_high, (3, p.action_dim))
        (oj, rj), (op, rp) = j.step(a), p.step(a)
        np.testing.assert_array_equal(op, oj)
        np.testing.assert_array_equal(rp, rj)
    p.snapshot()
    j.snapshot()
    a = rng.uniform(p.action_low, p.action_high, (3, p.action_dim))
    first, first_j = p.step(a), j.step(a)
    p.restore()
    j.restore()
    again, again_j = p.step(a), j.step(a)
    for ours, theirs in ((first, first_j), (again, again_j)):
        np.testing.assert_array_equal(ours[0], theirs[0])
        np.testing.assert_array_equal(ours[1], theirs[1])
    for a_, f_ in zip(again, first):
        np.testing.assert_allclose(a_, f_, rtol=1e-12, atol=1e-12)
    j.close()
    p.close()


def test_python_engine_matches_the_native_one():
    """`native=False` steps gymnasium's envs: the same observations and
    rewards as the native engine, and snapshot/restore."""
    n = MujocoBatchedEnv("HalfCheetah-v4", num_envs=2, frame_skip=5)
    py = MujocoBatchedEnv("HalfCheetah-v4", num_envs=2, frame_skip=5, native=False)
    assert py._backend == "python"
    np.testing.assert_array_equal(py.reset(), n.reset())
    a = np.full((2, 6), 0.3)
    on, rn = n.step(a)
    py.snapshot()
    op, rp = py.step(a)
    np.testing.assert_array_equal(op, on)
    np.testing.assert_allclose(rp, rn, rtol=1e-12)
    py.restore()
    np.testing.assert_array_equal(py.step(a)[0], op)
    n.close()
    py.close()


def test_native_build_failure_raises_and_names_no_native(tmp_path, monkeypatch):
    bad = tmp_path / "envpool_lite.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native_build, "SRC", bad)
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match=r"native=False \(--no-native\)"):
        MujocoBatchedEnv("HalfCheetah-v4", num_envs=2, frame_skip=5)
    assert not list((tmp_path / "_build").glob("*.so"))


def test_action_log_and_csv(tmp_path, engines):
    _, p = engines
    p.reset()
    acts = np.random.default_rng(2).uniform(-0.5, 0.5, (3, 6))
    for a in acts:
        p.step(a)  # broadcast to the K envs and recorded
    path = p.write_acts_to_file(str(tmp_path / "acts"))
    assert path.endswith(".csv")
    lines = open(path).read().splitlines()
    assert len(lines) == 3 and all(len(v.split(".")[1]) == 20 for v in lines[0].split(","))
    np.testing.assert_array_equal(np.loadtxt(path, delimiter=","), acts)


# -- HostPolicy against the JAX HostPolicy --------------------------------

K, HOR, ITS, STEPS = 16, 6, 2, 8


def _run_both(kind, monkeypatch):
    """STEPS control steps of both host policies, each on its own engine,
    with the same pre-drawn normals: returns the two action sequences."""
    kw = dict(kind=kind, num_samples=K, horizon=HOR, lam=1.0, opt_its=ITS, sigma_est="ss")
    cov = 0.25 * np.eye(6)
    jenv = JMujocoBatchedEnv("HalfCheetah-v4", num_envs=K, frame_skip=5)
    penv = MujocoBatchedEnv("HalfCheetah-v4", num_envs=K, frame_skip=5)
    jpol = jmake_host_policy(jenv, JPolicyConfig(**kw), cov_mat=cov)
    ppol = make_host_policy(penv, PolicyConfig(**kw), cov_mat=cov, device="cpu")
    rng = np.random.default_rng(11)
    shape = (K, HOR, 6) if kind == "mppi" else (ITS, 6 * HOR, K)
    queue = []

    def fake_normal(key, shape_, dtype=None):
        return jnp.asarray(queue.pop(0), dtype=dtype)

    monkeypatch.setattr(jax.random, "normal", fake_normal)
    jps, pps = jpol.init_state(3), ppol.init_state(3)
    ja, pa = [], []
    for _ in range(STEPS):
        z = rng.standard_normal(shape)
        queue[:] = [z] if kind == "mppi" else list(z)
        aj, jps, jinfo = jpol.step(jps)
        ap, pps, pinfo = ppol.step(pps, z=torch.as_tensor(z))
        jenv.step(aj)
        penv.step(ap)
        ja.append(np.asarray(aj))
        pa.append(ap)
        np.testing.assert_allclose(pinfo["weights"], jinfo["weights"], rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(pps.U.numpy(), np.asarray(jps.U), rtol=0, atol=1e-9)
    np.testing.assert_allclose(penv.rews, jenv.rews, rtol=1e-9)
    jenv.close()
    penv.close()
    return np.stack(ja), np.stack(pa)


@pytest.mark.parametrize("kind", ["cemppi", "mppi"])
def test_host_policy_matches_jax_under_injected_normals(kind, monkeypatch):
    ja, pa = _run_both(kind, monkeypatch)
    assert pa.shape == (STEPS, 6) and np.all(np.abs(pa) <= 1.0)
    np.testing.assert_allclose(pa, ja, rtol=0, atol=1e-9)
    assert np.ptp(pa) > 0.1  # the actions move


@pytest.mark.parametrize("kind", ["cmamppi", "pmcmppi", "nesmppi"])
def test_host_policy_other_kinds_run(kind):
    env = MujocoBatchedEnv("Swimmer-v4", num_envs=8, frame_skip=4)
    pol = make_host_policy(env, PolicyConfig(kind=kind, num_samples=8, horizon=4, opt_its=2),
                           cov_mat=0.25 * np.eye(2), device="cpu")
    ps = pol.init_state(0)
    for _ in range(2):
        act, ps, info = pol.step(ps)
        env.step(act)
    assert act.shape == (2,) and np.isfinite(act).all()
    np.testing.assert_allclose(info["weights"].sum(), 1.0, rtol=1e-12)
    assert ps.U.dtype == torch.float64 and ps.U.device.type == "cpu"
    env.close()


def test_host_policy_seeds_its_generator():
    env = MujocoBatchedEnv("HalfCheetah-v4", num_envs=8, frame_skip=5)
    pol = make_host_policy(env, PolicyConfig(num_samples=8, horizon=3, opt_its=2),
                           device="cpu")
    acts = []
    for seed in (5, 5, 6):
        env.reset()
        acts.append(pol.step(pol.init_state(seed))[0])
    np.testing.assert_array_equal(acts[0], acts[1])
    assert not np.array_equal(acts[0], acts[2])
    env.close()


def test_host_policy_rejects_a_k_other_than_the_envs():
    env = MujocoBatchedEnv("HalfCheetah-v4", num_envs=4, frame_skip=5)
    with pytest.raises(ValueError, match="must equal env.num_envs"):
        make_host_policy(env, PolicyConfig(num_samples=8, horizon=3), device="cpu")
    env.close()


# -- simulate_mujoco and the CLI -------------------------------------------

def test_simulate_mujoco_csv_replays_in_gymnasium(tmp_path):
    from scripts.replay_mujoco import replay

    m = simulate_mujoco(
        "HalfCheetah-v4", num_trials=1, num_steps=8, num_samples=16, horizon=6, ais_its=2,
        seed=3, output_acts_file=True, acts_dir=str(tmp_path), log_runs=True,
        log_dir=str(tmp_path / "logs"), print_output=False, device="cpu",
    )
    (csv,) = sorted(tmp_path.glob("*.csv"))
    acts = np.loadtxt(csv, delimiter=",", ndmin=2)
    assert acts.shape == (9, 6)  # the loop bound cnt <= num_steps: 9 executed actions
    assert m["steps"][0] == 8
    np.testing.assert_allclose(replay(str(csv), "HalfCheetah-v4"), m["rewards"][0], rtol=1e-12)
    (log,) = list((tmp_path / "logs").glob("*.txt"))
    text = log.read_text()
    assert "HalfCheetah-v4 cemppi K=16 H=6 seed=3" in text and "rewards: [" in text
    assert set(m) >= {"rewards", "steps", "rewards_per_step", "exec_times",
                      "control_steps_per_s"}


def test_simulate_mujoco_matches_the_jax_harness_rows(monkeypatch, capsys):
    """The banner, the header and the summary table's shape are the JAX
    harness's (the rewards differ: the two generators differ)."""
    from mpopis_tpu.harness.simulate_mujoco import simulate_mujoco as jsimulate_mujoco

    kw = dict(num_trials=2, num_steps=2, num_samples=4, horizon=2, ais_its=1, seed=5)
    simulate_mujoco("Swimmer-v4", device="cpu", **kw)
    ours = capsys.readouterr().out.splitlines()
    jsimulate_mujoco("Swimmer-v4", **kw)
    theirs = capsys.readouterr().out.splitlines()
    assert len(ours) == len(theirs)
    cut = ours.index("Trial    #:       Reward :   Steps:  Reward/Step : Ex Time")
    assert ours[:cut + 1] == theirs[:cut + 1]
    for a, b in zip(ours[cut + 1:], theirs[cut + 1:]):
        assert a.split(":")[0] == b.split(":")[0]


@pytest.mark.parametrize("argv,banner", [
    (["mujoco"], "HalfCheetah-v4"),
    (["mujoco", "--env-name", "Hopper-v4", "--frame-skip", "3"], "Hopper-v4"),
])
def test_cli_mujoco_runs_the_host_engine(argv, banner, capsys):
    rc = main(argv + ["--device", "cpu", "--samples", "8", "--horizon", "4", "--ais-its", "2",
                      "--steps", "3", "--seed", "3"])
    assert rc == 0
    out = capsys.readouterr().out
    assert f"Sim Type:                     {banner}" in out
    skip = "3" if "--frame-skip" in argv else "5"
    assert f"Frame Skip:                   {skip}" in out
    row = next(line for line in out.splitlines() if line.startswith("Trial    1:"))
    assert int(row.split(":")[2]) == 3
    assert "Trials MAX:" in out


def test_cli_mujoco_no_native_and_log_runs(tmp_path, monkeypatch, capsys):
    """`--no-native` takes the Python engine and `--log-runs` writes the run
    log; `--output-acts-file` the action CSV."""
    seen = []
    real = MujocoBatchedEnv.__init__

    def spy(self, *a, **kw):
        real(self, *a, **kw)
        seen.append(self._backend)

    monkeypatch.setattr(MujocoBatchedEnv, "__init__", spy)
    monkeypatch.chdir(tmp_path)
    rc = main(["mujoco", "--no-native", "--log-runs", "--output-acts-file", "--device", "cpu",
               "--samples", "4", "--horizon", "2", "--ais-its", "1", "--steps", "2",
               "--seed", "1"])
    assert rc == 0 and seen and set(seen) == {"python"}
    assert len(list((tmp_path / "logs").glob("HalfCheetah-v4_5_cemppi_*.txt"))) == 1
    (csv,) = list((tmp_path / "acts").glob("*trial-1.csv"))
    assert np.loadtxt(csv, delimiter=",", ndmin=2).shape == (3, 6)


def test_chip_smoke_host_run_on_the_cpu(tmp_path):
    """chip_smoke's host path (phase 48) at a small size on the CPU: each
    trial's CSV replays in gymnasium to its reward."""
    import chip_smoke

    config = dict(chip_smoke.BASELINE_ROW1, num_trials=2, num_steps=3, num_samples=8,
                  horizon=4, ais_its=2)
    m, replays, counts = chip_smoke.host_run("cpu", config, str(tmp_path))
    assert list(m["steps"]) == [3, 3]
    np.testing.assert_allclose(replays, m["rewards"], rtol=1e-12)
    assert not any(counts.values())
