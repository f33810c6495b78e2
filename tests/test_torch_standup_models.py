"""The port's HumanoidStandup in float64 on the CPU against the JAX package:
the supine reset's rows, the contact force term (`contact_force_ssq`) of
the Standup's lying-down tables, one RK4 substep from the supine reset, the
JAX env's control step with its Σ‖cfrc_ext‖² carry and reward from the
supine reset and the crouch (an action beyond ±0.4 pins the clipped control
cost), `reset`, `reward(state)` and `observation`, the plain rollout costs
and the CEMPPI step with the same injected normals; the wrappers' CPU path,
the packed model of the Standup build, its device code
(csrc/spatial_dynamics.cuh) built for the host with g++ against the plain
version, and the CLI on HumanoidStandup-v4. The geometry shared with the
Humanoid (frames, mass, bias, springs, capsule–capsule pairs) is pinned in
test_torch_humanoid_{models,kernel}.py; the CUDA build itself is held
against the plain version on the card by tests/test_torch_cuda.py and
chip_smoke.py.

The JAX Standup step is never compiled whole: an XLA:CPU compile of its
step graph (242 rows, then Σ‖cfrc_ext‖² over 109 pairs) had not finished
after 13 min on this CPU and grew to 9-18 GB. `_JaxStepStandup` runs the
JAX env's step as written there, its scan over the five substeps as a loop
of the JAX substep compiled alone (~2 min, once per module) and
`contact_force_ssq` eagerly. Where the supine body's contact switches turn
rounding into other QP iterates, a value beyond 1e-9 is held within 10×
the JAX side's own spread under actions·(1 + 1e-15) (the nudge rule)."""

import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_humanoid_kernel import _close, cemppi_step_against_jax, run_host

from mpopis_tpu.models import humanoidstandup_device as jsd
from mpopis_tpu.models import spatial_contact as jsc
from mpopis_tpu.utils.fastjit import fast_jit

from mpopis_tpu_torch.harness.cli import main
from mpopis_tpu_torch.kernels import spatial_step
from mpopis_tpu_torch.kernels.build import CSRC_DIR
from mpopis_tpu_torch.models import HumanoidStandupDeviceEnv, humanoid_device
from mpopis_tpu_torch.models import humanoidstandup_device as sd
from mpopis_tpu_torch.models import spatial_contact as sc
from mpopis_tpu_torch.models.base import make_state

M, JM = sd.MODEL, jsd.MODEL
K, T = 3, 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions are thousands of tiny ops: one thread each keeps
    test processes that run side by side from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def standup_state(name, dtype=torch.float64):
    """The supine reset (floor and self-pair rows active), or the Standup's
    table in the crouch (the same) with velocities from a numpy seed and a
    zero carry."""
    env = HumanoidStandupDeviceEnv(dtype=dtype, device="cpu")
    if name == "reset":
        return env, env.reset().x
    q = humanoid_device.crouched_qpos(M)
    qv = torch.as_tensor(np.random.default_rng(4).uniform(-0.3, 0.3, 23))
    return env, torch.cat([q, qv, torch.zeros(1, dtype=torch.float64)]).to(dtype)


def _jax(v):
    return tuple(jnp.asarray(e) for e in v)


# the JAX env's substep (the function its step's scan runs) at solver (3, 6),
# compiled on first use
_JAX_SUBSTEP = fast_jit(lambda q, qv, tau, lam: jsd._rk4_substep(q, qv, tau, 3, 6, lam))


class _JaxStepStandup(jsd.HumanoidStandupDeviceEnv):
    """The JAX env whose `step` is its own, with the scan over the substeps
    written as a loop of the compiled substep and Σ‖cfrc_ext‖² run eagerly;
    `step_reward`, `reward` and `observation` are the JAX env's."""

    def step(self, state, action):
        tau = self._tau(jnp.clip(action, -0.4, 0.4))
        q = tuple(state.x[i] for i in range(24))
        qv = tuple(state.x[24 + i] for i in range(23))
        lam, q4 = jnp.zeros(JM.n_rows, dtype=state.x.dtype), q
        for _ in range(jsd._FRAME_SKIP):
            q, qv, lam, q4 = _JAX_SUBSTEP(q, qv, tau, lam)
        ssq = jsc.contact_force_ssq(JM, q4, lam)
        return state.replace(x=jnp.stack(q + qv + (ssq,)), t=state.t + 1)


JENV = _JaxStepStandup(dtype=jnp.float64)


def _jax_costs(x, controls):
    """The JAX rollout costs Σ_t −step_reward_t of controls (K, T, na) from
    the state x, one sample at a time."""
    costs = []
    for c in np.asarray(controls):
        s, total = JENV.reset().replace(x=jnp.asarray(x)), 0.0
        for u in c:
            s, r = JENV.step_reward(s, jnp.asarray(u))
            total -= float(r)
        costs.append(total)
    return np.asarray(costs)


def _rel(got, want):
    return float(np.max(np.abs(np.asarray(got) - want)) / max(np.max(np.abs(want)), 1e-300))


def _held(parts, nudged):
    """Each (what, got, want) at 1e-9 relative to max|want|, or, where one
    is beyond it, within 10× the JAX side's own spread: `nudged()` gives
    the wants at inputs·(1 + 1e-15), in the same order. Prints both (shown
    with `pytest -s`)."""
    errs = [_rel(g, w) for _, g, w in parts]
    own = [0.0] * len(parts)
    if max(errs) > 1e-9:
        own = [_rel(n, w) for n, (_, _, w) in zip(nudged(), parts)]
    for (what, _, _), e, o in zip(parts, errs, own):
        print(f"{what}: port against JAX {e:.3e}, the JAX side's own spread {o:.3e}")
        assert e <= max(1e-9, 10 * o), f"{what}: {e:.3e}, the JAX side's own spread {o:.3e}"


def test_supine_rows_and_contact_force_ssq_match_jax():
    """At the supine reset: the 242 rows' J, aref, R and valid set at 1e-12
    with floor rows valid; Σ‖cfrc_ext‖² of the same λ (random, ≥ 0 on every
    row) at 1e-12 there and in the crouch, where self-pair rows carry force
    too; limit rows carry none."""
    _, x = standup_state("reset")
    q, qv = x[:24].numpy(), np.random.default_rng(1).uniform(-0.5, 0.5, 23)
    jmat, aref, reg, act = sc.contact_rows(M, torch.as_tensor(q), torch.as_tensor(qv))
    rows = jsc.contact_rows(JM, _jax(q), _jax(qv), jnp.float64(0.0))
    _close(jmat.numpy(), np.array([[float(v) for v in j] for j, *_ in rows]), 1e-12)
    _close(aref.numpy(), [float(r[1]) for r in rows], 1e-12)
    _close(reg.numpy(), [float(r[2]) for r in rows], 1e-12)
    assert act.tolist() == [bool(r[3]) for r in rows]
    assert act[17:133].any()

    rng = np.random.default_rng(3)
    for name in ("reset", "crouch"):
        q = standup_state(name)[1][:24].numpy()
        lam = rng.uniform(0.0, 5.0, M.n_rows)
        got = sc.contact_force_ssq(M, torch.as_tensor(q), torch.as_tensor(lam))
        np.testing.assert_allclose(float(got), float(jsc.contact_force_ssq(JM, _jax(q), _jax(lam))),
                                   rtol=1e-12)
        lam[:17] = 1e3
        np.testing.assert_allclose(
            float(sc.contact_force_ssq(M, torch.as_tensor(q), torch.as_tensor(lam))), float(got),
            rtol=1e-15)


def test_rk4_substep_from_the_supine_reset_matches_jax():
    """One RK4 substep of the Standup's tables from the supine reset (floor
    and self-pair rows valid) under an actuator torque: q', q̇', λ and the
    stage-4 snapshot at rtol 1e-10 against the JAX env's substep."""
    env, x = standup_state("reset")
    q, qv = x[:24].numpy(), np.random.default_rng(1).uniform(-0.3, 0.3, 23)
    tau = env._tau(torch.as_tensor(np.random.default_rng(4).uniform(-0.4, 0.4, 17))).numpy()
    want = _JAX_SUBSTEP(_jax(q), _jax(qv), _jax(tau), jnp.zeros(M.n_rows))
    got = sc.rk4_substep(M, torch.as_tensor(q), torch.as_tensor(qv), torch.as_tensor(tau), 3, 6,
                         torch.zeros(M.n_rows, dtype=torch.float64))
    for g, w in zip(got, want):
        w = np.array([float(e) for e in w]) if isinstance(w, tuple) else np.asarray(w, dtype=float)
        _close(g.numpy(), w, 1e-10)
    assert float(got[2].abs().sum()) > 0.0


@pytest.mark.parametrize("name", ["reset", "crouch"])
def test_step_reward_and_carry_match_jax(name):
    """One control step with an action up to ±0.6 (the torque and the
    control cost read it clipped to ±0.4) against the JAX env's: the new
    state, its Σ‖cfrc_ext‖² carry and the reward at 1e-9 (or by the nudge
    rule); `reset`, `reward(state)` and `observation` as the JAX env's."""
    env, x = standup_state(name)
    a = np.random.default_rng(9).uniform(-0.6, 0.6, 17)
    assert np.sum(np.clip(a, -0.4, 0.4) ** 2) < np.sum(a**2)

    def jax_step(act):
        js, jr = JENV.step_reward(JENV.reset().replace(x=jnp.asarray(x.numpy())), jnp.asarray(act))
        jx = np.asarray(js.x)
        return js, [jx[:47], jx[47:], np.asarray([float(jr)])]

    s, r = env.step_reward(make_state(x), torch.as_tensor(a))
    js, want = jax_step(a)
    assert want[1][0] > 0.0
    _held([("state", s.x[:47].numpy(), want[0]), ("carry", s.x[47:].numpy(), want[1]),
           ("reward", np.asarray([float(r)]), want[2])],
          lambda: jax_step(a * (1 + 1e-15))[1])
    np.testing.assert_array_equal(env.reset().x.numpy(), np.asarray(JENV.reset().x))
    same = js.replace(x=jnp.asarray(s.x.numpy()))  # the port's state in the JAX env
    np.testing.assert_allclose(float(env.reward(s)), float(JENV.reward(same)), rtol=1e-15)
    np.testing.assert_array_equal(env.observation(s).numpy(), np.asarray(JENV.observation(same)))


def test_plain_rollout_costs_sum_the_jax_rewards():
    """The plain rollout costs (K=3, T=2) from the supine reset against the
    sums of the JAX env's −`step_reward` along its own steps (one state at a
    time), at 1e-9 or by the nudge rule."""
    env, x = standup_state("reset")
    controls = np.random.default_rng(21).uniform(-0.4, 0.4, (K, T, 17))
    got = spatial_step.spatial_rollout_costs_tak_reference(
        env, x, torch.as_tensor(controls.transpose(1, 2, 0)))
    assert got.shape == (K,) and got.dtype == torch.float64
    _held([("costs", got.numpy(), _jax_costs(x.numpy(), controls))],
          lambda: [_jax_costs(x.numpy(), controls * (1 + 1e-15))])


def test_cemppi_step_matches_jax():
    """The Standup's CEMPPI step (λ=0.3) from the supine reset against the
    JAX package's, the JAX policy scoring its candidates with the JAX env's
    steps, under the nudge rule (the back lies on the floor)."""
    cemppi_step_against_jax(
        jsd.HumanoidStandupDeviceEnv, HumanoidStandupDeviceEnv(dtype=torch.float64, device="cpu"),
        0.3, costs=lambda x, c: _jax_costs(x, np.transpose(c, (2, 0, 1))))


def test_first_substep_active_rows_counts_floor_and_self_rows():
    """Supine, the back lies on the floor (16 pyramid rows: 4 contacts) and
    6 self pairs touch; the crouch has floor and self-pair rows too."""
    assert spatial_step.first_substep_active_rows(*standup_state("reset"))[1:] == (16, 6)
    _, n_con, n_self = spatial_step.first_substep_active_rows(*standup_state("crouch"))
    assert n_con > 0 and n_self > 0


def test_wrappers_on_cpu_run_the_plain_versions_without_launching():
    env, x0 = standup_state("reset")
    ctrl_tak = torch.as_tensor(np.random.default_rng(5).uniform(-0.4, 0.4, (1, 17, 2)))
    launches, step_launches = spatial_step.LAUNCHES, spatial_step.STEP_LAUNCHES
    want = spatial_step.spatial_rollout_costs_tak_reference(env, x0, ctrl_tak)
    assert torch.equal(spatial_step.spatial_rollout_costs_tak(env, x0, ctrl_tak), want)
    assert torch.equal(env.fused_rollout_costs_tak(make_state(x0), ctrl_tak), want)
    xs = x0.expand(2, -1)
    acts = ctrl_tak[0].T
    plain = env.plain_step(make_state(xs), acts).x
    assert torch.equal(spatial_step.spatial_step_states(env, xs, acts), plain)
    assert torch.equal(env.step(make_state(xs), acts).x, plain)
    assert (spatial_step.LAUNCHES, spatial_step.STEP_LAUNCHES) == (launches, step_launches)


def test_kernel_model_packing_selects_the_standup_build():
    """The Standup's build: self pairs, joint springs and the `standup`
    family, at the Humanoid's (23, 24); its reward constants in the header;
    a model of the Standup's shape with the `locomotion` family gets the
    Humanoid's build, and with another track none."""
    env = HumanoidStandupDeviceEnv(device="cpu")
    ints, dbl = spatial_step._env_model(env)
    ints, dbl = list(ints), list(dbl)
    feats = spatial_step.select_build(M, "standup")
    assert feats == spatial_step.SELF_PAIRS | spatial_step.SPRINGS | spatial_step.STANDUP == 352
    assert (23, 24, feats) == spatial_step.STANDUP_BUILD
    assert ints[:16] == [23, 24, 13, 18, 29, 17, 17, 0, 109, 5, 3, 6, feats, -1, -1, -1]
    h = M.timestep
    assert dbl[:8] == [9.81, 0.0, h, 0.5 * h, 1.0, 0.0, 0.1, 0.4]
    assert spatial_step.select_build(M, "locomotion", "com_x") == 224
    with pytest.raises(ValueError, match="no \\(23, 24\\) build fits: one lacks nothing and "
                       "adds the com_x track"):
        spatial_step.select_build(M, "locomotion")


@pytest.fixture(scope="module")
def host_check(tmp_path_factory):
    """tests/spatial_host_check.cpp built with g++ (the Standup build only)
    against the kernel's device code; skips where there is no g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel's device code for the host")
    exe = tmp_path_factory.mktemp("host") / "spatial_host_check"
    src = Path(__file__).with_name("spatial_host_check.cpp")
    subprocess.run([gxx, "-O1", "-std=c++17", "-DHOST_BUILDS=4", f"-I{CSRC_DIR}", "-o", str(exe),
                    str(src)], check=True, capture_output=True, timeout=300)
    return exe


@pytest.mark.parametrize("dtype,rtol,atol", [
    (torch.float64, 1e-9, 0.0),  # the kernel's f64 bound
    (torch.float32, 2e-4, 2e-3),  # the JAX kernel tests' f32 tolerance
])
@pytest.mark.parametrize("name", ["reset", "crouch"])
def test_kernel_code_built_for_the_host_matches_the_plain_version(host_check, name, dtype, rtol,
                                                                   atol):
    """The kernel's per-sample function (both entries) compiled for the CPU:
    costs of (T, na, K) controls and one control step of K states, the
    Σ‖cfrc_ext‖² carry included. The supine body lies on a dozen floor and
    self-pair rows, where the QP's discrete choices turn rounding into
    other iterates: f64 costs are held by the nudge rule, to 1e-9 or to 10×
    the plain version's own spread under controls·(1 + 1e-15)."""
    env, x = standup_state(name, dtype)
    rng = np.random.default_rng(31)
    ctrl = torch.as_tensor(rng.uniform(-0.4, 0.4, (T, 17, K)), dtype=dtype)
    want = spatial_step.spatial_rollout_costs_tak_reference(env, x, ctrl)
    got = run_host(host_check, env, 0, x.double().numpy(), ctrl.double().numpy(), K, T)[:, 0]
    if dtype == torch.float64:
        nudged = spatial_step.spatial_rollout_costs_tak_reference(env, x, ctrl * (1 + 1e-15))
        rtol = max(rtol, 10 * float(((nudged - want) / want).abs().max()))
    np.testing.assert_allclose(got, want.double().numpy(), rtol=rtol, atol=atol)

    dq = np.concatenate([rng.uniform(-0.02, 0.02, (K, 47)), np.zeros((K, 1))], axis=1)
    xs = x + torch.as_tensor(dq, dtype=dtype)
    acts = torch.as_tensor(rng.uniform(-0.6, 0.6, (K, 17)), dtype=dtype)
    want = env.plain_step(make_state(xs), acts).x.double().numpy()
    got = run_host(host_check, env, 1, xs.double().numpy(), acts.double().numpy(), K, 1)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=max(atol, rtol) * np.abs(want).max())


def test_cli_runs_the_standup_on_the_cpu(capsys):
    rc = main(["mujoco", "--on-device", "--env-name", "HumanoidStandup-v4", "--device", "cpu",
               "--samples", "2", "--horizon", "1", "--ais-its", "1", "--steps", "1", "--seed", "3",
               "--steps-per-call", "1"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "HumanoidStandup-v4 (on-device)" in out
    row = next(line for line in out.splitlines() if line.startswith("Trial    1:"))
    assert int(row.split(":")[2]) == 1
