"""The car rollout kernel's device code (csrc/car_dynamics.cuh) built for the
host with g++ through tests/car_host_check.cpp, held against the plain
PyTorch version on the CPU: the costs against `car_rollout_costs_tak_reference`
and each car's final state against `step_car_state` looped (the costs alone
hide the dynamics where the -5000 sideslip steps dominate them, as when
reversing). That checks the substep's identities (slip angles from their
components, the per-sign force cache, delta and the heading as rotations)
and the reward, in the order the kernel runs them. Skips where there is no
g++.

float64 is held sample by sample at rtol 1e-9 (of the largest entry, for a
state), or (the nudge rule) within 10x the most the plain version's own
result moves under controls·(1 ± 1e-15) and x0·(1 + 1e-15): an off-track or
sideslip step of the reward turns rounding into a jump of 1e6 or 5000.
float32 at the JAX kernel tests' rtol 2e-4 / atol 2e-3 over a short horizon.
"""

import shutil
import struct
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from mpopis_tpu_torch.kernels import car_rollout
from mpopis_tpu_torch.kernels.build import CSRC_DIR
from mpopis_tpu_torch.models import CarRacingEnv
from mpopis_tpu_torch.models.car_racing import step_car_state

K, T = 48, 20
# start -> (x, y, psi, vx, vy, psi_dot, delta) of the first car; further cars
# 5 m apart in x
STARTS = {
    "reset": (0.0, 0.0, np.pi / 2, 10.0, 0.0, 0.0, 0.0),
    # sideslip beta = atan2(vy, vx) 2 degrees under the 45-degree limit
    "sideslip": (0.0, 0.0, np.pi / 2, 10.0, 10.0 * np.tan(np.deg2rad(43.0)), 0.6, 0.2),
    # reversing: the front slip angle passes +-pi
    "reverse": (0.0, 0.0, np.pi / 2, -3.0, 0.4, -0.2, -0.25),
    # at rest: atan2(0, 0) in the first substep
    "rest": (0.0, 0.0, np.pi / 2, 0.0, 0.0, 0.0, 0.0),
}


class _Cars(CarRacingEnv):
    num_cars = 1


class _ThreeCars(CarRacingEnv):
    num_cars = 3


@pytest.fixture(scope="module")
def host_check(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel's device code for the host")
    exe = tmp_path_factory.mktemp("host") / "car_host_check"
    src = Path(__file__).with_name("car_host_check.cpp")
    subprocess.run([gxx, "-O1", "-std=c++17", "-Wno-unknown-pragmas", f"-I{CSRC_DIR}", "-o",
                    str(exe), str(src)], check=True, capture_output=True, timeout=300)
    return exe


def _start(name, num_cars):
    x = np.zeros(8 * num_cars)
    for c in range(num_cars):
        x[8 * c : 8 * c + 7] = STARTS[name]
        x[8 * c] += 5.0 * c
    return x


def _run_host(exe, env, x0, ctrl, tag):
    k, horizon = ctrl.shape[2], ctrl.shape[0]
    track = env.track_xyw.double().numpy()
    data = struct.pack("6i", int(env.dtype == torch.float64), env.num_cars, track.shape[1], k,
                       horizon, int(round(env.dt / env.ddt)))
    data += np.asarray(list(car_rollout._kernel_params(env)), np.float64).tobytes()
    data += np.asarray(x0, np.float64).tobytes() + track.tobytes()
    data += np.asarray(ctrl, np.float64).tobytes()
    path = Path(f"{exe}.{tag}.in")
    path.write_bytes(data)
    out = subprocess.run([str(exe), str(path)], capture_output=True, text=True, check=True,
                         timeout=300).stdout
    rows = np.array([[float(v) for v in line.split()] for line in out.strip().splitlines()])
    return rows[:, 0], rows[:, 1:].reshape(k, env.num_cars, 8)


def _plain(env, x0, ctrl):
    """(costs (K,), final states (K, cars, 8) as the host check prints them)."""
    x = torch.as_tensor(x0, dtype=env.dtype)
    u = torch.as_tensor(ctrl, dtype=env.dtype)
    costs = car_rollout.car_rollout_costs_tak_reference(env, x, u, ctrl.shape[0])
    finals = []
    for c in range(env.num_cars):
        s = x[8 * c : 8 * c + 8].expand(ctrl.shape[2], 8)
        for t in range(ctrl.shape[0]):
            s = step_car_state(env.params, s, u[t, 2 * c : 2 * c + 2].T, env.dt, env.ddt)
        finals.append(torch.stack([s[:, 0], s[:, 1], torch.sin(s[:, 2]), torch.cos(s[:, 2]),
                                   *(s[:, i] for i in range(3, 7))], dim=1))
    return costs.double().numpy(), torch.stack(finals, dim=1).double().numpy()


@pytest.mark.parametrize("num_cars", [1, 3])
@pytest.mark.parametrize("start", sorted(STARTS))
def test_car_kernel_code_built_for_the_host_matches_the_plain_version_f64(host_check, start,
                                                                         num_cars):
    env = (_Cars if num_cars == 1 else _ThreeCars)(dtype=torch.float64, device="cpu")
    x0 = _start(start, num_cars)
    ctrl = np.random.default_rng(num_cars).uniform(-1, 1, size=(T, 2 * num_cars, K))
    got = _run_host(host_check, env, x0, ctrl, f"{start}.{num_cars}")
    want = _plain(env, x0, ctrl)
    e = 1e-15
    runs = [_plain(env, x0, ctrl * (1 + e)), _plain(env, x0, ctrl * (1 - e)),
            _plain(env, x0 * (1 + e), ctrl)]
    for i, what in enumerate(("costs", "final states")):
        flat = [a[i].reshape(K, -1) for a in (got, want)]
        scale = np.abs(flat[1]).max(1)
        err = np.abs(flat[0] - flat[1]).max(1)
        own = np.max([np.abs(r[i].reshape(K, -1) - flat[1]).max(1) for r in runs], axis=0)
        bad = (err > 1e-9 * scale) & (err > 10 * own)
        assert not bad.any(), (f"{what}, samples {np.flatnonzero(bad)}: {err[bad] / scale[bad]}"
                               f" (own spreads {own[bad] / scale[bad]})")


@pytest.mark.parametrize("start", ["reset", "sideslip"])
def test_car_kernel_code_built_for_the_host_matches_the_plain_version_f32(host_check, start):
    env = _Cars(dtype=torch.float32, device="cpu")
    x0 = _start(start, 1)
    ctrl = np.random.default_rng(5).uniform(-1, 1, size=(5, 2, K))
    got = _run_host(host_check, env, x0, ctrl, f"{start}.f32")
    np.testing.assert_allclose(got[0], _plain(env, x0, ctrl)[0], rtol=2e-4, atol=2e-3)
