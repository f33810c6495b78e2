"""The CEMPPI step on Ant against the JAX package's, float64 on the CPU, with
the same injected normals `z`: two chained policy steps from the reset,
each with 2 AIS iterations whose K rollouts go through the plain rollout
(the JAX package's vmap rollout on its side), rtol 1e-9."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpopis_tpu.models import AntDeviceEnv as JAntDeviceEnv
from mpopis_tpu.policies import PolicyConfig as JPolicyConfig
from mpopis_tpu.policies import make_policy as jmake_policy

from mpopis_tpu_torch.models import AntDeviceEnv
from mpopis_tpu_torch.policies import PolicyConfig, make_policy

K, H, ITS = 8, 2, 2  # the JAX package's Ant configuration (bench.py:356) at small K and H
COV = 0.25 * np.eye(8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions are thousands of tiny ops: one thread each keeps
    test processes that run side by side from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rtol=1e-9):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=1e-300)


def test_cemppi_step_on_ant_matches_jax():
    kw = dict(kind="cemppi", num_samples=K, horizon=H, lam=1.0, opt_its=ITS, sigma_est="mle")
    jenv = JAntDeviceEnv(dtype=jnp.float64)
    env = AntDeviceEnv(dtype=torch.float64, device="cpu")
    jpol = jmake_policy(jenv, JPolicyConfig(**kw), cov_mat=COV)
    pol = make_policy(env, PolicyConfig(**kw), cov_mat=COV)
    rng = np.random.default_rng(17)
    js, jps = jenv.reset(), jpol.init_state(0)
    s, ps = env.reset(), pol.init_state(0)
    for _ in range(2):
        z = rng.standard_normal((ITS, 8 * H, K))
        ja, jps, jinfo = jpol.step(js, jps, z=jnp.asarray(z))
        a, ps, info = pol.step(s, ps, z=torch.as_tensor(z))
        assert info["ais_its"] in (1, ITS)
        _close(a, ja)
        _close(ps.U, jps.U)
        _close(info["costs"], jinfo["costs"])
        _close(info["weights"], jinfo["weights"])
