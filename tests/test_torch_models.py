"""The port's car model equals the JAX package's in float64 (rtol 1e-12):
track arrays, the batched distance query against `jax.vmap`, and the
batched dynamics and reward. Inputs come from a numpy seed; the JAX
parameters and state reach the port through `utils.convert`."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpopis_tpu.models import car_racing as jcar
from mpopis_tpu.models import track as jtrack

from mpopis_tpu_torch.models import CarRacingEnv, car_reward, distance_query, step_car_state
from mpopis_tpu_torch.models.track import Track
from mpopis_tpu_torch.utils import convert

RTOL = 1e-12
F64 = torch.float64


def _params():
    return convert.car_params(dataclasses.asdict(jcar.CarParams()))


def _random_states(rng, n):
    """States around the track's scale, including reversing (Vx < 0)."""
    return np.stack([
        rng.uniform(-60, 60, n), rng.uniform(-60, 60, n), rng.uniform(-3.1, 3.1, n),
        rng.uniform(-5, 25, n), rng.uniform(-3, 3, n), rng.uniform(-1, 1, n),
        rng.uniform(-0.3, 0.3, n), np.zeros(n),
    ], axis=1)


@pytest.mark.parametrize("name,factor", [("curve", 20), ("cubic3", 7)])
def test_track_arrays_match_jax(name, factor):
    jt = jtrack.Track.load(name, width=12.0, sample_factor=factor)
    pt = Track.load(name, width=12.0, sample_factor=factor)
    via_convert = convert.track(dataclasses.asdict(jt))
    for f in dataclasses.fields(Track):
        if f.name == "sample_factor":
            assert pt.sample_factor == via_convert.sample_factor == jt.sample_factor
            continue
        want = getattr(jt, f.name)
        np.testing.assert_allclose(getattr(pt, f.name), want, rtol=RTOL, atol=0)
        np.testing.assert_array_equal(getattr(via_convert, f.name), want)


def test_distance_query_matches_vmap():
    jt = jtrack.Track.load("curve")
    pts_j, w_j = jt.query_arrays(jnp.float64)
    rng = np.random.default_rng(0)
    pos = np.concatenate([
        rng.uniform(-80, 80, size=(400, 2)),
        np.stack([jt.xs, jt.ys], axis=1),  # exactly on the centerline points
    ])
    w_want, d_want = jax.vmap(lambda p: jtrack.distance_query(pts_j, w_j, p))(jnp.asarray(pos))
    pts, widths = Track.load("curve").query_arrays(F64)
    w_got, d_got = distance_query(pts, widths, torch.as_tensor(pos, dtype=F64))
    np.testing.assert_array_equal(w_got.numpy(), np.asarray(w_want))
    np.testing.assert_allclose(d_got.numpy(), np.asarray(d_want), rtol=RTOL, atol=1e-12)


def test_step_car_state_matches_vmap():
    rng = np.random.default_rng(1)
    s = _random_states(rng, 256)
    a = rng.uniform(-1, 1, size=(256, 2))
    jp = jcar.CarParams()
    want = jax.vmap(
        lambda si, ai: jcar.step_car_state(jp, si, ai, 0.1, 0.01, jnp.float64)
    )(jnp.asarray(s), jnp.asarray(a))
    got = step_car_state(_params(), torch.as_tensor(s), torch.as_tensor(a), 0.1, 0.01)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-12)


def test_car_reward_matches_vmap():
    rng = np.random.default_rng(2)
    s = _random_states(rng, 512)
    jp = jcar.CarParams()
    pts_j, w_j = jtrack.Track.load("curve").query_arrays(jnp.float64)
    want = jax.vmap(lambda si: jcar.car_reward(jp, pts_j, w_j, si))(jnp.asarray(s))
    env = CarRacingEnv(dtype=F64)
    got = car_reward(_params(), env.pts, env.widths, torch.as_tensor(s))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-12)


def test_env_reset_step_reward_match_jax():
    jenv = jcar.CarRacingEnv(dtype=jnp.float64)
    env = CarRacingEnv(dtype=F64)
    js, s = jenv.reset(), env.reset()
    np.testing.assert_array_equal(s.x.numpy(), np.asarray(js.x))
    act = np.array([0.3, 0.7])
    for _ in range(5):
        js = jenv.step(js, jnp.asarray(act))
        s = env.step(s, torch.as_tensor(act))
    np.testing.assert_allclose(s.x.numpy(), np.asarray(js.x), rtol=RTOL, atol=1e-12)
    assert s.t == int(js.t) == 5
    np.testing.assert_allclose(float(env.reward(s)), float(jenv.reward(js)), rtol=RTOL)
    assert bool(env.within_track(s)[0]) == bool(jenv.within_track(js)[0])


def test_convert_state_and_policy_state():
    x = np.arange(8.0)
    s = convert.env_state(x, dtype=F64, t=3)
    assert s.x.dtype == F64 and s.t == 3 and s.x.tolist() == x.tolist()
    ps = convert.policy_state(np.ones(6), seed=5, dtype=F64)
    again = convert.policy_state(np.ones(6), seed=5, dtype=F64)
    assert ps.U.tolist() == [1.0] * 6
    draw = torch.randn(4, generator=ps.generator, dtype=F64)
    assert torch.equal(draw, torch.randn(4, generator=again.generator, dtype=F64))
    u0, sigma = convert.u0_and_sigma(np.zeros(4), np.eye(4), dtype=F64)
    assert u0.shape == (4,) and torch.equal(sigma, torch.eye(4, dtype=F64))
