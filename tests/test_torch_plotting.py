"""The port's plots and gifs on the CPU: given the same numpy inputs, its
render functions draw the JAX package's pixels, and `save_gif` /
`plot_traj` write gifs through the harness and the CLI."""

import numpy as np
import pytest
import torch

pytest.importorskip("matplotlib")
imageio = pytest.importorskip("imageio.v2")

import jax.numpy as jnp

from mpopis_tpu.harness import plotting as jplotting
from mpopis_tpu.models import CarRacingEnv as JCarRacingEnv
from mpopis_tpu.models import CartPoleEnv as JCartPoleEnv
from mpopis_tpu.models import MountainCarEnv as JMountainCarEnv
from mpopis_tpu.models import MultiCarRacingEnv as JMultiCarRacingEnv
from mpopis_tpu.models.base import EnvState as JEnvState

from mpopis_tpu_torch.harness import plotting, simulate
from mpopis_tpu_torch.harness.cli import main
from mpopis_tpu_torch.models import CarRacingEnv, CartPoleEnv, MountainCarEnv, MultiCarRacingEnv
from mpopis_tpu_torch.models.base import EnvState


def _rgba(fig, module):
    fig.canvas.draw()
    out = np.asarray(fig.canvas.buffer_rgba()).copy()
    module.close(fig)
    return out


def _states(x, t, done=False):
    return (EnvState(x=torch.as_tensor(x), t=t, done=done),
            JEnvState(x=jnp.asarray(x), t=jnp.asarray(t), done=jnp.asarray(done)))


def _car_state(rng, n_cars):
    x = np.tile(np.array([1.0, -3.0, 1.3, 14.0, 0.4, 0.1, 0.05, 0.3]), n_cars)
    return x + 0.5 * rng.standard_normal(8 * n_cars) * np.tile([10, 10, 1, 1, 1, 1, 0.1, 0.1],
                                                               n_cars)


@pytest.mark.parametrize("n_cars,traj", [(1, False), (1, True), (3, True)])
def test_render_frame_matches_jax_pixels(n_cars, traj):
    """The track, the cars, the weight-graded rollouts and car 1's
    telemetry text (reward, distance to the lane center) as the JAX
    function draws them."""
    rng = np.random.default_rng(n_cars + 2 * traj)
    if n_cars == 1:
        env, jenv = CarRacingEnv(dtype=torch.float64, device="cpu"), JCarRacingEnv(
            dtype=jnp.float64)
    else:
        env = MultiCarRacingEnv(num_cars=n_cars, dtype=torch.float64, device="cpu")
        jenv = JMultiCarRacingEnv(num_cars=n_cars, dtype=jnp.float64)
    s, js = _states(_car_state(rng, n_cars), 17)
    info = jinfo = None
    if traj:
        trajs = 20.0 * rng.standard_normal((6, 5, 8 * n_cars))
        w = rng.dirichlet(np.ones(6))
        info = {"trajectories": torch.as_tensor(trajs), "weights": torch.as_tensor(w)}
        jinfo = {"trajectories": trajs, "weights": w}
    ours = _rgba(plotting.render_frame(env, s, info, 0.5, text_output=True), plotting)
    theirs = _rgba(jplotting.render_frame(jenv, js, jinfo, 0.5, text_output=True), jplotting)
    assert ours.shape == theirs.shape and ours.shape[2] == 4
    np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("name", ["mountaincar", "cartpole"])
def test_classic_renders_match_jax_pixels(name):
    if name == "mountaincar":
        env, jenv, x = MountainCarEnv(device="cpu"), JMountainCarEnv(), [-0.52, 0.013]
        draw, jdraw = plotting.render_mountaincar, jplotting.render_mountaincar
    else:
        env, jenv, x = CartPoleEnv(device="cpu"), JCartPoleEnv(), [0.3, -0.2, 0.15, 0.4]
        draw, jdraw = plotting.render_cartpole, jplotting.render_cartpole
    s, js = _states(np.asarray(x), 12)
    np.testing.assert_array_equal(_rgba(draw(env, s), plotting), _rgba(jdraw(jenv, js),
                                                                        jplotting))


@pytest.mark.parametrize("task", ["HalfCheetah-v4", "Pusher-v4", "NoSuchTask-v0"])
def test_mujoco_trajectories_match_jax_pixels(task):
    rng = np.random.default_rng(7)
    trail = [rng.standard_normal(30) for _ in range(4)]
    trajs = rng.standard_normal((8, 6, 30))
    w = rng.dirichlet(np.ones(8))
    ours = plotting.render_mujoco_trajectories(
        task, [torch.as_tensor(x) for x in trail], torch.as_tensor(trajs), torch.as_tensor(w))
    theirs = jplotting.render_mujoco_trajectories(task, trail, trajs, w)
    np.testing.assert_array_equal(_rgba(ours, plotting), _rgba(theirs, jplotting))
    assert plotting.MUJOCO_VIEWS == jplotting.MUJOCO_VIEWS


def test_figure_to_array_and_save_gif(tmp_path):
    env = MountainCarEnv(device="cpu")
    frames = []
    for t in range(3):
        fig = plotting.render_mountaincar(env, EnvState(x=torch.tensor([-0.5 + 0.1 * t, 0.0]),
                                                        t=t))
        frames.append(plotting.figure_to_array(fig))
        plotting.close(fig)
    assert frames[0].shape[2] == 3 and frames[0].dtype == np.uint8
    path = str(tmp_path / "mc.gif")
    plotting.save_gif(frames, path, fps=10)
    got = imageio.mimread(path)
    assert len(got) == 3 and got[0].shape[:2] == frames[0].shape[:2]


def _gif_frames(path) -> int:
    return len(imageio.mimread(str(path)))


# -- through the harness ---------------------------------------------------

SMALL = dict(num_trials=1, num_steps=2, num_samples=8, horizon=4, ais_its=1, seed=3,
             print_output=False, device="cpu", dtype=torch.float64)


@pytest.mark.parametrize("kw", [dict(save_gif=True), dict(save_gif=True, plot_traj=True),
                                dict(plot_traj=True)])
def test_car_race_gif_and_plots(kw, tmp_path, monkeypatch):
    """save_gif writes one frame a control step (3 for the loop bound of 2
    steps); plot_traj logs the rollouts and draws them into each frame; both
    run one control step a call."""
    drawn = []
    real = plotting.render_frame

    def spy(env, s, info=None, *a, **k):
        drawn.append(info is not None and "trajectories" in info)
        return real(env, s, info, *a, **k)

    monkeypatch.setattr(plotting, "render_frame", spy)
    gif = tmp_path / "race.gif"
    m = simulate.simulate_car_racing(gif_name=str(gif), **SMALL, **kw)
    assert m["steps"][0] == 2 and len(drawn) == 3
    assert all(drawn) == bool(kw.get("plot_traj"))
    assert gif.exists() == bool(kw.get("save_gif"))
    if gif.exists():
        assert _gif_frames(gif) == 3
    assert m["ais_iterations"][0] == 3  # one step a call: no chunk past the stop


def test_multi_car_gif(tmp_path):
    gif = tmp_path / "mcr.gif"
    simulate.simulate_car_racing(num_cars=2, save_gif=True, gif_name=str(gif), **SMALL)
    assert _gif_frames(gif) == 3


@pytest.mark.parametrize("run", ["mountaincar", "cartpole"])
def test_classic_gifs(run, tmp_path):
    gif = tmp_path / f"{run}.gif"
    fn = {"mountaincar": simulate.simulate_mountaincar, "cartpole": simulate.simulate_cartpole}
    fn[run](save_gif=True, gif_name=str(gif), **SMALL)
    assert _gif_frames(gif) == 3


def test_on_device_task_gif_with_plot_traj(tmp_path, monkeypatch):
    drawn = []
    real = plotting.render_mujoco_trajectories

    def spy(task, trail, trajectories, weights, perc=1.0):
        drawn.append((task, len(trail), tuple(trajectories.shape)))
        return real(task, trail, trajectories, weights, perc)

    monkeypatch.setattr(plotting, "render_mujoco_trajectories", spy)
    gif = tmp_path / "ip.gif"
    m = simulate.simulate_mujoco_on_device("InvertedPendulum-v4", save_gif=True, plot_traj=True,
                                           gif_name=str(gif), **SMALL)
    assert _gif_frames(gif) == 3 and m["steps"][0] == 2
    assert drawn == [("InvertedPendulum-v4", n, (8, 4, 4)) for n in (2, 3, 4)]


def test_on_device_gif_without_plot_traj_warns_and_is_dropped(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.warns(UserWarning, match="needs plot_traj=True"):
        m = simulate.simulate_mujoco_on_device("InvertedPendulum-v4", save_gif=True, **SMALL)
    assert m["steps"][0] == 2 and not list(tmp_path.glob("*.gif"))


@pytest.mark.parametrize("argv,gif", [
    (["mountaincar", "--save-gif"], "MountainCar-8-4-0.1-1.gif"),
    (["cartpole", "--save-gif"], "CartPole-8-4-0.1-1.gif"),
    (["car", "--save-gif", "--plot-traj"], "cr-1-cemppi-8-4-10.0-1.0-1-1-2.gif"),
    (["car", "--plot-traj"], None),
    (["mujoco", "--on-device", "--env-name", "InvertedPendulum-v4", "--save-gif",
      "--plot-traj"], "InvertedPendulum-v4 (on-device)-8-4-1.0-1.gif"),
])
def test_cli_gifs_and_plots(argv, gif, tmp_path, monkeypatch, capsys):
    """The default gif names in the working directory, as in the JAX harness."""
    monkeypatch.chdir(tmp_path)
    rc = main(argv + ["--device", "cpu", "--samples", "8", "--horizon", "4", "--ais-its", "1",
                      "--steps", "2", "--seed", "3"])
    assert rc == 0
    out = capsys.readouterr().out
    if gif is None:
        assert not list(tmp_path.glob("*.gif")) and "Trials MAX:" in out
    else:
        assert f"Saved gif...{gif}" in out and _gif_frames(tmp_path / gif) == 3


def test_cli_host_mujoco_refuses_gifs():
    with pytest.raises(SystemExit, match="needs --on-device"):
        main(["mujoco", "--save-gif", "--plot-traj", "--device", "cpu"])


def test_chip_smoke_gif_run_on_the_cpu(tmp_path):
    """chip_smoke's gif path (phase 47) at a small size on the CPU."""
    import chip_smoke

    cfg = dict(kind="cemppi", num_samples=8, horizon=4, lam=10.0, opt_its=1, sigma_est="ss")
    gif, n_frames, counts, (m_gif, m_plot) = chip_smoke.gif_run("cpu", cfg, 3, 2, str(tmp_path))
    assert n_frames == 3 and gif.startswith(str(tmp_path))
    assert m_gif["steps"][0] == 2 and m_plot["steps"][0] == 1
    assert not any(counts[0].values()) and not any(counts[1].values())
