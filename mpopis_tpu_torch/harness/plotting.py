"""Track/car/trajectory visualization and gif export (matplotlib + imageio).

Counterpart of `mpopis_tpu/harness/plotting.py`, the reference's Plots.jl
stack (envs/plots.jl): filled track polygon with boundary lines (:2-30),
rotated car rectangle with heading arrow and optional telemetry text
(:32-94), sampled-trajectory overlays color-graded by weight rank with an
RdYlGn map (:96-126), multi-car variants (:128-170), and 10 fps gif export
(car_example.jl:412-415). States, trajectories and weights may be tensors on
any device or numpy arrays; they are drawn from host copies. The harness
imports this module only when it draws.
"""

from __future__ import annotations

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt
import numpy as np

import torch

from mpopis_tpu_torch.models import MultiCarRacingEnv, Track


def _np(a) -> np.ndarray:
    """A host numpy copy of a tensor on any device (or of an array)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


_CAR_COLORS = ["tab:blue", "tab:orange", "tab:purple", "tab:red", "tab:brown", "tab:pink", "tab:cyan"]


def plot_track(track: Track, ax=None):
    if ax is None:
        _, ax = plt.subplots(figsize=(9, 9))
    lb, rb = track.boundary_left, track.boundary_right
    poly = np.concatenate([lb, rb[::-1]], axis=0)
    ax.set_facecolor("#9fd49f")
    ax.fill(poly[:, 0], poly[:, 1], color="grey", lw=0, zorder=1)
    ax.plot(lb[:, 0], lb[:, 1], color="black", lw=2, zorder=2)
    ax.plot(rb[:, 0], rb[:, 1], color="black", lw=2, zorder=2)
    allx = np.concatenate([lb[:, 0], rb[:, 0]])
    ally = np.concatenate([lb[:, 1], rb[:, 1]])
    ax.set_xlim(allx.min() - 10, allx.max() + 10)
    ax.set_ylim(ally.min() - 10, ally.max() + 10)
    ax.set_aspect("equal")
    return ax


def plot_car(params, state_vec, ax, color_idx: int = 0):
    """Rotated car rectangle + heading arrow (plots.jl:32-72)."""
    state_vec = _np(state_vec)
    x, y, psi = state_vec[0], state_vec[1], state_vec[2]
    l_f, l_r = params.l_f, params.l_r
    w = (l_f + l_r) * 0.4
    rot = np.array([[np.cos(psi), -np.sin(psi)], [np.sin(psi), np.cos(psi)]])
    corners = np.array(
        [[l_f, w / 2], [l_f, -w / 2], [-l_r, -w / 2], [-l_r, w / 2], [l_f, w / 2]]
    )
    pts = corners @ rot.T + np.array([x, y])
    color = _CAR_COLORS[color_idx % len(_CAR_COLORS)]
    ax.plot(pts[:, 0], pts[:, 1], lw=2, color=color, zorder=4)
    r = (l_f + l_r) * 0.8
    tail = rot @ np.array([-l_r * 0.8, 0.0]) + np.array([x, y])
    ax.annotate(
        "",
        xy=(tail[0] + r * np.cos(psi), tail[1] + r * np.sin(psi)),
        xytext=(tail[0], tail[1]),
        arrowprops=dict(arrowstyle="->", color="black", lw=1.2),
        zorder=5,
    )
    return ax


def plot_trajectories(ax, trajectories, weights, perc: float = 1.0, num_cars: int = 1):
    """Overlay sampled trajectories color-graded by weight rank
    (plots.jl:96-126): greener = higher weight."""
    trajs = _np(trajectories)  # (K, T, ss)
    w = _np(weights)
    k = len(w)
    order = np.argsort(-w)
    cmap = plt.get_cmap("RdYlGn")
    stride = max(int(round(1.0 / max(perc, 1e-6))), 1)
    ss_per_car = trajs.shape[-1] // num_cars
    for rank, idx in enumerate(order):
        if rank == 0 or rank % stride:
            continue
        col = cmap((k - rank) / k)
        for c in range(num_cars):
            off = c * ss_per_car
            ax.plot(
                trajs[idx, :, off], trajs[idx, :, off + 1],
                lw=0.3, color=col, zorder=3, alpha=0.8,
            )
    return ax


def render_frame(
    env,
    state,
    info=None,
    plot_traj_perc: float = 1.0,
    text_output: bool = False,
    text_xy=(80.0, -60.0),
):
    """One animation frame: track + car(s) (+ trajectory overlays
    + optional telemetry text block, plots.jl:74-92)."""
    fig, ax = plt.subplots(figsize=(9, 9))
    plot_track(env.track, ax)
    xs = _np(state.x)
    if isinstance(env, MultiCarRacingEnv):
        cars = xs.reshape(env.num_cars, 8)
        for i, car in enumerate(cars):
            plot_car(env.params, car, ax, color_idx=i)
        n_cars = env.num_cars
        car1 = cars[0]
    else:
        plot_car(env.params, xs, ax)
        n_cars = 1
        car1 = xs
    if info is not None and "trajectories" in info:
        plot_trajectories(
            ax, info["trajectories"], info["weights"], plot_traj_perc, n_cars
        )
    if text_output:
        rew = float(_np(env.reward(state)))
        _, dists = env.within_track(state)
        # car 1's distance to the lane center (MultiCarRacingEnv gives each car's)
        dist = _np(dists).reshape(-1)[0]
        beta = np.arctan2(car1[4], car1[3])
        t_env = int(_np(state.t))
        lines = [
            f"{'Time (s)':<24s}:{t_env * env.dt:5.1f}",
            "",
            f"{'':8s}{'--- CAR 1 ---':>13s}",
            f"{'Reward':<24s}:{rew:5.1f}",
            f"{'|v| (m/s)':<24s}:{np.linalg.norm(car1[3:5]):5.1f}",
            f"{'Dist to Lane Center (m)':<24s}:{float(dist):5.1f}",
            f"{'Beta Angle (deg)':<24s}:{np.rad2deg(beta):5.1f}",
            f"{'Steering Ang (deg)':<24s}:{np.rad2deg(car1[6]):5.1f}",
            f"{'Gas/Brake (%)':<24s}:{car1[7] * 100:5.1f}",
        ]
        ax.text(
            text_xy[0], text_xy[1], "\n".join(lines),
            family="monospace", fontsize=11, fontweight="bold",
            ha="left", va="top", zorder=6,
        )
    ax.set_xticks([])
    ax.set_yticks([])
    fig.tight_layout(pad=0)
    return fig


def render_mountaincar(env, state):
    """Hill profile sin(3x) with the car drawn at its position (parity with
    RL.jl's MountainCar plot recipe used by the reference's save_gif path)."""
    fig, ax = plt.subplots(figsize=(6, 4))
    xs = np.linspace(env.min_pos, env.max_pos, 200)
    ax.plot(xs, np.sin(3 * xs), color="black", lw=1.5)
    pos = float(_np(state.x)[0])
    ax.plot([pos], [np.sin(3 * pos)], "o", ms=12, color="tab:red")
    gx = env.goal_pos
    ax.plot([gx], [np.sin(3 * gx)], marker="$⚑$", ms=14, color="tab:green")
    ax.set_xlim(env.min_pos - 0.05, env.max_pos + 0.05)
    ax.set_ylim(-1.2, 1.2)
    ax.set_title(f"t={int(_np(state.t))}  v={float(_np(state.x)[1]):+.3f}")
    fig.tight_layout()
    return fig


def render_cartpole(env, state):
    """Cart rectangle + pole line (parity with RL.jl's CartPole recipe)."""
    fig, ax = plt.subplots(figsize=(6, 4))
    x, _, theta, _ = _np(state.x)
    ax.plot([-env.x_threshold, env.x_threshold], [0, 0], color="black", lw=1)
    cart_w, cart_h = 0.4, 0.2
    ax.add_patch(
        plt.Rectangle((x - cart_w / 2, -cart_h / 2), cart_w, cart_h,
                      color="tab:blue")
    )
    pole_len = 2 * env.halflength
    ax.plot(
        [x, x + pole_len * np.sin(theta)],
        [0, pole_len * np.cos(theta)],
        lw=4, color="tab:orange",
    )
    ax.set_xlim(-env.x_threshold - 0.5, env.x_threshold + 0.5)
    ax.set_ylim(-0.6, 1.6)
    ax.set_aspect("equal")
    ax.set_title(f"t={int(_np(state.t))}  θ={np.rad2deg(theta):+.1f}°")
    fig.tight_layout()
    return fig


# 2D projection of each on-device MuJoCo task's state vector for the
# sampled-trajectory overlay: (ix, iy, xlabel, ylabel). Locomotion tasks
# use the root's sagittal (x, z) or top-down (x, y) plane; the Pusher
# shows the pushed object; the arm/pendulum tasks show joint space.
MUJOCO_VIEWS = {
    "HalfCheetah-v4": (0, 1, "x [m]", "z [m]"),
    "Hopper-v4": (0, 1, "x [m]", "z [m]"),
    "Walker2d-v4": (0, 1, "x [m]", "z [m]"),
    "Swimmer-v4": (0, 1, "x [m]", "y [m]"),
    "Ant-v4": (0, 1, "x [m]", "y [m]"),
    "Humanoid-v4": (0, 2, "x [m]", "z [m]"),
    "HumanoidStandup-v4": (0, 2, "x [m]", "z [m]"),
    "Pusher-v4": (25, 26, "object x [m]", "object y [m]"),
    "Reacher-v4": (0, 1, "q1 [rad]", "q2 [rad]"),
    "InvertedPendulum-v4": (0, 1, "cart x [m]", "pole angle [rad]"),
    "InvertedDoublePendulum-v4": (0, 1, "cart x [m]", "pole1 angle [rad]"),
}


def render_mujoco_trajectories(task, trail, trajectories, weights,
                               perc: float = 1.0):
    """Sampled-trajectory overlay for an on-device MuJoCo control step —
    the flagship-task analog of the reference's plot(env, pol, perc)
    (plots.jl:96-126): the K logged rollouts from the policy's final AIS
    iteration, color-graded by weight rank (RdYlGn, greener = higher
    weight), over the executed state trail (black)."""
    ix, iy, xl, yl = MUJOCO_VIEWS.get(task, (0, 1, "state[0]", "state[1]"))
    fig, ax = plt.subplots(figsize=(6, 4.5))
    trajs = _np(trajectories)[:, :, [ix, iy]]
    plot_trajectories(ax, trajs, weights, perc)
    tr = np.stack([_np(s) for s in trail])
    ax.plot(tr[:, ix], tr[:, iy], color="black", lw=1.8, zorder=6)
    ax.plot(tr[-1, ix], tr[-1, iy], "o", ms=6, color="black", zorder=7)
    ax.set_xlabel(xl)
    ax.set_ylabel(yl)
    ax.set_title(f"{task}  t={len(tr) - 1}")
    fig.tight_layout()
    return fig


def figure_to_array(fig) -> np.ndarray:
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())
    return buf[:, :, :3].copy()


def close(fig) -> None:
    plt.close(fig)


def save_gif(frames, path: str, fps: int = 10) -> None:
    import imageio.v2 as imageio

    imageio.mimsave(path, frames, fps=fps, loop=0)
