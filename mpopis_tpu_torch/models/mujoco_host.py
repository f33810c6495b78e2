"""Host-batched MuJoCo environments: the envpool-equivalent engine.

Counterpart of `mpopis_tpu/models/mujoco_host.py`, and like it numpy on the
host, since that is where the engine runs: K environments stepped as one
batch per timestep, snapshot/restore of the physics state (qpos/qvel/act/
time) in O(1), an action log and its 20-decimal CSV for the gymnasium
replay check. Two engines: the native C++ thread-pool engine
(`native/envpool_lite.cc`, built with g++ at first use) by default, and a
pure-Python one stepping gymnasium envs on a thread pool (`native=False`).
Unlike the JAX package's, a native engine that fails to build raises; it
never falls back to the Python engine.

Task names follow gymnasium v4 ids ("HalfCheetah-v4", "Swimmer-v4", ...).
"""

from __future__ import annotations

import ctypes
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

_TASKS = {
    "HalfCheetah-v4": ("half_cheetah.xml", 0),
    "Swimmer-v4": ("swimmer.xml", 1),
    "Hopper-v4": ("hopper.xml", 2),
    "Walker2d-v4": ("walker2d.xml", 3),
    "Ant-v4": ("ant.xml", 4),
    "Humanoid-v4": ("humanoid.xml", 5),
    "HumanoidStandup-v4": ("humanoidstandup.xml", 6),
    "InvertedPendulum-v4": ("inverted_pendulum.xml", 7),
    "InvertedDoublePendulum-v4": ("inverted_double_pendulum.xml", 8),
    "Reacher-v4": ("reacher.xml", 9),
    "Pusher-v4": ("pusher.xml", 10),
}


def _gym_asset(xml_name: str) -> str:
    import gymnasium.envs.mujoco as gm

    return os.path.join(os.path.dirname(gm.__file__), "assets", xml_name)


class MujocoBatchedEnv:
    """K MuJoCo envs stepped as one batch.

    The surface of the reference's EnvpoolEnv: `state` (K, obs) matrix,
    `rews` (K,) vector, functor-like `step`, snapshot/restore, `acts` log.
    """

    def __init__(
        self,
        task: str = "HalfCheetah-v4",
        num_envs: int = 100,
        frame_skip: int = 5,
        num_threads: int = 0,
        native: bool = True,
    ):
        if task not in _TASKS:
            raise ValueError(f"unknown task {task!r}; options {sorted(_TASKS)}")
        self.task = task
        self.num_envs = num_envs
        self.frame_skip = frame_skip
        self.acts: list[np.ndarray] = []
        self._backend = None
        if native:
            try:
                self._init_native(num_threads)
            except (RuntimeError, OSError, ImportError) as exc:
                # the build (g++, the mujoco wheel), the library's load, epl_create
                raise RuntimeError(
                    f"the native envpool_lite engine is unavailable ({exc}); pass "
                    "native=False (--no-native) for the pure-Python engine"
                ) from exc
            self._backend = "native"
        else:
            self._init_python()
            self._backend = "python"
        self.reset()

    # ------------------------------------------------------------------
    def _init_native(self, num_threads: int):
        from mpopis_tpu_torch.native.build import build

        lib = ctypes.CDLL(build())
        lib.epl_create.restype = ctypes.c_void_p
        lib.epl_create.argtypes = [ctypes.c_char_p] + [ctypes.c_int] * 4
        lib.epl_last_error.restype = ctypes.c_char_p
        for name in ("epl_obs_dim", "epl_action_dim", "epl_num_envs"):
            getattr(lib, name).restype = ctypes.c_int
            getattr(lib, name).argtypes = [ctypes.c_void_p]
        lib.epl_dt.restype = ctypes.c_double
        lib.epl_dt.argtypes = [ctypes.c_void_p]
        dptr = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
        lib.epl_ctrl_range.argtypes = [ctypes.c_void_p, dptr, dptr]
        lib.epl_reset.argtypes = [ctypes.c_void_p, dptr]
        lib.epl_step.argtypes = [ctypes.c_void_p, dptr, dptr, dptr]
        for name in ("epl_snapshot", "epl_restore", "epl_sync_from_first", "epl_destroy"):
            getattr(lib, name).argtypes = [ctypes.c_void_p]

        xml, task_id = _TASKS[self.task]
        handle = lib.epl_create(
            _gym_asset(xml).encode(), self.num_envs, self.frame_skip,
            task_id, num_threads,
        )
        if not handle:
            raise RuntimeError(lib.epl_last_error().decode())
        self._lib = lib
        self._h = handle
        self.obs_dim = lib.epl_obs_dim(handle)
        self.action_dim = lib.epl_action_dim(handle)
        self.dt = lib.epl_dt(handle)
        low = np.zeros(self.action_dim)
        high = np.zeros(self.action_dim)
        lib.epl_ctrl_range(handle, low, high)
        self.action_low, self.action_high = low, high

    def _init_python(self):
        import gymnasium

        def make_one():
            try:
                return gymnasium.make(self.task, reset_noise_scale=0.0).unwrapped
            except TypeError:
                # tasks whose ctor has no reset_noise_scale (InvertedPendulum,
                # InvertedDoublePendulum, HumanoidStandup, Reacher, Pusher):
                # reset() below pins the state to (init_qpos, init_qvel)
                return gymnasium.make(self.task).unwrapped

        self._envs = [make_one() for _ in range(self.num_envs)]
        for e in self._envs:
            e.frame_skip = self.frame_skip  # match the native engine's stepping
            e.reset(seed=0)
            e.set_state(e.init_qpos, e.init_qvel)
        probe = self._envs[0]
        self.obs_dim = probe.observation_space.shape[0]
        self.action_dim = probe.action_space.shape[0]
        self.dt = probe.dt
        self.action_low = probe.action_space.low.astype(np.float64)
        self.action_high = probe.action_space.high.astype(np.float64)
        self._ex = ThreadPoolExecutor(max_workers=min(32, os.cpu_count() or 8))
        self._snaps = None

    # ------------------------------------------------------------------
    def reset(self) -> np.ndarray:
        self.acts = []
        if self._backend == "native":
            obs = np.zeros((self.num_envs, self.obs_dim))
            self._lib.epl_reset(self._h, obs)
        else:
            def _reset_one(e):
                e.reset(seed=0)
                # deterministic reset regardless of per-task reset-noise
                # conventions — matches the native engine's mj_resetData
                e.set_state(e.init_qpos, e.init_qvel)
                return e._get_obs()

            outs = list(self._ex.map(_reset_one, self._envs))
            obs = np.stack(outs)
        self.state = obs
        self.rews = np.zeros(self.num_envs)
        return obs

    def step(self, actions: np.ndarray, record: bool = False):
        """Step all K envs. `actions` is (K, nu) or (nu,) broadcast to all
        envs (recorded into the action log, ref envpool_env.jl:136-151)."""
        actions = np.asarray(actions, dtype=np.float64)
        if actions.ndim == 1:
            actions = np.tile(actions, (self.num_envs, 1))
            record = True
        if record:
            self.acts.append(actions[0].copy())
        actions = np.ascontiguousarray(actions)
        if self._backend == "native":
            obs = np.zeros((self.num_envs, self.obs_dim))
            rew = np.zeros(self.num_envs)
            self._lib.epl_step(self._h, actions, obs, rew)
        else:
            def one(i):
                o, r, *_ = self._envs[i].step(actions[i])
                return o, r

            outs = list(self._ex.map(one, range(self.num_envs)))
            obs = np.stack([o for o, _ in outs])
            rew = np.array([r for _, r in outs])
        self.state = obs
        self.rews = rew
        return obs, rew

    # --- snapshot/restore (replaces restore-by-replay) ----------------
    def snapshot(self):
        if self._backend == "native":
            self._lib.epl_snapshot(self._h)
        else:
            self._snaps = [
                (e.data.qpos.copy(), e.data.qvel.copy(), e.data.time)
                for e in self._envs
            ]

    def restore(self):
        if self._backend == "native":
            self._lib.epl_restore(self._h)
        else:
            import mujoco

            for e, (qp, qv, t) in zip(self._envs, self._snaps):
                e.data.qpos[:] = qp
                e.data.qvel[:] = qv
                e.data.time = t
                mujoco.mj_forward(e.model, e.data)

    def write_acts_to_file(self, fname: str) -> str:
        """Action CSV at 20 decimals (ref envpool_env.jl:184-197)."""
        if not fname.endswith(".csv"):
            fname += ".csv"
        with open(fname, "w") as f:
            for act in self.acts:
                f.write(",".join(f"{a:.20f}" for a in act) + "\n")
        return fname

    def close(self):
        if self._backend == "native" and self._h:
            self._lib.epl_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
