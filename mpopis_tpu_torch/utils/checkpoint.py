"""Checkpoint / resume.

Counterpart of `mpopis_tpu/utils/checkpoint.py`. The complete resumable
state of an experiment is {policy state (U, generator), env state (x, t,
done), step counter}, saved as one .npz with the JAX package's keys (`U`,
`step`, `env_x`, `env_t`, `env_done`, `extra_*`). The JAX key becomes the
policy's `torch.Generator`: its `get_state()` bytes and its device type are
saved, so a resumed run draws the same numbers and continues the exact
trajectory.
"""

from __future__ import annotations

import numpy as np
import torch

from mpopis_tpu_torch.models.base import EnvState
from mpopis_tpu_torch.policies.config import PolicyState


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def save_checkpoint(path: str, pol_state: PolicyState, env_state: EnvState | None = None,
                    step: int = 0, **extra) -> str:
    """Write the policy state, the env state (if given), the step counter and
    any `extra` arrays to `path` (.npz appended if missing); returns the path."""
    path = _npz(path)
    gen = pol_state.generator
    payload = {
        "U": _numpy(pol_state.U),
        "generator_state": gen.get_state().numpy(),
        "generator_device": np.asarray(torch.device(gen.device).type),
        "step": np.asarray(step),
    }
    if env_state is not None:
        payload["env_x"] = _numpy(env_state.x)
        payload["env_t"] = np.asarray(env_state.t)
        payload["env_done"] = _numpy(env_state.done)
        # a Python bool for the envs that never end, a bool tensor for the others
        payload["env_done_is_tensor"] = np.asarray(isinstance(env_state.done, torch.Tensor))
    for k, v in extra.items():
        payload["extra_" + k] = _numpy(v)
    np.savez(path, **payload)
    return path


def load_checkpoint(path: str, dtype=None, device="cuda"):
    """Returns (pol_state, env_state_or_None, step, extras). U and the env
    state land on `device` (in `dtype` if given, else as saved); the policy's
    generator is a new one on `device`, set to the saved state, which must
    come from a generator of the same device type."""
    data = np.load(_npz(path))
    device = torch.device(device)
    saved_on = str(data["generator_device"])
    if saved_on != device.type:
        raise ValueError(
            f"{path}: the generator was saved from a {saved_on} generator and cannot be "
            f"restored on {device.type}; load it with device={saved_on!r}"
        )
    gen = torch.Generator(device=device)
    gen.set_state(torch.from_numpy(data["generator_state"].copy()))
    pol_state = PolicyState(
        U=torch.as_tensor(data["U"], dtype=dtype, device=device), generator=gen
    )
    env_state = None
    if "env_x" in data:
        done = data["env_done"]
        if bool(data["env_done_is_tensor"]):
            done = torch.as_tensor(done, dtype=torch.bool, device=device)
        else:
            done = bool(done)
        env_state = EnvState(
            x=torch.as_tensor(data["env_x"], dtype=dtype, device=device),
            t=int(data["env_t"]),
            done=done,
        )
    extras = {
        k[len("extra_"):]: data[k] for k in data.files if k.startswith("extra_")
    }
    return pol_state, env_state, int(data["step"]), extras
