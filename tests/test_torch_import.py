"""The port imports without jax, and its copied tables equal the JAX package's."""

import dataclasses
import os
import subprocess
import sys

import pytest

from mpopis_tpu.models import ant_device as jant
from mpopis_tpu.models import humanoid_device as jhum
from mpopis_tpu.models import humanoidstandup_device as jstand
from mpopis_tpu.models import spatial_contact as jspatial
from mpopis_tpu.models.car_racing import CarParams as JCarParams
from mpopis_tpu.policies import config as jconfig

from mpopis_tpu_torch.models import ant_device, humanoid_device, humanoidstandup_device
from mpopis_tpu_torch.models import spatial_contact
from mpopis_tpu_torch.models.car_racing import CarParams
from mpopis_tpu_torch.policies import config

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
for blocked in ("jax", "jaxlib", "flax", "mpopis_tpu"):
    sys.modules[blocked] = None  # any import of them raises ImportError
import mpopis_tpu_torch
names = [m.name for m in pkgutil.walk_packages(mpopis_tpu_torch.__path__, "mpopis_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "mpopis_tpu") and sys.modules[m])
from mpopis_tpu_torch.kernels import planar_step, spatial_step
entries = ("swimmer_rollout_costs_tak", "swimmer_rollout_costs_tak_reference",
           "swimmer_step_states", "planar_rollout_costs_tak", "planar_step_states")
assert all(callable(getattr(planar_step, e)) for e in entries)
assert all(callable(getattr(spatial_step, e)) for e in ("spatial_rollout_costs_tak",
                                                        "spatial_step_states", "model_features"))
print(len(names), bad, " ".join(names))
assert not bad, bad
"""

_PLANAR_MODULES = (
    "mpopis_tpu_torch.models.planar",
    "mpopis_tpu_torch.models.planar_contact",
    "mpopis_tpu_torch.models.cheetah_device",
    "mpopis_tpu_torch.models.hopper_device",
    "mpopis_tpu_torch.models.walker2d_device",
    "mpopis_tpu_torch.models.swimmer_device",
    "mpopis_tpu_torch.kernels.planar_step",
)
_SPATIAL_MODULES = (
    "mpopis_tpu_torch.models.spatial_contact",
    "mpopis_tpu_torch.models.ant_device",
    "mpopis_tpu_torch.models.pusher_device",
    "mpopis_tpu_torch.models.humanoid_device",
    "mpopis_tpu_torch.models.humanoidstandup_device",
    "mpopis_tpu_torch.kernels.spatial_step",
)
_AIS_MODULES = (
    "mpopis_tpu_torch.ops.sampling",
    "mpopis_tpu_torch.kernels.ais_update",
    "mpopis_tpu_torch.kernels.linalg",
    "mpopis_tpu_torch.policies.strategies",
)
_HOST_MODULES = (
    "mpopis_tpu_torch.utils.profiling",
    "mpopis_tpu_torch.utils.checkpoint",
    "mpopis_tpu_torch.native.build",
    "mpopis_tpu_torch.models.mujoco_host",
    "mpopis_tpu_torch.policies.host_driver",
    "mpopis_tpu_torch.harness.simulate_mujoco",
    "mpopis_tpu_torch.harness.plotting",
)


def test_port_imports_every_module_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=_REPO, capture_output=True,
        text=True, timeout=120, check=False,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules, _bad, *names = proc.stdout.split()
    assert int(n_modules) >= 28  # every subpackage and module was walked
    assert set(_PLANAR_MODULES) <= set(names)
    assert set(_AIS_MODULES) <= set(names)
    assert set(_SPATIAL_MODULES) <= set(names)
    assert set(_HOST_MODULES) <= set(names)


_CHIP_SMOKE = """
import sys
for blocked in ("jax", "jaxlib", "flax", "mpopis_tpu"):
    sys.modules[blocked] = None
import torch
import chip_smoke
assert chip_smoke._parse_paths([]) == chip_smoke.PATHS
assert chip_smoke._parse_paths(["--only", "standup,humanoid"]) == ("humanoid", "standup")
assert set(chip_smoke._LIBRARIES) == set(chip_smoke.PATHS)
assert chip_smoke.PATHS[-3:] == ("resume", "gif", "host")
assert set(chip_smoke.PACKAGES) == {"gif", "host"}
print(chip_smoke.main([]) if not torch.cuda.is_available() else 2)
"""


def test_chip_smoke_imports_no_jax_and_selects_paths():
    """chip_smoke.py with jax and the JAX package blocked: `--only` picks
    paths in run order, and without a card `main` exits 2 before any build."""
    proc = subprocess.run([sys.executable, "-c", _CHIP_SMOKE], cwd=_REPO, capture_output=True,
                          text=True, timeout=120, check=False)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.split()[-1] == "2"


def _fields(cls):
    return [(f.name, f.default) for f in dataclasses.fields(cls)]


def test_car_params_fields_and_defaults_match_jax():
    assert _fields(CarParams) == _fields(JCarParams)


def test_policy_config_fields_and_defaults_match_jax():
    assert _fields(config.PolicyConfig) == _fields(jconfig.PolicyConfig)
    assert config.POLICY_KINDS == jconfig.POLICY_KINDS
    assert config.KIND_ALIASES == jconfig.KIND_ALIASES
    for kind in ("cem", ":CEMPPI", "μΣaismppi", "mppi"):
        assert config.canonical_kind(kind) == jconfig.canonical_kind(kind)
    cfg = config.PolicyConfig(kind="cem", lam=10.0, alpha=0.5)
    assert cfg.kind == "cemppi" and cfg.gamma == jconfig.PolicyConfig(lam=10.0, alpha=0.5).gamma


def _joint_dicts(bodies):
    """_BODIES with each joint as a dict: each package has its own SJoint."""
    return [b[:3] + (tuple(dataclasses.asdict(j) for j in b[3]),) + b[4:] for b in bodies]


@pytest.mark.parametrize("ours,theirs", [(humanoid_device, jhum), (humanoidstandup_device, jstand)],
                         ids=["humanoid", "standup"])
def test_humanoid_tables_match_jax(ours, theirs):
    """The copied Humanoid and HumanoidStandup tables (242 rows: 17 limits,
    29 condim-3 contacts, 109 self pairs; joint springs) and the env's step
    constants."""
    assert dataclasses.asdict(ours.MODEL) == dataclasses.asdict(theirs.MODEL)
    assert ours.MODEL.n_rows == 242 and len(ours.MODEL.self_pairs) == 109
    for name in ("_H", "_FRAME_SKIP", "_CONTACTS", "_PAIRS", "_SELF_PAIRS", "_LIMITS", "_DAMPING",
                 "_ARMATURE", "_STIFFNESS", "_SPRINGREF", "_DOF_INVWEIGHT0", "_BODY_INVWEIGHT0",
                 "_ACTUATORS"):
        assert getattr(ours, name) == getattr(theirs, name), name
    assert _joint_dicts(ours._BODIES) == _joint_dicts(theirs._BODIES)
    env = (humanoid_device.HumanoidDeviceEnv if ours is humanoid_device
           else humanoidstandup_device.HumanoidStandupDeviceEnv)
    assert (env.FRAME_SKIP, env.ACTUATORS, env.ACTION_CLIP, env.CTRL_W) == (
        theirs._FRAME_SKIP, theirs._ACTUATORS, 0.4, 0.1)
    assert (env.state_dim, env.action_dim) == (48, 17)


def test_ant_tables_match_jax():
    """The copied Ant tables, the spatial table classes' fields and defaults,
    and the env's step constants."""
    for name in ("SJoint", "SCBody", "SCContact", "SCPairCylinder", "SCPairCapsule", "SCLimit",
                 "SpatialContactModel"):
        assert _fields(getattr(spatial_contact, name)) == _fields(getattr(jspatial, name)), name
    assert dataclasses.asdict(ant_device.MODEL) == dataclasses.asdict(jant.MODEL)
    for name in ("_H", "_FRAME_SKIP", "_BODIES", "_CONTACTS", "_LIMITS", "_DAMPING", "_ARMATURE",
                 "_STIFFNESS", "_SPRINGREF", "_DOF_INVWEIGHT0", "_BODY_INVWEIGHT0", "_ACTUATORS"):
        ours, theirs = getattr(ant_device, name), getattr(jant, name)
        if name == "_BODIES":  # the joints are each package's own SJoint
            ours = [b[:3] + (tuple(dataclasses.asdict(j) for j in b[3]),) + b[4:] for b in ours]
            theirs = [b[:3] + (tuple(dataclasses.asdict(j) for j in b[3]),) + b[4:]
                      for b in theirs]
        assert ours == theirs, name
    env = ant_device.AntDeviceEnv
    assert (env.FRAME_SKIP, env.ACTUATORS, env.HEALTHY, env.CTRL_W) == (
        jant._FRAME_SKIP, jant._ACTUATORS, 1.0, 0.5)
