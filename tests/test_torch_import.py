"""The port imports without jax, and its copied tables equal the JAX package's."""

import dataclasses
import os
import subprocess
import sys

from mpopis_tpu.models.car_racing import CarParams as JCarParams
from mpopis_tpu.policies import config as jconfig

from mpopis_tpu_torch.models.car_racing import CarParams
from mpopis_tpu_torch.policies import config

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import mpopis_tpu_torch
names = [m.name for m in pkgutil.walk_packages(mpopis_tpu_torch.__path__, "mpopis_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "mpopis_tpu"))
print(len(names), bad)
assert not bad, bad
"""


def test_port_imports_every_module_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=_REPO, capture_output=True,
        text=True, timeout=120, check=False,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 20  # every subpackage and module was walked


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
