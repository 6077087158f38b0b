"""The port runs where neither jax nor yaml is installed, and stands
apart from the JAX package, so it never imports jax, yaml or any module
of ``shapy_tpu`` (numpy-only ones included). Every module of the port and
``chip_smoke``'s helpers are imported in a fresh interpreter in which
importing any of them raises; ``shapy_tpu_torch`` itself is matched by its
exact top-level name and still imports."""

import inspect
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]

SCRIPT = r"""
import importlib, importlib.abc, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "yaml", "shapy_tpu")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import shapy_tpu_torch
names = [m.name for m in pkgutil.walk_packages(shapy_tpu_torch.__path__,
                                               "shapy_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
chip_smoke.kernels()
bad = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
assert not bad, bad
print(len(names))
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 90  # every module was walked


def test_build_flagship_asks_for_the_card(monkeypatch):
    """The entry point runs on the card unless the caller asks for the
    CPU: without CUDA, the default raises instead of building on the
    CPU."""
    from shapy_tpu_torch.flagship import build_flagship

    default = inspect.signature(build_flagship).parameters["device"].default
    assert default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_flagship(subdivisions=1)


def test_measurement_entry_points_ask_for_the_card(monkeypatch, tmp_path):
    """The fit and the virtual-measurements CLIs run on the card unless
    the caller asks for the CPU: without CUDA their defaults raise."""
    from shapy_tpu_torch.cli import fit_measurements, virtual_measurements

    assert fit_measurements.build_parser().parse_args([]).device == "cuda"
    default = inspect.signature(virtual_measurements.main).parameters[
        "device"].default
    assert default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("SHAPY_TPU_SYNTHETIC_BODY", "1")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fit_measurements.main(["--num-steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        virtual_measurements.main(str(tmp_path), str(tmp_path / "out"),
                                  render=False)
