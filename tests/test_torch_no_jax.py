"""The port runs where neither jax nor yaml is installed, so it never
imports them. Every module of the port and ``chip_smoke``'s helpers are
imported in a fresh interpreter in which importing jax or yaml raises."""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

SCRIPT = r"""
import importlib, importlib.abc, pkgutil, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "yaml"):
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
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "yaml")]
assert not bad, bad
print(len(names))
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 20  # every module was walked
