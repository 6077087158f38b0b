"""The port's training CLI (``cli/train.py``) on the CPU, on synthetic
archives written by the port's generator at the learning test's size
(56 px images, SMPL-X at subdivisions 1, ResNet-18, 48 px crops, batch
8), with ``configs/train_shapy.yaml``'s augmentations (flip, scale,
rotation, channel noise) on full images that the step crops (K2's plain
version here): the eval rows it prints, a kill and resume bit-equal to
an uninterrupted run with the adversarial step off and on (LSGAN and
WGAN-GP), its refusals, and a run in a fresh interpreter where
importing ``cv2``, jax, yaml or the JAX package raises."""

import ast
import contextlib
import io
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from shapy_tpu_torch.cli import train
from shapy_tpu_torch.data.synthetic import (
    generate_parametric_fits,
    register_synthetic_datasets,
    synthetic_train_config,
)

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
GEN = dict(image_size=56, subdivisions=1, pose_std=0.1,
           global_std=(0.0, 0.45, 0.0), betas_std=2.5, active_betas=2)
ARCHIVES = (("pose_a", 16, 1), ("pose_b", 16, 2), ("shape_a", 16, 3),
            ("val", 8, 9))
AUGMENT = {"flip_prob": 0.5, "scale_factor": 0.25, "scale_dist": "normal",
           "rotation_factor": 30.0, "noise_scale": 0.4}


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth")
    for name, n, seed in ARCHIVES:
        generate_parametric_fits(str(root / name), n, seed=seed,
                                 device="cpu", **GEN)
    register_synthetic_datasets([a[0] for a in ARCHIVES])
    return root


@pytest.fixture(autouse=True)
def small_body(monkeypatch):
    monkeypatch.setenv("SHAPY_TPU_SYNTHETIC_BODY", "1")
    monkeypatch.setenv("SHAPY_TPU_TEST_SUBDIV", "1")


def _cfg(root, **overrides):
    cfg = synthetic_train_config(str(root), batch_size=8, crop_size=48,
                                 lr=1e-3, num_stages=1)
    for part in ("pose", "shape"):
        cfg["datasets"][part]["transforms"].update(AUGMENT)
    cfg.update({"summary_steps": 2, "checkpoint_steps": 4,
                "eval_steps": 0})
    cfg.update(overrides)
    return cfg


def _main(cfg, out, steps):
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        rc = train.main(cfg, output_folder=str(out), num_steps=steps,
                        device="cpu")
    assert rc == 0
    return text.getvalue().splitlines()


def test_train_cli_prints_losses_and_eval_rows(synth_root, tmp_path):
    """4 steps with the adversarial step and the eval hook every 2: the
    last summary's losses (with ``adv_gen`` and ``adv_disc``) and one eval
    row a call (before training, at 2 and at 4), every value finite."""
    lines = _main(_cfg(synth_root, eval_steps=2, use_adv_training=True),
                  tmp_path / "run", 4)
    losses = ast.literal_eval(lines[0])
    assert {"total", "joints2d", "adv_gen", "adv_disc"} <= set(losses)
    rows = [ast.literal_eval(x) for x in lines[1:]]
    assert [(r["eval"], r["step"]) for r in rows] == [
        ("pose", 0), ("pose", 2), ("pose", 4)]
    for r in rows:
        assert 0.01 < r["v2v"] < 1.0
    assert all(np.isfinite(v) for v in losses.values())
    assert (tmp_path / "run" / "checkpoints" / "ckpt_00000004").exists()


@pytest.mark.parametrize("adv", [None, "lsgan", "wgan-gp"])
def test_train_cli_resume_is_bit_identical(synth_root, tmp_path, adv):
    """8 steps against 4 + kill + a fresh ``main`` that resumes + 4: the
    two step-8 checkpoints hold the same bits (every parameter, BN stat,
    Adam moment and schedule, and with the adversarial step the
    discriminator's weights, ``u`` buffers, moments and step)."""
    over = {}
    if adv:
        over = {"use_adv_training": True,
                "losses": dict(_cfg(synth_root)["losses"],
                               discriminator={"type": adv})}
    cfg = _cfg(synth_root, **over)
    _main(cfg, tmp_path / "whole", 8)
    _main(cfg, tmp_path / "parts", 4)
    _main(cfg, tmp_path / "parts", 4)
    ckpt = "checkpoints/ckpt_00000008"
    a, b = (torch.load(tmp_path / d / ckpt, weights_only=False)
            for d in ("whole", "parts"))
    assert a["step"] == 8 and ("disc" in a) == bool(adv)
    if adv:
        assert a["disc"]["step"] == 8 and "linear3.u" in a["disc"]["model"]
    assert not chip_smoke._equal_trees(a, b)


def test_train_cli_refusals(synth_root, tmp_path, monkeypatch):
    """No training dataset: rc 1; more than one card, and pose and shape
    crops of two sizes, raise; the card by default, which raises without
    CUDA."""
    cfg = _cfg(synth_root)
    assert train.main(dict(cfg, datasets={}), str(tmp_path / "a"),
                      device="cpu") == 1
    with pytest.raises(ValueError, match="one card"):
        train.main(cfg, str(tmp_path / "b"), num_devices_data=2,
                   device="cpu")
    bad = _cfg(synth_root)
    bad["datasets"]["shape"]["transforms"]["crop_size"] = 64
    with pytest.raises(ValueError, match="different sizes"):
        train.main(bad, str(tmp_path / "c"), device="cpu")
    args = train.build_parser().parse_args([])
    assert args.device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(cfg, str(tmp_path / "d"))


NO_CV2_SCRIPT = r"""
import importlib.abc, sys

BLOCKED = ("cv2", "jax", "jaxlib", "yaml", "shapy_tpu")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import ast, os
from shapy_tpu_torch.cli import train
from shapy_tpu_torch.data.synthetic import (
    generate_parametric_fits, register_synthetic_datasets,
    synthetic_train_config)

root = sys.argv[1]
for name, seed in (("pose_a", 1), ("shape_a", 3)):
    generate_parametric_fits(os.path.join(root, name), 8, seed=seed,
                             device="cpu", image_size=56, subdivisions=1)
register_synthetic_datasets(["pose_a", "shape_a"])
cfg = synthetic_train_config(root, batch_size=4, crop_size=32,
                             pose_archives=("pose_a",), val_archives=(),
                             num_stages=1)
for part in ("pose", "shape"):
    cfg["datasets"][part]["transforms"].update(
        flip_prob=0.5, scale_factor=0.25, scale_dist="normal",
        rotation_factor=30.0, noise_scale=0.4)
cfg.update(use_adv_training=True, summary_steps=2)
rc = train.main(cfg, output_folder=os.path.join(root, "out"), num_steps=2,
                device="cpu")
bad = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
assert rc == 0 and not bad, (rc, bad)
print("ok")
"""


def test_train_cli_needs_no_cv2_jax_or_yaml(tmp_path):
    """The archives' generator and 2 augmented adversarial steps in a
    fresh interpreter where importing ``cv2`` (the card's machine has
    none), jax, yaml or a JAX-package module raises."""
    env = dict(os.environ, PYTHONPATH=str(REPO),
               SHAPY_TPU_SYNTHETIC_BODY="1", SHAPY_TPU_TEST_SUBDIV="1")
    proc = subprocess.run([sys.executable, "-c", NO_CV2_SCRIPT,
                           str(tmp_path)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.splitlines()[-1] == "ok"
