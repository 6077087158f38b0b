"""The port's checkpoints (``io/checkpoint.py``) and the trainer's
checkpoint, resume and wall-clock limit, on the CPU.

The file layout is held against the JAX package's ``Checkpointer``
(orbax) writing into a temporary directory; kill and resume is held to
bit-equality with an uninterrupted run, as the JAX package's
``tests/test_learning.py::test_resume_is_bit_identical`` holds its own.
"""

import copy
import functools
import logging
import os

import jax.numpy as jnp
import pytest
import torch

from shapy_tpu.io.checkpoint import Checkpointer as JCheckpointer
from shapy_tpu_torch.flagship import (
    FLAGSHIP_OPTIM_CFG,
    FLAGSHIP_TRAIN_LOSS_CFG,
    build_flagship,
    synthetic_train_batches,
)
from shapy_tpu_torch.io.checkpoint import (
    BEST_POINTER,
    LATEST_POINTER,
    Checkpointer,
    merge_loaded_params,
)
from shapy_tpu_torch.train.losses import RegressorLosses
from shapy_tpu_torch.train.trainer import Trainer

torch.set_num_threads(2)


def test_checkpointer_roundtrip_and_pointers(tmp_path):
    """Save / load by pointer, by explicit path and as the best; an empty
    directory loads None; a run with no checkpoint of its own falls back
    to the pretrained directory's pointer, then to its newest ckpt_*."""
    assert Checkpointer(str(tmp_path / "empty")).load() is None
    ck = Checkpointer(str(tmp_path / "run"))
    state = {"model": {"w": torch.arange(6.0).reshape(2, 3)},
             "step": 5, "optimizer": {"lr": [1e-4, 2e-4]}}
    p5 = ck.save(state, step=5)
    assert os.path.basename(p5) == "ckpt_00000005"
    with open(os.path.join(ck.save_dir, LATEST_POINTER)) as f:
        assert f.read() == p5
    loaded = ck.load()
    assert torch.equal(loaded["model"]["w"], state["model"]["w"])
    assert loaded["step"] == 5 and loaded["optimizer"]["lr"] == [1e-4, 2e-4]
    ck.save(dict(state, step=6), step=6, is_best=True)
    ck.save(dict(state, step=7), step=7)
    assert ck.load()["step"] == 7
    assert ck.load(use_best=True)["step"] == 6
    assert ck.load(path=p5)["step"] == 5
    assert sorted(os.listdir(ck.save_dir)) == [
        BEST_POINTER, "ckpt_00000005", "ckpt_00000006", "ckpt_00000007",
        LATEST_POINTER]

    fresh = Checkpointer(str(tmp_path / "fresh"), pretrained=ck.save_dir)
    assert fresh.load()["step"] == 6  # the pretrained run's best
    for pointer in (BEST_POINTER, LATEST_POINTER):
        os.remove(os.path.join(ck.save_dir, pointer))
    assert fresh.load()["step"] == 7  # its newest ckpt_*


def test_checkpoint_layout_matches_jax(tmp_path):
    """The JAX package's Checkpointer and the port's write the same names
    into their directories (``ckpt_{step:08d}`` and both pointer files),
    and each pointer names its own directory's checkpoint of that step."""
    jck = JCheckpointer(save_dir=str(tmp_path / "jax"))
    ck = Checkpointer(str(tmp_path / "torch"))
    for step, best in ((3, True), (12, False)):
        jck.save({"w": jnp.ones(3)}, step=step, is_best=best)
        ck.save({"w": torch.ones(3)}, step=step, is_best=best)
    assert sorted(os.listdir(jck.save_dir)) == sorted(os.listdir(ck.save_dir))
    for pointer in (LATEST_POINTER, BEST_POINTER):
        paths = []
        for d in (jck.save_dir, ck.save_dir):
            with open(os.path.join(d, pointer)) as f:
                path = f.read()
            assert os.path.dirname(path) == d
            paths.append(os.path.basename(path))
        assert paths[0] == paths[1]


def test_merge_loaded_params_logs_missing_and_unexpected(caplog):
    """A non-strict merge takes what the checkpoint has, keeps the rest,
    and logs how many keys were missing and unexpected; strict raises."""
    params = {"a.weight": torch.zeros(2), "b": {"bias": torch.zeros(1)}}
    loaded = {"a.weight": torch.ones(2), "c.extra": torch.ones(1)}
    with caplog.at_level(logging.WARNING,
                         logger="shapy_tpu_torch.io.checkpoint"):
        merged = merge_loaded_params(params, loaded)
    assert torch.equal(merged["a.weight"], torch.ones(2))
    assert torch.equal(merged["b"]["bias"], torch.zeros(1))
    text = caplog.text
    assert "Missing keys in checkpoint: 1 (b.bias)" in text
    assert "Unexpected keys in checkpoint: 1 (c.extra)" in text
    with pytest.raises(KeyError, match="Strict"):
        merge_loaded_params(params, loaded, strict=True)


@functools.lru_cache(maxsize=1)
def _flagship():
    return build_flagship(subdivisions=1, mlp_layers=(8,), device="cpu")


def _trainer(folder=None, **kwargs):
    """The flagship at W48 width, MLP (8,), synthetic SMPL-X at
    subdivisions=1, on the CPU: a copy of the same seeded weights every
    call."""
    reg = copy.deepcopy(_flagship())
    ck = None if folder is None else Checkpointer(str(folder))
    return Trainer(reg, RegressorLosses(FLAGSHIP_TRAIN_LOSS_CFG),
                   FLAGSHIP_OPTIM_CFG, checkpointer=ck, summary_steps=1,
                   device="cpu", **kwargs)


def _state(trainer):
    opt = trainer.state.optimizer.state_dict()["state"]
    return ({k: v.clone() for k, v in trainer.regressor.state_dict().items()},
            {(i, k): v.clone() for i, s in opt.items() for k, v in s.items()})


def test_kill_and_resume_is_bit_identical(tmp_path):
    """2 uninterrupted steps == 1 step, a checkpoint, a new Trainer on a
    freshly built regressor that resumes, and 1 more step: every
    parameter, BN running stat, ``param_mean``, Adam moment and step
    count bit-equal, over two distinct batches (the resumed stream starts
    at the global step) with dropout on."""
    whole = _trainer()
    loaders = {"train": synthetic_train_batches(whole.regressor, 2, 2, 64,
                                                seed=5)}
    whole.fit(loaders, 2, seed=3)
    assert whole.state.step == 2

    killed = _trainer(tmp_path, checkpoint_steps=1)
    killed.fit(loaders, 1, seed=3)
    assert sorted(d for d in os.listdir(tmp_path)
                  if d.startswith("ckpt_")) == ["ckpt_00000001"]
    resumed = _trainer(tmp_path)
    resumed.resume()
    assert resumed.state.step == 1
    assert resumed.state.scheduler.last_epoch == 1
    resumed.fit(loaders, 1, seed=3)
    assert resumed.state.step == 2

    (sd_a, opt_a), (sd_b, opt_b) = _state(whole), _state(resumed)
    assert sd_a.keys() == sd_b.keys() and opt_a.keys() == opt_b.keys()
    assert any("running_var" in k for k in sd_a)
    for k in sd_a:
        assert torch.equal(sd_a[k], sd_b[k]), k
    for k in opt_a:
        assert torch.equal(opt_a[k], opt_b[k]), k
    ckpt = torch.load(tmp_path / "ckpt_00000001", weights_only=True)
    assert not any(k.startswith(("model.", "body_measurements."))
                   for k in ckpt["model"])  # fixed tables are not saved
    assert "param_mean" in ckpt["model"]


def test_max_duration_stops_early():
    """With ``max_duration`` 0 s, ``fit`` stops after its first step."""
    trainer = _trainer(max_duration=0.0)
    batches = synthetic_train_batches(trainer.regressor, 1, 2, 64, seed=6)
    trainer.fit({"train": batches}, 5)
    assert trainer.state.step == 1
