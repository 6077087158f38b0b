"""Training orchestration (port of ``shapy_tpu/train/trainer.py``,
non-adversarial): batch streams from one or more loaders, merged per
step over the union of their keys, through the train step on the card;
periodic checkpoints, a resume that is bit-identical to an uninterrupted
run, and a wall-clock limit.

Not ported yet: the adversarial step.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np
import torch

from shapy_tpu_torch.io.checkpoint import merge_loaded_params
from shapy_tpu_torch.train.step import init_train_state, make_train_step
from shapy_tpu_torch.utils.device import get_device

logger = logging.getLogger(__name__)


# The regressor's fixed tables (body model, measurement anchors): not
# trained, so not checkpointed.
_FIXED = ("model.", "body_measurements.")


def _stream_from(loader, start: int = 0):
    """Infinite batch stream positioned at global batch ``start``: the
    loader's epochs, one after another, with the first ``start`` batches
    drawn and dropped, so that a resumed run at step N sees the batches
    of steps N, N+1, ... of an uninterrupted one (a loader that reshuffles
    replays its draws). The JAX version skips at the sampler level
    (``DataLoader.iter_batches``, the burned epochs' shuffles replayed
    without fetching); that waits for the port's data pipeline."""
    stream = _epochs(loader)
    for _ in range(start):
        next(stream)
    return stream


def _epochs(loader):
    it = iter(loader)
    while True:
        try:
            yield next(it)
        except StopIteration:
            it = iter(loader)
            # A loader that yields nothing even from a fresh epoch must
            # surface as an error, not a busy loop.
            try:
                yield next(it)
            except StopIteration:
                raise ValueError(
                    "data loader produced no batches (empty dataset or "
                    "batch size larger than the dataset with drop_last)"
                ) from None


def _to_device_batch(batch: Dict[str, Any], device: torch.device
                     ) -> Dict[str, torch.Tensor]:
    """Collate output -> tensors on ``device``; host-only fields (lists,
    object arrays) are dropped."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray) and v.dtype != object:
            out[k] = torch.from_numpy(np.ascontiguousarray(v)).to(device)
        elif isinstance(v, torch.Tensor):
            out[k] = v.to(device)
    return out


def merge_stream_batches(batches: Iterable[Dict[str, torch.Tensor]]
                         ) -> Dict[str, torch.Tensor]:
    """Concatenate per-stream batches along the batch axis over the
    union of their keys; a stream without a key contributes zeros (zero
    confidence / validity rows, which the losses ignore). Every batch
    carries ``images``, which gives the fill batch size."""
    merged: Optional[Dict[str, torch.Tensor]] = None
    for db in batches:
        if merged is None:
            merged = dict(db)
            continue

        def fill(d, k, other):
            if k in d:
                return d[k]
            ref = other[k]
            return ref.new_zeros((d["images"].shape[0],) + ref.shape[1:])

        merged = {k: torch.cat([fill(merged, k, db), fill(db, k, merged)])
                  for k in set(merged) | set(db)}
    if merged is None:
        raise ValueError("No batches produced by the loaders")
    return merged


class Trainer:
    """Trains a regressor on ``device`` (the card unless the caller asks
    for the CPU) with the losses and the optimizer of ``optim_cfg``. With
    a ``checkpointer`` (``io.checkpoint.Checkpointer``) it saves every
    ``checkpoint_steps`` steps, and :meth:`resume` continues from the
    latest checkpoint; ``fit`` stops after ``max_duration`` seconds."""

    def __init__(self, regressor, losses, optim_cfg: Optional[Dict] = None,
                 checkpointer=None, summary_steps: int = 100,
                 checkpoint_steps: int = 1000,
                 max_duration: float = float("inf"),
                 use_adv_training: bool = False, learn_mean: bool = False,
                 device: str | torch.device = "cuda"):
        if use_adv_training:
            raise NotImplementedError("the adversarial trainer is not "
                                      "ported yet")
        self.device = get_device(device)
        self.regressor = regressor.to(self.device).prepare_for_train_(
            regressor.backbone_dtype)
        self.losses = losses
        self.checkpointer = checkpointer
        self.summary_steps = summary_steps
        self.checkpoint_steps = checkpoint_steps
        self.max_duration = max_duration
        self.state = init_train_state(self.regressor, optim_cfg, learn_mean)
        self.step_fn = make_train_step(self.regressor, losses, self.state)

    def _trained_state(self) -> Dict[str, torch.Tensor]:
        """The module state a run changes: parameters, BN running stats
        and ``param_mean``."""
        return {k: v for k, v in self.regressor.state_dict().items()
                if not k.startswith(_FIXED)}

    def _ckpt_tree(self) -> Dict[str, Any]:
        """What a checkpoint holds: the trained module state, the
        optimizer's and the schedule's state, and the step."""
        return {"model": self._trained_state(), **self.state.state_dict()}

    def resume(self) -> None:
        """Restore the latest checkpoint, if the checkpointer finds one:
        the module state (a non-strict merge that logs missing and
        unexpected keys), the optimizer, the schedule and the step."""
        if self.checkpointer is None:
            return
        loaded = self.checkpointer.load()
        if loaded is None:
            return
        merged = merge_loaded_params(self._trained_state(), loaded["model"])
        self.regressor.load_state_dict(merged, strict=False)
        self.state.load_state_dict(loaded)
        logger.info("Resumed from step %d", self.state.step)

    def fit(self, loaders: Dict[str, Any], num_steps: int, seed: int = 0,
            on_step: Optional[Callable] = None) -> Dict[str, float]:
        """``num_steps`` updates from the merged streams of ``loaders``,
        each stream positioned at the global step (the state's, counted
        over every ``fit`` call and restored by :meth:`resume`). Step s
        draws its dropout from a generator seeded by (seed, s), so a kill
        and resume repeats an uninterrupted run bit for bit on one device.
        Saves a checkpoint after every ``checkpoint_steps``-th step and
        stops once ``max_duration`` seconds have passed.
        ``on_step(step, losses)`` sees each step's detached loss tensors
        (no host sync). Returns the losses of the last summary step as
        floats."""
        start_time = time.time()
        last: Dict[str, float] = {}
        step0 = self.state.step
        streams = {k: _stream_from(v, step0) for k, v in loaders.items()}
        for step in range(step0, step0 + num_steps):
            merged = merge_stream_batches(
                _to_device_batch(next(streams[part]), self.device)
                for part in loaders)
            images = merged.pop("images")
            generator = torch.Generator(device=self.device)
            generator.manual_seed(seed * 1_000_003 + step)
            metrics = self.step_fn(images, merged, generator)
            if on_step is not None:
                on_step(step, metrics)
            if (step + 1) % self.summary_steps == 0:
                last = {k: float(v) for k, v in metrics.items()}
                logger.info("step %d: %s", step + 1,
                            {k: round(v, 4) for k, v in last.items()})
            if (self.checkpointer is not None
                    and (step + 1) % self.checkpoint_steps == 0):
                self.checkpointer.save(self._ckpt_tree(), step=step + 1)
            if time.time() - start_time > self.max_duration:
                logger.info("Max duration reached at step %d", step + 1)
                break
        return last
