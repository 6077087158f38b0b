"""Training orchestration (port of ``shapy_tpu/train/trainer.py``):
batch streams from one or more loaders, merged per step over the union of
their keys, through the train step on the card (with the discriminator's
update where ``use_adv_training`` is set); periodic checkpoints, a resume
that is bit-identical to an uninterrupted run, periodic evaluation and a
wall-clock limit.

Batches of full images (``full_images`` with ``crop_to_image_affines``
and the channel noise's ``channel_noise``, the collate's full-image mode)
are cropped, noised, normalised and cast on the device by kernel K2, one
launch a step for every stream together.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from shapy_tpu_torch.data.crop import crop_normalize
from shapy_tpu_torch.io.checkpoint import merge_loaded_params
from shapy_tpu_torch.train.step import (
    TrainState,
    build_optimizer,
    init_train_state,
    make_adversarial_train_step,
    make_train_step,
)
from shapy_tpu_torch.utils.device import get_device

logger = logging.getLogger(__name__)


# The regressor's fixed tables (body model, measurement anchors): not
# trained, so not checkpointed.
_FIXED = ("model.", "body_measurements.")


def _stream_from(loader, start: int = 0):
    """Infinite batch stream positioned at global batch ``start``: a
    resumed run at step N sees the batches of steps N, N+1, ... of an
    uninterrupted one. A ``data.build.DataLoader`` skips without fetching:
    whole epochs burned at the sampler level (``burn_epoch``), then the
    partial epoch's first batches (``iter_batches(skip=...)``); any other
    iterable has its first ``start`` batches drawn and dropped."""
    epoch_len = len(loader) if hasattr(loader, "__len__") else 0
    if start and epoch_len and hasattr(loader, "burn_epoch"):
        epochs, offset = divmod(start, epoch_len)
        for _ in range(epochs):
            loader.burn_epoch()
        return _epochs(loader, loader.iter_batches(skip=offset))
    stream = _epochs(loader)
    for _ in range(start):
        next(stream)
    return stream


def _epochs(loader, first=None):
    """The loader's epochs one after another, from ``first`` (an iterator
    of the first epoch's batches) if given."""
    it = iter(loader) if first is None else first
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


def _pad_full_images(x: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(B, h, w, 3) -> (B, H, W, 3), zeros below and to the right (which
    move no crop: K2 reads zeros outside an image)."""
    return F.pad(x, (0, 0, 0, W - x.shape[2], 0, H - x.shape[1]))


def merge_stream_batches(batches: Iterable[Dict[str, torch.Tensor]]
                         ) -> Dict[str, torch.Tensor]:
    """Concatenate per-stream batches along the batch axis over the
    union of their keys; a stream without a key contributes zeros (zero
    confidence / validity rows, which the losses ignore), or ones for
    ``channel_noise`` (no noise). ``full_images`` are zero-padded to the
    largest height and width first. Every batch carries ``images`` or
    ``full_images``, which gives the fill batch size."""
    merged: Optional[Dict[str, torch.Tensor]] = None
    for db in batches:
        if merged is None:
            merged = dict(db)
            continue

        def fill(d, k, other):
            if k in d:
                return d[k]
            ref = other[k]
            rows = d["images" if "images" in d else "full_images"].shape[0]
            make = ref.new_ones if k == "channel_noise" else ref.new_zeros
            return make((rows,) + ref.shape[1:])

        if "full_images" in merged and "full_images" in db:
            H = max(merged["full_images"].shape[1], db["full_images"].shape[1])
            W = max(merged["full_images"].shape[2], db["full_images"].shape[2])
            merged["full_images"] = _pad_full_images(merged["full_images"],
                                                     H, W)
            db = dict(db, full_images=_pad_full_images(db["full_images"], H,
                                                       W))
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
    latest checkpoint; ``fit`` stops after ``max_duration`` seconds.

    With ``use_adv_training`` a discriminator (``disc_cfg``, the config's
    ``network.discriminator``), its loss (``adv_loss_cfg``,
    ``losses.discriminator``) and its optimizer (``disc_optim_cfg``,
    ``optim.discriminator``, else ``optim_cfg``) train beside the
    regressor, one update of each a step; the discriminator's state goes
    into the checkpoint. ``crop_size`` is the crops' side where batches
    hold full images."""

    def __init__(self, regressor, losses, optim_cfg: Optional[Dict] = None,
                 checkpointer=None, summary_steps: int = 100,
                 checkpoint_steps: int = 1000,
                 max_duration: float = float("inf"),
                 use_adv_training: bool = False, learn_mean: bool = False,
                 device: str | torch.device = "cuda",
                 disc_cfg: Optional[Dict] = None,
                 adv_loss_cfg: Optional[Dict] = None,
                 disc_optim_cfg: Optional[Dict] = None,
                 crop_size: int = 256):
        self.device = get_device(device)
        self.regressor = regressor.to(self.device).prepare_for_train_(
            regressor.backbone_dtype)
        self.losses = losses
        self.checkpointer = checkpointer
        self.summary_steps = summary_steps
        self.checkpoint_steps = checkpoint_steps
        self.max_duration = max_duration
        self.crop_size = int(crop_size)
        self.use_adv_training = bool(use_adv_training)
        self.state = init_train_state(self.regressor, optim_cfg, learn_mean)
        self.disc = self.disc_state = None
        if self.use_adv_training:
            from shapy_tpu_torch.losses.adversarial import build_adv_loss
            from shapy_tpu_torch.models.discriminator import (
                build_discriminator,
            )

            self.disc = build_discriminator(disc_cfg).to(self.device)
            self.disc_state = TrainState(*build_optimizer(
                self.disc.named_parameters(), disc_optim_cfg or optim_cfg))
            self.step_fn = make_adversarial_train_step(
                self.regressor, losses, self.state, self.disc,
                build_adv_loss(self.disc, adv_loss_cfg), self.disc_state)
        else:
            self.step_fn = make_train_step(self.regressor, losses,
                                           self.state)

    def _trained_state(self) -> Dict[str, torch.Tensor]:
        """The module state a run changes: parameters, BN running stats
        and ``param_mean``."""
        return {k: v for k, v in self.regressor.state_dict().items()
                if not k.startswith(_FIXED)}

    def _ckpt_tree(self) -> Dict[str, Any]:
        """What a checkpoint holds: the trained module state, the
        optimizer's and the schedule's state, and the step; with the
        adversarial step, the discriminator's module state (its ``u``
        buffers among it), optimizer, schedule and step under ``disc``."""
        tree = {"model": self._trained_state(), **self.state.state_dict()}
        if self.disc is not None:
            tree["disc"] = {"model": self.disc.state_dict(),
                            **self.disc_state.state_dict()}
        return tree

    def resume(self) -> None:
        """Restore the latest checkpoint, if the checkpointer finds one:
        the module state (a non-strict merge that logs missing and
        unexpected keys), the optimizer, the schedule and the step, and
        the discriminator's where both sides have one."""
        if self.checkpointer is None:
            return
        loaded = self.checkpointer.load()
        if loaded is None:
            return
        merged = merge_loaded_params(self._trained_state(), loaded["model"])
        self.regressor.load_state_dict(merged, strict=False)
        self.state.load_state_dict(loaded)
        disc = loaded.get("disc")
        if disc is not None and self.disc is not None:
            self.disc.load_state_dict(disc["model"])
            self.disc_state.load_state_dict(disc)
        logger.info("Resumed from step %d", self.state.step)

    def _images(self, merged: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The step's normalised crops: the batch's ``images``, or its full
        images cropped, noised, normalised and cast to the backbone's
        dtype by K2 (its plain version on the CPU)."""
        if "images" in merged:
            return merged.pop("images")
        return crop_normalize(
            merged.pop("full_images"), merged.pop("crop_to_image_affines"),
            self.crop_size, out_dtype=self.regressor.backbone_dtype,
            factors=merged.pop("channel_noise", None))

    def fit(self, loaders: Dict[str, Any], num_steps: int, seed: int = 0,
            on_step: Optional[Callable] = None,
            eval_fn: Optional[Callable] = None, eval_steps: int = 0
            ) -> Dict[str, float]:
        """``num_steps`` updates from the merged streams of ``loaders``,
        each stream positioned at the global step (the state's, counted
        over every ``fit`` call and restored by :meth:`resume`). Step s
        draws its dropout from a generator seeded by (seed, s), and the
        WGAN-GP's tau from another, so a kill and resume repeats an
        uninterrupted run bit for bit on one device. Saves a checkpoint
        after every ``checkpoint_steps``-th step, calls ``eval_fn(step)``
        after every ``eval_steps``-th, and stops once ``max_duration``
        seconds have passed. ``on_step(step, losses)`` sees each step's
        detached loss tensors (no host sync). Returns the losses of the
        last summary step as floats."""
        start_time = time.time()
        last: Dict[str, float] = {}
        step0 = self.state.step
        streams = {k: _stream_from(v, step0) for k, v in loaders.items()}
        for step in range(step0, step0 + num_steps):
            merged = merge_stream_batches(
                _to_device_batch(next(streams[part]), self.device)
                for part in loaders)
            images = self._images(merged)
            step_seed = seed * 1_000_003 + step
            generator = torch.Generator(device=self.device)
            generator.manual_seed(step_seed)
            if self.use_adv_training:
                # Real poses for the discriminator: a real_body_pose
                # stream if a loader gives one, else the batch's GT.
                if "real_body_pose" not in merged:
                    if "gt_body_pose" not in merged:
                        raise ValueError(
                            "use_adv_training needs real_body_pose or "
                            "gt_body_pose in the batch (a dataset with GT "
                            "pose rotations)")
                    merged["real_body_pose"] = merged["gt_body_pose"]
                gp_generator = torch.Generator(device=self.device)
                gp_generator.manual_seed((1 << 62) + step_seed)
                metrics = self.step_fn(images, merged, generator,
                                       gp_generator)
            else:
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
            if eval_fn is not None and eval_steps and \
                    (step + 1) % eval_steps == 0:
                eval_fn(step + 1)
            if time.time() - start_time > self.max_duration:
                logger.info("Max duration reached at step %d", step + 1)
                break
        return last
