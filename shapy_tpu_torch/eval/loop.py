"""In-training evaluation: run the Evaluator over val loaders with a
regressor's current weights (port of ``shapy_tpu/eval/loop.py``; the port
has no ``TrainState``, so the module itself is evaluated)."""

from __future__ import annotations

import logging
from typing import Callable, Dict, Optional

import numpy as np
import torch

from shapy_tpu_torch.eval.evaluator import (
    bmi_bucket,
    bmi_hist_group,
    build_evaluator,
)

logger = logging.getLogger(__name__)

_TARGET_FIELDS = (
    ("gt_v_shaped", "gt_v_shaped"),
    ("gt_vertices", "gt_vertices"),
    ("joints3d", "gt_joints3d"),
    ("joints14", "gt_joints14"),
    ("joints14_valid", "joints14_valid"),
)


def _to(x, device: torch.device) -> torch.Tensor:
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.array(x))  # a copy: x may be read-only
    return x.to(device, non_blocking=True)


def _host(x) -> np.ndarray:
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64).reshape(-1)


def adapt_eval_batches(loader, device: str | torch.device = "cuda",
                       crop_size: Optional[int] = None):
    """Collate output -> the batch dicts ``Evaluator.run`` consumes, with
    every tensor on ``device``.

    Besides the JAX package's fields, a batch may carry full images
    (uint8, or f32 in [0, 1]) with ``crop_to_image_affines`` (B, 3, 3):
    the images (the collate's padded ``full_images`` where the batch has
    no ``images``) become the batch's ``images``, the affines (and
    ``crop_size``, the side of the crops they map, where given) go to the
    model batch, and the model then crops on the device (kernel K2)."""
    device = torch.device(device)
    for batch in loader:
        targets = {dst: _to(batch[src], device)
                   for src, dst in _TARGET_FIELDS if src in batch}
        for key in ("height", "chest", "waist", "hips", "mass"):
            if f"{key}_gt" in batch:
                targets[key] = _to(batch[f"{key}_gt"], device)
        model_batch = {}
        if "gender" in batch:
            model_batch["gender"] = _to(batch["gender"], device)
        if "crop_to_image_affines" in batch:
            model_batch["crop_to_image_affines"] = _to(
                batch["crop_to_image_affines"], device)
            if crop_size is not None:
                model_batch["crop_size"] = crop_size
        out = {
            "images": _to(batch["images"] if "images" in batch
                          else batch["full_images"], device),
            "targets": targets,
            "model_batch": model_batch,
            "genders": batch.get("genders"),
        }
        # BMI breakdowns from GT height/mass: histogram groups and bucket
        # names for the per-gender/BMI group means.
        if "height_gt" in batch and "mass_gt" in batch:
            h = _host(batch["height_gt"])
            m = _host(batch["mass_gt"])
            out["bmi_hist_groups"] = bmi_hist_group(h, m)
            out["bmi_buckets"] = [bmi_bucket(hh, mm) for hh, mm in zip(h, m)]
        yield out


def gender_batch(images: torch.Tensor, model_batch: Optional[Dict]
                 ) -> torch.Tensor:
    """The model batch's ``gender`` codes (1 male, 2 female), zeros where
    it has none: the attribute plugins' routing, as the JAX package's
    ``model_fn`` passes it."""
    gender = (model_batch or {}).get("gender")
    if gender is None:
        return torch.zeros(images.shape[0], dtype=torch.int32,
                           device=images.device)
    return gender


def make_eval_fn(regressor, val_loaders: Dict,
                 exp_cfg: Optional[Dict] = None,
                 results_sink: Optional[Dict] = None, keypoint_names=None,
                 crop_size: int = 256, **evaluator_kwargs) -> Callable:
    """Returns ``eval_fn(step=0) -> {dataset: {metric: value}}``, which
    evaluates ``regressor`` with its weights at call time on the device
    its parameters lie on (in eval mode, then back in the mode it was
    in: the trainer's eval hook). Batches with ``crop_to_image_affines``
    go through ``apply_from_full_images`` (``crop_size`` crops), others
    through ``apply(images)``, each with the batch's ``gender`` for the
    attribute plugins. ``results_sink[step]`` (if given) records
    the history; ``evaluator_kwargs`` go to :func:`build_evaluator`."""
    device = regressor.param_mean.device
    evaluator = build_evaluator(exp_cfg or {}, keypoint_names=keypoint_names,
                                device=device, **evaluator_kwargs)
    last_stage = f"stage_{regressor.num_stages - 1:02d}"

    def model_fn(images, model_batch):
        batch = {"gender": gender_batch(images, model_batch)}
        affines = (model_batch or {}).get("crop_to_image_affines")
        if affines is not None:
            return regressor.apply_from_full_images(images, affines,
                                                    crop_size, batch=batch)
        return regressor.apply(images, batch=batch)

    def eval_fn(step: int = 0, **run_kwargs) -> Dict[str, Dict[str, float]]:
        """``run_kwargs`` go to ``Evaluator.run`` (e.g. ``on_batch``)."""
        was_training = regressor.training
        regressor.eval()
        try:
            results = evaluator.run(
                model_fn,
                {part: adapt_eval_batches(loader, device, crop_size)
                 for part, loader in val_loaders.items()},
                step=step, last_stage=last_stage, **run_kwargs)
        finally:
            regressor.train(was_training)
        for ds, metrics in results.items():
            pretty = {k: round(float(v), 5) for k, v in metrics.items()}
            logger.info("eval step %d [%s]: %s", step, ds, pretty)
        if results_sink is not None:
            results_sink[int(step)] = results
        return results

    eval_fn.evaluator = evaluator
    return eval_fn
