"""Import the reference's full SHAPY model checkpoint into the port's
regressor (port of ``shapy_tpu/io/model_import.py``).

The released checkpoint is a regressor ``Checkpointer`` torch file,
``{'model': state_dict, ...}`` (a Lightning file's ``state_dict`` or a
bare state dict also load), whose state dict holds:

  backbone.*                    -> the regressor's ``backbone.*`` as they
                                   are: the port's names are the torch
                                   names and its convs are OIHW
                                   (``num_batches_tracked`` dropped)
  regressor.module.*            -> ``head.*``, where the head has the key
  regressor.mean_param          -> ``param_mean``, reshaped to (1, -1)
  model.* / body_measurements.* -> skipped (the body model's constants)

Keys the checkpoint lacks keep the regressor's own values. Load before
``prepare_for_eval_``, so that folding BN sees the imported statistics.
:mod:`shapy_tpu_torch.io.from_jax` carries the JAX package's weights; this
module carries the reference's.
"""

from __future__ import annotations

import logging
from typing import Dict

import torch
from torch import nn

from shapy_tpu_torch.models.backbones.layers import BatchNorm2d

logger = logging.getLogger(__name__)


def reference_state_dict(obj) -> Dict[str, torch.Tensor]:
    """The flat ``{name: tensor}`` of a loaded checkpoint: a Lightning
    file's ``state_dict``, a ``Checkpointer`` file's ``model``, or the
    object itself; entries that are not tensors are left out."""
    if isinstance(obj, dict):
        for key in ("state_dict", "model"):
            if isinstance(obj.get(key), dict):
                obj = obj[key]
                break
    return {k: v for k, v in obj.items() if isinstance(v, torch.Tensor)}


def load_reference_model_checkpoint(path: str, regressor: nn.Module
                                    ) -> nn.Module:
    """Copy the reference checkpoint at ``path`` into ``regressor`` (in
    place; returned). Every imported tensor must match its target's
    shape; backbone keys the regressor lacks are logged and skipped."""
    sd = reference_state_dict(torch.load(path, map_location="cpu"))
    backbone = {k[len("backbone."):]: v for k, v in sd.items()
                if k.startswith("backbone.")
                and not k.endswith("num_batches_tracked")}
    if backbone and not any(isinstance(m, BatchNorm2d)
                            for m in regressor.backbone.modules()):
        raise ValueError("load_reference_model_checkpoint: the backbone's "
                         "BN was folded; load before prepare_for_eval_")
    prefix = "regressor.module."
    head = {k[len(prefix):]: v for k, v in sd.items()
            if k.startswith(prefix)}

    targets = {**{f"backbone.{k}": v for k, v in backbone.items()},
               **{f"head.{k}": v for k, v in head.items()}}
    own = regressor.state_dict()
    skipped = [k for k in targets
               if k not in own and not k.startswith("head.")]
    if skipped:
        logger.warning("Checkpoint keys the regressor lacks: %d (%s)",
                       len(skipped), ", ".join(skipped[:8]))
    with torch.no_grad():
        for name, value in targets.items():
            if name not in own:
                continue
            if own[name].shape != value.shape:
                raise ValueError(f"{name}: checkpoint shape "
                                 f"{tuple(value.shape)}, regressor "
                                 f"{tuple(own[name].shape)}")
            own[name].copy_(value)
        if "regressor.mean_param" in sd:
            mean = sd["regressor.mean_param"].reshape(1, -1)
            if mean.shape != regressor.param_mean.shape:
                raise ValueError(f"regressor.mean_param: checkpoint shape "
                                 f"{tuple(mean.shape)}, param_mean "
                                 f"{tuple(regressor.param_mean.shape)}")
            regressor.param_mean.copy_(mean)
    return regressor
