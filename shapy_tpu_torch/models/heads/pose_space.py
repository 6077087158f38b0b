"""Pose / blend-shape parameter spaces (port of
``shapy_tpu/models/heads/pose_space.py``; the ``cont_rot_repr`` space
that the flagship uses)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from shapy_tpu_torch.core.rotations import rot6d_to_rotmat

IDENTITY_6D = np.asarray([1.0, 0.0, 0.0, 1.0, 0.0, 0.0], np.float32)


@dataclass(frozen=True)
class PoseSpace:
    """One pose group: raw dim, mean, and decoder to (B, J, 3, 3)."""

    num_angles: int
    param_type: str
    dim: int
    mean: np.ndarray
    decoder: Callable[[torch.Tensor], torch.Tensor]


@dataclass(frozen=True)
class BlendShapeSpace:
    dim: int
    mean: np.ndarray


def _tile_mean(mean, num_angles: int, per_joint: int,
               default: np.ndarray) -> np.ndarray:
    """Broadcast / trim a provided mean to ``num_angles`` joints."""
    if mean is None:
        return np.tile(default, num_angles).astype(np.float32)
    m = np.asarray(mean, np.float32).reshape(-1, per_joint)
    if m.shape[0] < num_angles:
        m = np.tile(m, (num_angles // m.shape[0] + 1, 1))
    return m[:num_angles].reshape(-1)


def build_pose_parameterization(num_angles: int,
                                param_type: str = "cont_rot_repr",
                                mean=None, **kwargs) -> PoseSpace:
    """``mean``: an array, or a dict keyed by the parameterisation (a mean
    pose file's entry; its ``cont_rot_repr`` array where ``param_type``
    has none). Other keywords of a config section (``type`` ...) are
    ignored, as the JAX package ignores them."""
    if isinstance(mean, dict):
        mean = mean.get(param_type, mean.get("cont_rot_repr"))
    if param_type == "cont_rot_repr":
        def decoder(x: torch.Tensor) -> torch.Tensor:
            return rot6d_to_rotmat(x.reshape(x.shape[0], num_angles, 6))

        return PoseSpace(num_angles, param_type, num_angles * 6,
                         _tile_mean(mean, num_angles, 6, IDENTITY_6D),
                         decoder)
    raise ValueError(f"pose parameterization not ported: {param_type}")


def global_rot_mean_flipped(space: PoseSpace) -> np.ndarray:
    """The 180-degree-about-x global-orientation mean: the 6D second
    column's y component = -1."""
    mean = np.array(space.mean, copy=True)
    mean[3] = -1.0
    return mean
