"""Weak-perspective camera (port of
``shapy_tpu/models/cameras/projection.py``; the perspective camera is
not ported yet).

The reference's quirk is kept: scale applies AFTER adding the image-plane
translation unless ``scale_first``. The positive-scale function
(softplus / exp / none) is applied to the raw camera parameter by the
caller, and the camera mean is the pre-image of ``mean_scale`` under it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class WeakPerspectiveCamera:
    scale_first: bool = False

    def __call__(self, points: torch.Tensor, scale: torch.Tensor,
                 translation: torch.Tensor) -> torch.Tensor:
        """points (B, N, 3), scale (B, 1), translation (B, 2) -> (B, N, 2)."""
        s = scale.reshape(-1, 1, 1)
        t = translation.reshape(-1, 1, 2)
        if self.scale_first:
            return s * points[..., :2] + t
        return s * (points[..., :2] + t)


_SCALE_FUNCS = {
    "softplus": F.softplus,
    "exp": torch.exp,
    "none": lambda x: x,
}


def build_cam_proj(camera_cfg: Optional[Dict] = None) -> Dict:
    """Camera, mean, positive-scale function and dim."""
    cfg = dict(camera_cfg or {})
    cam_type = cfg.get("type", "weak-persp").lower()
    pos_func = str(cfg.get("pos_func", "softplus")).lower()
    if pos_func not in _SCALE_FUNCS:
        raise ValueError(f"Unknown positive scaling function: {pos_func}")
    if cam_type != "weak-persp":
        raise ValueError(f"camera type not ported: {cam_type}")
    wp = dict(cfg.get("weak_persp") or {})
    mean_scale = float(wp.get("mean_scale", 0.9))
    if pos_func == "softplus":
        mean_scale = float(np.log(np.expm1(mean_scale)))
    elif pos_func == "exp":
        mean_scale = float(np.log(mean_scale))
    return {
        "camera": WeakPerspectiveCamera(
            scale_first=bool(wp.get("scale_first", False))),
        "mean": np.asarray([mean_scale, 0.0, 0.0], np.float32),
        "scale_func": _SCALE_FUNCS[pos_func],
        "dim": 3,
    }
