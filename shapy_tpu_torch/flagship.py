"""The flagship model: the port's counterpart of
``__graft_entry__._build_flagship``.

SHAPY regressor = HRNet-W48 + 3-stage iterative MLP head (6D pose) +
SMPL-X (synthetic assets from a seed) + measurements with K=256 hull
directions on candidate-face subsets, weak-perspective camera with
softplus scale.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from shapy_tpu.data.crop import crop_to_image_affine
from shapy_tpu_torch.measure.measurements import (
    BodyMeasurements,
    MeasurementAnchors,
    candidate_faces,
)
from shapy_tpu_torch.models.backbones.layers import BasicBlock, Bottleneck
from shapy_tpu_torch.models.body.assets import make_synthetic_model_data
from shapy_tpu_torch.models.body.model import SMPLX
from shapy_tpu_torch.models.heads.regressor import SMPLXRegressor
from shapy_tpu_torch.utils.device import get_device

FLAGSHIP_NETWORK_CFG = {
    "num_stages": 3,
    "predict_hands": False,
    "predict_face": False,
    "backbone": {"type": "hrnet"},
    "camera": {"type": "weak-persp", "pos_func": "softplus"},
}
FLAGSHIP_BODY_CFG = {
    "smplx": {
        "global_rot": {"param_type": "cont_rot_repr"},
        "body_pose": {"param_type": "cont_rot_repr"},
    }
}


def build_flagship(subdivisions: int = 2, exact_counts: bool = False,
                   mlp_layers: Sequence[int] = (1024, 1024),
                   device: str | torch.device = "cpu", seed: int = 0,
                   num_hull_directions: int = 256) -> SMPLXRegressor:
    """The flagship regressor on ``device``, weights initialised as the
    JAX package initialises them, drawn from ``seed``. Call
    ``prepare_for_eval_`` on it before serving."""
    device = get_device(device)
    model = SMPLX(make_synthetic_model_data(
        "smplx", subdivisions=subdivisions, exact_counts=exact_counts))
    v_template = model.v_template.numpy()
    anchors = MeasurementAnchors.synthetic(model.faces, v_template)
    meas = BodyMeasurements(
        anchors, model.faces, num_hull_directions=num_hull_directions,
        face_subsets=candidate_faces(
            v_template, model.shapedirs.numpy(), model.faces, anchors))
    network_cfg = dict(FLAGSHIP_NETWORK_CFG,
                       mlp={"layers": list(mlp_layers), "dropout": 0.5})
    return SMPLXRegressor(model, meas, FLAGSHIP_BODY_CFG, network_cfg,
                          seed=seed).to(device)


@torch.no_grad()
def spread_init_(regressor: SMPLXRegressor, seed: int,
                 beta_scale: float = 1.0) -> SMPLXRegressor:
    """Re-draw the backbone and the head's betas outputs so that random
    weights give image-dependent predictions (the JAX init's 0.001-std
    convs make the features vanish). Convs are He-normal; the last conv of
    every residual branch is scaled by 0.1 and every fuse-layer conv by
    0.25, so activations neither vanish nor grow over the network's depth.
    The betas rows of the output layer are normal with std ``beta_scale /
    sqrt(fan_in)``. Call before ``prepare_for_eval_``."""
    gen = torch.Generator().manual_seed(seed)
    for name, m in regressor.backbone.named_modules():
        if isinstance(m, torch.nn.Conv2d):
            std = math.sqrt(2.0 / m.weight[0].numel())
            if "fuse_layers" in name:
                std *= 0.25
            m.weight.copy_(torch.randn(m.weight.shape, generator=gen) * std)
    for m in regressor.backbone.modules():
        if isinstance(m, BasicBlock):
            m.conv2.weight.mul_(0.1)
        elif isinstance(m, Bottleneck):
            m.conv3.weight.mul_(0.1)
    out = regressor.head.output_layer
    sl = regressor.param_slices["betas"]
    out.weight[sl] = torch.randn(out.weight[sl].shape, generator=gen) * (
        beta_scale / math.sqrt(out.weight.shape[1]))
    return regressor


def synthetic_requests(batch: int, height: int, width: int, crop_size: int,
                       seed: int) -> tuple[np.ndarray, np.ndarray]:
    """uint8 full images (B, H, W, 3) of smooth random content and
    crop->image affines (B, 3, 3): a box around the centre, randomly
    scaled, shifted and rotated so that some crops leave the image."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    images = np.empty((batch, height, width, 3), np.uint8)
    affines = np.empty((batch, 3, 3), np.float32)
    for b in range(batch):
        f = rng.uniform(0.01, 0.05, size=(3, 2))
        ph = rng.uniform(0, 2 * np.pi, size=3)
        img = 127.5 + 127.5 * np.sin(
            xx[..., None] * f[:, 0] + yy[..., None] * f[:, 1] + ph)
        images[b] = np.clip(img + rng.normal(0, 8, img.shape), 0, 255)
        center = (width * rng.uniform(0.4, 0.6),
                  height * rng.uniform(0.4, 0.6))
        scale = min(height, width) * rng.uniform(0.6, 1.2) / 200.0
        affines[b] = crop_to_image_affine(center, scale,
                                          (crop_size, crop_size),
                                          rot_deg=rng.uniform(-30, 30))
    return images, affines
