"""The SHAPY body regressor, eval forward (port of
``shapy_tpu/models/heads/regressor.py``).

HRNet-W48 features -> 3-stage iterative MLP head -> 6D pose decode ->
SMPL-X LBS on the last stage -> weak-perspective projection ->
measurements on ``v_shaped``. The flat parameter layout matches the JAX
package and the reference: pose spaces in order, then betas, then the
camera (global_rot 6 + body_pose 126 + betas 10 + camera 3 = 145).

``state_dict`` keys: ``backbone.*`` and ``head.*`` are the JAX package's
``params['backbone']`` / ``params['head']`` names, ``param_mean`` its
``params['param_mean']``; ``model.*`` the body model's params.

Ported so far: the SMPL-X regressor with the iterative MLP head,
``predict_hands`` and ``predict_face`` off (the flagship config). Not
yet: training and dropout, the RNN head, the ResNet backbone, the
B2A/A2B attribute plugins.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from shapy_tpu_torch.data.crop import crop_normalize
from shapy_tpu_torch.measure.measurements import BodyMeasurements
from shapy_tpu_torch.models.backbones.hrnet import HRNET_OUTPUT_DIM, HRNet
from shapy_tpu_torch.models.backbones.layers import fold_bn_
from shapy_tpu_torch.models.body.model import SMPLX
from shapy_tpu_torch.models.cameras.projection import build_cam_proj
from shapy_tpu_torch.models.heads.mlp import MLP
from shapy_tpu_torch.models.heads.pose_space import (
    BlendShapeSpace,
    PoseSpace,
    build_pose_parameterization,
    global_rot_mean_flipped,
)
from shapy_tpu_torch.utils.device import full_f32_matmul


class SMPLXRegressor(nn.Module):
    """HMR-style iterative regressor over SMPL-X."""

    def __init__(
        self,
        body_model: SMPLX,
        measurements: Optional[BodyMeasurements] = None,
        body_model_cfg: Optional[Dict] = None,
        network_cfg: Optional[Dict] = None,
        seed: int = 0,
    ):
        super().__init__()
        network_cfg = dict(network_cfg or {})
        model_cfg = dict((body_model_cfg or {}).get("smplx") or {})
        self.num_stages = int(network_cfg.get("num_stages", 3))
        mlp_cfg = dict(network_cfg.get("mlp") or {})
        for key, default, ported in (
                ("predict_hands", True, False), ("predict_face", True, False),
                ("pose_last_stage", True, True)):
            if bool(network_cfg.get(key, default)) != ported:
                raise ValueError(f"{key}={not ported} is not ported yet")
        if (mlp_cfg.get("activation") or {}).get("type", "none") not in (
                "none", "None"):
            raise ValueError("MLP activations are not ported yet")
        backbone_type = dict(network_cfg.get("backbone") or {}).get(
            "type", "hrnet")
        if backbone_type != "hrnet":
            raise ValueError(f"backbone not ported yet: {backbone_type}")
        if network_cfg.get("type", "iterative-mlp") not in (
                "iterative-mlp", "SMPLXRegressor"):
            raise ValueError("only the iterative-mlp head is ported")

        self.model = body_model
        self.body_measurements = measurements

        cam = build_cam_proj(network_cfg.get("camera"))
        self.projection = cam["camera"]
        self.camera_scale_func = cam["scale_func"]

        global_desc = build_pose_parameterization(
            1, **dict(model_cfg.get("global_rot") or {}))
        global_desc = PoseSpace(global_desc.num_angles, global_desc.param_type,
                                global_desc.dim,
                                global_rot_mean_flipped(global_desc),
                                global_desc.decoder)
        body_desc = build_pose_parameterization(
            body_model.NUM_BODY_JOINTS,
            **dict(model_cfg.get("body_pose") or {}))
        self.spaces: Dict[str, Any] = {
            "global_rot": global_desc,
            "body_pose": body_desc,
            "betas": BlendShapeSpace(
                body_model.num_betas,
                np.zeros(body_model.num_betas, np.float32)),
            "camera": BlendShapeSpace(cam["dim"], cam["mean"]),
        }
        self.param_slices: Dict[str, slice] = {}
        start = 0
        for name, desc in self.spaces.items():
            self.param_slices[name] = slice(start, start + desc.dim)
            start += desc.dim
        self.param_dim = start
        param_mean = np.concatenate(
            [np.asarray(d.mean, np.float32).reshape(-1)
             for d in self.spaces.values()])[None]

        gen = torch.Generator().manual_seed(seed)
        self.backbone = HRNet()
        self.backbone.init_weights_(gen)
        self.feat_dim = HRNET_OUTPUT_DIM
        self.head = MLP(
            self.feat_dim + self.param_dim, self.param_dim,
            tuple(mlp_cfg.get("layers", (1024, 1024))),
            gain=float(mlp_cfg.get("gain", 0.01)), generator=gen)
        self.register_buffer("param_mean", torch.as_tensor(param_mean))
        self.backbone_dtype = torch.float32

    def prepare_for_eval_(self, backbone_dtype: torch.dtype = torch.float32
                          ) -> "SMPLXRegressor":
        """Freeze for inference: eval mode, no gradients, BN folded into
        the convs, backbone in ``backbone_dtype`` and channels_last (its
        features are cast back to f32 for the head)."""
        self.eval()
        self.requires_grad_(False)
        fold_bn_(self.backbone)
        self.backbone.to(dtype=backbone_dtype,
                         memory_format=torch.channels_last)
        self.backbone_dtype = backbone_dtype
        return self

    # -- decode ------------------------------------------------------------
    def decode_params(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        out: Dict[str, torch.Tensor] = {}
        for name, sl in self.param_slices.items():
            val = flat[:, sl]
            desc = self.spaces[name]
            if isinstance(desc, PoseSpace):
                out[name] = desc.decoder(val)
                out[f"raw_{name}"] = val
            else:
                out[name] = val
        return out

    # -- forward -----------------------------------------------------------
    def compute_features(self, images: torch.Tensor) -> torch.Tensor:
        """images (B, H, W, 3) NHWC -> features (B, 2048) f32."""
        x = images.permute(0, 3, 1, 2).to(self.backbone_dtype)
        x = x.contiguous(memory_format=torch.channels_last)
        return self.backbone(x).float()

    def iterative_stages(self, features: torch.Tensor) -> List[torch.Tensor]:
        """Additive refinement from the mean parameters."""
        current = self.param_mean.expand(features.shape[0], -1)
        stages = []
        for _ in range(self.num_stages):
            current = current + self.head(torch.cat([features, current], -1))
            stages.append(current)
        return stages

    def apply(self, images: torch.Tensor) -> Dict[str, Any]:
        """images (B, H, W, 3) normalised crops (NHWC) -> the JAX
        package's output dict: ``features``, ``stage_XX`` (the last stage
        with ``vertices``, ``joints``, ``v_shaped``, decoded params),
        ``proj_joints``, ``camera_parameters``, ``measurements``."""
        features = self.compute_features(images)
        with full_f32_matmul():
            return self._apply_head(features)

    def _apply_head(self, features: torch.Tensor) -> Dict[str, Any]:
        """Head, body model (last stage only), camera and measurements,
        all in f32."""
        param_dicts = [self.decode_params(p)
                       for p in self.iterative_stages(features)]
        out: Dict[str, Any] = {"features": features}
        for i, decoded in enumerate(param_dicts):
            out[f"stage_{i:02d}"] = decoded
        last = param_dicts[-1]
        last.update(self.model(**{
            k: v for k, v in last.items()
            if not k.startswith("raw_") and k != "camera"}))

        cam = param_dicts[-1]["camera"]
        scale = self.camera_scale_func(cam[:, 0:1])
        translation = cam[:, 1:3]
        proj_joints = self.projection(last["joints"], scale, translation)
        out["camera_parameters"] = {
            "scale": scale, "translation": translation,
            "scale_first": self.projection.scale_first,
        }
        out["proj_joints"] = proj_joints
        last["proj_joints"] = proj_joints

        if self.body_measurements is not None:
            meas = self.body_measurements.forward_from_vertices(
                last["v_shaped"])["measurements"]
            meas_dict = {k: v["tensor"] for k, v in meas.items()}
            out["measurements"] = meas_dict
            last["measurements"] = meas_dict
        return out

    def apply_from_full_images(self, full_images: torch.Tensor,
                               crop_to_image_affines: torch.Tensor,
                               crop_size: int = 256, **norm) -> Dict[str, Any]:
        """Fused preprocessing + forward: full images (B, H, W, 3) uint8
        (or f32 in [0, 1]) + crop->image affines (B, 3, 3) are cropped,
        ImageNet-normalised and cast to the backbone's dtype (kernel K2
        on the card), then run through :meth:`apply`. ``norm`` may give
        ``mean`` / ``std``."""
        crops = crop_normalize(full_images, crop_to_image_affines, crop_size,
                               out_dtype=self.backbone_dtype, **norm)
        return self.apply(crops)

    def forward(self, images: torch.Tensor) -> Dict[str, Any]:
        return self.apply(images)
