"""The SHAPY body regressor family, eval and train forward (port of
``shapy_tpu/models/heads/regressor.py``).

HRNet-W48 (or ResNet-18/34/50/101/152, ``backbone: {type: resnet,
depth: d}``) features -> 3-stage iterative MLP head -> 6D pose decode ->
body model LBS on the last stage -> weak-perspective projection ->
measurements on ``v_shaped``. :class:`BodyRegressor` is the family's
base; :class:`SMPLRegressor`, :class:`SMPLHRegressor` and
:class:`SMPLXRegressor` put SMPL (23 body joints), SMPL+H or SMPL-X (21)
under it, and :func:`build_body_head` builds one from a config's
``network.type`` through :data:`BODY_HEAD_REGISTRY`. The flat parameter
layout matches the JAX package and the reference: pose spaces in order,
then betas, then the camera (SMPL-X: global_rot 6 + body_pose 126 +
betas 10 + camera 3 = 145).

The body config's ``mean_pose_path`` (a latin1 pickle whose
``body_pose`` entry, an array or a dict keyed by the parameterisation,
seeds the body-pose mean) and ``shape_mean_path`` (an ``.npy`` of the
betas' mean) are read as the JAX package reads them; a path to no file
is ignored.

``state_dict`` keys: ``backbone.*`` and ``head.*`` are the JAX package's
``params['backbone']`` / ``params['head']`` names, ``param_mean`` its
``params['param_mean']``; ``model.*`` the body model's params.

Modes: :meth:`BodyRegressor.prepare_for_eval_` folds BN and freezes;
:meth:`BodyRegressor.prepare_for_train_` keeps BN unfolded (train-mode
BN, kernel K4 on the card) with f32 master weights, and ``apply(...,
train=True)`` adds the head's dropout and measures on all faces.

Not yet ported, and refused with ``ValueError`` where a config asks for
them: hand and face prediction (``predict_hands`` on SMPL+H / SMPL-X,
``predict_face`` on SMPL-X), MLP activations, the RNN head, HRNet's
``use_old_impl`` topology, ``pose_last_stage`` off, pose spaces other
than ``cont_rot_repr``.

The frozen attribute plugins (``b2a_models`` / ``a2b_models``: a
``{'male': ..., 'female': ...}`` pair of
:class:`~shapy_tpu_torch.models.attributes.b2a.B2A` /
:class:`~shapy_tpu_torch.models.attributes.a2b.A2B`) run where ``apply``'s
``batch`` holds ``gender`` (1 male, 2 female, other rows zero): B2A puts
``attributes`` in the output, A2B ``betas_ref`` and ``v_shaped_ref`` in
the last stage. They are not submodules (no ``state_dict`` entry, no
optimizer state, always eval mode, no gradient of their own), but they
move with the regressor's ``.to``, and gradients flow through them into
the head. They launch no kernel: A2B reads this forward's K1 height and
mass, and ``forward_shape`` is a blend-shape product.
``compute_measurements`` builds the measurements from the reference's
YAMLs when none are given, as the JAX package does.
"""

from __future__ import annotations

import inspect
import os
import pickle
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from shapy_tpu_torch.data.crop import crop_normalize
from shapy_tpu_torch.measure.measurements import BodyMeasurements
from shapy_tpu_torch.models.backbones.hrnet import HRNET_OUTPUT_DIM, HRNet
from shapy_tpu_torch.models.backbones.layers import BatchNorm2d, fold_bn_
from shapy_tpu_torch.models.backbones.resnet import RESNET_FEAT_DIM, ResNet
from shapy_tpu_torch.models.body.model import SMPL, MODEL_CLASSES
from shapy_tpu_torch.models.cameras.projection import build_cam_proj
from shapy_tpu_torch.models.heads.mlp import MLP
from shapy_tpu_torch.models.heads.pose_space import (
    BlendShapeSpace,
    PoseSpace,
    build_pose_parameterization,
    global_rot_mean_flipped,
)
from shapy_tpu_torch.utils.device import full_f32_matmul


def _build_body_model(model_type: str, model_cfg: Dict, model_folder: str
                      ) -> SMPL:
    """The body model of ``model_type`` from its config section; keys its
    class does not take (``betas``, ``global_rot`` ...) are ignored, as
    the JAX package's models ignore them."""
    cls = MODEL_CLASSES[model_type]
    accepted = set()
    for klass in cls.__mro__:
        if klass is nn.Module:
            break
        accepted |= set(inspect.signature(klass.__init__).parameters)
    kwargs = {k: v for k, v in model_cfg.items() if k in accepted}
    return cls(model_folder=os.path.expandvars(model_folder), **kwargs)


class BodyRegressor(nn.Module):
    """HMR-style iterative regressor over the body model of
    ``MODEL_TYPE``; ``body_model`` None builds it from ``body_model_cfg``
    (its ``MODEL_TYPE`` section and ``model_folder``)."""

    MODEL_TYPE = "smpl"
    # (config key, default, the value the port supports)
    PORTED_OPTIONS = (("pose_last_stage", True, True),)

    def __init__(
        self,
        body_model: Optional[SMPL] = None,
        measurements: Optional[BodyMeasurements] = None,
        body_model_cfg: Optional[Dict] = None,
        network_cfg: Optional[Dict] = None,
        seed: int = 0,
        b2a_models: Optional[Dict[str, Any]] = None,
        a2b_models: Optional[Dict[str, Any]] = None,
    ):
        super().__init__()
        network_cfg = dict(network_cfg or {})
        body_model_cfg = dict(body_model_cfg or {})
        model_cfg = dict(body_model_cfg.get(self.MODEL_TYPE) or {})
        self.curr_model_cfg = model_cfg
        self.num_stages = int(network_cfg.get("num_stages", 3))
        mlp_cfg = dict(network_cfg.get("mlp") or {})
        for key, default, ported in self.PORTED_OPTIONS:
            if bool(network_cfg.get(key, default)) != ported:
                raise ValueError(f"{key}={not ported} is not ported yet")
        if (mlp_cfg.get("activation") or {}).get("type", "none") not in (
                "none", "None"):
            raise ValueError("MLP activations are not ported yet")
        backbone_cfg = dict(network_cfg.get("backbone") or {})
        self.backbone_type = backbone_cfg.get("type", "hrnet")
        if self.backbone_type not in ("hrnet", "resnet"):
            raise ValueError(f"backbone not ported yet: {self.backbone_type}")
        if self.backbone_type == "hrnet" and bool(
                dict(backbone_cfg.get("hrnet") or {}).get(
                    "use_old_impl", backbone_cfg.get("use_old_impl", False))):
            raise ValueError("HRNet's use_old_impl topology is not ported yet")
        if network_cfg.get("type", "iterative-mlp") not in (
                "iterative-mlp", *BODY_HEAD_REGISTRY):
            raise ValueError("only the iterative-mlp head is ported")

        if body_model is None:
            body_model = _build_body_model(
                self.MODEL_TYPE, model_cfg,
                str(body_model_cfg.get("model_folder", "")))
        self.model = body_model
        self.mean_poses_dict = self._load_mean_poses()
        if measurements is None and network_cfg.get("compute_measurements",
                                                    False):
            measurements = BodyMeasurements(
                None, body_model.faces, model_type=body_model.NAME,
                meas_definition_path=network_cfg.get("meas_definition_path"),
                meas_vertices_path=network_cfg.get("meas_vertices_path"))
        self.body_measurements = measurements

        cam = build_cam_proj(network_cfg.get("camera"))
        self.projection = cam["camera"]
        self.camera_scale_func = cam["scale_func"]

        self.spaces: Dict[str, Any] = {
            **self._build_pose_space(),
            **self._build_blendshape_space(),
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
        if self.backbone_type == "hrnet":
            self.backbone = HRNet()
            self.feat_dim = HRNET_OUTPUT_DIM
        else:
            depth = int(backbone_cfg.get("depth", 50))
            self.backbone = ResNet(depth)
            self.feat_dim = RESNET_FEAT_DIM[depth]
        self.backbone.init_weights_(gen)
        self.head = MLP(
            self.feat_dim + self.param_dim, self.param_dim,
            tuple(mlp_cfg.get("layers", (1024, 1024))),
            gain=float(mlp_cfg.get("gain", 0.01)), generator=gen,
            dropout=float(mlp_cfg.get("dropout", 0.0)))
        self.register_buffer("param_mean", torch.as_tensor(param_mean))
        self.backbone_dtype = torch.float32
        self.num_attributes = int(network_cfg.get("num_attributes", 15))
        self.attach_plugins_(b2a_models, a2b_models)

    def attach_plugins_(self, b2a_models: Optional[Dict[str, Any]] = None,
                        a2b_models: Optional[Dict[str, Any]] = None
                        ) -> "BodyRegressor":
        """Set the frozen attribute plugins (empty: none), in eval mode
        and without gradients of their own, on the regressor's device."""
        self.b2a_models = dict(b2a_models or {})
        self.a2b_models = dict(a2b_models or {})
        device = self.param_mean.device
        for plugin in self._plugins():
            plugin.eval().requires_grad_(False).to(device)
        return self

    def _plugins(self) -> List[nn.Module]:
        return [*self.b2a_models.values(), *self.a2b_models.values()]

    def _apply(self, fn, recurse: bool = True):
        """``.to`` / ``.cuda`` / ... reach the attribute plugins too."""
        super()._apply(fn, recurse)
        for plugin in self._plugins():
            plugin._apply(fn, recurse)
        return self

    # -- space builders (extended per model family) ------------------------
    def _load_mean_poses(self) -> Dict[str, Any]:
        path = os.path.expandvars(
            str(self.curr_model_cfg.get("mean_pose_path", "")))
        if path and os.path.exists(path):
            with open(path, "rb") as f:
                return pickle.load(f, encoding="latin1")
        return {}

    def _build_pose_space(self) -> Dict[str, PoseSpace]:
        global_desc = build_pose_parameterization(
            1, **dict(self.curr_model_cfg.get("global_rot") or {}))
        global_desc = PoseSpace(global_desc.num_angles, global_desc.param_type,
                                global_desc.dim,
                                global_rot_mean_flipped(global_desc),
                                global_desc.decoder)
        body_desc = build_pose_parameterization(
            self.model.NUM_BODY_JOINTS,
            mean=self.mean_poses_dict.get("body_pose"),
            **dict(self.curr_model_cfg.get("body_pose") or {}))
        return {"global_rot": global_desc, "body_pose": body_desc}

    def _build_blendshape_space(self) -> Dict[str, BlendShapeSpace]:
        num_betas = self.model.num_betas
        mean = np.zeros(num_betas, np.float32)
        path = os.path.expandvars(
            str(self.curr_model_cfg.get("shape_mean_path", "")))
        if path and os.path.exists(path):
            mean = np.load(path, allow_pickle=True).reshape(-1)[
                :num_betas].astype(np.float32)
        return {"betas": BlendShapeSpace(num_betas, mean)}

    def prepare_for_eval_(self, backbone_dtype: torch.dtype = torch.float32
                          ) -> "BodyRegressor":
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

    def prepare_for_train_(self, backbone_dtype: torch.dtype = torch.float32
                           ) -> "BodyRegressor":
        """Train mode: BN unfolded (batch moments and running-stat EMA),
        the head's dropout on, f32 master weights with the backbone's
        convs and BN in ``backbone_dtype`` and channels_last; the head,
        body model and measurements stay f32."""
        if not any(isinstance(m, BatchNorm2d)
                   for m in self.backbone.modules()):
            raise ValueError("prepare_for_train_: the backbone's BN was "
                             "folded for eval")
        self.train()
        self.backbone.to(memory_format=torch.channels_last)
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
        """images (B, H, W, 3) NHWC -> features (B, feat_dim) f32: HRNet's,
        or a ResNet's ``avg_pooling``."""
        x = images.permute(0, 3, 1, 2).to(self.backbone_dtype)
        x = x.contiguous(memory_format=torch.channels_last)
        feats = self.backbone(x)
        if self.backbone_type == "resnet":
            feats = feats["avg_pooling"]
        return feats.float()

    def iterative_stages(self, features: torch.Tensor,
                         generator: Optional[torch.Generator] = None
                         ) -> List[torch.Tensor]:
        """Additive refinement from the mean parameters."""
        current = self.param_mean.expand(features.shape[0], -1)
        stages = []
        for _ in range(self.num_stages):
            current = current + self.head(torch.cat([features, current], -1),
                                          generator)
            stages.append(current)
        return stages

    def apply(self, images: torch.Tensor,
              batch: Optional[Dict[str, torch.Tensor]] = None,
              train: bool = False,
              generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        """images (B, H, W, 3) normalised crops (NHWC) -> the JAX
        package's output dict: ``features``, ``stage_XX`` (the last stage
        with ``vertices``, ``joints``, ``v_shaped``, decoded params),
        ``proj_joints``, ``camera_parameters``, ``measurements``.

        ``train`` must match the module's mode (``prepare_for_train_`` /
        ``prepare_for_eval_``); in training ``generator`` draws the head's
        dropout masks and the measurements walk all faces. ``batch``
        (``gender``, and for A2B ``attributes``, ``height``, ``weight``)
        feeds the attribute plugins."""
        if train != self.training:
            raise ValueError(f"apply(train={train}) on a regressor in "
                             f"{'train' if self.training else 'eval'} mode")
        features = self.compute_features(images)
        with full_f32_matmul():
            return self._apply_head(features, train, generator, batch)

    def _apply_head(self, features: torch.Tensor, train: bool = False,
                    generator: Optional[torch.Generator] = None,
                    batch: Optional[Dict[str, torch.Tensor]] = None
                    ) -> Dict[str, Any]:
        """Head, body model (last stage only), camera, measurements and
        the attribute plugins, all in f32."""
        param_dicts = [self.decode_params(p)
                       for p in self.iterative_stages(features, generator)]
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
            # Candidate-face subsets only in eval: they are exact inside
            # the beta bound they were built for, which training may leave.
            meas = self.body_measurements.forward_from_vertices(
                last["v_shaped"], use_face_subsets=not train)["measurements"]
            meas_dict = {k: v["tensor"] for k, v in meas.items()}
            out["measurements"] = meas_dict
            last["measurements"] = meas_dict
        if batch is not None and "gender" in batch:
            gender = batch["gender"].reshape(-1).to(features.device)
            if self.b2a_models:
                out["attributes"] = self._by_gender(
                    gender, *(self.b2a_models[g](last["betas"])
                              for g in ("male", "female")))
            if self.a2b_models and self.body_measurements is not None:
                betas_ref = self._refined_betas(gender, batch, meas_dict)
                last["betas_ref"] = betas_ref
                last["v_shaped_ref"] = self.model.forward_shape(
                    betas_ref)["v_shaped"]
        return out

    @staticmethod
    def _by_gender(gender: torch.Tensor, male: torch.Tensor,
                   female: torch.Tensor) -> torch.Tensor:
        """Row i from ``male`` where gender is 1, ``female`` where 2, else
        zeros."""
        return torch.where((gender == 1)[:, None], male,
                           torch.where((gender == 2)[:, None], female,
                                       torch.zeros_like(male)))

    def _refined_betas(self, gender: torch.Tensor, batch: Dict,
                       meas: Dict[str, torch.Tensor]) -> torch.Tensor:
        """A2B's betas from the batch's ``attributes`` (zeros where
        absent), ``height`` / ``weight`` (each gender's population mean
        where absent) and this forward's measured height and mass."""
        B = gender.shape[0]
        ref = meas["height"]

        def given(key, fill):
            if key in batch:
                return batch[key].reshape(-1).to(ref)
            return ref.new_full((B,), fill)

        attr = (batch["attributes"].to(ref) if "attributes" in batch
                else ref.new_zeros((B, self.num_attributes)))
        betas = []
        for g, height, weight in (("male", 1.71, 71.0),
                                  ("female", 1.59, 62.0)):
            model = self.a2b_models[g]
            feats = model.create_input_feature_vec_tensor({
                "rating": attr, "height_gt": given("height", height),
                "weight_gt": given("weight", weight),
                "height_bg": meas["height"], "weight_bg": meas["mass"]})
            betas.append(model.a2b(feats))
        return self._by_gender(gender, *betas)

    def apply_from_full_images(self, full_images: torch.Tensor,
                               crop_to_image_affines: torch.Tensor,
                               crop_size: int = 256,
                               batch: Optional[Dict[str, torch.Tensor]] = None,
                               **norm) -> Dict[str, Any]:
        """Fused preprocessing + forward: full images (B, H, W, 3) uint8
        (or f32 in [0, 1]) + crop->image affines (B, 3, 3) are cropped,
        ImageNet-normalised and cast to the backbone's dtype (kernel K2
        on the card), then run through :meth:`apply` with ``batch``.
        ``norm`` may give ``mean`` / ``std``."""
        crops = crop_normalize(full_images, crop_to_image_affines, crop_size,
                               out_dtype=self.backbone_dtype, **norm)
        return self.apply(crops, batch=batch)

    def forward(self, images: torch.Tensor) -> Dict[str, Any]:
        return self.apply(images)


class SMPLRegressor(BodyRegressor):
    MODEL_TYPE = "smpl"


class SMPLHRegressor(BodyRegressor):
    """SMPL+H; its hand spaces (``predict_hands``) are not ported yet."""

    MODEL_TYPE = "smplh"
    PORTED_OPTIONS = BodyRegressor.PORTED_OPTIONS + (
        ("predict_hands", True, False),)


class SMPLXRegressor(SMPLHRegressor):
    """SMPL-X; its jaw and expression spaces (``predict_face``) are not
    ported yet."""

    MODEL_TYPE = "smplx"
    PORTED_OPTIONS = SMPLHRegressor.PORTED_OPTIONS + (
        ("predict_face", True, False),)


BODY_HEAD_REGISTRY = {
    "SMPLRegressor": SMPLRegressor,
    "SMPLHRegressor": SMPLHRegressor,
    "SMPLXRegressor": SMPLXRegressor,
}


def build_body_head(cfg: Dict, **kwargs) -> BodyRegressor:
    """The regressor of ``cfg['network']['type']`` (default
    ``SMPLXRegressor``), its network config from the section of its model
    type (``network.smplx`` ...), its body config ``cfg['body_model']``;
    ``kwargs`` (``body_model``, ``measurements``, ``seed``,
    ``b2a_models``, ``a2b_models``) go to the class."""
    network_cfg = dict(cfg.get("network") or {})
    head_type = network_cfg.get("type", "SMPLXRegressor")
    if head_type not in BODY_HEAD_REGISTRY:
        raise ValueError(f"Unknown body head: {head_type}")
    head = BODY_HEAD_REGISTRY[head_type]
    return head(
        body_model_cfg=dict(cfg.get("body_model") or {}),
        network_cfg=dict(network_cfg.get(head.MODEL_TYPE) or {}),
        **kwargs)
