"""The flagship model: the port's counterpart of
``__graft_entry__._build_flagship``.

SHAPY regressor = HRNet-W48 + 3-stage iterative MLP head (6D pose) +
SMPL-X (synthetic assets from a seed) + measurements with K=256 hull
directions on candidate-face subsets, weak-perspective camera with
softplus scale. ``build_flagship(backbone="resnet50")`` (or any depth of
``RESNET_LAYERS``) puts a ResNet in HRNet's place, as the JAX regressor's
``backbone: {type: resnet, depth: d}`` does.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from shapy_tpu_torch.core.rotations import aa_to_rotmat
from shapy_tpu_torch.data.crop import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    crop_to_image_affine,
)
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
# The loss terms of configs/train_shapy.yaml that need no files (the
# gender-shape prior needs stats files, the attributes the B2A plugin; the
# measurement weights are 0) and its optimizer.
FLAGSHIP_TRAIN_LOSS_CFG = {"body": {
    "stages_to_penalize": ["stage_02"],
    "body_joints_2d": {"type": "keypoints", "norm_type": "l1",
                       "weight": 1.0},
    "body_joints_3d": {"norm_type": "l1", "weight": 1.0},
    "shape": {"weight": 1e-3},
    "global_rot": {"type": "rotation", "weight": 1.0},
    "body_pose": {"type": "rotation", "weight": 1.0},
    **{k: {"weight": 0.0} for k in ("height", "chest", "waist", "hips")},
}}
FLAGSHIP_OPTIM_CFG = {"type": "adam", "lr": 1e-4, "weight_decay": 1e-4,
                      "scheduler": {"type": "multi-step-lr", "gamma": 0.1,
                                    "milestones": [60000, 100000]},
                      "adam": {"betas": [0.9, 0.999]}}
# The reference config's metric sets (v2v over procrustes / scale /
# translation, v2v_t over scale / translation, mpjpe root + procrustes;
# mpjpe14 roots on the hips [2, 3]).
REFERENCE_EVAL_CFG = {"evaluation": {"body": {
    "v2v": ["procrustes", "scale", "translation"],
    "v2v_t": ["scale", "translation"],
    "mpjpe": {"alignments": ["root", "procrustes"]},
}}}


def backbone_cfg(backbone: str) -> dict:
    """The network config's ``backbone`` entry for ``"hrnet"`` (HRNet-W48)
    or ``"resnet<depth>"`` (``"resnet18"``, ``"resnet50"`` ...)."""
    if backbone == "hrnet":
        return {"type": "hrnet"}
    depth = backbone[len("resnet"):]
    if not backbone.startswith("resnet") or not depth.isdigit():
        raise ValueError(f"unknown backbone {backbone!r}: 'hrnet' or "
                         "'resnet<depth>'")
    return {"type": "resnet", "depth": int(depth)}


def build_flagship_body(subdivisions: int = 2, exact_counts: bool = False,
                        num_hull_directions: int = 256
                        ) -> tuple[SMPLX, BodyMeasurements]:
    """The flagship's body on the CPU: the synthetic SMPL-X
    (``exact_counts``: the release's 10475 vertices / 20908 faces) and its
    measurement module, synthetic anchors with ``num_hull_directions``
    hull directions on the candidate-face subsets."""
    model = SMPLX(make_synthetic_model_data(
        "smplx", subdivisions=subdivisions, exact_counts=exact_counts))
    v_template = model.v_template.numpy()
    anchors = MeasurementAnchors.synthetic(model.faces, v_template)
    meas = BodyMeasurements(
        anchors, model.faces, num_hull_directions=num_hull_directions,
        face_subsets=candidate_faces(
            v_template, model.shapedirs.numpy(), model.faces, anchors))
    return model, meas


def build_flagship(subdivisions: int = 2, exact_counts: bool = False,
                   mlp_layers: Sequence[int] = (1024, 1024),
                   device: str | torch.device = "cuda", seed: int = 0,
                   num_hull_directions: int = 256,
                   backbone: str = "hrnet") -> SMPLXRegressor:
    """The flagship regressor on ``device``, weights initialised as the
    JAX package initialises them, drawn from ``seed``, on ``backbone``
    (:func:`backbone_cfg`). Call ``prepare_for_eval_`` on it before
    serving."""
    device = get_device(device)
    model, meas = build_flagship_body(subdivisions, exact_counts,
                                      num_hull_directions)
    network_cfg = dict(FLAGSHIP_NETWORK_CFG,
                       mlp={"layers": list(mlp_layers), "dropout": 0.5},
                       backbone=backbone_cfg(backbone))
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


def synthetic_eval_data(regressor: SMPLXRegressor, num_batches: int,
                        batch: int, height: int, width: int, crop_size: int,
                        seed: int, p2p_points: int = 20000) -> dict:
    """Synthetic HBW-style evaluation data on the regressor's device.

    Returns ``batches``, the collate output that
    ``eval.loop.adapt_eval_batches`` consumes (uint8 full images and crop
    affines from :func:`synthetic_requests`; GT ``v_shaped`` and posed
    ``vertices`` / ``joints3d`` of SMPL-X bodies with ||beta|| <= 6 and
    random body poses; GT measurements from K1 on all faces, as the HBW
    dataset precomputes them; ``joints14`` through the J14 regressor with
    one sample per batch marked invalid; genders), ``p2p``, a
    :class:`SparsePointRegressor` of ``p2p_points`` surface points with
    barycentric weights on random faces (the P2P-20k regressor's shape),
    and ``j14``, a (14, V) regressor mixing 8 random vertices per joint.
    Everything is drawn from ``seed`` with numpy."""
    from shapy_tpu_torch.eval.metrics import SparsePointRegressor

    rng = np.random.default_rng(seed)
    model, meas = regressor.model, regressor.body_measurements
    dev = regressor.param_mean.device
    faces, V = model.faces, model.num_verts
    tri = faces[rng.integers(0, len(faces), size=p2p_points)]
    w = rng.dirichlet(np.ones(3), size=p2p_points)
    p2p = SparsePointRegressor(tri, w, device=dev)
    j14 = np.zeros((14, V), np.float32)
    for j in range(14):
        cols = rng.choice(V, size=8, replace=False)
        ww = rng.uniform(size=8)
        j14[j, cols] = ww / ww.sum()
    j14_t = torch.from_numpy(j14).to(dev)
    names = ("female", "male", "neutral")
    batches = []
    for i in range(num_batches):
        betas = rng.normal(size=(batch, model.num_betas)) * 1.5
        betas *= np.minimum(1.0, 6.0 / np.linalg.norm(betas, axis=1,
                                                      keepdims=True))
        pose = rng.normal(size=(batch, model.NUM_BODY_JOINTS, 3)) * 0.2
        with torch.inference_mode():
            gt = model(betas=torch.tensor(betas, dtype=torch.float32,
                                          device=dev),
                       body_pose=torch.tensor(pose, dtype=torch.float32,
                                              device=dev))
            m = meas.forward_from_vertices(
                gt["v_shaped"].contiguous(),
                use_face_subsets=False)["measurements"]
            joints = gt["joints"][:, :25]
            joints3d = torch.cat([joints, torch.ones_like(joints[..., :1])],
                                 dim=-1)
            joints14 = torch.einsum("jv,bvn->bjn", j14_t, gt["vertices"])
        images, affines = synthetic_requests(batch, height, width, crop_size,
                                             seed + 1 + i)
        gender = rng.integers(0, 3, size=batch)
        valid = np.ones(batch, np.float32)
        valid[(1 + i) % batch] = 0.0  # one sample without J14 GT
        batches.append({
            "images": torch.from_numpy(images).to(dev),
            "crop_to_image_affines": torch.from_numpy(affines).to(dev),
            "gt_v_shaped": gt["v_shaped"].contiguous(),
            "gt_vertices": gt["vertices"].contiguous(),
            "joints3d": joints3d,
            "joints14": joints14,
            "joints14_valid": torch.from_numpy(valid).to(dev),
            **{f"{k}_gt": m[k]["tensor"] for k in
               ("height", "chest", "waist", "hips", "mass")},
            "gender": torch.from_numpy(gender).to(dev),
            "genders": [names[g] for g in gender],
        })
    return {"batches": batches, "p2p": p2p, "j14": j14}


def synthetic_train_batches(regressor: SMPLXRegressor, num_batches: int,
                            batch: int, crop: int, seed: int) -> list:
    """Supervised training batches on the regressor's device, drawn from
    ``seed`` with numpy: ``images``, ImageNet-normalised f32 crops
    (B, crop, crop, 3) of smooth random content; GT SMPL-X bodies with
    ||beta|| <= 6, body poses of 0.2 rad per axis and global rotations
    near the flipped mean, giving ``joints3d`` (B, 25, 4) (the body
    joints, confidence 1), ``target_keypoints2d`` (B, N, 3) (every joint
    through a weak-perspective camera of random scale and shift, about a
    fifth of the confidences 0), ``gt_betas``, ``gt_betas_valid`` (one
    row 0 per batch), ``gt_global_rot`` (B, 1, 3, 3) and
    ``gt_body_pose`` (B, 21, 3, 3) rotation matrices, and ``gender``."""
    rng = np.random.default_rng(seed)
    model = regressor.model
    dev = regressor.param_mean.device
    flip = np.diag([1.0, -1.0, -1.0])  # 180 degrees about x
    out = []
    for i in range(num_batches):
        images, _ = synthetic_requests(batch, crop, crop, crop, seed + 1 + i)
        crops = ((images.astype(np.float32) / 255.0 - IMAGENET_MEAN)
                 / IMAGENET_STD).astype(np.float32)
        betas = rng.normal(size=(batch, model.num_betas)) * 1.5
        betas *= np.minimum(1.0, 6.0 / np.linalg.norm(betas, axis=1,
                                                      keepdims=True))
        body_aa = rng.normal(size=(batch, model.NUM_BODY_JOINTS, 3)) * 0.2
        glob_aa = rng.normal(size=(batch, 1, 3)) * 0.2
        glob = np.einsum("ij,bnjk->bnik", flip, aa_to_rotmat(
            torch.from_numpy(glob_aa)).numpy())
        body = aa_to_rotmat(torch.from_numpy(body_aa)).numpy()
        scale = rng.uniform(0.8, 1.2, size=(batch, 1))
        shift = rng.uniform(-0.1, 0.1, size=(batch, 2))
        t = {k: torch.tensor(v, dtype=torch.float32, device=dev) for k, v in
             (("betas", betas), ("glob", glob), ("body", body),
              ("scale", scale), ("shift", shift))}
        with torch.no_grad():
            gt = model(betas=t["betas"], global_rot=t["glob"],
                       body_pose=t["body"])
            kp = regressor.projection(gt["joints"], t["scale"], t["shift"])
        conf = (rng.uniform(size=kp.shape[:2]) > 0.2).astype(np.float32)
        joints = gt["joints"][:, :25]
        valid = np.ones(batch, np.float32)
        valid[i % batch] = 0.0
        out.append({
            "images": torch.from_numpy(crops).to(dev),
            "target_keypoints2d": torch.cat(
                [kp, torch.from_numpy(conf).to(dev)[..., None]], dim=-1),
            "joints3d": torch.cat([joints, torch.ones_like(joints[..., :1])],
                                  dim=-1),
            "gt_betas": t["betas"],
            "gt_betas_valid": torch.from_numpy(valid).to(dev),
            "gt_global_rot": t["glob"],
            "gt_body_pose": t["body"],
            "gender": torch.from_numpy(
                rng.integers(0, 3, size=batch)).to(dev),
        })
    return out
