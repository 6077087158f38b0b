"""Training losses of the body regressor (port of
``shapy_tpu/train/losses.py``).

Every term of the JAX ``RegressorLosses``, per penalised stage: joints2d
(confidence-weighted keypoints on the projected joints), joints3d, shape
(weighted L1 on betas), global_rot and body_pose (geodesic), the
gender-shape prior, the measurements (height, chest, waist, hips, mass),
identity consistency, the A2B-refined betas and vertices; and the B2A
attributes. ``total`` sums them in insertion order.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from shapy_tpu_torch.losses.losses import (
    keypoint_loss,
    l2_loss,
    rotation_loss,
    weighted_l1_loss,
)
from shapy_tpu_torch.losses.priors import GenderShapePrior


def center_keypoints(kp: torch.Tensor, conf: torch.Tensor,
                     center_idxs) -> torch.Tensor:
    """Center keypoints (B, N, D) around the mean of ``center_idxs`` in
    the rows where all of those have conf > 0."""
    idx = torch.as_tensor(np.asarray(center_idxs), device=kp.device)
    valid = (conf[:, idx] > 0).all(dim=-1, keepdim=True)
    center = kp[:, idx].mean(dim=1, keepdim=True)
    return torch.where(valid[..., None], kp - center, kp)


def _weight(body: Dict, key: str, default: float) -> float:
    return float((body.get(key) or {}).get("weight", default))


class RegressorLosses:
    """Configured loss aggregator over the regressor's output dict."""

    def __init__(self, loss_cfg: Optional[Dict] = None, regressor=None,
                 gender_shape_prior: Optional[GenderShapePrior] = None):
        cfg = dict(loss_cfg or {})
        body = dict(cfg.get("body") or cfg)
        self.w_joints2d = _weight(body, "body_joints_2d", 1.0)
        self.w_joints3d = _weight(body, "body_joints_3d", 1.0)
        self.norm2d = (body.get("body_joints_2d") or {}).get("norm_type",
                                                              "l1")
        shape_cfg = dict(body.get("shape") or {})
        self.w_shape = float(shape_cfg.get("weight", 1e-3))
        self.w_shape_prior = float(
            (shape_cfg.get("prior") or {}).get("weight", 0.0))
        self.w_global_rot = _weight(body, "global_rot", 1.0)
        self.w_body_pose = _weight(body, "body_pose", 1.0)
        self.w_attributes = _weight(body, "attributes", 0.0)
        self.meas_weights = {k: _weight(body, k, 0.0) for k in
                             ("mass", "height", "chest", "waist", "hips")}
        self.w_identity = _weight(body, "identity", 0.0)
        self.w_beta_refined = _weight(body, "beta_refined", 0.0)
        self.w_vertex_refined = _weight(body, "vertex_refined", 0.0)
        self.gender_shape_prior = gender_shape_prior
        self.regressor = regressor
        self.stages = list(body.get("stages_to_penalize", ["stage_02"]))

    def __call__(self, out: Dict[str, Any], batch: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
        """out: ``SMPLXRegressor.apply`` output; batch: targets with
        optional 'target_keypoints2d' (B, N, 3), 'joints3d' (B, N, 4),
        'gt_betas' (+ 'gt_betas_valid'), 'gt_global_rot' / 'gt_body_pose'
        rotation matrices (+ 'gt_pose_valid'), 'gender', measurement
        targets (+ '<name>_valid'), 'identity', 'attributes'."""
        losses: Dict[str, torch.Tensor] = {}
        for stage_key in self.stages:
            stage = out.get(stage_key)
            if stage is None:
                continue
            sfx = "" if len(self.stages) == 1 else f"_{stage_key}"

            if self.w_joints2d > 0 and "target_keypoints2d" in batch:
                gt = batch["target_keypoints2d"]
                proj = out["proj_joints"]
                n = min(proj.shape[1], gt.shape[1])
                losses[f"joints2d{sfx}"] = self.w_joints2d * keypoint_loss(
                    proj[:, :n], gt[:, :n, :2], gt[:, :n, 2], self.norm2d)
            if self.w_joints3d > 0 and "joints3d" in batch:
                gt = batch["joints3d"]
                est = stage["joints"]
                n = min(est.shape[1], gt.shape[1])
                losses[f"joints3d{sfx}"] = self.w_joints3d * keypoint_loss(
                    est[:, :n], gt[:, :n, :3], gt[:, :n, 3], "l1")
            if self.w_shape > 0 and "gt_betas" in batch:
                losses[f"shape{sfx}"] = self.w_shape * weighted_l1_loss(
                    stage["betas"], batch["gt_betas"],
                    batch.get("gt_betas_valid"))
            for key, w in (("global_rot", self.w_global_rot),
                           ("body_pose", self.w_body_pose)):
                if w > 0 and f"gt_{key}" in batch:
                    losses[f"{key}{sfx}"] = w * rotation_loss(
                        stage[key], batch[f"gt_{key}"],
                        batch.get("gt_pose_valid"))
            if self.w_shape_prior > 0 and self.gender_shape_prior is not None:
                losses[f"shape_prior{sfx}"] = (
                    self.w_shape_prior * self.gender_shape_prior(
                        stage["betas"], batch.get("gender")))

            meas = stage.get("measurements") or out.get("measurements")
            if meas is not None:
                for name, w in self.meas_weights.items():
                    if w > 0 and name in batch:
                        valid = batch.get(f"{name}_valid")
                        pred = meas[name]
                        err = (pred - batch[name].reshape(pred.shape)).abs()
                        if valid is not None:
                            v = valid.reshape(err.shape)
                            err = torch.where(v > 0, err,
                                              torch.zeros_like(err))
                            denom = torch.clamp(v.sum(), min=1e-6)
                            losses[f"{name}{sfx}"] = w * err.sum() / denom
                        else:
                            losses[f"{name}{sfx}"] = w * err.mean()

            if self.w_identity > 0 and "identity" in batch:
                # Mean squared beta difference over all same-identity
                # pairs; ids < 0 are ignored.
                ids = batch["identity"].reshape(-1)
                betas = stage["betas"]
                same = (ids[:, None] == ids[None, :]) & (ids >= 0)[:, None]
                iu = torch.triu(same, diagonal=1).to(betas.dtype)
                d2 = ((betas[:, None] - betas[None, :]) ** 2).sum(-1)
                losses[f"identity{sfx}"] = (
                    self.w_identity * (iu * d2).sum()
                    / torch.clamp(iu.sum(), min=1.0))
            if self.w_beta_refined > 0 and "betas_ref" in stage:
                losses[f"beta_refined{sfx}"] = self.w_beta_refined * l2_loss(
                    stage["betas"], stage["betas_ref"])
            if (self.w_vertex_refined > 0 and "v_shaped_ref" in stage
                    and "v_shaped" in stage):
                losses[f"vertex_refined{sfx}"] = (
                    self.w_vertex_refined
                    * l2_loss(stage["v_shaped"], stage["v_shaped_ref"]))

        if (self.w_attributes > 0 and "attributes" in out
                and "attributes" in batch):
            # Total squared error over the valid rows / their number.
            err = (out["attributes"] - batch["attributes"]) ** 2
            valid = batch.get("attributes_valid")
            if valid is not None:
                v = valid.reshape(-1, 1)
                err = torch.where(v > 0, err, torch.zeros_like(err))
                denom = torch.clamp(v.sum(), min=1e-6)
            else:
                denom = err.shape[0]
            losses["attributes"] = self.w_attributes * err.sum() / denom

        losses["total"] = (sum(v for k, v in losses.items() if k != "total")
                           if losses else torch.zeros(()))
        return losses
