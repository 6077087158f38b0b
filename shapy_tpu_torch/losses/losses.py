"""Loss functions (port of ``shapy_tpu/losses/losses.py``): the ones the
regressor's training losses use.

Normalisation matches the JAX package, which matches the reference:
``keypoint_loss`` divides by the batch size by default (never by the sum
of confidences), the weighted L2 / L1 losses divide the total sum by the
batch size, and the rotation loss is the geodesic angle
``acos((tr(R_p^T R_g) - 1) / 2)``.
"""

from __future__ import annotations

from typing import Optional

import torch


def gmof(x: torch.Tensor, rho: float = 100.0) -> torch.Tensor:
    """Geman-McClure robustifier."""
    sq = x * x
    return (rho * rho) * sq / (sq + rho * rho)


def keypoint_loss(pred: torch.Tensor, gt: torch.Tensor,
                  conf: Optional[torch.Tensor] = None, norm_type: str = "l1",
                  rho: float = 100.0, division: str = "batch"
                  ) -> torch.Tensor:
    """Confidence-weighted keypoint loss. pred / gt (B, N, D), conf
    (B, N). ``division``: 'batch' divides the weighted sum by B,
    'visible' by 2 x the number of keypoints with conf > 0."""
    diff = pred - gt
    if norm_type == "l1":
        per_kp = diff.abs().sum(dim=-1)
    elif norm_type == "l2":
        per_kp = (diff * diff).sum(dim=-1)
    elif norm_type == "gmof":
        per_kp = gmof(diff, rho).sum(dim=-1)
    else:
        raise ValueError(f"Unknown norm type: {norm_type}")
    if conf is not None:
        per_kp = per_kp * conf
    if division == "batch":
        return per_kp.sum() / pred.shape[0]
    if division == "visible":
        visible = ((conf > 0).sum() if conf is not None
                   else pred.shape[0] * pred.shape[1])
        return per_kp.sum() / (2.0 * visible + 1e-9)
    raise ValueError(f"Unknown division: {division}")


def _batch_sum_loss(diff: torch.Tensor,
                    weights: Optional[torch.Tensor]) -> torch.Tensor:
    """``(weights[..., None] * diff).sum() / B``."""
    if weights is not None:
        diff = diff * weights[..., None]
    return diff.sum() / diff.shape[0]


def l2_loss(pred: torch.Tensor, gt: torch.Tensor,
            weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    return _batch_sum_loss((pred - gt) ** 2, weights)


def weighted_l1_loss(pred: torch.Tensor, gt: torch.Tensor,
                     weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    return _batch_sum_loss((pred - gt).abs(), weights)


def rotation_loss(pred: torch.Tensor, gt: torch.Tensor,
                  weights: Optional[torch.Tensor] = None,
                  epsilon: float = 1e-7) -> torch.Tensor:
    """Geodesic rotation distance; unweighted -> sum / B, weighted ->
    sum / (#weights > 0)."""
    B = pred.shape[0]
    p = pred.reshape(-1, 3, 3)
    g = gt.reshape(-1, 3, 3)
    tr = torch.einsum("bij,bij->b", p, g)
    theta = torch.clamp((tr - 1.0) * 0.5, -1.0 + epsilon, 1.0 - epsilon)
    per = torch.arccos(theta)
    if weights is not None:
        per = per.reshape(B, -1) * weights.reshape(B, -1)
        return per.sum() / ((weights > 0).sum() + epsilon)
    return per.sum() / B
