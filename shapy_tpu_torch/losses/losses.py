"""Loss functions (port of ``shapy_tpu/losses/losses.py``) and their
factory, :func:`build_loss`.

Normalisation matches the JAX package, which matches the reference:
``keypoint_loss`` divides by the batch size by default (never by the sum
of confidences), the weighted L2 / L1 losses divide the total sum by the
batch size, and the rotation loss is the geodesic angle
``acos((tr(R_p^T R_g) - 1) / 2)``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F


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


def _edge_index(edges, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(edges), dtype=torch.long,
                           device=device)


def keypoint_edge_loss(pred: torch.Tensor, gt: torch.Tensor, connections,
                       conf: Optional[torch.Tensor] = None,
                       norm_type: str = "l1") -> torch.Tensor:
    """Bone-vector loss over the skeleton edges ``connections`` (E, 2):
    edge vectors instead of positions, each edge weighted by the product
    of its two keypoints' confidences."""
    conn = _edge_index(connections, pred.device)
    pe = pred[:, conn[:, 1]] - pred[:, conn[:, 0]]
    ge = gt[:, conn[:, 1]] - gt[:, conn[:, 0]]
    edge_conf = None
    if conf is not None:
        edge_conf = conf[:, conn[:, 0]] * conf[:, conn[:, 1]]
    return keypoint_loss(pe, ge, edge_conf, norm_type)


def vertex_edge_loss(pred_verts: torch.Tensor, gt_verts: torch.Tensor,
                     edges, norm_type: str = "l2") -> torch.Tensor:
    """Mesh edge-vector loss: squared L2 (or L1) of the edge-vector
    differences, summed per item, then the batch mean."""
    e = _edge_index(edges, pred_verts.device)
    pe = pred_verts[:, e[:, 1]] - pred_verts[:, e[:, 0]]
    ge = gt_verts[:, e[:, 1]] - gt_verts[:, e[:, 0]]
    diff = pe - ge
    per_elem = diff * diff if norm_type == "l2" else diff.abs()
    return per_elem.reshape(pred_verts.shape[0], -1).sum(-1).mean()


def bce_loss(pred_logits: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy on logits (log-sigmoid, stable)."""
    logp = F.logsigmoid(pred_logits)
    lognp = F.logsigmoid(-pred_logits)
    return -(gt * logp + (1 - gt) * lognp).mean()


def mse_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return ((pred - gt) ** 2).mean()


def l1_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return (pred - gt).abs().mean()


def bce_logits_loss(pred_logits: torch.Tensor, gt: torch.Tensor
                    ) -> torch.Tensor:
    """The 'bce-logits' factory entry: the same expression as
    :func:`bce_loss`."""
    return bce_loss(pred_logits, gt)


def cross_entropy_loss(pred_logits: torch.Tensor, gt: torch.Tensor,
                       ignore_index: int = -100) -> torch.Tensor:
    """Cross-entropy over class logits (B, C) with int labels (B,); rows
    labelled ``ignore_index`` drop out of the mean."""
    logp = F.log_softmax(pred_logits, dim=-1)
    valid = gt != ignore_index
    safe = torch.where(valid, gt, torch.zeros_like(gt)).long()
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    denom = torch.clamp(valid.sum(), min=1)
    return torch.where(valid, nll, torch.zeros_like(nll)).sum() / denom


LOSS_FACTORY: Dict[str, Callable] = {
    "keypoints": keypoint_loss,
    "gmof": lambda p, g, c=None, rho=100.0: keypoint_loss(
        p, g, c, "gmof", rho),
    "l2": l2_loss,
    "weighted-l1": weighted_l1_loss,
    "keypoint-edge": keypoint_edge_loss,
    "vertex-edge": vertex_edge_loss,
    "rotation": rotation_loss,
    "bce": bce_loss,
    "bce-logits": bce_logits_loss,
    "cross-entropy": cross_entropy_loss,
    "l1": l1_loss,
    "mse": mse_loss,
}


def build_loss(loss_type: str = "l2", **kwargs) -> Callable:
    """The loss named ``loss_type``, its config keys (``norm_type``,
    ``rho`` ...) bound; keys the loss does not take (``weight``,
    ``type`` ...) are dropped."""
    if loss_type not in LOSS_FACTORY:
        raise ValueError(f"Unknown loss type: {loss_type}")
    fn = LOSS_FACTORY[loss_type]
    if not kwargs:
        return fn

    def bound(*args, **kw):
        merged = {**kwargs, **kw}
        return fn(*args, **{k: v for k, v in merged.items()
                            if k in fn.__code__.co_varnames})

    return bound
