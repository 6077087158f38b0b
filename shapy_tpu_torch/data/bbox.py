"""Bounding-box utilities (a numpy copy of ``shapy_tpu/data/bbox.py``,
which the port may not import; a test holds it equal to the JAX
package's). The center / scale convention divides the box size by a
reference of 200 px, the hourglass-crop convention of the whole pipeline.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

REF_BBOX_SIZE = 200.0


def keyps_to_bbox(
    keypoints: np.ndarray,
    conf: np.ndarray,
    img_size: Optional[Tuple[int, ...]] = None,
    clip_to_img: bool = False,
    min_valid_keypoints: int = 6,
    scale: float = 1.0,
) -> Optional[np.ndarray]:
    """2D keypoints + confidences -> xyxy box, or None if too few valid."""
    valid = keypoints[conf > 0]
    if len(valid) < min_valid_keypoints:
        return None
    xmin, ymin = np.amin(valid, axis=0)
    xmax, ymax = np.amax(valid, axis=0)
    if img_size is not None and clip_to_img:
        H, W = img_size[:2]
        xmin, xmax = np.clip(xmin, 0, W), np.clip(xmax, 0, W)
        ymin, ymax = np.clip(ymin, 0, H), np.clip(ymax, 0, H)
    w = (xmax - xmin) * scale
    h = (ymax - ymin) * scale
    cx, cy = 0.5 * (xmax + xmin), 0.5 * (ymax + ymin)
    bbox = np.asarray(
        [cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h],
        dtype=np.float32,
    )
    if bbox_area(bbox) > 0:
        return bbox
    return None


def bbox_to_center_scale(
    bbox: Optional[np.ndarray],
    dset_scale_factor: float = 1.0,
    ref_bbox_size: float = REF_BBOX_SIZE,
):
    if bbox is None:
        return None, None, None
    bbox = np.asarray(bbox).reshape(-1)
    bbox_size = dset_scale_factor * max(
        bbox[2] - bbox[0], bbox[3] - bbox[1]
    )
    scale = bbox_size / ref_bbox_size
    center = np.asarray(
        [(bbox[0] + bbox[2]) * 0.5, (bbox[1] + bbox[3]) * 0.5],
        dtype=np.float32,
    )
    return center, float(scale), float(bbox_size)


def scale_to_bbox_size(scale: float, ref_bbox_size: float = REF_BBOX_SIZE
                       ) -> float:
    return scale * ref_bbox_size


def bbox_area(bbox) -> float:
    if bbox is None:
        return 0.0
    b = np.asarray(bbox).reshape(-1)
    return float(abs((b[2] - b[0]) * (b[3] - b[1])))


def points_to_bbox(points: np.ndarray, bbox_scale_factor: float = 1.0):
    """(B, N, 2) points -> (center (B, 2), square size (B,))."""
    mn = points.min(axis=1)
    mx = points.max(axis=1)
    center = 0.5 * (mn + mx)
    size = np.maximum(mx[:, 0] - mn[:, 0], mx[:, 1] - mn[:, 1])
    return center, size * bbox_scale_factor


def bbox_xyxy_to_xywh(bbox: np.ndarray) -> np.ndarray:
    b = np.asarray(bbox).reshape(-1)
    return np.asarray([b[0], b[1], b[2] - b[0], b[3] - b[1]], dtype=b.dtype)


def bbox_xywh_to_xyxy(bbox: np.ndarray) -> np.ndarray:
    b = np.asarray(bbox).reshape(-1)
    return np.asarray([b[0], b[1], b[0] + b[2], b[1] + b[3]], dtype=b.dtype)


def bbox_iou(a: np.ndarray, b: np.ndarray) -> float:
    a = np.asarray(a).reshape(-1)
    b = np.asarray(b).reshape(-1)
    ix = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    iy = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = ix * iy
    union = bbox_area(a) + bbox_area(b) - inter
    return float(inter / union) if union > 0 else 0.0
