"""2D keypoint / skeleton / bbox drawing for image summaries (port of
``shapy_tpu/render/skeleton.py``): ``blend_images``,
``undo_img_normalization``, ``create_skel_img``, ``keyp_target_to_image``
and ``create_bbox_img`` on plain numpy arrays.

The drawing is ``cv2``'s (anti-aliased lines, circles, rectangles), as in
the JAX package, so the images are bit-equal to its. ``cv2`` is imported
when a drawing function runs; where it is not installed that function
raises an ``ImportError`` that names it.

Colour semantics: left-side joints red, right-side blue, everything else
white; finger chains get a per-finger colour; hand / face markers shrink
(decided by name).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

# per-finger colours
_FINGER_COLORS = {
    "thumb": (1.0, 0.4, 0.4),
    "index": (0.4, 1.0, 0.4),
    "middle": (0.4, 0.4, 1.0),
    "ring": (1.0, 1.0, 0.4),
    "pinky": (1.0, 0.4, 1.0),
}


def _cv2(what: str):
    """``cv2``, or an ``ImportError`` that says which function needs it."""
    try:
        import cv2
    except ImportError as exc:
        raise ImportError(f"{what} draws with cv2, which is not "
                          "installed") from exc
    return cv2


def blend_images(img1: np.ndarray, img2: np.ndarray,
                 alpha: float = 0.7) -> np.ndarray:
    return img1 * alpha + (1 - alpha) * img2


def undo_img_normalization(img: np.ndarray, mean, std) -> np.ndarray:
    """(H, W, 3) or (3, H, W) normalised crop -> [0, 1] HWC float image."""
    img = np.asarray(img, np.float32)
    if img.ndim == 3 and img.shape[0] == 3 and img.shape[-1] != 3:
        img = np.transpose(img, (1, 2, 0))
    mean = np.asarray(mean, np.float32).reshape(1, 1, -1)
    std = np.asarray(std, np.float32).reshape(1, 1, -1)
    return np.clip(img * std + mean, 0.0, 1.0)


def _joint_color(name: Optional[str], color_left, color_right, color_else):
    if not name:
        return color_else
    for finger, c in _FINGER_COLORS.items():
        if finger in name:
            return c
    if "left" in name:
        return color_left
    if "right" in name:
        return color_right
    return color_else


def create_skel_img(
    img: np.ndarray,
    keypoints: np.ndarray,
    connections: Sequence[Tuple[int, int]],
    valid: Optional[np.ndarray] = None,
    names: Optional[List[str]] = None,
    color_left=(0.9, 0.0, 0.0),
    color_right=(0.0, 0.0, 0.9),
    color_else=(1.0, 1.0, 1.0),
    marker_size: int = 2,
    linewidth: int = 2,
    draw_skel: bool = True,
    draw_text: bool = False,
) -> np.ndarray:
    """Draw a 2D skeleton over an image: a marker at each edge's END
    joint, an anti-aliased line per valid edge, the colour from the end
    joint's name.

    img: (H, W, 3) float [0, 1] (or CHW, transposed automatically);
    keypoints: (K, 2) pixel coords; valid: (K,) bool / 0-1 mask.
    """
    cv2 = _cv2("create_skel_img")
    kp_img = np.ascontiguousarray(undo_img_normalization(img, 0.0, 1.0))
    K = keypoints.shape[0]
    if valid is None:
        valid = np.ones(K, bool)
    valid = np.asarray(valid).reshape(-1) > 0

    for a, b in connections:
        if a >= K or b >= K or not (valid[a] and valid[b]):
            continue
        name_b = names[b] if names is not None and b < len(names) else None
        color = tuple(
            float(c)
            for c in _joint_color(name_b, color_left, color_right,
                                  color_else))
        body = name_b is None or not any(
            f in name_b for f in _FINGER_COLORS)
        m = marker_size if body else max(int(0.1 * marker_size), 1)
        center = tuple(int(round(v)) for v in keypoints[b, :2])
        cv2.circle(kp_img, center, m, color)
        if draw_skel:
            start = tuple(int(round(v)) for v in keypoints[a, :2])
            cv2.line(kp_img, start, center, color, thickness=linewidth,
                     lineType=cv2.LINE_AA)
        if draw_text and body:
            cv2.putText(kp_img, str(b), center, cv2.FONT_HERSHEY_PLAIN,
                        1.0, (0.0, 0.0, 0.0), 4)
            cv2.putText(kp_img, str(b), center, cv2.FONT_HERSHEY_PLAIN,
                        1.0, color, 2)
    return kp_img


def keyp_target_to_image(
    img: np.ndarray,
    keypoints: np.ndarray,
    fmt: str,
    draw_text: bool = False,
    **kwargs,
) -> np.ndarray:
    """GT-keypoint overlay from a (K, 3) [x, y, conf] target in the named
    registry format (its connections and names)."""
    from shapy_tpu_torch.data.keypoints import (
        KEYPOINT_NAMES_DICT,
        kp_connections,
    )

    _cv2("keyp_target_to_image")
    kp = np.asarray(keypoints, np.float32)
    return create_skel_img(
        img, kp[:, :2], kp_connections(fmt),
        valid=kp[:, -1] > 0,
        names=KEYPOINT_NAMES_DICT[fmt],
        draw_text=draw_text, **kwargs)


def create_bbox_img(
    img: np.ndarray,
    bounding_box: np.ndarray,
    color=(0.0, 0.0, 0.0),
    linewidth: int = 2,
) -> np.ndarray:
    """Draw an [xmin, ymin, xmax, ymax] box."""
    cv2 = _cv2("create_bbox_img")
    out = np.ascontiguousarray(np.asarray(img, np.float32).copy())
    xmin, ymin, xmax, ymax = [int(round(float(v)))
                              for v in np.asarray(bounding_box).reshape(4)]
    cv2.rectangle(out, (xmin, ymin), (xmax, ymax),
                  tuple(float(c) for c in color), linewidth)
    return out
