"""OpenPose JSON keypoint reading and confidence processing (a numpy copy
of ``shapy_tpu/data/openpose.py``).

Per person, body (25) + left hand (21) + right hand (21) + face (70 minus
the 2 pupil points) keypoints become a 135 x 3 array in the
``openpose25_v1`` format; part confidences are thresholded / binarised.
"""

from __future__ import annotations

import json
import logging
from typing import Optional

import numpy as np

from shapy_tpu_torch.data.keypoints import get_part_idxs


def read_openpose_json(path: str) -> Optional[np.ndarray]:
    """-> (num_people, 135, 3) [x, y, conf] or None when no people.

    Robust to malformed files (invalid JSON, missing/mis-shaped keypoint
    blocks): a broken file or person is skipped with a logged warning
    instead of aborting the whole ingest — the tolerance the reference's
    structures layer provides (data/utils/keypoints.py:75-120)."""
    logger = logging.getLogger(__name__)
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError) as exc:
        logger.warning("Skipping unreadable OpenPose file %s: %s",
                       path, exc)
        return None
    if not isinstance(data, dict):
        logger.warning("Skipping OpenPose file %s: not a JSON object",
                       path)
        return None

    people = []
    raw_people = data.get("people", [])
    if not isinstance(raw_people, list):
        raw_people = []
    for pi, person in enumerate(raw_people):
        try:
            body = np.asarray(
                person["pose_keypoints_2d"], dtype=np.float32
            ).reshape(-1, 3)
            if body.shape[0] != 25:
                raise ValueError(
                    f"expected 25 body keypoints, got {body.shape[0]}")
            parts = [body]
            for key, n in (
                ("hand_left_keypoints_2d", 21),
                ("hand_right_keypoints_2d", 21),
            ):
                vals = person.get(key, [])
                if len(vals) < 1:
                    vals = [0.0] * (n * 3)
                part = np.asarray(vals, dtype=np.float32).reshape(-1, 3)
                if part.shape[0] != n:
                    raise ValueError(
                        f"{key}: expected {n} rows, got {part.shape[0]}")
                parts.append(part)
            face = person.get("face_keypoints_2d", [])
            if len(face) < 1:
                face = [0.0] * (70 * 3)
            face = np.asarray(face, dtype=np.float32).reshape(-1, 3)
            if face.shape[0] != 70:
                raise ValueError(
                    f"face: expected 70 rows, got {face.shape[0]}")
            parts.append(face[:-2])  # drop the two pupil points
            people.append(np.concatenate(parts, axis=0))
        except (KeyError, TypeError, ValueError) as exc:
            logger.warning("Skipping malformed person %d in %s: %s",
                           pi, path, exc)

    if not people:
        return None
    return np.stack(people)


def binarize(conf: np.ndarray, thresh: float) -> np.ndarray:
    if thresh > 0:
        return (conf >= thresh).astype(conf.dtype)
    return (conf > 0).astype(conf.dtype)


def threshold_and_keep_parts(
    keypoints: np.ndarray,
    fmt: str = "openpose25_v1",
    body_thresh: float = 0.3,
    hand_thresh: float = 0.3,
    face_thresh: float = 0.4,
    binarization: bool = True,
) -> np.ndarray:
    """Zero out low-confidence part keypoints, optionally binarise
    confidences (reference keypoints.py:10-72)."""
    out = np.array(keypoints, copy=True)
    parts = get_part_idxs(fmt)
    groups = (
        (parts["body"], body_thresh),
        (parts["left_hand"], hand_thresh),
        (parts["right_hand"], hand_thresh),
        (parts["face"], face_thresh),
    )
    for idxs, thresh in groups:
        conf = out[..., idxs, -1]
        if thresh > 0:
            conf = np.where(conf < thresh, 0.0, conf)
        if binarization:
            conf = binarize(conf, thresh)
        out[..., idxs, -1] = conf
    return out
