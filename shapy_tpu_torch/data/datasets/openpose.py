"""OpenPose-keypoints dataset, images + OpenPose JSONs, no labels (port of
``shapy_tpu/data/datasets/openpose.py``), and :func:`read_img`, the image
reader of every dataset.

One item per detected person, keypoints in the ``openpose25_v1`` format,
per-part confidence thresholding / binarisation, the box from the valid
keypoints padded by ``body_dset_factor``, and the crop metadata for the
transforms.

:func:`read_img` decodes binary PPM (``P6``, maxval 255) itself with
numpy, bit-equal to ``cv2.imread``; every other format goes through
``cv2``, imported when such a file is read. Where ``cv2`` is not
installed (the machine with the card) it raises an ``ImportError`` that
names the file.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional

import numpy as np

from shapy_tpu_torch.data.bbox import bbox_to_center_scale, keyps_to_bbox
from shapy_tpu_torch.data.openpose import (
    read_openpose_json,
    threshold_and_keep_parts,
)


_PPM_WHITESPACE = b" \t\r\n\v\f"


def read_ppm(path: str) -> Optional[np.ndarray]:
    """A binary PPM (``P6``, maxval 255) as (H, W, 3) RGB uint8, or None if
    the file is not one (another format or maxval). Header comments
    (``#`` to the end of the line) are skipped."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] != b"P6":
        return None
    fields = []
    i = 2
    while len(fields) < 3:
        while i < len(data) and (data[i:i + 1] in _PPM_WHITESPACE
                                 or data[i:i + 1] == b"#"):
            if data[i:i + 1] == b"#":
                while i < len(data) and data[i:i + 1] not in b"\r\n":
                    i += 1
            else:
                i += 1
        j = i
        while j < len(data) and data[j:j + 1].isdigit():
            j += 1
        if j == i:
            raise ValueError(f"{path}: malformed PPM header")
        fields.append(int(data[i:j]))
        i = j
    width, height, maxval = fields
    if maxval != 255:
        return None
    if data[i:i + 1] not in _PPM_WHITESPACE:
        raise ValueError(f"{path}: malformed PPM header")
    i += 1  # the single whitespace before the raster
    size = width * height * 3
    if len(data) - i < size:
        raise ValueError(f"{path}: truncated PPM raster")
    return np.frombuffer(data, np.uint8, size, i).reshape(
        height, width, 3).copy()


def read_img(path: str, dtype: str = "float32") -> np.ndarray:
    """RGB float32 [0, 1], or raw uint8 with ``dtype='uint8'`` (the input
    of the on-device decode + crop + normalise, kernel K2). Binary PPM is
    decoded here; any other format needs ``cv2``."""
    img = read_ppm(path)
    if img is None:
        try:
            import cv2
        except ImportError as exc:
            raise ImportError(
                f"reading {path} needs cv2, which is not installed; only "
                "binary PPM (P6, maxval 255) is read without it") from exc
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(path)
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    if dtype == "uint8":
        return img
    out = img.astype(np.float32)
    np.divide(out, 255.0, out=out)  # in-place: skip one full-image pass
    return out


class OpenPoseDataset:
    SOURCE = "openpose25_v1"

    def __init__(
        self,
        data_folder: str = "data/openpose",
        img_folder: str = "images",
        keyp_folder: str = "keypoints",
        split: str = "test",
        transforms=None,
        body_thresh: float = 0.1,
        hand_thresh: float = 0.2,
        face_thresh: float = 0.4,
        body_dset_factor: float = 1.2,
        binarization: bool = True,
        image_dtype: str = "float32",
        **kwargs,
    ):
        self.image_dtype = image_dtype
        self.data_folder = os.path.expanduser(os.path.expandvars(data_folder))
        self.img_folder = os.path.join(self.data_folder, img_folder)
        self.keyp_folder = os.path.join(self.data_folder, keyp_folder)
        self.transforms = transforms
        self.body_thresh = body_thresh
        self.hand_thresh = hand_thresh
        self.face_thresh = face_thresh
        self.body_dset_factor = body_dset_factor
        self.binarization = binarization
        self.is_train = "train" in split

        self.img_paths: List[str] = []
        keypoints = []
        for img_fname in sorted(os.listdir(self.img_folder)):
            fname = os.path.splitext(img_fname)[0]
            keyp_path = os.path.join(self.keyp_folder,
                                     f"{fname}_keypoints.json")
            if not os.path.exists(keyp_path):
                keyp_path = os.path.join(self.keyp_folder, f"{fname}.json")
                if not os.path.exists(keyp_path):
                    continue
            kps = read_openpose_json(keyp_path)
            if kps is None:
                continue
            self.img_paths += [
                os.path.join(self.img_folder, img_fname)
            ] * kps.shape[0]
            keypoints.append(kps)
        self.keypoints = (
            np.concatenate(keypoints, axis=0) if keypoints
            else np.zeros((0, 135, 3), np.float32)
        )

    def __len__(self) -> int:
        return len(self.img_paths)

    def only_2d(self) -> bool:
        return True

    def __getitem__(self, index: int) -> Optional[Dict]:
        img_path = self.img_paths[index]
        try:
            img = read_img(img_path, self.image_dtype)
        except (FileNotFoundError, OSError, ValueError) as exc:
            # Truncated/corrupt image: skip the sample with a warning
            # (collate_batch drops None rows) instead of killing the run.
            logging.getLogger(__name__).warning(
                "Skipping unreadable image %s: %s", img_path, exc)
            return None

        kp = np.array(self.keypoints[index], copy=True)
        kp[:, -1] = np.clip(kp[:, -1], 0, 1)
        kp = threshold_and_keep_parts(
            kp, self.SOURCE, self.body_thresh, self.hand_thresh,
            self.face_thresh, self.binarization,
        )

        bbox = keyps_to_bbox(kp[:, :2], kp[:, 2], img_size=img.shape)
        center, scale, bbox_size = bbox_to_center_scale(
            bbox, dset_scale_factor=self.body_dset_factor
        )
        if center is None:
            return None

        sample: Dict = {
            "image": img,
            "keypoints2d": kp,
            "keypoint_format": self.SOURCE,
            "center": center,
            "scale": scale,
            "bbox_size": bbox_size,
            "orig_center": center.copy(),
            "orig_bbox_size": bbox_size,
            "fname": os.path.basename(img_path),
            "index": index,
        }
        if self.transforms is not None:
            from shapy_tpu_torch.data.rng import augment_rng

            rng = augment_rng(index, self.is_train)
            sample = self.transforms(sample, rng)
        return sample
