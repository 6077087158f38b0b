"""Parametric-fit pose datasets (CuratedFittings / SPIN / SPIN-X /
Human3.6M-X style; port of ``shapy_tpu/data/datasets/parametric.py``).

Behavioural spec: reference ``regressor/human_shape/data/datasets/``
curated_fittings / spin / human36m loaders: npz archives of per-sample
image name, crop center/scale, SMPL(-X) pose + betas (+ optional
expression, hand poses, 3D joints, vertices), consumed by the pose
training stream. One loader covers the family; per-dataset quirks are
constructor flags, mirroring the reference's near-identical classes.

Beside the JAX package's arguments, ``image_dtype`` ('float32' or
'uint8') picks what :func:`read_img` gives: the training CLI asks for
uint8 full images, which kernel K2 decodes, crops and normalises on the
card.
"""

from __future__ import annotations

import os
import logging
from typing import Dict, Optional

import numpy as np

from shapy_tpu_torch.data.datasets.hbw import GENDER_TO_INT
from shapy_tpu_torch.data.datasets.openpose import read_img


# Native keypoint ordering per parametric-fit dataset family (reference
# keypoint_names.py registry: each dataset remaps from its own table).
PARAMETRIC_SOURCES = {
    "ehf": "ehf",
    "spin": "spin",
    "spinx": "spinx",
    "human36mx": "h36m",
    "curated_fits": "spin",
}


class ParametricFitsDataset:
    SOURCE = "openpose25_v1"

    def __init__(
        self,
        data_folder: str = "",
        img_folder: str = "",
        npz_files=(),
        split: str = "train",
        transforms=None,
        keypoint_format: Optional[str] = None,
        dataset_name: str = "",
        return_shape: bool = True,
        return_expression: bool = False,
        return_vertices: bool = False,
        body_dset_factor: float = 1.2,
        metrics=("mpjpe",),
        image_dtype: str = "float32",
        **kwargs,
    ):
        self.image_dtype = image_dtype
        if keypoint_format is None:
            keypoint_format = PARAMETRIC_SOURCES.get(
                dataset_name, self.SOURCE
            )
        self.keypoint_format = keypoint_format
        self.data_folder = os.path.expandvars(data_folder)
        self.img_folder = os.path.join(self.data_folder, img_folder) \
            if img_folder else self.data_folder
        self.transforms = transforms
        self.body_dset_factor = body_dset_factor
        self.metrics = metrics
        self.split = split
        self.is_train = "train" in split
        self.return_shape = return_shape
        self.return_expression = return_expression
        self.return_vertices = return_vertices

        fields = [
            "imgname", "center", "scale", "pose", "shape", "gender",
            "keypoints2d", "joints3d", "expression", "vertices",
            "left_hand_pose", "right_hand_pose",
        ]
        # Two passes so fields present in only SOME archives stay
        # row-aligned: naive per-field concatenation would silently map
        # archive B's joints3d rows onto archive A's images (wrong 3D
        # supervision) and crash for the tail indices. Missing blocks
        # are NaN-filled and masked out via <field>_present.
        archives = []
        for fname in npz_files:
            if not fname:
                continue
            path = fname if os.path.isabs(fname) else os.path.join(
                self.data_folder, fname
            )
            with np.load(os.path.expandvars(path),
                         allow_pickle=True) as d:
                archives.append({k: np.asarray(d[k]) for k in fields
                                 if k in d})
        self.data = {}
        self.present = {}
        for k in fields:
            proto = next((a[k] for a in archives if k in a), None)
            if proto is None and k != "gender":
                self.data[k] = None
                continue
            blocks, mask = [], []
            for a in archives:
                n = len(a["imgname"])
                if k in a:
                    blocks.append(a[k])
                    mask.append(np.ones(n, bool))
                elif k == "gender":
                    blocks.append(np.asarray(["neutral"] * n))
                    mask.append(np.ones(n, bool))
                else:
                    blocks.append(np.full(
                        (n,) + proto.shape[1:], np.nan, np.float32))
                    mask.append(np.zeros(n, bool))
            self.data[k] = np.concatenate(blocks) if blocks else None
            self.present[k] = (np.concatenate(mask) if mask
                               else np.zeros(0, bool))
        self.num_items = (
            len(self.data["imgname"]) if self.data.get("imgname")
            is not None else 0
        )

        # SPIN-family archives come in two keypoint layouts: the bare
        # 24-name GT block ('spin') or the 49-row training layout
        # (25 OpenPose body rows + the 24 GT rows, 'spin49'). Resolve by
        # the actual row count — assuming 24 when the archive stores 49
        # would relabel OpenPose rows as GT joints silently.
        kp = self.data.get("keypoints2d")
        if kp is not None and self.keypoint_format in ("spin", "spin49"):
            from shapy_tpu_torch.data.keypoints import KEYPOINT_NAMES_DICT

            rows = kp.shape[-2]
            for candidate in ("spin", "spin49"):
                if rows == len(KEYPOINT_NAMES_DICT[candidate]):
                    self.keypoint_format = candidate
                    break
            else:
                raise ValueError(
                    f"{dataset_name or 'spin'} archive stores {rows} "
                    "keypoint rows; expected "
                    f"{len(KEYPOINT_NAMES_DICT['spin'])} ('spin') or "
                    f"{len(KEYPOINT_NAMES_DICT['spin49'])} ('spin49')"
                )

    def __len__(self) -> int:
        return self.num_items

    def only_2d(self) -> bool:
        return False

    def name(self) -> str:
        return f"ParametricFits/{self.split}"

    def __getitem__(self, index: int) -> Optional[Dict]:
        img_path = os.path.join(
            self.img_folder, str(self.data["imgname"][index])
        )
        try:
            img = read_img(img_path, self.image_dtype)
        except (FileNotFoundError, OSError, ValueError) as exc:
            # Missing/corrupt frame in an archive: skip-and-warn
            # (collate_batch drops None rows), don't abort the epoch.
            logging.getLogger(__name__).warning(
                "Skipping unreadable image %s: %s", img_path, exc)
            return None
        center = np.asarray(self.data["center"][index], np.float32)
        scale = float(np.asarray(self.data["scale"][index]).reshape(-1)[0])
        gender = str(self.data["gender"][index])

        sample: Dict = {
            "image": img,
            "keypoint_format": self.keypoint_format,
            "center": center,
            "scale": scale * self.body_dset_factor,
            "bbox_size": scale * 200.0,
            "orig_center": center.copy(),
            "orig_bbox_size": scale * 200.0,
            "fname": os.path.basename(str(self.data["imgname"][index])),
            "gender": gender,
            "gender_int": GENDER_TO_INT.get(gender.lower()[:1], 0),
            "index": index,
        }

        def has(k):
            return (self.data.get(k) is not None
                    and bool(self.present[k][index]))

        if has("pose"):
            sample["gt_pose_aa"] = np.asarray(
                self.data["pose"][index], np.float32)
        if has("keypoints2d"):
            sample["keypoints2d"] = np.asarray(
                self.data["keypoints2d"][index], np.float32
            )
        if self.return_shape and has("shape"):
            sample["gt_betas"] = np.asarray(
                self.data["shape"][index], np.float32
            )
        if self.return_expression and has("expression"):
            sample["gt_expression"] = np.asarray(
                self.data["expression"][index], np.float32
            )
        if self.return_vertices and has("vertices"):
            sample["gt_vertices"] = np.asarray(
                self.data["vertices"][index], np.float32
            )
        if has("joints3d"):
            sample["joints3d"] = np.asarray(
                self.data["joints3d"][index], np.float32
            )
        if self.transforms is not None:
            from shapy_tpu_torch.data.rng import augment_rng

            sample = self.transforms(
                sample, augment_rng(index, self.is_train))
        return sample


class EHFDataset(ParametricFitsDataset):
    """EHF test set: 100 studio frames with SMPL-X alignment GT meshes
    (reference datasets/ehf.py). Expects <data_folder>/<img_folder> with
    frames and an ``ehf.npz`` index (imgname/center/scale/vertices)."""

    def __init__(self, data_folder: str = "data/EHF",
                 img_folder: str = "images", split: str = "test",
                 npz_files=("ehf.npz",), **kwargs):
        kwargs.setdefault("dataset_name", "ehf")
        super().__init__(
            data_folder=data_folder,
            img_folder=img_folder,
            npz_files=npz_files,
            split=split,
            return_vertices=True,
            **kwargs,
        )

    def name(self) -> str:
        return f"EHF/{self.split}"
