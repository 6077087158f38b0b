"""SSP-3D test dataset, a sports shape-estimation benchmark (port of
``shapy_tpu/data/datasets/ssp3d.py``): npz labels with ``fnames, shapes
(betas), poses, joints2D, cam_trans, genders, bbox_centres, bbox_whs``
(+ optional GT vertices), images and silhouettes folders, boxes from the
given centre / width-height, coco25 keypoints.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from shapy_tpu_torch.data.bbox import bbox_to_center_scale
from shapy_tpu_torch.data.datasets.hbw import GENDER_TO_INT
from shapy_tpu_torch.data.datasets.openpose import read_img
from shapy_tpu_torch.data.openpose import threshold_and_keep_parts


class SSP3DDataset:
    SOURCE = "openpose25_v1"

    def __init__(
        self,
        data_folder: str = "data/ssp_3d",
        img_folder: str = "images",
        silh_folder: str = "silhouettes",
        label_fname: str = "labels.npz",
        split: str = "test",
        transforms=None,
        body_thresh: float = 0.1,
        hand_thresh: float = 0.2,
        face_thresh: float = 0.4,
        binarization: bool = False,
        body_dset_factor: float = 1.2,
        **kwargs,
    ):
        assert "test" in split, "SSP3D is a test-only dataset"
        self.data_folder = os.path.expandvars(data_folder)
        self.img_folder = os.path.join(self.data_folder, img_folder)
        self.silh_folder = os.path.join(self.data_folder, silh_folder)
        self.transforms = transforms
        self.body_thresh = body_thresh
        self.hand_thresh = hand_thresh
        self.face_thresh = face_thresh
        self.binarization = binarization
        self.body_dset_factor = body_dset_factor
        self.split = split

        label_path = label_fname
        if not os.path.isabs(label_path):
            label_path = os.path.join(self.data_folder, label_fname)
        labels = np.load(os.path.expandvars(label_path), allow_pickle=True)
        self.fnames = [str(f) for f in labels["fnames"]]
        self.shapes = np.asarray(labels["shapes"], np.float32)
        self.poses = np.asarray(labels["poses"], np.float32)
        self.joints2d = np.asarray(labels["joints2D"], np.float32)
        self.genders = [str(g) for g in labels["genders"]]
        self.bbox_centers = np.asarray(labels["bbox_centres"], np.float32)
        self.bbox_whs = np.asarray(labels["bbox_whs"], np.float32)
        self.cam_trans = (
            np.asarray(labels["cam_trans"], np.float32)
            if "cam_trans" in labels else None
        )
        self.gt_vertices = (
            np.asarray(labels["vertices"], np.float32)
            if "vertices" in labels else None
        )

    def __len__(self) -> int:
        return len(self.fnames)

    def only_2d(self) -> bool:
        return False

    def name(self) -> str:
        return f"SSP3D/{self.split}"

    def __getitem__(self, index: int) -> Optional[Dict]:
        img = read_img(os.path.join(self.img_folder, self.fnames[index]))
        kp = self.joints2d[index]
        if kp.shape[-1] == 2:
            kp = np.concatenate(
                [kp, np.ones_like(kp[..., :1])], axis=-1
            )
        n = kp.shape[0]
        full = np.zeros((135, 3), np.float32)
        full[:n] = kp
        full = threshold_and_keep_parts(
            full, self.SOURCE, self.body_thresh, self.hand_thresh,
            self.face_thresh, self.binarization,
        )

        wh = self.bbox_whs[index]
        center = self.bbox_centers[index]
        wh2 = np.broadcast_to(np.asarray(wh, np.float32).reshape(-1), (2,))
        bbox = np.concatenate([center - 0.5 * wh2, center + 0.5 * wh2])
        center, scale, bbox_size = bbox_to_center_scale(
            bbox, dset_scale_factor=self.body_dset_factor
        )

        gender = self.genders[index]
        sample: Dict = {
            "image": img,
            "keypoints2d": full,
            "keypoint_format": self.SOURCE,
            "center": center,
            "scale": scale,
            "bbox_size": bbox_size,
            "orig_center": center.copy(),
            "orig_bbox_size": bbox_size,
            "fname": self.fnames[index],
            "gender": gender,
            "gender_int": GENDER_TO_INT.get(str(gender).lower()[:1], 0),
            "gt_betas": self.shapes[index],
            "gt_pose": self.poses[index],
            "index": index,
        }
        if self.gt_vertices is not None:
            sample["gt_vertices"] = self.gt_vertices[index]
        silh_path = os.path.join(self.silh_folder, self.fnames[index])
        if os.path.exists(silh_path):
            sample["silhouette_path"] = silh_path
        if self.transforms is not None:
            from shapy_tpu_torch.data.rng import augment_rng

            sample = self.transforms(
                sample, augment_rng(index, "train" in self.split))
        return sample
