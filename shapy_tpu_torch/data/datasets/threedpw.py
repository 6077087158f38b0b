"""3DPW evaluation dataset, in-the-wild sequences with SMPL GT (port of
``shapy_tpu/data/datasets/threedpw.py``).

On disk:
  <data_folder>/npz_data/<split>.npz with fields
    imgname (N,), center (N, 2), scale (N,), pose (N, 72), shape (N, 10),
    gender (N,), [keypoints2d (N, K, 3)], [joints3d (N, J, 3)]
  <data_folder>/images/... image files referenced by imgname.
In evaluation the first 14 joints are the LSP-14 GT of MPJPE-14.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from shapy_tpu_torch.data.datasets.hbw import GENDER_TO_INT
from shapy_tpu_torch.data.datasets.openpose import read_img


class ThreeDPWDataset:
    SOURCE = "3dpw"

    def __init__(
        self,
        data_folder: str = "data/3dpw",
        img_folder: str = "images",
        param_folder: str = "npz_data",
        split: str = "test",
        transforms=None,
        body_dset_factor: float = 1.2,
        **kwargs,
    ):
        self.data_folder = os.path.expandvars(data_folder)
        self.img_folder = os.path.join(self.data_folder, img_folder)
        self.transforms = transforms
        self.body_dset_factor = body_dset_factor
        self.split = split

        npz_path = os.path.join(self.data_folder, param_folder,
                                f"{split}.npz")
        data = np.load(npz_path, allow_pickle=True)
        self.imgnames = [str(x) for x in data["imgname"]]
        self.centers = np.asarray(data["center"], np.float32)
        self.scales = np.asarray(data["scale"], np.float32)
        self.poses = np.asarray(data["pose"], np.float32)
        self.shapes = np.asarray(data["shape"], np.float32)
        self.genders = [str(g) for g in data["gender"]]
        self.keypoints2d = (
            np.asarray(data["keypoints2d"], np.float32)
            if "keypoints2d" in data else None
        )
        self.joints3d = (
            np.asarray(data["joints3d"], np.float32)
            if "joints3d" in data else None
        )

    def __len__(self) -> int:
        return len(self.imgnames)

    def only_2d(self) -> bool:
        return False

    def name(self) -> str:
        return f"3DPW/{self.split}"

    def __getitem__(self, index: int) -> Optional[Dict]:
        img = read_img(os.path.join(self.img_folder, self.imgnames[index]))
        gender = self.genders[index]
        sample: Dict = {
            "image": img,
            "keypoint_format": self.SOURCE,
            "center": self.centers[index].copy(),
            "scale": float(self.scales[index]) * self.body_dset_factor,
            "bbox_size": float(self.scales[index]) * 200.0,
            "orig_center": self.centers[index].copy(),
            "orig_bbox_size": float(self.scales[index]) * 200.0,
            "fname": os.path.basename(self.imgnames[index]),
            "gender": gender,
            "gender_int": GENDER_TO_INT.get(str(gender).lower()[:1], 0),
            "gt_betas": self.shapes[index],
            "gt_pose_aa": self.poses[index],
            "index": index,
        }
        if self.keypoints2d is not None:
            sample["keypoints2d"] = self.keypoints2d[index]
        if self.joints3d is not None:
            sample["joints3d"] = self.joints3d[index]
            if "train" not in self.split:
                # Eval protocol: the first 14 rows are the LSP-14 GT
                # joints used by mpjpe14 (reference threedpw.py:209-212).
                sample["joints14"] = self.joints3d[index][:14, :3]
        if self.transforms is not None:
            from shapy_tpu_torch.data.rng import augment_rng

            sample = self.transforms(
                sample, augment_rng(index, "train" in self.split))
        return sample
