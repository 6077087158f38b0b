"""Model-agency web-image shape dataset (port of
``shapy_tpu/data/datasets/model_agencies.py``).

Behavioural spec: reference ``regressor/human_shape/data/datasets/
model_agencies.py:176-584``: per-agency JSON annotations with model
height / chest / waist / hips, crowd attribute ratings, per-image
keypoints, train/val/test splits, optional fitted betas; this is the
"shape" training stream of SHAPY (attributes + measurements supervision,
no 3D GT).

Simplified on-disk layout (documented, convertible from the reference's):
  <data_folder>/<agency>/images/<model>/<img>.jpg
  <data_folder>/annotations.json:
     {model_key: {agency, gender, height, chest, waist, hips,
                  attributes: [15], images: {img_fname: keypoints(135x3)
                  or null}}}
  <data_folder>/splits.json: {train: [model_key...], val: ..., test: ...}

``image_dtype`` ('float32' or 'uint8') picks what :func:`read_img` gives,
as in the parametric datasets.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from shapy_tpu_torch.data.bbox import bbox_to_center_scale, keyps_to_bbox
from shapy_tpu_torch.data.datasets.hbw import GENDER_TO_INT
from shapy_tpu_torch.data.datasets.openpose import read_img
from shapy_tpu_torch.data.openpose import threshold_and_keep_parts


class ModelAgencyDataset:
    SOURCE = "openpose25_v1"

    def __init__(
        self,
        data_folder: str = "data/model_agencies",
        img_folder: str = "images",
        annot_fname: str = "annotations.json",
        splits_fname: str = "splits.json",
        split: str = "train",
        transforms=None,
        body_thresh: float = 0.1,
        hand_thresh: float = 0.2,
        face_thresh: float = 0.4,
        binarization: bool = False,
        body_dset_factor: float = 1.2,
        only_data_with_attributes: bool = False,
        betas_fname: str = "",
        image_dtype: str = "float32",
        **kwargs,
    ):
        self.image_dtype = image_dtype
        self.data_folder = os.path.expandvars(data_folder)
        self.img_folder = img_folder
        self.split = split
        self.transforms = transforms
        self.body_thresh = body_thresh
        self.hand_thresh = hand_thresh
        self.face_thresh = face_thresh
        self.binarization = binarization
        self.body_dset_factor = body_dset_factor
        self.is_train = "train" in split

        with open(os.path.join(self.data_folder, annot_fname)) as f:
            annotations = json.load(f)
        with open(os.path.join(self.data_folder, splits_fname)) as f:
            splits = json.load(f)

        betas_db = {}
        if betas_fname:
            betas_path = os.path.join(self.data_folder, betas_fname)
            if os.path.exists(betas_path):
                with open(betas_path) as f:
                    betas_db = json.load(f)

        self.items: List[Dict] = []
        for model_key in splits.get(split, []):
            annot = annotations.get(model_key)
            if annot is None:
                continue
            if only_data_with_attributes and not annot.get("attributes"):
                continue
            for img_fname, kp in (annot.get("images") or {}).items():
                if kp is None:
                    # The annotations.json schema allows null keypoints
                    # for un-detected images; np.asarray(None) in
                    # __getitem__ would kill the loader worker.
                    continue
                self.items.append(
                    {
                        "model_key": model_key,
                        "agency": annot.get("agency", ""),
                        "gender": annot.get("gender", "neutral"),
                        "height": annot.get("height"),
                        "chest": annot.get("chest"),
                        "waist": annot.get("waist"),
                        "hips": annot.get("hips"),
                        "weight": annot.get("weight"),
                        "attributes": annot.get("attributes"),
                        "img_fname": img_fname,
                        "keypoints": kp,
                        "betas": betas_db.get(model_key),
                    }
                )

    def __len__(self) -> int:
        return len(self.items)

    def only_2d(self) -> bool:
        return True

    def name(self) -> str:
        return f"ModelAgency/{self.split}"

    def __getitem__(self, index: int) -> Optional[Dict]:
        item = self.items[index]
        img_path = os.path.join(
            self.data_folder, item["agency"], self.img_folder,
            item["model_key"], item["img_fname"],
        )
        if not os.path.exists(img_path):
            img_path = os.path.join(self.data_folder, item["img_fname"])
        img = read_img(img_path, self.image_dtype)

        kp = np.asarray(item["keypoints"], np.float32)
        full = np.zeros((135, 3), np.float32)
        full[: kp.shape[0]] = kp[:135]
        full = threshold_and_keep_parts(
            full, self.SOURCE, self.body_thresh, self.hand_thresh,
            self.face_thresh, self.binarization,
        )
        bbox = keyps_to_bbox(full[:, :2], full[:, 2], img_size=img.shape)
        center, scale, bbox_size = bbox_to_center_scale(
            bbox, dset_scale_factor=self.body_dset_factor
        )
        if center is None:
            return None

        gender = item["gender"]
        sample: Dict = {
            "image": img,
            "keypoints2d": full,
            "keypoint_format": self.SOURCE,
            "center": center,
            "scale": scale,
            "bbox_size": bbox_size,
            "orig_center": center.copy(),
            "orig_bbox_size": bbox_size,
            "fname": item["img_fname"],
            "gender": gender,
            "gender_int": GENDER_TO_INT.get(str(gender).lower()[:1], 0),
            "index": index,
        }
        for key in ("height", "chest", "waist", "hips", "weight"):
            if item.get(key) is not None:
                sample[key] = np.float32(item[key])
                sample[f"{key}_valid"] = np.float32(1.0)
        if item.get("attributes"):
            sample["attributes"] = np.asarray(item["attributes"],
                                              np.float32)
            sample["attributes_valid"] = np.float32(1.0)
        if item.get("betas") is not None:
            sample["gt_betas"] = np.asarray(item["betas"], np.float32)
        if self.transforms is not None:
            from shapy_tpu_torch.data.rng import augment_rng

            sample = self.transforms(
                sample, augment_rng(index, self.is_train))
        return sample
