"""Human Bodies in the Wild (HBW) dataset (port of
``shapy_tpu/data/datasets/hbw.py``).

Images under ``<img_folder>/<split>/<subject>_.../<img_type>/<image>``
with OpenPose JSONs mirrored under the keypoint folder, GT ``v_shaped``
meshes per subject (``.obj``), ``genders.yaml`` (read by
:mod:`shapy_tpu_torch.utils.yaml_subset`), multi-person images skipped.

The GT measurements are computed once for all subjects, given a
measurement module and the body model's faces: one
``BodyMeasurements.forward`` on the GT triangles (kernel K1-AoS on the
card, where the module lies), cached in
``<data_folder>/_meas_cache_<split>.npz`` in the JAX package's format, so
that a cache written by either package reads in the other. A cache whose
subject ids differ from the dataset's is recomputed.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from shapy_tpu_torch.data.bbox import bbox_to_center_scale, keyps_to_bbox
from shapy_tpu_torch.data.datasets.openpose import read_img
from shapy_tpu_torch.data.openpose import (
    read_openpose_json,
    threshold_and_keep_parts,
)
from shapy_tpu_torch.utils import yaml_subset

GENDER_TO_INT = {"neutral": 0, "n": 0, "male": 1, "m": 1, "female": 2,
                 "f": 2}


def load_obj_vertices(path: str) -> np.ndarray:
    verts = []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]),
                              float(parts[3])])
    return np.asarray(verts, np.float64)


class HBWDataset:
    SOURCE = "openpose25_v1"

    def __init__(
        self,
        data_folder: str = "data/HBW",
        img_folder: str = "photos",
        keyp_folder: str = "keypoints",
        mesh_folder: str = "v_templates/smplx",
        gender_fname: str = "genders.yaml",
        split: str = "val",
        transforms=None,
        body_thresh: float = 0.1,
        hand_thresh: float = 0.2,
        face_thresh: float = 0.4,
        binarization: bool = True,
        body_dset_factor: float = 1.2,
        skip_multi_person: bool = True,
        measurements_module=None,
        body_model_faces: Optional[np.ndarray] = None,
        **kwargs,
    ):
        self.data_folder = os.path.expandvars(data_folder)
        self.split = split
        self.transforms = transforms
        self.body_thresh = body_thresh
        self.hand_thresh = hand_thresh
        self.face_thresh = face_thresh
        self.binarization = binarization
        self.body_dset_factor = body_dset_factor

        img_root = os.path.join(self.data_folder, img_folder, split)
        keyp_root = os.path.join(self.data_folder, keyp_folder, split)
        mesh_root = os.path.join(self.data_folder, mesh_folder, split)

        # GT meshes per subject
        self.gt_v_shaped: Dict[str, np.ndarray] = {}
        if split in ("val", "test") and os.path.isdir(mesh_root):
            for fname in sorted(os.listdir(mesh_root)):
                if fname.startswith(".") or not fname.endswith(".obj"):
                    continue
                sid = os.path.splitext(fname)[0]
                self.gt_v_shaped[sid] = load_obj_vertices(
                    os.path.join(mesh_root, fname)
                )

        gender_data = yaml_subset.load(
            os.path.join(self.data_folder, gender_fname)) or {}

        self.img_paths: List[str] = []
        self.subject_ids: List[str] = []
        self.genders: List[str] = []
        keypoints = []
        num_skipped = 0
        if os.path.isdir(img_root):
            for subject_folder in sorted(os.listdir(img_root)):
                if subject_folder.startswith("."):
                    continue
                sid = subject_folder.split("_")[0]
                subj_path = os.path.join(img_root, subject_folder)
                for img_type in sorted(os.listdir(subj_path)):
                    if img_type.startswith("."):
                        continue
                    type_path = os.path.join(subj_path, img_type)
                    keyp_path = os.path.join(
                        keyp_root, subject_folder, img_type
                    )
                    for img_fname in sorted(os.listdir(type_path)):
                        if img_fname.startswith("."):
                            continue
                        stem = os.path.splitext(img_fname)[0]
                        kp_file = os.path.join(keyp_path, f"{stem}.json")
                        if not os.path.exists(kp_file):
                            alt = stem.replace("(", "").replace(
                                ")", "").replace(" ", "_")
                            kp_file = os.path.join(keyp_path,
                                                   f"{alt}.json")
                        if not os.path.exists(kp_file):
                            continue
                        kp = read_openpose_json(kp_file)
                        if kp is None or (
                            skip_multi_person and kp.shape[0] != 1
                        ):
                            num_skipped += 1
                            continue
                        self.img_paths.append(
                            os.path.join(type_path, img_fname)
                        )
                        self.subject_ids.append(sid)
                        self.genders.append(gender_data.get(sid, "neutral"))
                        keypoints.append(kp[0])
        self.keypoints2d = (
            np.stack(keypoints) if keypoints
            else np.zeros((0, 135, 3), np.float32)
        )
        self.num_skipped = num_skipped

        # Batched GT measurements, cached on disk
        self.gt_measurements: Dict[str, Dict[str, float]] = {}
        if self.gt_v_shaped and measurements_module is not None \
                and body_model_faces is not None:
            self.gt_measurements = self._compute_gt_measurements(
                measurements_module, body_model_faces
            )

    def _compute_gt_measurements(self, meas_module, faces) -> Dict:
        cache_path = os.path.join(
            self.data_folder, f"_meas_cache_{self.split}.npz"
        )
        sids = sorted(self.gt_v_shaped)
        if os.path.exists(cache_path):
            with np.load(cache_path, allow_pickle=True) as d:
                if list(d["subject_ids"]) == sids:
                    return {
                        sid: {k: float(d[k][i]) for k in
                              ("height", "chest", "waist", "hips", "mass")}
                        for i, sid in enumerate(sids)
                    }
        device = meas_module.faces.device
        verts = torch.as_tensor(
            np.stack([self.gt_v_shaped[s] for s in sids]),
            dtype=torch.float32, device=device)
        faces = torch.as_tensor(np.asarray(faces), device=device).long()
        with torch.inference_mode():
            meas = meas_module.forward(verts[:, faces])["measurements"]
            arrays = {k: meas[k]["tensor"].cpu().numpy() for k in
                      ("height", "chest", "waist", "hips", "mass")}
        out = {}
        for i, sid in enumerate(sids):
            out[sid] = {k: float(v[i]) for k, v in arrays.items()}
        np.savez(cache_path, subject_ids=sids, **arrays)
        return out

    def __len__(self) -> int:
        return len(self.img_paths)

    def only_2d(self) -> bool:
        return False

    def name(self) -> str:
        return f"HumanBodyInTheWild/{self.split}"

    def __getitem__(self, index: int) -> Optional[Dict]:
        img = read_img(self.img_paths[index])
        kp = threshold_and_keep_parts(
            np.array(self.keypoints2d[index], copy=True), self.SOURCE,
            self.body_thresh, self.hand_thresh, self.face_thresh,
            self.binarization,
        )
        bbox = keyps_to_bbox(kp[:, :2], kp[:, 2], img_size=img.shape)
        center, scale, bbox_size = bbox_to_center_scale(
            bbox, dset_scale_factor=self.body_dset_factor
        )
        if center is None:
            return None
        sid = self.subject_ids[index]
        gender = self.genders[index]
        sample: Dict = {
            "image": img,
            "keypoints2d": kp,
            "keypoint_format": self.SOURCE,
            "center": center,
            "scale": scale,
            "bbox_size": bbox_size,
            "orig_center": center.copy(),
            "orig_bbox_size": bbox_size,
            "fname": os.path.basename(self.img_paths[index]),
            "subject_id": sid,
            "gender": gender,
            "gender_int": GENDER_TO_INT.get(str(gender).lower()[:1], 0),
            "index": index,
        }
        if sid in self.gt_v_shaped:
            sample["gt_v_shaped"] = self.gt_v_shaped[sid].astype(np.float32)
        if sid in self.gt_measurements:
            sample.update(
                {f"{k}_gt": v for k, v in self.gt_measurements[sid].items()}
            )
        if self.transforms is not None:
            from shapy_tpu_torch.data.rng import augment_rng

            sample = self.transforms(
                sample, augment_rng(index, "train" in self.split))
        return sample
