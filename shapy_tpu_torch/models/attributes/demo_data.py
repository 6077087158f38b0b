"""Demo data for the attribute models (port of
``shapy_tpu/models/attributes/demo_data.py``).

:class:`DemoS2AData` reads per-image betas npz files and a genders YAML
(through the port's YAML reader); :class:`DemoA2SData` reads the rating
database ``modeldata_for_a2s_{gender}.pt`` (``joblib`` where installed,
else :func:`shapy_tpu_torch.io.pickles.load_pickle`) with height as it
is and bust / waist / hips from cm to m.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from shapy_tpu_torch.models.attributes.constants import ATTRIBUTE_NAMES


class DemoS2AData:
    """Betas npz files + genders.yaml -> per-gender beta DBs."""

    def __init__(
        self,
        betas_folder: str = "../samples/shapy_fit/",
        ds_genders_path: str = "../samples/genders.yaml",
        model_gender: str = "neutral",
        model_type: str = "smplx",
    ):
        from shapy_tpu_torch.utils import yaml_subset

        self.ds_gender = yaml_subset.load(ds_genders_path)
        self.betas_key = f"betas_{model_type}_{model_gender}"

        files = sorted(
            f for f in os.listdir(betas_folder) if f.endswith("npz")
        )
        self.npz_files: Dict[str, list] = {"male": [], "female": []}
        self.betas: Dict[str, list] = {"male": [], "female": []}
        for fname in files:
            # splitext, not split('.'): image ids may contain dots
            fid = os.path.splitext(fname)[0]
            gender = self.ds_gender[fid]
            data = np.load(os.path.join(betas_folder, fname))
            self.betas[gender].append(np.asarray(data["betas"]))
            self.npz_files[gender].append(fid)
        for g in ("male", "female"):
            self.betas[g] = (
                np.stack(self.betas[g]) if self.betas[g]
                else np.zeros((0, 10))
            )
        self.db: Dict = {}

    def create_db(self, ds_gender: str) -> Dict:
        self.db = {
            "labels": ATTRIBUTE_NAMES[ds_gender],
            self.betas_key: self.betas[ds_gender],
            "filename": self.npz_files[ds_gender],
        }
        return self.db


class DemoA2SData:
    """The rating database with BodyTalk's unit conversions."""

    def __init__(
        self,
        ds_gender: str = "female",
        model_gender: str = "neutral",
        model_type: str = "smplx",
        rating_folder: str = "../samples/attributes/",
    ):
        from shapy_tpu_torch.io.pickles import load_pickle

        path = os.path.join(
            rating_folder, f"modeldata_for_a2s_{ds_gender}.pt"
        )
        self.db = load_pickle(path)
        if "rating" not in self.db:
            self.db["rating"] = self.db["ratings"]
        self.db["height_gt"] = np.asarray(
            self.db["heights"], np.float32
        )
        for src, dst in (("bust", "chest"), ("waist", "waist"),
                         ("hips", "hips")):
            self.db[dst] = np.asarray(self.db[src], np.float32) / 100.0
