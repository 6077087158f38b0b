"""Regression databases for the attribute models (port of
``shapy_tpu/models/attributes/regression_data.py``).

The reference's databases are ``{dataset}_{gender}_{split}.pt`` files
(joblib dumps) of per-subject betas (``betas_{model_type}_
{model_gender}``), attribute ratings and measurement columns, gathered
into train / val / test splits. They are read with ``joblib`` where it is
installed and otherwise by :func:`shapy_tpu_torch.io.pickles.load_pickle`
(plain pickles and joblib's uncompressed format).
:meth:`RegressionDataset.synthetic` draws the JAX package's synthetic
database, bit for bit from the same seed.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from shapy_tpu_torch.models.attributes.constants import ATTRIBUTE_NAMES


class RegressionDataset:
    """db = {'labels': [...], 'train'/'val'/'test': {column: array}}."""

    def __init__(
        self,
        ds_name: str = "caesar",
        ds_gender: str = "female",
        model_gender: str = "neutral",
        model_type: str = "smplx",
        db_folder: str = "../data/dbs",
        db: Optional[Dict] = None,
        **kwargs,
    ):
        self.ds_name = ds_name
        self.ds_gender = ds_gender
        self.model_gender = model_gender
        self.model_type = model_type
        self.betas_key = f"betas_{model_type}_{model_gender}"

        if db is not None:
            self.db = db
            return

        from shapy_tpu_torch.io.pickles import load_pickle

        db_folder = os.path.expandvars(db_folder)
        self.db = {"labels": ATTRIBUTE_NAMES[ds_gender]}
        for split in ("train", "val", "test"):
            path = os.path.join(
                db_folder, f"{ds_name}_{ds_gender}_{split}.pt"
            )
            if os.path.exists(path):
                self.db[split] = load_pickle(path)

    @classmethod
    def synthetic(cls, seed: int = 0, n_train: int = 400, n_eval: int = 64,
                  ds_gender: str = "female", model_gender: str = "neutral",
                  model_type: str = "smplx", num_betas: int = 10
                  ) -> "RegressionDataset":
        """A database with a consistent linear betas <-> ratings map, for
        tests and smoke training without the CAESAR license."""
        rng = np.random.default_rng(seed)
        W = rng.normal(size=(num_betas, 15)) * 0.4
        betas_key = f"betas_{model_type}_{model_gender}"

        def make(n):
            betas = rng.normal(size=(n, num_betas))
            rating = np.clip(betas @ W + 3.0
                             + rng.normal(size=(n, 15)) * 0.05, 1, 5)
            height = 1.7 + betas[:, 0] * 0.05
            weight = 65 + betas[:, 1] * 8
            return {
                betas_key: betas.astype(np.float32),
                "rating": rating.astype(np.float32),
                "height_gt": height.astype(np.float32),
                "weight_gt": weight.astype(np.float32),
                "height_bg": height.astype(np.float32),
                "weight_bg": weight.astype(np.float32),
                "chest": (0.9 + betas[:, 1] * 0.05).astype(np.float32),
                "waist": (0.7 + betas[:, 1] * 0.06).astype(np.float32),
                "hips": (0.95 + betas[:, 1] * 0.05).astype(np.float32),
            }

        db = {
            "labels": ATTRIBUTE_NAMES[ds_gender],
            "train": make(n_train),
            "val": make(n_eval),
            "test": make(n_eval),
        }
        return cls(ds_name="synthetic-db", ds_gender=ds_gender,
                   model_gender=model_gender, model_type=model_type, db=db)
