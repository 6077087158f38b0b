"""B2A / S2A: SMPL-X shape coefficients -> linguistic attribute ratings
(port of ``shapy_tpu/models/attributes/b2a.py``).

The input is the first ``num_shape_comps`` betas; the output the
selected attribute ratings (1-5) followed by the selected measurements.
:class:`B2A` is an ``nn.Module`` whose network is ``b2a`` (a reference
Lightning B2A's ``state_dict`` names), fitted with the network zoo's
``fit``; :meth:`B2A.metrics` is the per-output L1 mean / std and the
rounded-class accuracy.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from shapy_tpu_torch.models.attributes.features import select_features
from shapy_tpu_torch.models.attributes.networks import build_network


def _checkpoint_cfg(path: str, cfg: Optional[Dict]):
    """A reference Lightning checkpoint -> (merged cfg, state dict)."""
    from shapy_tpu_torch.io.pickles import load_torch_file

    ckpt = load_torch_file(path)
    hp = ckpt.get("hyper_parameters", {})
    conf = dict(hp.get("cfg", {}) if isinstance(hp, dict) else {})
    if cfg:
        conf.update(cfg)
    return conf, ckpt.get("state_dict", ckpt.get("model", {}))


class B2A(nn.Module):
    def __init__(self, cfg: Optional[Dict] = None,
                 generator: Optional[torch.Generator] = None, **kwargs):
        super().__init__()
        cfg = dict(cfg or {}, **kwargs)
        self.cfg = cfg
        self.betas_size = int(cfg.get("num_shape_comps", 10))
        self.model_type = cfg.get("model_type", "smplx")
        self.model_gender = cfg.get("model_gender", "female")
        self.ds_gender = cfg.get("ds_gender", "female")

        self.selected_attr, self.selected_attr_idx, self.selected_mmts = (
            select_features(cfg)
        )
        self.output_feature_size = len(self.selected_attr) + len(
            self.selected_mmts
        )
        self.b2a = build_network(cfg.get("network"), self.betas_size,
                                 self.output_feature_size,
                                 generator=generator)
        self.eval()

    @property
    def output_names(self):
        return list(self.selected_attr) + list(self.selected_mmts)

    # -- inference --------------------------------------------------------
    def forward(self, betas: torch.Tensor) -> torch.Tensor:
        return self.b2a(betas)

    def predict(self, betas) -> np.ndarray:
        betas = np.asarray(betas)[:, : self.betas_size]
        return self.b2a.predict(betas)

    # -- fitting / evaluation ---------------------------------------------
    def _tvt(self, db: Dict) -> Tuple:
        beta_key = f"betas_{self.model_type}_{self.model_gender}"
        out = []
        for split in ("train", "val", "test"):
            d = db[split]
            # Targets in output_names order: the selected attribute
            # columns, then the selected measurement columns.
            cols = [np.asarray(d["rating"])[:, self.selected_attr_idx]]
            for m in self.selected_mmts:
                cols.append(
                    np.asarray(d[m], np.float32).reshape(-1, 1))
            y = np.concatenate(cols, axis=1)
            assert y.shape[1] == self.output_feature_size
            out.append(
                (np.asarray(d[beta_key])[:, : self.betas_size], y)
            )
        return tuple(out)

    def fit(self, db: Dict, generator: Optional[torch.Generator] = None
            ) -> Dict[str, Dict[str, np.ndarray]]:
        """Fit on the train split; the val and test metrics."""
        (xtr, ytr), (xval, yval), (xte, yte) = self._tvt(db)
        self.b2a.fit(xtr, ytr, generator=generator)
        report = {}
        for name, (x, y) in (("val", (xval, yval)), ("test", (xte, yte))):
            pred = self.b2a.predict(x)
            report[name] = self.metrics(y, pred)
        return report

    @staticmethod
    def metrics(gt: np.ndarray, pred: np.ndarray) -> Dict[str, np.ndarray]:
        """L1 mean / std and rounded-class accuracy, per output."""
        err = np.abs(gt - pred)
        correct = np.round(gt) == np.round(pred)
        return {
            "l1_mean": err.mean(0),
            "l1_std": err.std(0),
            "class_accuracy": correct.sum(0) / correct.shape[0],
        }

    # -- checkpoint I/O ----------------------------------------------------
    @classmethod
    def load_from_checkpoint(cls, path: str, cfg: Optional[Dict] = None
                             ) -> "B2A":
        """A reference Lightning checkpoint, any network type: its
        ``hyper_parameters['cfg']`` (updated by ``cfg``) builds the model,
        its ``b2a.`` block loads into ``b2a``."""
        from shapy_tpu_torch.models.attributes.ckpt_import import (
            network_from_state_dict,
        )

        conf, sd = _checkpoint_cfg(path, cfg)
        obj = cls(conf)
        if any(k.startswith("b2a.") for k in sd):
            obj.b2a = network_from_state_dict(
                conf.get("network"), obj.betas_size,
                obj.output_feature_size, sd, "b2a.")
        return obj
