"""Input-feature selection and preprocessing for the A2S / S2A models
(port of ``shapy_tpu/models/attributes/features.py``).

* :func:`select_features`: the config's booleans choose which attributes
  and measurements form the input vector; attribute keys are the
  lowercase, underscored gender-specific names, in the canonical order.
* :func:`build_feature_vector`: ratings + measurement columns on the
  host in float64, with the BodyTalk preprocessing (height x 100, mass /
  weight -> cube root) where asked.
* :func:`to_whw2s`: the whw2s setup, height to cm and weight -> sqrt.
* :func:`feature_vector_tensor`: the tensor twin of
  :func:`build_feature_vector`, the A2B plugin's features inside the
  regressor's forward. Like the JAX package's
  ``A2B.create_input_feature_vec_jax`` it keeps the BodyTalk cube root and
  x100 and leaves out whw2s, a fit-time transform.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from shapy_tpu_torch.models.attributes.constants import ATTRIBUTE_NAMES

def attr_key(name: str) -> str:
    return name.lower().replace(" ", "_")


def select_features(cfg: Dict) -> Tuple[List[str], np.ndarray, List[str]]:
    """(selected attribute names, their indices, selected measurement keys)."""
    ds_gender = cfg.get("ds_gender", "female")
    names = ATTRIBUTE_NAMES[ds_gender]

    attributes: List[str] = []
    if cfg.get("use_attributes", True):
        conf = cfg.get(f"{ds_gender}_attributes") or {}
        attributes = [k for k, v in conf.items() if v]

    # Names and indices share one order, the canonical one: the config's
    # insertion order would mislabel feature columns.
    idx = np.asarray(
        [i for i, n in enumerate(names) if attr_key(n) in attributes],
        dtype=np.int64,
    )
    if len(idx) != len(attributes):
        raise ValueError("Some selected attributes are not annotated")
    attributes = [attr_key(names[i]) for i in idx]

    mmts: List[str] = []
    if cfg.get("use_measurements", True):
        conf = cfg.get("measurements") or {}
        mmts = [k for k, v in conf.items() if v]
    return attributes, idx, mmts


def _bodytalk(name: str, m):
    if "height" in name:
        m = m * 100.0
    if "mass" in name or "weight" in name:
        m = np.cbrt(m) if isinstance(m, np.ndarray) else torch.pow(
            m.abs(), 1.0 / 3.0) * torch.sign(m)
    return m


def build_feature_vector(
    batch: Dict[str, np.ndarray],
    attr_idx: np.ndarray,
    selected_mmts: Sequence[str],
    bodytalk_meas_preprocess: bool = False,
) -> np.ndarray:
    """ratings (B, 15) + measurement columns -> (B, n_features) float64."""
    cols = [np.asarray(batch["rating"], dtype=np.float64)[:, attr_idx]]
    for name in selected_mmts:
        m = np.asarray(batch[name], dtype=np.float64).reshape(-1, 1)
        if bodytalk_meas_preprocess:
            m = _bodytalk(name, m)
        cols.append(m)
    return np.concatenate(cols, axis=1)


def feature_vector_tensor(
    batch: Dict[str, torch.Tensor],
    attr_idx: np.ndarray,
    selected_mmts: Sequence[str],
    bodytalk_meas_preprocess: bool = False,
) -> torch.Tensor:
    """:func:`build_feature_vector` on tensors, differentiable, in the
    ratings' dtype on their device."""
    rating = batch["rating"]
    idx = torch.as_tensor(attr_idx, dtype=torch.long, device=rating.device)
    cols = [rating.index_select(1, idx)]
    for name in selected_mmts:
        m = batch[name].reshape(-1, 1).to(rating.dtype)
        if bodytalk_meas_preprocess:
            m = _bodytalk(name, m)
        cols.append(m)
    return torch.cat(cols, dim=1)


def to_whw2s(
    features: np.ndarray,
    feature_names: Sequence[str],
    noise: np.ndarray | None = None,
) -> np.ndarray:
    """The whw2s preprocessing of the raw feature vector: height x 100,
    weight (plus its noise, if given) -> sqrt, then the other columns'
    noise added."""
    out = np.array(features, dtype=np.float64, copy=True)
    names = np.asarray(list(feature_names))
    h = np.nonzero(names == "height_gt")[0]
    w = np.nonzero(names == "weight_gt")[0]
    out[:, h] = out[:, h] * 100.0
    if noise is None:
        out[:, w] = np.sqrt(out[:, w])
    else:
        noise = np.array(noise, dtype=np.float64, copy=True)
        out[:, w] = np.sqrt(out[:, w] + noise[:, w])
        noise[:, w] = 0.0
        out = out + noise
    return out
