"""Attribute-model registry (port of
``shapy_tpu/models/attributes/build.py``)."""

from __future__ import annotations

from typing import Dict, Optional

from shapy_tpu_torch.models.attributes.a2b import A2B
from shapy_tpu_torch.models.attributes.b2a import B2A
from shapy_tpu_torch.models.attributes.prob import A2BProbabilistic

MODEL_DICT = {
    "a2b": A2B,
    "b2a": B2A,
    "a2b-prob": A2BProbabilistic,
}


def build(cfg: Optional[Dict] = None, **kwargs):
    cfg = dict(cfg or {})
    model_type = cfg.get("type", "a2b")
    if model_type not in MODEL_DICT:
        raise ValueError(f"Unknown attribute model type: {model_type}")
    return MODEL_DICT[model_type](cfg, **kwargs)
