"""The demo's regressor builder (port of ``build_demo_regressor`` in
``shapy_tpu/cli/demo.py``), which the evaluation CLI shares.

Only :func:`build_demo_regressor` is ported. The demo itself (images and
OpenPose keypoints -> fitted SMPL-X meshes, parameters and rendered
overlays) needs the renderer and waits for it; this module has no
``main`` yet.
"""

from __future__ import annotations

import os
from typing import Dict

import torch

from shapy_tpu_torch.measure.measurements import (
    BodyMeasurements,
    MeasurementAnchors,
)
from shapy_tpu_torch.models.body.assets import make_synthetic_model_data
from shapy_tpu_torch.models.body.model import SMPLX
from shapy_tpu_torch.models.heads.regressor import (
    BodyRegressor,
    build_body_head,
)
from shapy_tpu_torch.utils.device import get_device


def build_demo_regressor(exp_cfg: Dict, checkpoint_path: str = "",
                         device: str | torch.device = "cuda") -> BodyRegressor:
    """The regressor of a layered config on ``device``, its weights drawn
    as the JAX package draws them.

    The body model is SMPL-X from ``body_model.model_folder``, or a
    synthetic SMPL-X (``make_synthetic_model_data`` at
    ``SHAPY_TPU_TEST_SUBDIV`` subdivisions, default 5) with synthetic
    measurement anchors where ``SHAPY_TPU_SYNTHETIC_BODY=1`` or the folder
    does not exist.

    ``network.<model>.compute_dtype`` must be ``float32`` or
    ``bfloat16``; the caller picks the backbone's dtype with
    ``prepare_for_eval_``. Importing a reference checkpoint
    (``checkpoint_path`` naming a file) and the B2A / A2B plugins (``use_b2a``
    / ``use_a2b`` with both genders' checkpoints present; without them the
    JAX package runs without the plugin, and so does the port) are not
    ported yet and raise."""
    device = get_device(device)
    body_cfg = dict(exp_cfg.get("body_model") or {})
    model_folder = os.path.expandvars(body_cfg.get("model_folder", ""))
    smplx_cfg = dict(body_cfg.get("smplx") or {})
    num_betas = int((smplx_cfg.get("betas") or {}).get("num", 10))
    use_synthetic = (
        os.environ.get("SHAPY_TPU_SYNTHETIC_BODY", "0") == "1"
        or not os.path.isdir(model_folder)
    )
    if use_synthetic:
        subdiv = int(os.environ.get("SHAPY_TPU_TEST_SUBDIV", "5"))
        body_model = SMPLX(make_synthetic_model_data(
            "smplx", subdivisions=subdiv), num_betas=num_betas)
        anchors = MeasurementAnchors.synthetic(
            body_model.faces, body_model.v_template.numpy())
        measurements = BodyMeasurements(anchors, body_model.faces)
    else:
        body_model = SMPLX(
            model_folder=model_folder, num_betas=num_betas,
            num_expression_coeffs=int(
                (smplx_cfg.get("expression") or {}).get("num", 10)),
            use_face_contour=bool(smplx_cfg.get("use_face_contour", False)))
        measurements = BodyMeasurements(None, body_model.faces,
                                        model_type="smplx")

    network = dict(exp_cfg.get("network") or {})
    net_sub = dict(network.get("smplx") or network.get("smpl") or {})
    dtype_name = str(net_sub.get("compute_dtype", "") or "")
    if dtype_name not in ("", "float32", "bfloat16", "bf16"):
        raise ValueError("network compute_dtype must be float32|bfloat16, "
                         f"got {dtype_name!r}")
    for plugin in ("b2a", "a2b"):
        paths = [os.path.expandvars(
            net_sub.get(f"{plugin}_{g}_checkpoint", "") or "")
            for g in ("males", "females")]
        if net_sub.get(f"use_{plugin}") and all(
                p and os.path.exists(p) for p in paths):
            raise NotImplementedError(
                f"the {plugin.upper()} attribute plugin is not ported yet")
    if checkpoint_path and os.path.exists(checkpoint_path):
        raise NotImplementedError(
            f"importing the reference checkpoint {checkpoint_path!r} is not "
            "ported yet")
    regressor = build_body_head(exp_cfg, body_model=body_model,
                                measurements=measurements)
    return regressor.to(device)

