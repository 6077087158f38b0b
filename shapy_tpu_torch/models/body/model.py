"""SMPL / SMPL-H / SMPL-X body models (port of
``shapy_tpu/models/body/model.py``).

The model parameters are buffers whose ``state_dict`` keys are the JAX
package's param names (``v_template``, ``shapedirs``, ``posedirs`` ...).
Static topology (faces, parents, depth schedule) stays numpy on the host;
``faces`` is also kept as a non-persistent device buffer.

The full pose is assembled in the reference's order (SMPL-X: global,
body(21), jaw, leye, reye, lhand(15), rhand(15)). Pose inputs are
rotation matrices ``(B, n, 3, 3)`` or axis-angle ``(B, n, 3)`` / flat
``(B, n*3)``.

Ported so far: what the flagship regressor runs (pose assembly, the
SMPL-X expression slice, static landmarks, ``v_shaped`` without
expression), loading the release files from ``model_folder`` and
:func:`build_body_model`. Not yet: the SMPL-X dynamic face contour,
mesh-surface extra joints and the J14 regressor override.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from shapy_tpu_torch.core.geometry import blend_shapes, vertices2landmarks
from shapy_tpu_torch.core.kinematics import compute_level_schedule
from shapy_tpu_torch.core.rotations import aa_to_rotmat
from shapy_tpu_torch.models.body.assets import load_model_data
from shapy_tpu_torch.models.body.lbs import lbs


def _as_rotmats(pose: Optional[torch.Tensor], batch: int, n: int,
                like: torch.Tensor) -> torch.Tensor:
    """Default to identity; convert axis-angle (B, n, 3) / (B, n*3)."""
    if pose is None:
        eye = torch.eye(3, dtype=like.dtype, device=like.device)
        return eye.expand(batch, n, 3, 3)
    pose = pose.to(like.dtype)
    if pose.dim() == 2 or (pose.shape[-1] == 3 and pose.shape[-2] != 3):
        return aa_to_rotmat(pose.reshape(batch, n, 3))
    return pose.reshape(batch, n, 3, 3)


class SMPL(nn.Module):
    """SMPL body model: 23 body joints + root, linear shape space."""

    NAME = "smpl"
    NUM_BODY_JOINTS = 23
    SHAPE_SPACE_DIM = 300

    def __init__(self, model_data: Optional[Dict[str, np.ndarray]] = None,
                 num_betas: int = 10, dtype: torch.dtype = torch.float32,
                 model_folder: str = "", gender: str = "neutral",
                 ext: str = "npz"):
        """``model_data`` as :func:`~shapy_tpu_torch.models.body.assets
        .load_model_data` returns it, or None to load the release file
        of this model, ``gender`` and ``ext`` from ``model_folder``."""
        super().__init__()
        if model_data is None:
            model_data = load_model_data(model_folder, self.NAME,
                                         gender=gender, ext=ext)
        self.gender = gender
        self.dtype = dtype
        self.faces = np.asarray(model_data["f"], dtype=np.int64)
        parents = np.asarray(model_data["kintree_table"][0], dtype=np.int64)
        parents[0] = -1
        self.parents = parents
        self.levels = compute_level_schedule(parents)

        shapedirs = np.asarray(model_data["shapedirs"])
        self.num_betas = min(int(num_betas), shapedirs.shape[-1],
                             self.SHAPE_SPACE_DIM)
        posedirs = np.asarray(model_data["posedirs"])
        # Runtime layout (P, V*3): pose offsets are one (B, P) x (P, V*3)
        # matmul.
        posedirs = posedirs.reshape(posedirs.shape[0] * 3, -1).T

        def buf(name, value):  # C-contiguous: the kernels require it
            self.register_buffer(name, torch.as_tensor(
                np.ascontiguousarray(value), dtype=dtype))

        buf("v_template", model_data["v_template"])
        buf("shapedirs", shapedirs[:, :, :self.num_betas])
        buf("posedirs", posedirs)
        buf("J_regressor", model_data["J_regressor"])
        buf("lbs_weights", model_data["weights"])
        self.register_buffer("faces_tensor", torch.as_tensor(self.faces),
                             persistent=False)
        self._post_init(model_data)

    def _post_init(self, model_data: Dict[str, np.ndarray]) -> None:
        pass

    @property
    def num_verts(self) -> int:
        return self.v_template.shape[0]

    @property
    def num_joints(self) -> int:
        return self.J_regressor.shape[0]

    def forward_shape(self, betas: torch.Tensor) -> Dict[str, torch.Tensor]:
        """betas -> shaped (T-pose) vertices."""
        v_shaped = self.v_template[None] + blend_shapes(
            betas.to(self.dtype), self.shapedirs)
        return {"vertices": v_shaped, "v_shaped": v_shaped, "betas": betas}

    def _pose_groups(self) -> Dict[str, int]:
        return {"global_rot": 1, "body_pose": self.NUM_BODY_JOINTS}

    def _shape_components(self, betas: torch.Tensor,
                          kwargs: Dict[str, Any]):
        return betas.to(self.dtype), self.shapedirs

    def _extra_landmarks(self, vertices: torch.Tensor
                         ) -> Optional[torch.Tensor]:
        return None

    def forward(self, betas: Optional[torch.Tensor] = None,
                **kwargs) -> Dict[str, Any]:
        """Pose groups by name (``global_rot``, ``body_pose`` ...) and, for
        SMPL-X, ``expression``; missing groups are identity, missing betas
        and expression zero. Returns ``vertices``, ``joints`` (with the
        landmarks appended), ``v_shaped`` and ``faces``."""
        pose_args = [kwargs.get(k) for k in self._pose_groups()]
        batch = max([1] + [a.shape[0] for a in (betas, *pose_args)
                           if a is not None])
        if betas is None:
            betas = self.v_template.new_zeros((batch, self.num_betas))
        shape_comps, shapedirs = self._shape_components(betas, kwargs)
        full_pose = torch.cat(
            [_as_rotmats(kwargs.get(name), batch, n, self.v_template)
             for name, n in self._pose_groups().items()], dim=1)

        out = lbs(shape_comps, full_pose, self.v_template, shapedirs,
                  self.posedirs, self.J_regressor, self.parents,
                  self.lbs_weights, levels=self.levels)
        vertices, joints = out["vertices"], out["joints"]
        landmarks = self._extra_landmarks(vertices)
        if landmarks is not None:
            joints = torch.cat([joints, landmarks], dim=1)
        return {"joints": joints, "vertices": vertices, "faces": self.faces,
                "v_shaped": self._v_shaped_for_output(out, betas)}

    def _v_shaped_for_output(self, lbs_out, betas) -> torch.Tensor:
        return lbs_out["v_shaped"]


class SMPLH(SMPL):
    """SMPL+H: SMPL body with 2 x 15 articulated hand joints."""

    NAME = "smplh"
    NUM_BODY_JOINTS = 21
    NUM_HAND_JOINTS = 15

    def __init__(self, model_data: Optional[Dict[str, np.ndarray]] = None,
                 num_hand_components: int = 45, **kwargs):
        self.num_hand_components = num_hand_components
        super().__init__(model_data, **kwargs)

    def _post_init(self, model_data: Dict[str, np.ndarray]) -> None:
        super()._post_init(model_data)
        # Hand PCA bases (for PCA hand-pose spaces, not ported yet).
        n = self.num_hand_components
        for side in ("l", "r"):
            comps = model_data.get(f"hands_components{side}")
            mean = model_data.get(f"hands_mean{side}")
            if comps is not None:
                self.register_buffer(f"hand_components_{side}",
                                     torch.as_tensor(comps[:n],
                                                     dtype=self.dtype))
            if mean is not None:
                self.register_buffer(f"hand_mean_{side}",
                                     torch.as_tensor(mean, dtype=self.dtype))

    def _pose_groups(self) -> Dict[str, int]:
        return {
            "global_rot": 1,
            "body_pose": self.NUM_BODY_JOINTS,
            "left_hand_pose": self.NUM_HAND_JOINTS,
            "right_hand_pose": self.NUM_HAND_JOINTS,
        }


class SMPLX(SMPLH):
    """SMPL-X: SMPL-H + jaw/eyes, expression space, facial landmarks."""

    NAME = "smplx"
    EXPRESSION_SPACE_DIM = 100

    def __init__(self, model_data: Optional[Dict[str, np.ndarray]] = None,
                 num_expression_coeffs: int = 10, **kwargs):
        self.num_expression_coeffs = int(num_expression_coeffs)
        super().__init__(model_data, **kwargs)

    def _post_init(self, model_data: Dict[str, np.ndarray]) -> None:
        super()._post_init(model_data)
        # Expression basis: shapedirs[:, :, 300:300+n], or the trailing
        # dims of synthetic / truncated assets.
        shapedirs = np.asarray(model_data["shapedirs"])
        start = self.SHAPE_SPACE_DIM
        if shapedirs.shape[-1] <= self.SHAPE_SPACE_DIM:
            start = max(0, shapedirs.shape[-1] - self.EXPRESSION_SPACE_DIM)
        expr_dirs = shapedirs[:, :, start:start + self.num_expression_coeffs]
        self.register_buffer("expr_dirs", torch.as_tensor(
            np.ascontiguousarray(expr_dirs), dtype=self.dtype))
        self.register_buffer("lmk_faces_idx", torch.as_tensor(
            np.asarray(model_data["lmk_faces_idx"]), dtype=torch.int32))
        self.register_buffer("lmk_bary_coords", torch.as_tensor(
            np.asarray(model_data["lmk_bary_coords"]), dtype=self.dtype))

    def _pose_groups(self) -> Dict[str, int]:
        return {
            "global_rot": 1,
            "body_pose": self.NUM_BODY_JOINTS,
            "jaw_pose": 1,
            "leye_pose": 1,
            "reye_pose": 1,
            "left_hand_pose": self.NUM_HAND_JOINTS,
            "right_hand_pose": self.NUM_HAND_JOINTS,
        }

    def _shape_components(self, betas, kwargs):
        expression = kwargs.get("expression")
        if expression is None:
            expression = betas.new_zeros(
                (betas.shape[0], self.num_expression_coeffs))
        shape_comps = torch.cat([betas.to(self.dtype),
                                 expression.to(self.dtype)], dim=-1)
        shapedirs = torch.cat([self.shapedirs, self.expr_dirs], dim=-1)
        return shape_comps, shapedirs

    def _extra_landmarks(self, vertices):
        return vertices2landmarks(vertices, self.faces_tensor,
                                  self.lmk_faces_idx, self.lmk_bary_coords)

    def _v_shaped_for_output(self, lbs_out, betas):
        # SMPL-X reports v_shaped WITHOUT the expression dims.
        return self.v_template[None] + blend_shapes(betas.to(self.dtype),
                                                    self.shapedirs)


MODEL_CLASSES = {"smpl": SMPL, "smplh": SMPLH, "smplx": SMPLX}


def build_body_model(model_type: str = "smplx", **kwargs) -> SMPL:
    """The body model of ``model_type`` ("smpl", "smplh", "smplx")."""
    return MODEL_CLASSES[model_type](**kwargs)
