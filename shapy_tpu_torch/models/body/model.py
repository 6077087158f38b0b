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

The JAX model's API: ``forward(betas, transl, get_skin,
return_full_pose, return_shaped, **pose_groups)`` (SMPL-X also takes
``expression``; any other keyword raises ``TypeError``), the ``v_template``
override, mesh-surface extra joints, the J14 regressor override, PCA hands
(:meth:`SMPLH.hand_pca_to_rotmats`), the SMPL-X dynamic face contour,
``num_faces`` and ``keypoint_names``; loading the release files from
``model_folder`` and :func:`build_body_model`.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from shapy_tpu_torch.core.geometry import blend_shapes, vertices2landmarks
from shapy_tpu_torch.core.kinematics import compute_level_schedule
from shapy_tpu_torch.core.rotations import aa_to_rotmat, rotmat_to_euler_y
from shapy_tpu_torch.data.keypoints import model_keypoint_names
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
                 ext: str = "npz", v_template: Optional[np.ndarray] = None,
                 extra_joint_faces: Optional[np.ndarray] = None,
                 extra_joint_bcs: Optional[np.ndarray] = None,
                 extra_joint_names: Optional[Sequence[str]] = None,
                 j14_regressor: Optional[np.ndarray] = None,
                 j14_source_idxs: Optional[np.ndarray] = None,
                 j14_target_idxs: Optional[np.ndarray] = None):
        """``model_data`` as :func:`~shapy_tpu_torch.models.body.assets
        .load_model_data` returns it, or None to load the release file
        of this model, ``gender`` and ``ext`` from ``model_folder``.

        ``v_template`` replaces the file's template. ``extra_joint_faces``
        (E,) and ``extra_joint_bcs`` (E, 3) append E joints at barycentric
        points of the mesh, named ``extra_joint_names``.
        ``j14_regressor`` (R, V) regresses joints from the vertices whose
        rows ``j14_target_idxs`` replace the joints ``j14_source_idxs``."""
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

        buf("v_template", model_data["v_template"] if v_template is None
            else v_template)
        buf("shapedirs", shapedirs[:, :, :self.num_betas])
        buf("posedirs", posedirs)
        buf("J_regressor", model_data["J_regressor"])
        buf("lbs_weights", model_data["weights"])
        self.register_buffer("faces_tensor", torch.as_tensor(self.faces),
                             persistent=False)

        self.extra_joint_names = list(extra_joint_names or [])
        self.extra_joint_faces = None
        if extra_joint_faces is not None:
            self.extra_joint_faces = np.asarray(extra_joint_faces, np.int64)
            buf("extra_joint_bcs", extra_joint_bcs)
            self.register_buffer("extra_joint_vertices", torch.as_tensor(
                self.faces[self.extra_joint_faces]), persistent=False)
        self.use_joint_regressor = j14_regressor is not None
        if self.use_joint_regressor:
            buf("extra_joint_regressor", j14_regressor)
            for name, idxs in (("j14_source_idxs", j14_source_idxs),
                               ("j14_target_idxs", j14_target_idxs)):
                self.register_buffer(name, torch.as_tensor(
                    np.array(idxs, np.int64)), persistent=False)
        self._post_init(model_data)

    def _post_init(self, model_data: Dict[str, np.ndarray]) -> None:
        pass

    @property
    def num_verts(self) -> int:
        return self.v_template.shape[0]

    @property
    def num_faces(self) -> int:
        return self.faces.shape[0]

    @property
    def num_joints(self) -> int:
        return self.J_regressor.shape[0]

    @property
    def keypoint_names(self):
        """The joints' names: this model's (SMPL-X: the contour's 17 only
        with ``use_face_contour``), then the extra joints'."""
        return model_keypoint_names(
            self.NAME, use_face_contour=getattr(self, "use_face_contour",
                                                True)) + \
            self.extra_joint_names

    def forward_shape(self, betas: torch.Tensor) -> Dict[str, torch.Tensor]:
        """betas -> shaped (T-pose) vertices."""
        v_shaped = self.v_template[None] + blend_shapes(
            betas.to(self.dtype), self.shapedirs)
        return {"vertices": v_shaped, "v_shaped": v_shaped, "betas": betas}

    def _pose_groups(self) -> Dict[str, int]:
        return {"global_rot": 1, "body_pose": self.NUM_BODY_JOINTS}

    def _other_inputs(self) -> tuple:
        """Keywords of :meth:`forward` besides the pose groups."""
        return ()

    def _shape_components(self, betas: torch.Tensor,
                          kwargs: Dict[str, Any]):
        return betas.to(self.dtype), self.shapedirs

    def _extra_landmarks(self, vertices: torch.Tensor,
                         full_pose: torch.Tensor) -> Optional[torch.Tensor]:
        return None

    def forward(self, betas: Optional[torch.Tensor] = None,
                transl: Optional[torch.Tensor] = None, get_skin: bool = True,
                return_full_pose: bool = False, return_shaped: bool = True,
                **kwargs) -> Dict[str, Any]:
        """Pose groups by name (``global_rot``, ``body_pose`` ...) and, for
        SMPL-X, ``expression``; missing groups are identity, missing betas
        and expression zero; another keyword raises ``TypeError``.
        ``transl`` (B, 3) moves the joints and vertices.

        Returns ``joints`` (with the landmarks and extra joints appended,
        the J14 override applied), ``faces``, and ``vertices`` if
        ``get_skin``, ``full_pose`` (B, J, 3, 3) if ``return_full_pose``,
        ``v_shaped`` if ``return_shaped``."""
        unknown = set(kwargs) - set(self._pose_groups()) - set(
            self._other_inputs())
        if unknown:
            raise TypeError(f"{type(self).__name__}.forward: unexpected "
                            f"keyword(s) {sorted(unknown)}")
        pose_args = [kwargs.get(k) for k in self._pose_groups()]
        batch = max([1] + [a.shape[0] for a in (betas, transl, *pose_args)
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
        joint_set = [joints]
        landmarks = self._extra_landmarks(vertices, full_pose)
        if landmarks is not None:
            joint_set.append(landmarks)
        if self.extra_joint_faces is not None:
            tri = vertices[:, self.extra_joint_vertices]  # (B, E, 3, 3)
            joint_set.append(torch.sum(
                tri * self.extra_joint_bcs[None, :, :, None], dim=-2))
        joints = torch.cat(joint_set, dim=1)
        if self.use_joint_regressor:
            reg_joints = torch.matmul(self.extra_joint_regressor, vertices)
            joints = joints.index_copy(1, self.j14_source_idxs,
                                       reg_joints[:, self.j14_target_idxs])
        if transl is not None:
            transl = transl.to(self.dtype)[:, None]
            joints = joints + transl
            vertices = vertices + transl

        output: Dict[str, Any] = {"joints": joints, "faces": self.faces}
        if get_skin:
            output["vertices"] = vertices
        if return_full_pose:
            output["full_pose"] = full_pose
        if return_shaped:
            output["v_shaped"] = self._v_shaped_for_output(out, betas)
        return output

    def _v_shaped_for_output(self, lbs_out, betas) -> torch.Tensor:
        return lbs_out["v_shaped"]


class SMPLH(SMPL):
    """SMPL+H: SMPL body with 2 x 15 articulated hand joints and PCA
    hand-pose bases."""

    NAME = "smplh"
    NUM_BODY_JOINTS = 21
    NUM_HAND_JOINTS = 15

    def __init__(self, model_data: Optional[Dict[str, np.ndarray]] = None,
                 num_hand_components: int = 45, flat_hand_mean: bool = True,
                 **kwargs):
        self.num_hand_components = num_hand_components
        self.flat_hand_mean = flat_hand_mean
        super().__init__(model_data, **kwargs)

    def _post_init(self, model_data: Dict[str, np.ndarray]) -> None:
        super()._post_init(model_data)
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

    def hand_pca_to_rotmats(self, coeffs: torch.Tensor, side: str
                            ) -> torch.Tensor:
        """PCA hand coefficients (B, n) of ``side`` ("l" or "r") -> (B, 15,
        3, 3) rotations; the mean pose is added unless
        ``flat_hand_mean``."""
        aa = coeffs.to(self.dtype) @ getattr(self, f"hand_components_{side}")
        if not self.flat_hand_mean:
            aa = aa + getattr(self, f"hand_mean_{side}")[None]
        return aa_to_rotmat(aa.reshape(coeffs.shape[0], 15, 3))


def find_joint_kin_chain(joint_id: int, parents: np.ndarray) -> list:
    """``joint_id`` and its ancestors up to the root."""
    chain = []
    while joint_id != -1:
        chain.append(joint_id)
        joint_id = int(parents[joint_id])
    return chain


class SMPLX(SMPLH):
    """SMPL-X: SMPL-H + jaw/eyes, expression space, facial landmarks and,
    with ``use_face_contour``, the 17 contour landmarks that follow the
    neck's yaw."""

    NAME = "smplx"
    EXPRESSION_SPACE_DIM = 100
    HEAD_IDX = 15

    def __init__(self, model_data: Optional[Dict[str, np.ndarray]] = None,
                 num_expression_coeffs: int = 10,
                 use_face_contour: bool = False, **kwargs):
        self.num_expression_coeffs = int(num_expression_coeffs)
        self.use_face_contour = use_face_contour
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
        self.register_buffer("dynamic_lmk_faces_idx", torch.as_tensor(
            np.asarray(model_data["dynamic_lmk_faces_idx"]),
            dtype=torch.int32))
        self.register_buffer("dynamic_lmk_bary_coords", torch.as_tensor(
            np.ascontiguousarray(model_data["dynamic_lmk_bary_coords"]),
            dtype=self.dtype))
        self.neck_kin_chain = find_joint_kin_chain(
            min(self.HEAD_IDX, self.num_joints - 1), self.parents)

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

    def _other_inputs(self) -> tuple:
        return ("expression",)

    def _shape_components(self, betas, kwargs):
        expression = kwargs.get("expression")
        if expression is None:
            expression = betas.new_zeros(
                (betas.shape[0], self.num_expression_coeffs))
        shape_comps = torch.cat([betas.to(self.dtype),
                                 expression.to(self.dtype)], dim=-1)
        shapedirs = torch.cat([self.shapedirs, self.expr_dirs], dim=-1)
        return shape_comps, shapedirs

    def _dynamic_contour(self, full_pose: torch.Tensor):
        """The contour landmarks' (B, 17) faces and (B, 17, 3) barycentrics:
        the table row of the neck chain's yaw in whole degrees."""
        rel = torch.eye(3, dtype=full_pose.dtype, device=full_pose.device)
        for joint in self.neck_kin_chain:
            rel = full_pose[:, joint] @ rel
        y_deg = torch.clamp(torch.round(
            -rotmat_to_euler_y(rel) * 180.0 / math.pi), max=39).to(
                torch.int64)
        row = torch.where(y_deg < 0,
                          torch.where(y_deg < -39, 78, 39 - y_deg), y_deg)
        return self.dynamic_lmk_faces_idx[row], \
            self.dynamic_lmk_bary_coords[row]

    def _extra_landmarks(self, vertices, full_pose):
        B = vertices.shape[0]
        faces_idx = self.lmk_faces_idx.expand(B, -1)
        bary = self.lmk_bary_coords.expand(B, -1, -1)
        if self.use_face_contour:
            dyn_idx, dyn_bary = self._dynamic_contour(full_pose)
            faces_idx = torch.cat([faces_idx, dyn_idx], dim=1)
            bary = torch.cat([bary, dyn_bary], dim=1)
        return vertices2landmarks(vertices, self.faces_tensor, faces_idx,
                                  bary)

    def _v_shaped_for_output(self, lbs_out, betas):
        # SMPL-X reports v_shaped WITHOUT the expression dims.
        return self.v_template[None] + blend_shapes(betas.to(self.dtype),
                                                    self.shapedirs)


MODEL_CLASSES = {"smpl": SMPL, "smplh": SMPLH, "smplx": SMPLX}


def build_body_model(model_type: str = "smplx", **kwargs) -> SMPL:
    """The body model of ``model_type`` ("smpl", "smplh", "smplx")."""
    return MODEL_CLASSES[model_type](**kwargs)
