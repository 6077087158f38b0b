"""Linear blend skinning (port of ``shapy_tpu/models/body/lbs.py``).

Blend shapes, joint regression and pose-corrective offsets are plain
matmuls (the JAX package left them to XLA). The kinematic chain is the
depth-scheduled composition of :mod:`shapy_tpu_torch.core.kinematics`.
Skinning goes through :func:`skin`, whose CUDA path is kernel K3
(``csrc/skinning.cu``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from shapy_tpu_torch.core.geometry import blend_shapes, vertices2joints
from shapy_tpu_torch.core.kinematics import batch_rigid_transform
from shapy_tpu_torch.utils.cuda_kernels import CudaKernel, check_cuda_input

SKIN_KERNEL = CudaKernel("skinning.cu", {"skin_forward": "pppp iii p"})
# The kernel keeps one (128 x J) weight tile plus J 3x4 transforms in
# 48 KB of static-size shared memory: 4 * J * (128 + 12) bytes.
_SKIN_MAX_JOINTS = 85


def skin_plain(lbs_weights: torch.Tensor, rel_transforms: torch.Tensor,
               v_posed: torch.Tensor) -> torch.Tensor:
    """``v = sum_j w_vj A_j [v_posed; 1]`` with the (B, V, 4, 4) per-vertex
    transforms materialised, as ``lbs.py:97-101`` of the JAX package.

    lbs_weights (V, J), rel_transforms (B, J, 4, 4), v_posed (B, V, 3)
    -> (B, V, 3)."""
    B, J = rel_transforms.shape[:2]
    T = torch.matmul(lbs_weights, rel_transforms.reshape(B, J, 16))
    T = T.reshape(B, -1, 4, 4)
    v_hom = torch.cat([v_posed, torch.ones_like(v_posed[..., :1])], dim=-1)
    return torch.matmul(T[..., :3, :], v_hom[..., None])[..., 0]


def skin(lbs_weights: torch.Tensor, rel_transforms: torch.Tensor,
         v_posed: torch.Tensor) -> torch.Tensor:
    """Skinning: the plain version for CPU tensors, kernel K3 for CUDA
    tensors (forward only)."""
    if v_posed.device.type == "cpu":
        return skin_plain(lbs_weights, rel_transforms, v_posed)
    if v_posed.device.type != "cuda":
        raise ValueError(f"skin: unsupported device {v_posed.device}")
    B, V, _ = v_posed.shape
    J = lbs_weights.shape[1]
    if J > _SKIN_MAX_JOINTS:
        raise ValueError(f"skin: {J} joints exceed the kernel's "
                         f"{_SKIN_MAX_JOINTS}")
    dev = v_posed.device
    check_cuda_input(lbs_weights, "lbs_weights", torch.float32, (V, J), dev)
    check_cuda_input(rel_transforms, "rel_transforms", torch.float32,
                     (B, J, 4, 4), dev)
    check_cuda_input(v_posed, "v_posed", torch.float32, (B, V, 3), dev)
    out = torch.empty_like(v_posed)
    if B == 0 or V == 0:
        return out
    SKIN_KERNEL.launches += 1
    SKIN_KERNEL.launch("skin_forward",
                       [lbs_weights, rel_transforms, v_posed, out, B, V, J])
    return out


def lbs(
    betas: torch.Tensor,
    pose: torch.Tensor,
    v_template: torch.Tensor,
    shapedirs: torch.Tensor,
    posedirs: torch.Tensor,
    J_regressor: torch.Tensor,
    parents: Sequence[int],
    lbs_weights: torch.Tensor,
    levels: Optional[Sequence[np.ndarray]] = None,
) -> Dict[str, torch.Tensor]:
    """Linear blend skinning.

    betas (B, L) blend coefficients (may include expression dims); pose
    (B, J, 3, 3) rotations; v_template (V, 3); shapedirs (V, 3, L);
    posedirs (9*(J-1), V*3); J_regressor (J, V); lbs_weights (V, J).

    Returns ``vertices`` (B, V, 3), ``joints`` (B, J, 3), ``v_shaped``
    (B, V, 3) and ``rel_transforms`` (B, J, 4, 4).
    """
    B = max(betas.shape[0], pose.shape[0])
    v_shaped = v_template[None] + blend_shapes(betas, shapedirs)
    v_shaped = v_shaped.expand(B, -1, -1)
    joints = vertices2joints(J_regressor, v_shaped)
    rot_mats = pose.expand(B, -1, -1, -1)
    ident = torch.eye(3, dtype=rot_mats.dtype, device=rot_mats.device)
    pose_feature = (rot_mats[:, 1:] - ident).reshape(B, -1)
    pose_offsets = (pose_feature @ posedirs).reshape(B, -1, 3)
    v_posed = v_shaped + pose_offsets

    posed_joints, rel_transforms, _ = batch_rigid_transform(
        rot_mats, joints, parents, levels=levels
    )
    verts = skin(lbs_weights, rel_transforms.contiguous(),
                 v_posed.contiguous())
    return {
        "vertices": verts,
        "joints": posed_joints,
        "v_shaped": v_shaped,
        "rel_transforms": rel_transforms,
    }
