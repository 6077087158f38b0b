"""Linear blend skinning (port of ``shapy_tpu/models/body/lbs.py``).

Blend shapes, joint regression and pose-corrective offsets are plain
matmuls (the JAX package left them to XLA). The kinematic chain is
:func:`shapy_tpu_torch.core.kinematics.batch_rigid_transform` (kernel
K3-chain on the card). Skinning goes through :func:`skin`, whose CUDA path
is kernel K3 (``csrc/skinning.cu``), forward and backward.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from shapy_tpu_torch.core.geometry import blend_shapes, vertices2joints
from shapy_tpu_torch.core.kinematics import batch_rigid_transform
from shapy_tpu_torch.utils.cuda_kernels import CudaKernel, check_cuda_input

SKIN_KERNEL = CudaKernel("skinning.cu", {
    "skin_forward": "pppp iii p",
    "skin_backward": "ppppppp iii p",
})
# The kernels keep one (128 x J) weight tile, J 3x4 transforms and (in the
# backward) 128 x 12 outer products in the default 48 KB of shared memory:
# 4 * (12 J + 128 (J + 12)) bytes.
_SKIN_MAX_JOINTS = 76
_SKIN_TILE = 128


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


class _Skin(torch.autograd.Function):
    """K3 forward and backward kernels (no gradient for the weights)."""

    @staticmethod
    def forward(ctx, lbs_weights, rel_transforms, v_posed):
        B, V, _ = v_posed.shape
        J = lbs_weights.shape[1]
        out = torch.empty_like(v_posed)
        if B > 0 and V > 0:
            SKIN_KERNEL.launch("skin_forward", [
                lbs_weights, rel_transforms, v_posed, out, B, V, J])
        ctx.save_for_backward(lbs_weights, rel_transforms, v_posed)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        lbs_weights, rel_transforms, v_posed = ctx.saved_tensors
        B, V, _ = v_posed.shape
        J = lbs_weights.shape[1]
        grad_out = grad_out.contiguous()
        d_v = torch.empty_like(v_posed)
        d_rel = torch.empty_like(rel_transforms)
        tiles = -(-V // _SKIN_TILE)
        partials = torch.empty((B, tiles, J, 12), dtype=torch.float32,
                               device=v_posed.device)
        if B > 0 and V > 0:
            SKIN_KERNEL.launch("skin_backward", [
                lbs_weights, rel_transforms, v_posed, grad_out, d_v,
                partials, d_rel, B, V, J])
        else:
            d_rel.zero_()
        return None, d_rel, d_v


def skin(lbs_weights: torch.Tensor, rel_transforms: torch.Tensor,
         v_posed: torch.Tensor) -> torch.Tensor:
    """Skinning: the plain version for CPU tensors, kernel K3 for CUDA
    tensors (forward, and backward to ``rel_transforms`` and
    ``v_posed``)."""
    if v_posed.device.type == "cpu":
        return skin_plain(lbs_weights, rel_transforms, v_posed)
    if v_posed.device.type != "cuda":
        raise ValueError(f"skin: unsupported device {v_posed.device}")
    B, V, _ = v_posed.shape
    J = lbs_weights.shape[1]
    if J > _SKIN_MAX_JOINTS:
        raise ValueError(f"skin: {J} joints exceed the kernel's "
                         f"{_SKIN_MAX_JOINTS}")
    if lbs_weights.requires_grad:
        raise ValueError("skin: the kernel gives no gradient for the "
                         "skinning weights")
    dev = v_posed.device
    check_cuda_input(lbs_weights, "lbs_weights", torch.float32, (V, J), dev)
    check_cuda_input(rel_transforms, "rel_transforms", torch.float32,
                     (B, J, 4, 4), dev)
    check_cuda_input(v_posed, "v_posed", torch.float32, (B, V, 3), dev)
    return _Skin.apply(lbs_weights, rel_transforms, v_posed)


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
