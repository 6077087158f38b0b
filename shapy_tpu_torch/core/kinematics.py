"""Forward kinematics over a joint tree (port of
``shapy_tpu/core/kinematics.py``).

Joints are composed level by level of tree depth: all joints at one
depth compose with their parents in one batched matmul, so the SMPL-X
tree costs one small matmul per level instead of 55 dependent ones.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch


def compute_level_schedule(parents: Sequence[int]) -> List[np.ndarray]:
    """Joint indices grouped by tree depth; level 0 is ``[0]``."""
    parents = np.asarray(parents)
    num_joints = len(parents)
    depth = np.zeros(num_joints, dtype=np.int64)
    for j in range(1, num_joints):
        depth[j] = depth[parents[j]] + 1
    return [np.nonzero(depth == d)[0].astype(np.int32)
            for d in range(int(depth.max()) + 1)]


def local_transforms(rot_mats: torch.Tensor, rel_joints: torch.Tensor
                     ) -> torch.Tensor:
    """(..., J, 3, 3) rotations + (..., J, 3) offsets -> (..., J, 4, 4)."""
    top = torch.cat([rot_mats, rel_joints[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=rot_mats.dtype,
                          device=rot_mats.device)
    bottom = bottom.expand(*rot_mats.shape[:-2], 1, 4)
    return torch.cat([top, bottom], dim=-2)


def batch_rigid_transform(
    rot_mats: torch.Tensor,
    joints: torch.Tensor,
    parents: Sequence[int],
    levels: Sequence[np.ndarray] | None = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Compose local rotations down the kinematic chain.

    rot_mats (B, J, 3, 3), joints (B, J, 3) rest-pose joints.
    Returns posed_joints (B, J, 3), rel_transforms (B, J, 4, 4) (world
    transform with the rest joint removed, for skinning) and the world
    transforms (B, J, 4, 4).
    """
    parents_np = np.asarray(parents)
    if levels is None:
        levels = compute_level_schedule(parents_np)
    device = joints.device

    parent_idx = torch.as_tensor(np.maximum(parents_np, 0), device=device)
    rel_joints = joints - joints[..., parent_idx, :]
    rel_joints[..., 0, :] = joints[..., 0, :]
    A = local_transforms(rot_mats, rel_joints)

    world = A.clone()
    for level in levels[1:]:
        lvl = torch.as_tensor(np.asarray(level, np.int64), device=device)
        par = torch.as_tensor(parents_np[np.asarray(level)], device=device)
        world[..., lvl, :, :] = world[..., par, :, :] @ A[..., lvl, :, :]

    posed_joints = world[..., :3, 3]
    rotated_rest = (world[..., :3, :3] @ joints[..., None])[..., 0]
    rel_transforms = world.clone()
    rel_transforms[..., :3, 3] = world[..., :3, 3] - rotated_rest
    return posed_joints, rel_transforms, world
