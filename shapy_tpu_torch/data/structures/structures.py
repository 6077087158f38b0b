"""Annotation structures: typed field bags with geometric transforms
(a numpy copy of ``shapy_tpu/data/structures/structures.py``; a test
holds each structure's arrays equal to the JAX package's).

Behavioural spec: reference ``regressor/human_shape/data/structures/``
(14 files, ~2100 LoC): an ``AbstractStructure`` base carrying extra
fields plus per-type geometric ops (crop / flip / rotate / normalize),
``Keypoints2D/3D`` with cross-format remapping, parameter containers
(Betas, Expression, pose types), ``BoundingBox``, ``Vertices``/``Joints``,
and ``ImageList`` batching.

The data path moves plain padded arrays through
:func:`shapy_tpu_torch.data.build.collate_batch`; these structures are
the host-side annotation layer, numpy only, for dataset code that
handles annotations before collation. The transform math is shared with
:mod:`shapy_tpu_torch.data.crop` (one affine instead of chained warps).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from shapy_tpu_torch.data import crop as crop_utils
from shapy_tpu_torch.data.keypoints import flip_permutation, map_keypoints


class AbstractStructure:
    """Field bag with chained geometric ops (reference
    abstract_structure.py:5-75)."""

    def __init__(self):
        self.extra_fields: Dict = {}

    def add_field(self, name: str, value) -> None:
        self.extra_fields[name] = value

    def get_field(self, name: str, default=None):
        return self.extra_fields.get(name, default)

    def has_field(self, name: str) -> bool:
        return name in self.extra_fields

    def fields(self) -> List[str]:
        return list(self.extra_fields)

    def _copy_fields(self, other: "AbstractStructure", op: str, *args,
                     **kwargs) -> None:
        for k, v in self.extra_fields.items():
            if isinstance(v, AbstractStructure) and hasattr(v, op):
                v = getattr(v, op)(*args, **kwargs)
            other.add_field(k, v)

    # Default no-op transforms; subclasses override what applies to them.
    def crop(self, center, scale, crop_size=256, **kwargs):
        return self

    def flip(self, width: int):
        return self

    def normalize(self, size=None):
        return self

    def to_tensor(self):
        return self


class Keypoints2D(AbstractStructure):
    """(N, 3) [x, y, conf] keypoints in pixel coordinates
    (reference structures/keypoints.py:26-530)."""

    def __init__(self, keypoints: np.ndarray, size: Tuple[int, ...],
                 source: str = "openpose25_v1", **kwargs):
        super().__init__()
        kp = np.asarray(keypoints, np.float32)
        if kp.shape[-1] == 2:
            kp = np.concatenate([kp, np.ones_like(kp[..., :1])], axis=-1)
        self.keypoints = kp
        self.size = size  # (H, W, ...) of the carrying image
        self.source = source

    @property
    def conf(self) -> np.ndarray:
        return self.keypoints[..., -1]

    def to_dset(self, target: str) -> "Keypoints2D":
        """Cross-format remap by name (keypoints.py to_dset :123-186)."""
        mapped, conf = map_keypoints(
            self.keypoints[..., :2], self.source, target,
            self.keypoints[..., 2],
        )
        out = Keypoints2D(
            np.concatenate([mapped, conf[..., None]], axis=-1),
            self.size, source=target,
        )
        self._copy_fields(out, "to_dset", target)
        return out

    def crop(self, center, scale, crop_size: int = 256, rot: float = 0.0,
             **kwargs) -> "Keypoints2D":
        affine = crop_utils.image_to_crop_affine(
            center, scale, (crop_size, crop_size), rot
        )
        kp = np.array(self.keypoints, copy=True)
        kp[..., :2] = crop_utils.transform_points(kp[..., :2], affine)
        out = Keypoints2D(kp, (crop_size, crop_size, 3), self.source)
        self._copy_fields(out, "crop", center, scale, crop_size)
        return out

    def flip(self, width: Optional[int] = None) -> "Keypoints2D":
        W = width if width is not None else self.size[1]
        perm = flip_permutation(self.source)
        kp = np.array(self.keypoints, copy=True)[perm]
        kp[..., 0] = W - 1 - kp[..., 0]
        out = Keypoints2D(kp, self.size, self.source)
        self._copy_fields(out, "flip", W)
        return out

    def normalize(self, size=None) -> "Keypoints2D":
        """Pixel coords -> [-1, 1] (keypoints.py:285-300)."""
        H, W = (size or self.size)[:2]
        kp = np.array(self.keypoints, copy=True)
        kp[..., 0] = 2.0 * kp[..., 0] / W - 1.0
        kp[..., 1] = 2.0 * kp[..., 1] / H - 1.0
        out = Keypoints2D(kp, self.size, self.source)
        self._copy_fields(out, "normalize", size)
        return out

    def __len__(self) -> int:
        return self.keypoints.shape[0]


class Keypoints3D(AbstractStructure):
    """(N, 4) [x, y, z, conf] 3D keypoints."""

    def __init__(self, keypoints: np.ndarray,
                 source: str = "smplx", **kwargs):
        super().__init__()
        kp = np.asarray(keypoints, np.float32)
        if kp.shape[-1] == 3:
            kp = np.concatenate([kp, np.ones_like(kp[..., :1])], axis=-1)
        self.keypoints = kp
        self.source = source

    def to_dset(self, target: str) -> "Keypoints3D":
        mapped, conf = map_keypoints(
            self.keypoints[..., :3], self.source, target,
            self.keypoints[..., 3],
        )
        return Keypoints3D(
            np.concatenate([mapped, conf[..., None]], axis=-1), target
        )

    def rotate(self, rot_deg: float) -> "Keypoints3D":
        """In-plane rotation matching image augmentation."""
        rad = np.deg2rad(rot_deg)
        R = np.asarray(
            [[np.cos(rad), -np.sin(rad), 0],
             [np.sin(rad), np.cos(rad), 0],
             [0, 0, 1]], np.float32,
        )
        kp = np.array(self.keypoints, copy=True)
        kp[..., :3] = kp[..., :3] @ R.T
        return Keypoints3D(kp, self.source)

    def flip(self, *args) -> "Keypoints3D":
        perm = flip_permutation(self.source)
        kp = np.array(self.keypoints, copy=True)[perm]
        kp[..., 0] *= -1
        return Keypoints3D(kp, self.source)


class BoundingBox(AbstractStructure):
    """xyxy box (reference structures/bbox.py)."""

    def __init__(self, bbox, size):
        super().__init__()
        self.bbox = np.asarray(bbox, np.float32).reshape(4)
        self.size = size

    def flip(self, width: Optional[int] = None) -> "BoundingBox":
        W = width if width is not None else self.size[1]
        x0, y0, x1, y1 = self.bbox
        return BoundingBox([W - 1 - x1, y0, W - 1 - x0, y1], self.size)

    def to_center_scale(self, dset_scale_factor: float = 1.0):
        from shapy_tpu_torch.data.bbox import bbox_to_center_scale

        return bbox_to_center_scale(self.bbox, dset_scale_factor)


class _ParamStructure(AbstractStructure):
    FLIP_SIGN: Optional[np.ndarray] = None

    def __init__(self, value):
        super().__init__()
        self.value = np.asarray(value, np.float32)

    def flip(self, *args):
        return self


class Betas(_ParamStructure):
    pass


class Expression(_ParamStructure):
    pass


def _flip_aa_pose(pose: np.ndarray, flip_pairs) -> np.ndarray:
    """Mirror an axis-angle pose: swap left/right joints, negate y/z."""
    p = np.array(pose, copy=True).reshape(-1, 3)
    for i, j in flip_pairs:
        p[[i, j]] = p[[j, i]]
    p[:, 1] *= -1
    p[:, 2] *= -1
    return p.reshape(pose.shape)


class BodyPose(_ParamStructure):
    # SMPL body joint left/right pairs (indices into the 21/23 joints).
    # (21, 22) are the SMPL hand stubs — present only in the 23-joint
    # SMPL body pose; _flip_aa_pose skips pairs beyond the pose length.
    FLIP_PAIRS = [(0, 1), (3, 4), (6, 7), (9, 10), (12, 13), (15, 16),
                  (17, 18), (19, 20), (21, 22)]

    def flip(self, *args) -> "BodyPose":
        pose = np.asarray(self.value).reshape(-1, 3)
        pairs = [p for p in self.FLIP_PAIRS if p[1] < len(pose)]
        return BodyPose(_flip_aa_pose(self.value, pairs))


class GlobalRot(_ParamStructure):
    def flip(self, *args) -> "GlobalRot":
        v = np.array(self.value, copy=True).reshape(3)
        v[1] *= -1
        v[2] *= -1
        return GlobalRot(v)


class HandPose(_ParamStructure):
    pass


class JawPose(_ParamStructure):
    def flip(self, *args) -> "JawPose":
        v = np.array(self.value, copy=True).reshape(-1, 3)
        v[:, 1] *= -1
        v[:, 2] *= -1
        return JawPose(v.reshape(self.value.shape))


class Vertices(AbstractStructure):
    """(V, 3) mesh vertices with optional flip correspondences
    (reference structures/vertices.py)."""

    def __init__(self, vertices, flip_index=None, bc=None,
                 closest_faces=None):
        super().__init__()
        self.vertices = np.asarray(vertices, np.float32)
        self.flip_index = flip_index
        self.bc = bc
        self.closest_faces = closest_faces

    def flip(self, *args) -> "Vertices":
        v = np.array(self.vertices, copy=True)
        v[..., 0] *= -1
        if self.bc is not None and self.closest_faces is not None:
            # Resample the mirrored surface through the correspondence map
            v = (v[self.closest_faces] *
                 self.bc[..., None]).sum(axis=-2)
        elif self.flip_index is not None:
            v = v[self.flip_index]
        return Vertices(v, self.flip_index, self.bc, self.closest_faces)


class Joints(AbstractStructure):
    def __init__(self, joints, source: str = "smplx"):
        super().__init__()
        self.joints = np.asarray(joints, np.float32)
        self.source = source


class Points2D(AbstractStructure):
    def __init__(self, points, size):
        super().__init__()
        self.points = np.asarray(points, np.float32)
        self.size = size


class ImageList:
    """Batch of images padded to a common size (reference
    image_list.py:10-177); returns the padded tensor + original sizes."""

    def __init__(self, tensor: np.ndarray, sizes: List[Tuple[int, int]]):
        self.tensor = tensor
        self.sizes = sizes

    @classmethod
    def from_images(cls, images: Sequence[np.ndarray]) -> "ImageList":
        sizes = [img.shape[:2] for img in images]
        H = max(s[0] for s in sizes)
        W = max(s[1] for s in sizes)
        C = images[0].shape[2] if images[0].ndim == 3 else 1
        out = np.zeros((len(images), H, W, C), images[0].dtype)
        for i, img in enumerate(images):
            h, w = img.shape[:2]
            out[i, :h, :w] = img.reshape(h, w, -1)
        return cls(out, sizes)

    def __len__(self) -> int:
        return len(self.sizes)
