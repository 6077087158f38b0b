"""Data augmentation / preprocessing pipeline, host-side numpy (a copy of
``shapy_tpu/data/transforms.py``; a test holds every transform's fields
equal to the JAX package's).

Samples are plain dicts of fixed-size numpy arrays:

  image        (H, W, 3) float32 in [0, 1] (or uint8)
  keypoints2d  (N, 3) [x, y, conf] in image pixels
  center (2,), scale (float), bbox_size (float)
  + passthrough annotation fields (betas, gender, attributes, ...).

Augmentations move center / scale / rotation, and the terminal ``Crop``
applies one affine warp. ``cv2`` is imported only by the transforms that
need it, when they act: ``Resize``, ``MotionBlur``, ``SimulateLowRes``
and ``Crop``'s host warp; where it is missing they raise an
``ImportError`` that names the transform. ``Crop`` rotates the
axis-angle GT pose with :func:`rodrigues`, a numpy copy of
``cv2.Rodrigues``.

One deliberate difference from the JAX package: with
``return_full_imgs`` the port's ``Crop`` does not warp on the host. It
keeps the full image and ``crop_to_image``, and the device crops them
(kernel K2, as ``apply_from_full_images`` does), so the sample has no
``cropped_image``. The transforms that act on ``cropped_image`` then
leave it to the device too: ``ChannelNoise`` keeps its drawn (3,) factors
as ``channel_noise``, which K2 applies between the crop and the
normalisation, and ``Normalize`` is K2's own; ``SimulateLowRes``, which
has no device version, raises if it would act. The JAX ``Crop`` warps
with ``cv2`` (its fixed-point 1/32-pixel coordinates) in either case; the
machine with the card has no ``cv2``.
"""

from __future__ import annotations

import os
import warnings
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from shapy_tpu_torch.data import crop as crop_utils
from shapy_tpu_torch.data.crop import IMAGENET_MEAN, IMAGENET_STD
from shapy_tpu_torch.data.keypoints import flip_permutation, flip_pose_aa

Sample = Dict[str, object]


def _cv2(what: str):
    """``cv2``, or an ``ImportError`` that says which transform needs it."""
    try:
        import cv2
    except ImportError as exc:
        raise ImportError(
            f"{what} needs cv2, which is not installed; the training "
            "config's augmentations (flip, rotation, scale, channel noise) "
            "run without it on full images (return_full_imgs)") from exc
    return cv2


def rodrigues(x: np.ndarray) -> np.ndarray:
    """``cv2.Rodrigues`` in numpy, f64: an axis-angle vector (3,) -> its
    rotation matrix (3, 3), or a rotation matrix -> its axis-angle vector
    (the matrix first made orthogonal by its SVD, U V^T), with OpenCV's
    branches for angles near 0 and pi."""
    x = np.asarray(x, np.float64)
    if x.shape == (3, 3):
        U, _, Vt = np.linalg.svd(x)
        R = U @ Vt
        r = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                      R[1, 0] - R[0, 1]])
        s = np.sqrt((r @ r) * 0.25)
        c = min(max((R[0, 0] + R[1, 1] + R[2, 2] - 1) * 0.5, -1.0), 1.0)
        theta = np.arccos(c)
        if s >= 1e-5:
            return r * (1 / (2 * s) * theta)
        if c > 0:
            return np.zeros(3)
        r = np.sqrt(np.maximum((np.diag(R) + 1) * 0.5, 0.0))
        r[1] *= -1.0 if R[0, 1] < 0 else 1.0
        r[2] *= -1.0 if R[0, 2] < 0 else 1.0
        if (abs(r[0]) < abs(r[1]) and abs(r[0]) < abs(r[2])
                and (R[1, 2] > 0) != (r[1] * r[2] > 0)):
            r[2] = -r[2]
        return r * (theta / np.linalg.norm(r))
    theta = np.linalg.norm(x)
    if theta < np.finfo(np.float64).eps:
        return np.eye(3)
    c, s = np.cos(theta), np.sin(theta)
    r = x * (1.0 / theta)
    r_x = np.array([[0, -r[2], r[1]], [r[2], 0, -r[0]], [-r[1], r[0], 0]])
    return c * np.eye(3) + (1.0 - c) * np.outer(r, r) + s * r_x


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = [t for t in transforms if t is not None]

    def __call__(self, sample: Sample, rng: np.random.Generator) -> Sample:
        for t in self.transforms:
            sample = t(sample, rng)
        return sample


class Resize:
    """Cap the longer image side at ``max_size`` (transforms.py Resize)."""

    def __init__(self, max_size: float = -1):
        self.max_size = max_size

    def __call__(self, sample: Sample, rng) -> Sample:
        if self.max_size <= 0:
            return sample
        img = sample["image"]
        H, W = img.shape[:2]
        longer = max(H, W)
        if longer <= self.max_size:
            return sample
        cv2 = _cv2("Resize (max_size)")

        ratio = self.max_size / longer
        sample["image"] = cv2.resize(
            img, (int(W * ratio), int(H * ratio)),
            interpolation=cv2.INTER_AREA,
        )
        for key in ("keypoints2d",):
            if key in sample and sample[key] is not None:
                kp = np.array(sample[key], copy=True)
                kp[..., :2] *= ratio
                sample[key] = kp
        sample["center"] = np.asarray(sample["center"]) * ratio
        sample["scale"] = float(sample["scale"]) * ratio
        return sample


class BBoxCenterJitter:
    def __init__(self, factor: float = 0.0, dist: str = "normal"):
        self.factor = factor
        self.dist = dist

    def __call__(self, sample: Sample, rng) -> Sample:
        if self.factor <= 1e-3:
            return sample
        bbox_size = float(sample["scale"]) * crop_utils.REF_BBOX_SIZE
        if self.dist == "normal":
            jitter = rng.normal(size=2) * self.factor * bbox_size
        else:
            jitter = (rng.uniform(size=2) * 2 - 1) * self.factor * bbox_size
        sample["center"] = np.asarray(sample["center"]) + jitter
        return sample


class VertexFlipper:
    """Mirror a body mesh left<->right via surface correspondences.

    Reference semantics (ssp3d.py:84-94, model_agencies.py): the
    ``vertex_flip_correspondences`` npz ships ``closest_faces`` (V, 3
    vertex ids of the closest face on the mirrored surface) and ``bc``
    (V, 3 barycentrics); flipped vertex i resamples the x-negated mesh
    at that surface point. Negating x alone would produce a body with
    left/right asymmetries (e.g. hand vertex ordering) on the wrong
    side of the template's vertex layout.
    """

    def __init__(self, closest_faces: np.ndarray, bc: np.ndarray):
        self.closest_faces = np.asarray(closest_faces, np.int64)
        self.bc = np.asarray(bc, np.float32)

    @classmethod
    def from_npz(cls, path: str) -> "VertexFlipper":
        data = np.load(os.path.expandvars(os.path.expanduser(path)))
        return cls(data["closest_faces"], data["bc"])

    @classmethod
    def from_template(cls, vertices: np.ndarray,
                      chunk: int = 1024) -> "VertexFlipper":
        """Nearest-vertex correspondences computed from a template mesh
        (capability the reference lacks — it requires the shipped npz).
        Exact on mirror-symmetric templates; nearest-vertex otherwise."""
        v = np.asarray(vertices, np.float64)
        mirrored = v * np.array([-1.0, 1.0, 1.0])
        idx = np.empty(len(v), np.int64)
        for s in range(0, len(v), chunk):
            d = np.linalg.norm(
                mirrored[s:s + chunk, None, :] - v[None, :, :], axis=-1
            )
            idx[s:s + chunk] = np.argmin(d, axis=1)
        closest = np.stack([idx] * 3, axis=1)
        bc = np.tile(np.array([[1.0, 0.0, 0.0]], np.float32), (len(v), 1))
        return cls(closest, bc)

    def __call__(self, vertices: np.ndarray) -> np.ndarray:
        neg = np.asarray(vertices, np.float32) * np.array(
            [-1.0, 1.0, 1.0], np.float32
        )
        return np.einsum("vc,vck->vk", self.bc, neg[self.closest_faces])


class RandomHorizontalFlip:
    # Sample keys holding (V, 3) GT meshes that must mirror with the image.
    VERTEX_KEYS = ("gt_vertices", "gt_v_shaped", "v_shaped")

    def __init__(self, prob: float = 0.0, fmt: str = "openpose25_v1",
                 vertex_flipper: Optional["VertexFlipper"] = None):
        self.prob = prob
        self.fmt = fmt
        self._perms: Dict[str, np.ndarray] = {}
        self.vertex_flipper = vertex_flipper

    def _perm(self, fmt: str) -> np.ndarray:
        if fmt not in self._perms:
            self._perms[fmt] = flip_permutation(fmt)
        return self._perms[fmt]

    def __call__(self, sample: Sample, rng) -> Sample:
        if self.prob <= 0 or rng.uniform() > self.prob:
            return sample
        img = sample["image"]
        W = img.shape[1]
        sample["image"] = np.ascontiguousarray(img[:, ::-1])
        # Parametric datasets carry their own native ordering per
        # sample; the pipeline-level fmt is the fallback (the reference
        # builds flip_indices per dataset, e.g. ssp3d.py:132).
        fmt = str(sample.get("keypoint_format", self.fmt))
        kp = sample.get("keypoints2d")
        if kp is not None:
            kp = np.array(kp, copy=True)[self._perm(fmt)]
            kp[:, 0] = W - 1 - kp[:, 0]
            sample["keypoints2d"] = kp
        c = np.asarray(sample["center"], dtype=np.float64).copy()
        c[0] = W - 1 - c[0]
        sample["center"] = c
        mesh_keys = [k for k in self.VERTEX_KEYS if k in sample]
        if mesh_keys:
            if self.vertex_flipper is None:
                raise RuntimeError(
                    "flip augmentation hit a sample carrying GT meshes "
                    f"({mesh_keys}) but no vertex_flip_correspondences "
                    "is configured — the mesh would silently stay "
                    "unmirrored (reference ssp3d.py:85-92 asserts)"
                )
            for key in mesh_keys:
                sample[key] = self.vertex_flipper(sample[key])
        # Every GT modality must mirror together or the losses pull in
        # opposite directions on flipped samples:
        j3d = sample.get("joints3d")
        if j3d is not None:
            j3d = np.array(j3d, copy=True)
            perm = None
            for cand in (str(sample.get("joints3d_format", fmt)), fmt,
                         "spin", "h36m"):
                try:
                    p = self._perm(cand)
                except KeyError:
                    continue
                if len(p) == j3d.shape[0]:
                    perm = p
                    break
            if perm is None:
                # No usable left/right table for this row count: drop
                # the 3D GT for this flipped sample rather than train
                # on left/right-mislabelled joints.
                del sample["joints3d"]
            else:
                j3d = j3d[perm]
                j3d[..., 0] *= -1.0
                sample["joints3d"] = j3d
        if sample.get("gt_pose_aa") is not None:
            sample["gt_pose_aa"] = flip_pose_aa(sample["gt_pose_aa"])
        sample["is_flipped"] = True
        return sample


class RandomRotation:
    def __init__(self, is_train: bool = True, rotation_factor: float = 0.0):
        self.factor = rotation_factor if is_train else 0.0

    def __call__(self, sample: Sample, rng) -> Sample:
        if self.factor <= 0:
            return sample
        # Reference convention: rot ~ clamp(N(0, factor), +-2factor),
        # ZEROED 60% of the time, i.e. applied to 40% of samples
        # (reference transforms.py:395-400: `if uniform() <= 0.6: rot=0`).
        if rng.uniform() <= 0.6:
            return sample
        rot = np.clip(
            rng.normal() * self.factor, -2 * self.factor, 2 * self.factor
        )
        sample["rotation"] = float(sample.get("rotation", 0.0) + rot)
        return sample


class MotionBlur:
    def __init__(self, prob: float = 0.0, kernel_size_min: int = 3,
                 kernel_size_max: int = 7):
        self.prob = prob
        self.kmin = kernel_size_min
        self.kmax = kernel_size_max

    def __call__(self, sample: Sample, rng) -> Sample:
        if self.prob <= 0 or rng.uniform() > self.prob:
            return sample
        cv2 = _cv2("MotionBlur (motion_blur_prob)")

        k = int(rng.integers(self.kmin, self.kmax + 1)) | 1
        kernel = np.zeros((k, k), np.float32)
        angle = rng.uniform(0, np.pi)
        c = k // 2
        dx, dy = np.cos(angle), np.sin(angle)
        for t in np.linspace(-c, c, 2 * k):
            x, y = int(round(c + t * dx)), int(round(c + t * dy))
            if 0 <= x < k and 0 <= y < k:
                kernel[y, x] = 1
        kernel /= kernel.sum()
        sample["image"] = cv2.filter2D(sample["image"], -1, kernel)
        return sample


class ExtremeBodyCrop:
    """Crop to torso / upper body keypoints (transforms.py ExtremeBodyCrop),
    used to augment truncation robustness."""

    def __init__(self, prob: float = 0.0, torso_upper_body_prob: float = 0.5,
                 fmt: str = "openpose25_v1"):
        self.prob = prob
        self.torso_prob = torso_upper_body_prob
        self.fmt = fmt

    def __call__(self, sample: Sample, rng) -> Sample:
        from shapy_tpu_torch.data.keypoints import get_part_idxs

        if self.prob <= 0 or rng.uniform() > self.prob:
            return sample
        kp = sample.get("keypoints2d")
        if kp is None:
            return sample
        # Resolve part indices in the SAMPLE's keypoint format (like
        # RandomHorizontalFlip): the pose stream mixes 49/24-row spin
        # layouts with the pipeline-level openpose format, whose part
        # indices would be out of range here. (get_part_idxs is
        # lru_cached — per-call resolution is a dict hit.)
        parts = get_part_idxs(str(sample.get("keypoint_format", self.fmt)))
        idxs = (
            parts["torso"] if rng.uniform() < self.torso_prob
            else parts["upper"]
        )
        idxs = [i for i in idxs if i < kp.shape[0]]
        if not idxs:
            return sample
        part = kp[idxs]
        valid = part[part[:, 2] > 0]
        if len(valid) < 4:
            return sample
        mn, mx = valid[:, :2].min(0), valid[:, :2].max(0)
        center = 0.5 * (mn + mx)
        size = 1.2 * max(mx[0] - mn[0], mx[1] - mn[1])
        if size < 10:
            return sample
        sample["center"] = center
        sample["scale"] = float(size / crop_utils.REF_BBOX_SIZE)
        return sample


class Crop:
    """Terminal crop: apply scale augmentation, then one affine warp to the
    network input resolution; remap keypoints into crop pixel coords.
    With ``return_full_imgs`` the warp is left to the device: the sample
    keeps ``image`` and ``crop_to_image`` and gets no ``cropped_image``."""

    def __init__(self, crop_size: int = 256, is_train: bool = False,
                 scale_factor: float = 0.0, scale_dist: str = "uniform",
                 scale_factor_min: float = 1.0, scale_factor_max: float = 1.0,
                 return_full_imgs: bool = False):
        self.crop_size = crop_size
        self.is_train = is_train
        self.scale_factor = scale_factor
        self.scale_dist = scale_dist
        self.scale_factor_min = scale_factor_min
        self.scale_factor_max = scale_factor_max
        self.return_full_imgs = return_full_imgs
        if (is_train and scale_factor > 0 and scale_dist != "normal"
                and scale_factor_min == 1.0 and scale_factor_max == 1.0):
            # Same trap as the reference (transforms.py:520-533):
            # scale_factor only takes effect under scale_dist='normal';
            # 'uniform' draws from [min, max] which default to (1, 1).
            # The reference's shipped configs always pair
            # scale_factor: 0.25 with scale_dist: 'normal'. Warn loudly
            # instead of silently skipping the configured augmentation.
            warnings.warn(
                f"scale_factor={scale_factor} has NO effect with "
                "scale_dist='uniform' and default bounds (1, 1); set "
                "scale_dist: normal (as the reference configs do) or "
                "scale_factor_min/max", stacklevel=2)

    def __call__(self, sample: Sample, rng) -> Sample:
        scale = float(sample["scale"])
        if self.is_train and self.scale_factor > 0:
            if self.scale_dist == "normal":
                sc = np.clip(
                    rng.normal() * self.scale_factor + 1,
                    1 - self.scale_factor, 1 + self.scale_factor,
                )
            else:
                sc = rng.uniform(self.scale_factor_min,
                                 self.scale_factor_max)
            scale *= float(sc)
        center = np.asarray(sample["center"], dtype=np.float64)
        rot = float(sample.get("rotation", 0.0))
        res = (self.crop_size, self.crop_size)

        if not self.return_full_imgs:
            sample["cropped_image"] = crop_utils.crop_image(
                sample["image"], center, scale, res, rot
            )
        affine = crop_utils.image_to_crop_affine(center, scale, res, rot)
        sample["crop_to_image"] = crop_utils.crop_to_image_affine(
            center, scale, res, rot
        ).astype(np.float32)
        kp = sample.get("keypoints2d")
        if kp is not None:
            kp = np.array(kp, copy=True)
            kp[:, :2] = crop_utils.transform_points(kp[:, :2], affine)
            sample["cropped_keypoints2d"] = kp.astype(np.float32)
            # [-1, 1]-normalised target keypoints, the loss convention
            # (reference structures/keypoints.py:285-300).
            norm = np.array(kp, copy=True)
            norm[:, :2] = 2.0 * norm[:, :2] / self.crop_size - 1.0
            sample["target_keypoints2d"] = norm.astype(np.float32)
        if rot != 0.0:
            # Rotation augmentation must rotate the CAMERA-FRAME 3D
            # supervision too, or the 3D losses fight the rotated 2D
            # keypoints by the augmentation angle. Reference semantics:
            # R_z(-rot) applied to 3D joints (structures/keypoints.py
            # :432-445), to posed GT vertices (vertices.py:85-104), and
            # to the global-orient row of the axis-angle pose via
            # Rodrigues (global_rot.py:54-67). The canonical-shape
            # fields (v_shaped) are pose-independent and stay put.
            c, s = (np.cos(np.deg2rad(-rot)), np.sin(np.deg2rad(-rot)))
            R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
            j3d = sample.get("joints3d")
            if j3d is not None:
                j3d = np.array(j3d, np.float32, copy=True)
                j3d[:, :3] = j3d[:, :3] @ R.T
                sample["joints3d"] = j3d
            gv = sample.get("gt_vertices")
            if gv is not None:
                sample["gt_vertices"] = (
                    np.asarray(gv, np.float32) @ R.T)
            pose = sample.get("gt_pose_aa")
            if pose is not None:
                pose = np.asarray(pose, np.float32)
                shape = pose.shape
                aa = pose.reshape(-1, 3).copy()
                per_rdg = rodrigues(aa[0])
                resrot = rodrigues(R.astype(np.float64) @ per_rdg)
                aa[0] = resrot.reshape(3).astype(np.float32)
                sample["gt_pose_aa"] = aa.reshape(shape)
        sample["center"] = center
        sample["scale"] = scale
        if not self.return_full_imgs:
            sample.pop("image")
        return sample


def _device_crop(sample: Sample) -> bool:
    """Whether ``Crop`` left the crop to the device (``return_full_imgs``):
    the sample has a crop affine and no ``cropped_image``."""
    return "crop_to_image" in sample and "cropped_image" not in sample


class ChannelNoise:
    def __init__(self, noise_scale: float = 0.0):
        self.noise_scale = noise_scale

    def __call__(self, sample: Sample, rng) -> Sample:
        if self.noise_scale <= 0:
            return sample
        # Per-channel multiplicative jitter (transforms.py ChannelNoise).
        pn = rng.uniform(1 - self.noise_scale, 1 + self.noise_scale, size=3)
        if _device_crop(sample):
            sample["channel_noise"] = pn.astype(np.float32)
            return sample
        key = "cropped_image" if "cropped_image" in sample else "image"
        sample[key] = np.clip(sample[key] * pn[None, None], 0.0, 1.0).astype(
            np.float32
        )
        return sample


class SimulateLowRes:
    def __init__(self, dist: str = "categorical",
                 cat_factors: Tuple[float, ...] = (1.0,),
                 factor_min: float = 1.0, factor_max: float = 1.0):
        self.dist = dist
        self.cat_factors = cat_factors
        self.factor_min = factor_min
        self.factor_max = factor_max

    def __call__(self, sample: Sample, rng) -> Sample:
        if self.dist == "categorical":
            factor = self.cat_factors[
                int(rng.integers(len(self.cat_factors)))
            ]
        else:
            factor = rng.uniform(self.factor_min, self.factor_max)
        if factor <= 1.0:
            return sample
        if _device_crop(sample):
            raise ValueError(
                "SimulateLowRes (downsample factors above 1) acts on the "
                "host's crop, and this sample is cropped on the device "
                "(return_full_imgs): it has no device version")
        cv2 = _cv2("SimulateLowRes (downsample factors)")

        key = "cropped_image" if "cropped_image" in sample else "image"
        img = sample[key]
        H, W = img.shape[:2]
        small = cv2.resize(
            img, (max(1, int(W / factor)), max(1, int(H / factor))),
            interpolation=cv2.INTER_AREA,
        )
        sample[key] = cv2.resize(small, (W, H),
                                 interpolation=cv2.INTER_LINEAR)
        return sample


class Normalize:
    def __init__(self, mean=IMAGENET_MEAN, std=IMAGENET_STD):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, sample: Sample, rng) -> Sample:
        # ONLY the crop: the retained full image must stay raw [0, 1] —
        # the fused on-device path (apply_from_full_images) ImageNet-
        # normalises on device (normalising here double-normalised the
        # demo's batched path), and the overlay renderer composites on
        # the raw image (the reference un-normalises before rendering).
        img = sample.get("cropped_image")
        if img is not None:
            # In-place on the transform-owned crop buffer: one pass for
            # subtract + one for divide, no temporaries.
            if img.dtype != np.float32:
                img = img.astype(np.float32)
            np.subtract(img, self.mean, out=img)
            np.divide(img, self.std, out=img)
            sample["cropped_image"] = img
        return sample


def _build_vertex_flipper(cfg, aug):
    """Configured + flipping active -> the file MUST exist (reference
    ssp3d.py:85-92 asserts): silently skipping it would mirror images
    and keypoints while leaving GT meshes unmirrored — corrupted
    supervision with no error."""
    path = cfg.get("vertex_flip_correspondences")
    if not (aug and path and float(cfg.get("flip_prob", 0.0)) > 0):
        return None
    full = os.path.expandvars(os.path.expanduser(path))
    if not os.path.exists(full):
        raise FileNotFoundError(
            f"vertex_flip_correspondences does not exist: {full}")
    return VertexFlipper.from_npz(full)


def build_transforms(
    transf_cfg: Optional[Dict] = None,
    is_train: bool = False,
    enable_augment: bool = True,
    return_full_imgs: bool = False,
    fmt: str = "openpose25_v1",
) -> Compose:
    """Assemble the pipeline (reference transforms/build.py:7-102)."""
    cfg = dict(transf_cfg or {})
    aug = is_train and enable_augment
    crop_size = int(cfg.get("crop_size", 256))
    return Compose(
        [
            Resize(cfg.get("max_size", -1) if aug else -1),
            BBoxCenterJitter(
                cfg.get("center_jitter_factor", 0.0) if aug else 0.0,
                cfg.get("center_jitter_dist", "normal"),
            ),
            MotionBlur(
                cfg.get("motion_blur_prob", 0.0) if aug else 0.0,
                cfg.get("motion_blur_kernel_size_min", 3),
                cfg.get("motion_blur_kernel_size_max", 7),
            ),
            RandomHorizontalFlip(
                cfg.get("flip_prob", 0.0) if aug else 0.0, fmt,
                vertex_flipper=_build_vertex_flipper(cfg, aug),
            ),
            RandomRotation(aug, cfg.get("rotation_factor", 0.0)),
            ExtremeBodyCrop(
                cfg.get("extreme_crop_prob", 0.0) if aug else 0.0,
                cfg.get("torso_upper_body_prob", 0.5), fmt,
            ),
            Crop(
                crop_size,
                is_train=aug,
                scale_factor=cfg.get("scale_factor", 0.0) if aug else 0.0,
                scale_dist=cfg.get("scale_dist", "uniform"),
                scale_factor_min=cfg.get("scale_factor_min", 1.0),
                scale_factor_max=cfg.get("scale_factor_max", 1.0),
                return_full_imgs=return_full_imgs,
            ),
            ChannelNoise(cfg.get("noise_scale", 0.0) if aug else 0.0),
            SimulateLowRes(
                cfg.get("downsample_dist", "categorical"),
                tuple(cfg.get("downsample_cat_factors", (1.0,)))
                if aug else (1.0,),
                cfg.get("downsample_factor_min", 1.0) if aug else 1.0,
                cfg.get("downsample_factor_max", 1.0) if aug else 1.0,
            ),
            Normalize(
                cfg.get("mean", IMAGENET_MEAN), cfg.get("std", IMAGENET_STD)
            ),
        ]
    )
