"""Dataset registry, batch collation and the data-loader factory (port of
``shapy_tpu/data/build.py``).

``build_all_data_loaders`` splits the global batch between the pose and
shape streams by ``pose_shape_ratio``, with per-part transforms; the
collate returns ONE dict of fixed-shape numpy arrays (pad-and-mask), the
dataset keypoints remapped by name into the model's keypoint order. The
loader is a thread-pool prefetcher.

Differences from the JAX package:

* The registry holds the ported datasets (``openpose``, ``hbw``,
  ``threedpw``, ``ssp3d``); the JAX package's other names raise "not
  ported yet". ``build_dataset`` tells the parametric-fit datasets by
  name.
* In full-image mode (``return_full_imgs``: the samples carry ``image``
  and ``crop_to_image`` and no ``cropped_image``), the collate stacks the
  full images zero-padded at the bottom and right to the batch's largest
  height and width as ``full_images`` (B, H, W, 3), with
  ``crop_to_image_affines`` (B, 3, 3), for the device to crop (kernel
  K2). Padding at the bottom and right moves no crop->image coordinate,
  and the crop reads zeros outside an image, so the padded batch crops as
  each image alone. Such samples give no ``images`` stack.
"""

from __future__ import annotations

import queue
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np

from shapy_tpu_torch.data.keypoints import (
    KEYPOINT_NAMES_DICT,
    mapping_between,
)
from shapy_tpu_torch.data.samplers import (
    EqualSampler,
    ShapeSampler,
    shard_sampler_by_process,
)
from shapy_tpu_torch.data.transforms import build_transforms

DATASET_REGISTRY: Dict[str, Callable] = {}


def register_dataset(name: str):
    def deco(cls):
        DATASET_REGISTRY[name] = cls
        return cls

    return deco


# The JAX package's datasets that the port does not have yet.
NOT_PORTED = ("model_agencies", "ehf", "curated_fits", "spin", "spinx",
              "human36mx", "openpose_tracks")
# The parametric-fit archives: each keeps its own native keypoint order.
PARAMETRIC_DATASETS = ("ehf", "curated_fits", "spin", "spinx", "human36mx")


def _populate_registry() -> None:
    from shapy_tpu_torch.data.datasets.hbw import HBWDataset
    from shapy_tpu_torch.data.datasets.openpose import OpenPoseDataset
    from shapy_tpu_torch.data.datasets.ssp3d import SSP3DDataset
    from shapy_tpu_torch.data.datasets.threedpw import ThreeDPWDataset

    DATASET_REGISTRY.update(
        {
            "openpose": OpenPoseDataset,
            "hbw": HBWDataset,
            "ssp3d": SSP3DDataset,
            "threedpw": ThreeDPWDataset,
        }
    )


MEASUREMENT_TARGETS = ("height", "chest", "waist", "hips", "weight",
                       "mass")


def _aa_to_rotmat_np(aa: np.ndarray) -> np.ndarray:
    """(J, 3) axis-angle -> (J, 3, 3) rotation matrices (host-side
    Rodrigues, for GT pose collation)."""
    aa = np.asarray(aa, np.float64)
    angle = np.linalg.norm(aa, axis=-1, keepdims=True)
    axis = aa / np.maximum(angle, 1e-12)
    x, y, z = axis[:, 0], axis[:, 1], axis[:, 2]
    zeros = np.zeros_like(x)
    K = np.stack(
        [zeros, -z, y, z, zeros, -x, -y, x, zeros], axis=-1
    ).reshape(-1, 3, 3)
    a = angle[..., None]
    eye = np.eye(3)[None]
    rot = eye + np.sin(a) * K + (1.0 - np.cos(a)) * (K @ K)
    return rot.astype(np.float32)


def pad_images(images: Sequence[np.ndarray]) -> np.ndarray:
    """(H_i, W_i, C) images -> (B, max H, max W, C), each image at the top
    left, zeros below and to its right."""
    H = max(img.shape[0] for img in images)
    W = max(img.shape[1] for img in images)
    out = np.zeros((len(images), H, W) + images[0].shape[2:],
                   np.result_type(*images))
    for i, img in enumerate(images):
        out[i, :img.shape[0], :img.shape[1]] = img
    return out


def collate_batch(
    samples: Sequence[Optional[Dict]],
    target_keypoint_names: Optional[Sequence[str]] = None,
    num_betas: int = 10,
    num_attributes: int = 15,
) -> Optional[Dict[str, np.ndarray]]:
    """Stack sample dicts into fixed-shape arrays.

    Keypoints are remapped from each sample's source format into
    ``target_keypoint_names`` (the model's keypoint order) by name, so
    the 2D loss compares like with like.
    """
    samples = [s for s in samples if s is not None]
    if not samples:
        return None
    B = len(samples)
    out: Dict[str, Any] = {}

    if all("cropped_image" in s for s in samples):
        out["images"] = np.stack([s["cropped_image"] for s in samples])
        if "image" in samples[0]:
            out["full_images"] = [s.get("image") for s in samples]
    elif all("image" in s and "crop_to_image" in s for s in samples):
        out["full_images"] = pad_images([s["image"] for s in samples])
        out["crop_to_image_affines"] = np.stack(
            [np.asarray(s["crop_to_image"], np.float32) for s in samples])
    else:
        raise ValueError("collate_batch: every sample needs a "
                         "'cropped_image', or an 'image' and its "
                         "'crop_to_image'")
    out["fnames"] = [s.get("fname", "") for s in samples]
    out["genders"] = [str(s.get("gender", "neutral")) for s in samples]
    out["gender"] = np.asarray(
        [int(s.get("gender_int", 0)) for s in samples], np.int32
    )
    for key in ("orig_center", "center"):
        if key in samples[0]:
            out[key] = np.stack(
                [np.asarray(s[key], np.float32) for s in samples]
            )
    for key in ("orig_bbox_size", "bbox_size", "scale"):
        if key in samples[0]:
            out[key] = np.asarray(
                [np.float32(s[key]) for s in samples]
            )

    # Per-format mapping cache: the mapping depends only on the source
    # format name + target list, not on the sample.
    _map_cache: Dict[str, Any] = {}

    def fmt_mapping(fmt: str):
        if fmt not in _map_cache:
            _map_cache[fmt] = mapping_between(
                KEYPOINT_NAMES_DICT[fmt], tuple(target_keypoint_names)
            )
        return _map_cache[fmt]

    # Gate every optional target on any() — samples[0]-gating either
    # drops GT for the whole batch (first sample lacks it) or crashes
    # (first sample has it, a later one doesn't). Missing samples get
    # zeros, masked by confidence/validity.
    if target_keypoint_names is not None and any(
            "target_keypoints2d" in s for s in samples):
        n_t = len(target_keypoint_names)
        stacked = np.zeros((B, n_t, 3), np.float32)
        for i, s in enumerate(samples):
            if "target_keypoints2d" not in s:
                continue
            src_idx, dst_idx = fmt_mapping(s["keypoint_format"])
            kp = np.asarray(s["target_keypoints2d"], np.float32)
            stacked[i, dst_idx] = kp[src_idx]
        out["target_keypoints2d"] = stacked

    # 3D joints, remapped by name into the model's keypoint order (the
    # joints3d loss and mpjpe compare positionally against the model's
    # joint output). Rows carry (x, y, z, conf); missing samples stay
    # all-zero-confidence.
    if target_keypoint_names is not None and any(
            "joints3d" in s for s in samples):
        n_t = len(target_keypoint_names)
        stacked = np.zeros((B, n_t, 4), np.float32)
        for i, s in enumerate(samples):
            j3d = s.get("joints3d")
            if j3d is None:
                continue
            j3d = np.asarray(j3d, np.float32)
            fmt = str(s.get("joints3d_format", s["keypoint_format"]))
            names = KEYPOINT_NAMES_DICT.get(fmt)
            if names is None or len(names) != j3d.shape[0]:
                # Fall back to the GT-block table when the 2D format is
                # the 49-row training layout but joints3d is the bare
                # GT block (SPIN archives).
                for cand in ("spin", "h36m"):
                    if len(KEYPOINT_NAMES_DICT[cand]) == j3d.shape[0]:
                        fmt = cand
                        break
                else:
                    continue
            src_idx, dst_idx = fmt_mapping(fmt)
            if j3d.shape[-1] == 3:
                j3d = np.concatenate(
                    [j3d, np.ones((len(j3d), 1), np.float32)], axis=-1)
            stacked[i, dst_idx] = j3d[src_idx]
        out["joints3d"] = stacked

    # LSP-14 GT joints for the mpjpe14 protocol (reference
    # threedpw.py:209-212 / evaluation.py:161-190). Positional — no
    # name remap; missing samples flagged in joints14_valid.
    if any("joints14" in s for s in samples):
        stacked = np.zeros((B, 14, 3), np.float32)
        valid = np.zeros((B,), np.float32)
        for i, s in enumerate(samples):
            j14 = s.get("joints14")
            if j14 is None:
                continue
            stacked[i] = np.asarray(j14, np.float32)[:14, :3]
            valid[i] = 1.0
        out["joints14"] = stacked
        out["joints14_valid"] = valid

    # Axis-angle GT poses -> rotation-matrix targets for the pose
    # losses (gt_global_rot (B,3,3), gt_body_pose (B,21,3,3)).
    if any(s.get("gt_pose_aa") is not None for s in samples):
        glob = np.tile(np.eye(3, dtype=np.float32), (B, 1, 1))
        body = np.tile(np.eye(3, dtype=np.float32), (B, 21, 1, 1))
        valid = np.zeros((B,), np.float32)
        for i, s in enumerate(samples):
            aa = s.get("gt_pose_aa")
            if aa is None:
                continue
            aa = np.asarray(aa, np.float32).reshape(-1, 3)
            rots = _aa_to_rotmat_np(aa)
            glob[i] = rots[0]
            nb = min(21, len(rots) - 1)
            if nb > 0:
                body[i, :nb] = rots[1:1 + nb]
            valid[i] = 1.0
        out["gt_global_rot"] = glob
        out["gt_body_pose"] = body
        out["gt_pose_valid"] = valid

    if any("gt_betas" in s for s in samples):
        betas = np.zeros((B, num_betas), np.float32)
        valid = np.zeros((B,), np.float32)
        for i, s in enumerate(samples):
            if "gt_betas" in s:
                b = np.asarray(s["gt_betas"], np.float32).reshape(-1)
                betas[i, : min(num_betas, len(b))] = b[:num_betas]
                valid[i] = 1.0
        out["gt_betas"] = betas
        out["gt_betas_valid"] = valid

    for vkey in ("gt_v_shaped", "gt_vertices"):
        if any(vkey in s for s in samples):
            ref_shape = next(
                np.asarray(s[vkey], np.float32).shape
                for s in samples if vkey in s
            )
            stacked = np.zeros((B,) + ref_shape, np.float32)
            valid = np.zeros((B,), np.float32)
            for i, s in enumerate(samples):
                if vkey in s and np.asarray(s[vkey]).shape == ref_shape:
                    stacked[i] = np.asarray(s[vkey], np.float32)
                    valid[i] = 1.0
            out[vkey] = stacked
            out[f"{vkey}_valid"] = valid

    for key in MEASUREMENT_TARGETS:
        if any(key in s for s in samples):
            vals = np.zeros((B,), np.float32)
            valid = np.zeros((B,), np.float32)
            for i, s in enumerate(samples):
                if key in s:
                    vals[i] = np.float32(s[key])
                    valid[i] = np.float32(s.get(f"{key}_valid", 1.0))
            out[key] = vals
            out[f"{key}_valid"] = valid
        gt_key = f"{key}_gt"
        if any(gt_key in s for s in samples):
            out[gt_key] = np.asarray(
                [np.float32(s.get(gt_key, 0.0)) for s in samples]
            )

    if any("attributes" in s for s in samples):
        attrs = np.zeros((B, num_attributes), np.float32)
        valid = np.zeros((B,), np.float32)
        for i, s in enumerate(samples):
            if "attributes" in s:
                a = np.asarray(s["attributes"], np.float32).reshape(-1)
                attrs[i, : min(num_attributes, len(a))] = a[:num_attributes]
                valid[i] = 1.0
        out["attributes"] = attrs
        out["attributes_valid"] = valid
    return out


class DataLoader:
    """Thread-pool prefetching loader over (dataset(s), batch sampler)."""

    def __init__(
        self,
        datasets: Sequence,
        batch_sampler,
        collate_fn: Callable,
        num_workers: int = 2,
        prefetch: int = 2,
    ):
        self.datasets = list(datasets)
        self.offsets = np.cumsum([0] + [len(d) for d in self.datasets])
        self.batch_sampler = batch_sampler
        self.collate_fn = collate_fn
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch

    def _fetch(self, global_idx: int):
        ds = int(np.searchsorted(self.offsets, global_idx, "right") - 1)
        return self.datasets[ds][int(global_idx - self.offsets[ds])]

    def __len__(self) -> int:
        return len(self.batch_sampler)

    def __iter__(self):
        return self.iter_batches()

    def iter_batches(self, skip: int = 0):
        """One epoch of batches, optionally skipping the first ``skip``
        index-batches WITHOUT fetching their data. Together with burning
        whole epochs at the sampler level this gives resume-stable
        training streams: the sampler's stateful shuffle rng advances
        exactly as in an uninterrupted run, so batch ``n`` after a
        restart is bit-identical to batch ``n`` of a fresh run
        (Trainer.fit positions the stream at the resumed step)."""
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(self.num_workers) as pool:
            pending: "queue.Queue" = queue.Queue()
            sampler_iter = iter(self.batch_sampler)
            for _ in range(skip):
                try:
                    next(sampler_iter)
                except StopIteration:
                    break

            def submit_next():
                try:
                    idxs = next(sampler_iter)
                except StopIteration:
                    return False
                futures = [pool.submit(self._fetch, i) for i in idxs]
                pending.put(futures)
                return True

            for _ in range(self.prefetch + 1):
                if not submit_next():
                    break
            while not pending.empty():
                futures = pending.get()
                batch = self.collate_fn([f.result() for f in futures])
                submit_next()
                if batch is not None:
                    yield batch


class SequentialBatchSampler:
    def __init__(self, length: int, batch_size: int,
                 drop_last: bool = False):
        self.length = length
        self.batch_size = batch_size
        self.drop_last = drop_last

    def __len__(self) -> int:
        if self.drop_last:
            return self.length // self.batch_size
        return (self.length + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        for start in range(0, self.length, self.batch_size):
            idxs = np.arange(start, min(start + self.batch_size,
                                        self.length))
            if self.drop_last and len(idxs) < self.batch_size:
                return
            yield idxs


class ShuffledBatchSampler:
    """Reshuffled every epoch — the single-dataset train sampler
    (sequential order + drop_last would give SGD the same correlated
    batches every epoch)."""

    def __init__(self, length: int, batch_size: int,
                 drop_last: bool = True, seed: int = 0):
        self.length = length
        self.batch_size = batch_size
        self.drop_last = drop_last
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        if self.drop_last:
            return self.length // self.batch_size
        return (self.length + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        order = self._rng.permutation(self.length)
        for start in range(0, self.length, self.batch_size):
            idxs = order[start:start + self.batch_size]
            if self.drop_last and len(idxs) < self.batch_size:
                return
            yield idxs


def build_dataset(name: str, dataset_cfg: Dict, split: str, transforms):
    if not DATASET_REGISTRY:
        _populate_registry()
    if name not in DATASET_REGISTRY:
        if name in NOT_PORTED:
            raise NotImplementedError(f"dataset {name!r} is not ported yet")
        raise KeyError(f"Unknown dataset: {name}")
    sub_cfg = dict(dataset_cfg.get(name) or {})
    cls = DATASET_REGISTRY[name]
    if name in PARAMETRIC_DATASETS:
        # Parametric fit archives each use their own native keypoint
        # ordering (ehf/spin/spinx/h36m registry formats).
        sub_cfg.setdefault("dataset_name", name)
    return cls(split=split, transforms=transforms, **sub_cfg)


def build_all_data_loaders(
    exp_cfg: Dict,
    split: str = "train",
    target_keypoint_names: Optional[Sequence[str]] = None,
    return_full_imgs: bool = False,
    enable_augment: bool = True,
) -> Dict[str, DataLoader]:
    """Pose + shape loaders with the batch split by pose_shape_ratio
    (reference data/build.py:306-398)."""
    ds_cfg = dict(exp_cfg.get("datasets") or {})
    batch_size = int(ds_cfg.get("batch_size", 32))
    ratio = float(ds_cfg.get("pose_shape_ratio", 0.5))
    is_train = split == "train"

    part_batch = {
        "pose": int(round(batch_size * ratio)),
        "shape": batch_size - int(round(batch_size * ratio)),
    }
    loaders: Dict[str, DataLoader] = {}
    for part in ("pose", "shape"):
        part_cfg = dict(ds_cfg.get(part) or {})
        splits_map = dict(part_cfg.get("splits") or {})
        names = list(splits_map.get(split) or [])
        if not names or part_batch[part] <= 0:
            continue
        transf_cfg = dict(part_cfg.get("transforms") or {})
        # Part-level key in the reference layout
        # (datasets_defaults.py:239, demo yaml datasets.shape.*): GT
        # meshes mirror through these correspondences on flip augment.
        if part_cfg.get("vertex_flip_correspondences"):
            transf_cfg.setdefault(
                "vertex_flip_correspondences",
                part_cfg["vertex_flip_correspondences"],
            )
        transforms = build_transforms(
            transf_cfg,
            is_train=is_train,
            enable_augment=enable_augment,
            return_full_imgs=return_full_imgs,
        )
        datasets = [
            build_dataset(n, part_cfg, split, transforms) for n in names
        ]
        datasets = [d for d in datasets if len(d) > 0]
        if not datasets:
            continue
        sampler_cfg = dict(part_cfg.get("sampler") or {})
        total = sum(len(d) for d in datasets)
        if is_train and sampler_cfg.get("use_equal_sampling", True) \
                and len(datasets) > 1:
            sampler = EqualSampler(
                datasets,
                batch_size=part_batch[part],
                ratio_2d=float(sampler_cfg.get("ratio_2d", 0.5)),
                shuffle=True,
            )
        elif is_train and sampler_cfg.get("use_shape_sampling", False):
            sampler = ShapeSampler(
                datasets,
                batch_size=part_batch[part],
                importance_key=sampler_cfg.get("importance_key", "weight"),
                shuffle=True,
            )
        elif is_train:
            sampler = ShuffledBatchSampler(
                total, part_batch[part], drop_last=True
            )
        else:
            sampler = SequentialBatchSampler(
                total, part_batch[part], drop_last=False
            )
        if bool(ds_cfg.get("shard_by_process", True)):
            # Multi-process: each process keeps its strided slice of every
            # global batch (no-op single-process).
            sampler = shard_sampler_by_process(sampler)

        loaders[part] = DataLoader(
            datasets,
            sampler,
            lambda samples: collate_batch(
                samples, target_keypoint_names=target_keypoint_names,
            ),
            num_workers=int(
                dict(part_cfg.get("num_workers") or {}).get(split, 2)
                if isinstance(part_cfg.get("num_workers"), dict)
                else part_cfg.get("num_workers", 2)
            ),
        )
    return loaders
