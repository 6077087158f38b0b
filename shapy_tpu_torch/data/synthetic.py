"""Synthetic supervised training archives (the learning-proof harness;
port of ``shapy_tpu/data/synthetic.py``).

The reference trains on licensed parametric-fit archives (CuratedFittings
/ SPIN npz files consumed by ``regressor/human_shape/data/datasets/
image_folder.py``); none can ship in this environment. This generator
produces a fully self-contained substitute in the SAME on-disk layout a
:class:`~shapy_tpu_torch.data.datasets.parametric.ParametricFitsDataset`
archive uses — rendered crops of a synthetic SMPL-X body with known
betas/pose, projected 2D keypoints, and GT vertices — so the whole
train→eval chain (``cli/train.py`` → Evaluator v2v) can be exercised,
and proven to *learn*, without any licensed asset.

Conventions match real SPIN-style fits:
  * the global orientation carries the ~π-about-x flip the fitting
    pipelines bake in, so body coordinates are y-down / z-away like the
    image plane and a positive weak-perspective scale can explain the
    projection (reference camera_projection.py:202-208);
  * keypoints2d are full-image pixel coordinates with a confidence
    column; the crop transform normalises them
    (data/transforms.py target_keypoints2d);
  * the npz stores pose as (N, 22, 3) axis-angle [global + 21 body
    joints], shape as (N, num_betas), vertices as (N, V, 3) in body
    coordinates (pre-translation), exactly the fields parametric.py
    reads.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

KEYPOINT_FORMAT = "smplx"


def write_ppm(path: str, image: np.ndarray) -> None:
    """(H, W, 3) uint8 as a binary PPM (P6, maxval 255), channels in
    array order."""
    H, W = image.shape[:2]
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (W, H))
        f.write(np.ascontiguousarray(image, np.uint8).tobytes())


def _perspective_px(points: np.ndarray, focal: float, dist: float,
                    size: int) -> np.ndarray:
    """(N, 3) body coords -> (N, 2) pixel coords for a camera at the
    origin looking +z, body translated to z=dist."""
    z = points[:, 2] + dist
    x = focal * points[:, 0] / z + size / 2.0
    y = focal * points[:, 1] / z + size / 2.0
    return np.stack([x, y], axis=1)


def generate_parametric_fits(
    out_dir: str,
    num_samples: int,
    *,
    model=None,
    subdivisions: int = 1,
    image_size: int = 96,
    seed: int = 0,
    betas_std: float = 1.5,
    active_betas: Optional[int] = None,
    pose_std: float = 0.25,
    global_std=0.15,
    distance: float = 2.4,
    npz_name: str = "fits.npz",
    save_vertices: bool = True,
    render_mode: str = "geometry",
    fill: float = 0.9,
    device: str | torch.device = "cuda",
    raster_route: str = "native",
) -> Dict[str, np.ndarray]:
    """Render ``num_samples`` supervised crops into ``out_dir`` and write
    ``npz_name`` beside them. Returns the archive dict (also on disk).

    The body fills ``fill`` of the frame; focal length is derived from
    the template height so any ``image_size``/``distance`` pair frames
    the body consistently.

    render_mode:
      * ``"geometry"`` (default) — R=Gouraud shading, G=normalised
        inverse depth, B=silhouette mask. Three decorrelated geometry
        channels so the images carry a strong, learnable pose/shape
        signal (the point of this harness is proving the training loop
        LEARNS, not photorealism);
      * ``"shading"`` — grayscale Gouraud shading replicated to RGB
        (overlay-renderer look).

    ``model``: the port's SMPL-X on ``device`` (default: a synthetic one,
    ``make_synthetic_model_data('smplx', subdivisions)``, built there);
    ``raster_route``: the rasterizer's geometry pass, 'native' or
    'numpy'.
    """
    from shapy_tpu_torch.data.keypoints import KEYPOINT_NAMES_DICT
    from shapy_tpu_torch.render.rasterizer import rasterize_mesh
    from shapy_tpu_torch.utils.device import get_device

    device = get_device(device)
    if model is None:
        from shapy_tpu_torch.models.body.assets import (
            make_synthetic_model_data,
        )
        from shapy_tpu_torch.models.body.model import SMPLX

        model = SMPLX(make_synthetic_model_data(
            "smplx", subdivisions=subdivisions)).to(device)

    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    n = int(num_samples)
    num_betas = int(model.num_betas)

    betas = rng.normal(0.0, betas_std, (n, num_betas)).astype(np.float32)
    if active_betas is not None:
        # Low-dimensional shape factor for fast-learning harness tasks
        # (the CPU learning-proof test): only the first k betas vary.
        betas[:, int(active_betas):] = 0.0
    pose = rng.normal(0.0, pose_std, (n, 22, 3)).astype(np.float32)
    # SPIN-style global flip: ~π about x (y-down body coords) + jitter;
    # global_std may be a scalar or a per-axis (3,) spread.
    pose[:, 0] = np.asarray([np.pi, 0.0, 0.0], np.float32)
    g_std = np.broadcast_to(np.asarray(global_std, np.float32), (3,))
    pose[:, 0] += (rng.normal(0.0, 1.0, (n, 3)) * g_std).astype(np.float32)

    with torch.no_grad():
        out = model(betas=torch.from_numpy(betas).to(device),
                    global_rot=torch.from_numpy(pose[:, :1]).to(device),
                    body_pose=torch.from_numpy(pose[:, 1:]).to(device))
    vertices = out["vertices"].cpu().numpy().astype(np.float32)  # (n, V, 3)
    joints = out["joints"].cpu().numpy().astype(np.float32)  # (n, J, 3)
    faces = np.asarray(model.faces)

    template_h = float(np.ptp(model.v_template.cpu().numpy()[:, 1]))
    focal = fill * image_size * distance / max(template_h, 1e-3)

    fmt_names = KEYPOINT_NAMES_DICT[KEYPOINT_FORMAT]
    n_fmt = len(fmt_names)
    n_j = joints.shape[1]
    keypoints2d = np.zeros((n, n_fmt, 3), np.float32)
    names = []
    for i in range(n):
        px = _perspective_px(joints[i], focal, distance, image_size)
        keypoints2d[i, :n_j, :2] = px
        keypoints2d[i, :n_j, 2] = 1.0

        v_cam = vertices[i].astype(np.float64)
        v_cam[:, 2] += distance
        shade, mask, depth = rasterize_mesh(
            v_cam, faces, (image_size, image_size), focal_length=focal,
            light_dir=(0.2, 0.2, -1.0), return_depth=True,
            route=raster_route,
        )
        img = np.zeros((image_size, image_size, 3), np.float32)
        if render_mode == "geometry":
            img[mask, 0] = shade[mask]
            # inverse depth normalised to a fixed body-scale window so
            # absolute limb depth (not per-image min/max) is readable
            near, far = distance - 1.0, distance + 1.0
            d = np.clip((far - depth[mask]) / (far - near), 0.0, 1.0)
            img[mask, 1] = d
            img[mask, 2] = 1.0
        else:
            img[mask] = shade[mask, None]
        # Lossless PPM in both modes; its channels reversed, as
        # cv2.imwrite stores the array (BGR) and the loader reads RGB.
        fname = f"synth_{seed:04d}_{i:05d}.ppm"
        write_ppm(os.path.join(out_dir, fname),
                  (img * 255.0).clip(0, 255).astype(np.uint8)[..., ::-1])
        names.append(fname)

    archive: Dict[str, np.ndarray] = {
        "imgname": np.asarray(names),
        "center": np.full((n, 2), image_size / 2.0, np.float32),
        # bbox_size = scale * 200 (parametric.py); frame the full crop.
        "scale": np.full((n,), image_size / 200.0, np.float32),
        "pose": pose,
        "shape": betas,
        "keypoints2d": keypoints2d,
    }
    if save_vertices:
        archive["vertices"] = vertices
    np.savez(os.path.join(out_dir, npz_name), **archive)
    return archive


def synthetic_train_config(
    data_root: str,
    *,
    batch_size: int = 8,
    crop_size: int = 64,
    num_betas: int = 10,
    pose_archives=("pose_a", "pose_b"),
    shape_archives=("shape_a",),
    val_archives=("val",),
    backbone: Optional[Dict] = None,
    lr: float = 3e-4,
    num_stages: int = 2,
) -> Dict:
    """An exp_cfg that trains on archives generated by
    :func:`generate_parametric_fits` under ``data_root/<name>/fits.npz``.

    Exercises the production data path: two pose archives (EqualSampler
    engages, reference data/build.py equal sampling), a shape stream
    mixed by pose_shape_ratio, and a held-out val split with GT vertices
    for the Evaluator's v2v.
    """

    def dset(name, return_vertices=False):
        return {
            "data_folder": os.path.join(data_root, name),
            "npz_files": ["fits.npz"],
            "keypoint_format": KEYPOINT_FORMAT,
            "return_vertices": return_vertices,
            "body_dset_factor": 1.0,
        }

    pose_cfg: Dict = {
        "splits": {
            "train": list(pose_archives),
            "val": list(val_archives),
        },
        "transforms": {"crop_size": crop_size},
    }
    for name in list(pose_archives):
        pose_cfg[name] = dset(name)
    for name in list(val_archives):
        pose_cfg[name] = dset(name, return_vertices=True)

    shape_cfg: Dict = {
        "splits": {"train": list(shape_archives)},
        "transforms": {"crop_size": crop_size},
    }
    for name in list(shape_archives):
        shape_cfg[name] = dset(name)

    return {
        "body_model": {
            "type": "smplx",
            "model_folder": "",
            "smplx": {"betas": {"num": num_betas}},
        },
        "network": {
            "type": "SMPLXRegressor",
            "smplx": {
                "num_stages": num_stages,
                "predict_hands": False,
                "predict_face": False,
                "backbone": backbone
                or {"type": "resnet", "depth": 18},
                "mlp": {"layers": [256], "dropout": 0.0},
            },
        },
        "datasets": {
            "batch_size": batch_size,
            "pose_shape_ratio": 0.5,
            "pose": pose_cfg,
            "shape": shape_cfg,
        },
        "losses": {
            "body": {
                "body_joints_2d": {"weight": 1.0},
                "shape": {"weight": 1.0},
                "global_rot": {"weight": 1.0},
                "body_pose": {"weight": 1.0},
                "stages_to_penalize": [f"stage_{num_stages - 1:02d}"],
            },
        },
        "optim": {"type": "adam", "lr": lr},
        "summary_steps": 10,
    }


# Dataset names the config references must resolve in the registry; the
# generator's archives are plain parametric-fits layouts, so aliasing
# every synthetic archive name onto ParametricFitsDataset is enough.
def register_synthetic_datasets(names) -> None:
    from shapy_tpu_torch.data.build import (
        DATASET_REGISTRY,
        _populate_registry,
    )
    from shapy_tpu_torch.data.datasets.parametric import (
        ParametricFitsDataset,
    )

    if not DATASET_REGISTRY:
        _populate_registry()
    for name in names:
        DATASET_REGISTRY.setdefault(name, ParametricFitsDataset)
