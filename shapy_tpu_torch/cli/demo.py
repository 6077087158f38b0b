"""SHAPY regressor demo: images + OpenPose keypoints -> SMPL-X fits (port
of ``shapy_tpu/cli/demo.py``).

    python -m shapy_tpu_torch.cli.demo --exp-cfg configs/shapy_demo.yaml \\
        [--exp-opts key.path=value ...] [--output-folder demo_output] \\
        [--save-vis true] [--save-params true] [--save-mesh true] \\
        [--batch-size 4] [--device cpu]

The JAX demo's flags, plus ``--device`` (the card unless the CPU is asked
for; without a card, asking for it exits with code 3). Per image it
writes what the JAX demo writes: ``{img}.npz`` (the last stage's
parameters, ``proj_joints``, the measurements and the Blender-style
camera: ``shift_x``, ``shift_y``, ``transl``, ``focal_length_in_mm``,
``focal_length_in_px``, ``center``, ``sensor_width``), ``{img}.ply``
(the mesh moved by the camera translation), ``{img}_hd_imgs.png`` and,
per stage with vertices, ``{img}_hd_stage_NN_overlay.png`` (RGBA) and
``{img}_hd_stage_NN_cat.png`` ([image | overlay]); and it prints the
same lines. The weights come through ``pretrained`` (the reference's
checkpoint, :mod:`shapy_tpu_torch.io.model_import`).

The forward runs on ``--device`` in bf16 with BN folded on the card (f32
on the CPU): kernel K2 crops, normalises and casts the padded full
images (``apply_from_full_images``), then K5-conv / K5-fuse (the
backbone), K3-chain and K3 (the body model) and K1 (the measurements).
Rendering stays on the host (:mod:`shapy_tpu_torch.render`), and the PNGs
go through the port's own writer (:mod:`shapy_tpu_torch.render.png`), so
the demo needs no ``cv2``.

**Deliberate difference.** Both batch routes crop on the device. At batch
1 the JAX demo crops on the host with ``cv2.warpAffine`` (fixed-point
1/32-pixel coordinates); its batches above 1 crop on the device from the
padded full images. The port matches the JAX demo's batched route, not
its batch-1 route bit for bit.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Dict

import numpy as np
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

DEFAULT_FOCAL_LENGTH = 5000.0
DEFAULT_SENSOR_WIDTH = 36.0


def weak_persp_to_blender(
    orig_centers: np.ndarray,
    orig_bbox_sizes: np.ndarray,
    camera_scale: np.ndarray,
    camera_transl: np.ndarray,
    H: int,
    W: int,
    sensor_width: float = DEFAULT_SENSOR_WIDTH,
    focal_length: float = DEFAULT_FOCAL_LENGTH,
) -> Dict[str, np.ndarray]:
    """Weak-perspective -> perspective (Blender) camera: z = 2f / (s *
    bbox_size), the principal point's shift, the focal length in mm and
    px."""
    from shapy_tpu_torch.render.rasterizer import (
        weak_persp_to_blender as _wp_transl)

    camera_scale = np.asarray(camera_scale).reshape(-1)
    transl = _wp_transl(camera_scale, camera_transl, orig_bbox_sizes,
                        focal_length=focal_length)
    shift_x = -(orig_centers[:, 0] / W - 0.5)
    shift_y = (orig_centers[:, 1] - 0.5 * H) / W
    n = len(camera_scale)
    return {
        "shift_x": shift_x,
        "shift_y": shift_y,
        "transl": transl,
        "focal_length_in_mm": np.full(n, focal_length / W * sensor_width),
        "focal_length_in_px": np.full(n, focal_length),
        "center": orig_centers,
        "sensor_width": np.full(n, sensor_width),
    }


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
    ``prepare_for_eval_``. A ``checkpoint_path`` naming a file is the
    reference's checkpoint, imported by
    :func:`~shapy_tpu_torch.io.model_import.load_reference_model_checkpoint`
    (BN still unfolded). The B2A / A2B plugins (``use_b2a`` / ``use_a2b``
    with both genders' checkpoints present; without them the JAX package
    runs without the plugin, and so does the port) are not ported yet and
    raise."""
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
    regressor = build_body_head(exp_cfg, body_model=body_model,
                                measurements=measurements)
    if checkpoint_path and os.path.exists(checkpoint_path):
        from shapy_tpu_torch.io.model_import import (
            load_reference_model_checkpoint)

        load_reference_model_checkpoint(checkpoint_path, regressor)
    return regressor.to(device)



def _to_numpy(tree):
    """Tensors (nested in dicts) -> numpy arrays on the host; other
    values as they are."""
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        tree = tree.detach()
        if tree.dtype == torch.bfloat16:
            tree = tree.float()
        return tree.cpu().numpy()
    return tree


class _Concat:
    """Several datasets read as one, in order."""

    def __init__(self, parts):
        self.parts = parts
        self.lens = [len(p) for p in parts]

    def __len__(self):
        return sum(self.lens)

    def __getitem__(self, i):
        for p, n in zip(self.parts, self.lens):
            if i < n:
                return p[i]
            i -= n
        raise IndexError(i)


def main(
    exp_cfg: Dict,
    demo_output_folder: str = "demo_output",
    datasets=("openpose",),
    save_vis: bool = True,
    save_params: bool = False,
    save_mesh: bool = False,
    split: str = "test",
    batch_size: int = 1,
    focal_length: float = DEFAULT_FOCAL_LENGTH,
    device: str | torch.device = "cuda",
) -> int:
    """Fit every image of the config's datasets and write its outputs;
    returns the exit code (1 where no input is found)."""
    from shapy_tpu_torch.data.build import build_dataset, pad_images
    from shapy_tpu_torch.data.datasets.openpose import OpenPoseDataset
    from shapy_tpu_torch.data.transforms import build_transforms

    device = get_device(device)
    os.makedirs(demo_output_folder, exist_ok=True)

    ds_cfg = dict(exp_cfg.get("datasets") or {})
    pose_cfg = dict(ds_cfg.get("pose") or {})
    op_cfg = dict(pose_cfg.get("openpose") or {})
    crop_size = int(ds_cfg.get("crop_size", 256))

    transforms = build_transforms({"crop_size": crop_size}, is_train=False,
                                  return_full_imgs=True)
    # Every requested dataset: 'openpose' reads the demo's image and
    # keypoint folders; any other registry dataset takes its config from
    # the pose / shape sections.
    built = []
    for name in datasets:
        if name == "openpose":
            ds = OpenPoseDataset(
                data_folder=op_cfg.get("data_folder", "data/openpose"),
                img_folder=op_cfg.get("img_folder", "images"),
                keyp_folder=op_cfg.get("keyp_folder", "keypoints"),
                transforms=transforms,
                split=split,
            )
        else:
            section = None
            for part in ("pose", "shape"):
                part_cfg = dict(ds_cfg.get(part) or {})
                if name in part_cfg:
                    section = part_cfg
                    break
            ds = build_dataset(name, section or {name: {}}, split,
                               transforms)
        if len(ds) > 0:
            built.append(ds)
    if not built:
        print("No inputs found", file=sys.stderr)
        return 1
    dataset = built[0] if len(built) == 1 else _Concat(built)

    checkpoint = os.path.expandvars(exp_cfg.get("pretrained", "") or "")
    regressor = build_demo_regressor(exp_cfg, checkpoint, device=device)
    regressor.prepare_for_eval_(
        torch.bfloat16 if device.type == "cuda" else torch.float32)

    def run_batch(samples):
        """One forward over the samples' full images, padded at the bottom
        and right (which moves no crop->image coordinate) and cropped on
        the device."""
        full = torch.from_numpy(pad_images(
            [np.asarray(s["image"], np.float32) for s in samples]))
        affines = torch.from_numpy(np.stack(
            [np.asarray(s["crop_to_image"], np.float32) for s in samples]))
        with torch.inference_mode():
            out = regressor.apply_from_full_images(
                full.to(device), affines.to(device), crop_size)
        return _to_numpy(out)

    def iter_chunks(size):
        """At most ``size`` decoded samples at a time: a large folder's
        full images are never all held at once."""
        chunk = []
        for i in range(len(dataset)):
            s = dataset[i]
            if s is None:
                continue
            chunk.append(s)
            if len(chunk) == size:
                yield chunk
                chunk = []
        if chunk:
            yield chunk

    total_time, cnt = 0.0, 0
    for chunk in iter_chunks(max(batch_size, 1)):
        start = time.perf_counter()
        out = run_batch(chunk)  # its copy to the host waits for the device
        total_time += time.perf_counter() - start
        cnt += len(chunk)

        for bi, sample in enumerate(chunk):
            _save_sample_outputs(
                regressor, out, bi, sample, demo_output_folder,
                save_params, save_mesh, save_vis,
                focal_length=focal_length,
            )

    if cnt:
        print(f"Average inference time: {total_time / cnt}")
        print(
            f"Throughput: {cnt / total_time:.2f} images/sec "
            f"(batch size {batch_size})"
        )
    else:
        from shapy_tpu_torch.utils.logging import get_logger

        get_logger(__name__).warning(
            "No usable samples found (check data_folder/img_folder/"
            "keyp_folder and keypoint confidences); nothing written.")
    return 0


def _save_sample_outputs(regressor, out, bi, sample, demo_output_folder,
                         save_params, save_mesh, save_vis,
                         focal_length=DEFAULT_FOCAL_LENGTH):
    """Write image ``bi``'s npz / ply / overlays from the batch's host
    outputs ``out`` (numpy)."""
    stage = out[f"stage_{regressor.num_stages - 1:02d}"]
    cam = out["camera_parameters"]
    full_img = sample.get("image")
    H, W = (full_img.shape[:2] if full_img is not None else (256, 256))
    hd_params = weak_persp_to_blender(
        np.asarray(sample["orig_center"]).reshape(1, 2),
        np.asarray([sample["orig_bbox_size"]]),
        cam["scale"][bi:bi + 1],
        cam["translation"][bi:bi + 1],
        H, W,
        focal_length=focal_length,
    )

    imgname = os.path.splitext(sample["fname"])[0]
    vertices = stage["vertices"][bi]
    faces = regressor.model.faces

    if save_params:
        B = out["proj_joints"].shape[0]
        out_params: Dict[str, np.ndarray] = {"fname": sample["fname"]}
        for key, val in stage.items():
            if hasattr(val, "shape"):
                # batched entries are sliced per sample; static ones are
                # saved as they are
                out_params[key] = val[bi] if (
                    val.ndim > 0 and val.shape[0] == B and key != "faces"
                ) else val
            elif isinstance(val, dict):  # measurements
                out_params[key] = {k: v[bi] for k, v in val.items()}
        out_params["proj_joints"] = out["proj_joints"][bi]
        for key, val in hd_params.items():
            out_params[key] = val[0] if np.ndim(val[0]) else float(val[0])
        np.savez_compressed(
            os.path.join(demo_output_folder, f"{imgname}.npz"), **out_params)

    if save_mesh:
        from shapy_tpu_torch.render import save_ply

        save_ply(os.path.join(demo_output_folder, f"{imgname}.ply"),
                 vertices + hd_params["transl"][0], faces)

    if save_vis and full_img is not None:
        # The raw image plus, per stage with vertices, an RGBA overlay and
        # an [image | overlay] side by side, in the stage's tab10 color.
        from shapy_tpu_torch.render import COLORS, HDRenderer
        from shapy_tpu_torch.render.png import write_png

        hd = HDRenderer()  # lit material + anti-aliased silhouette
        bg = np.transpose(np.asarray(full_img, np.float32), (2, 0, 1))[None]

        def write(name, img_chw):
            arr = np.clip(np.transpose(img_chw, (1, 2, 0)) * 255, 0,
                          255).astype(np.uint8)
            write_png(os.path.join(demo_output_folder, name), arr)

        write(f"{imgname}_hd_imgs.png", bg[0])
        for si in range(regressor.num_stages):
            key = f"stage_{si:02d}"
            v = (out.get(key) or {}).get("vertices")
            if v is None:
                continue
            overlay = hd(
                v[bi:bi + 1], faces,
                focal_length=hd_params["focal_length_in_px"][0:1],
                camera_translation=hd_params["transl"][0:1],
                # principal point = the subject's bbox center
                camera_center=hd_params["center"][0:1],
                bg_imgs=bg, return_with_alpha=True,
                body_color=COLORS.get(key, COLORS["default"]),
            )
            write(f"{imgname}_hd_{key}_overlay.png", overlay[0])
            write(f"{imgname}_hd_{key}_cat.png",
                  np.concatenate([bg[0], overlay[0][:3]], axis=-1))


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="shapy_tpu_torch regressor demo",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("--exp-cfg", dest="exp_cfgs", nargs="+", default=[])
    parser.add_argument("--exp-opts", dest="exp_opts", nargs="*",
                        default=[])
    parser.add_argument("--output-folder", dest="output_folder",
                        default="demo_output")
    parser.add_argument("--datasets", nargs="+", default=["openpose"])
    # Default False; only the string 'true' (any case) is true.
    parser.add_argument("--save-vis", dest="save_vis", default=False,
                        type=lambda x: str(x).lower() in ("true",))
    parser.add_argument("--save-params", dest="save_params", default=False,
                        type=lambda x: str(x).lower() in ("true",))
    parser.add_argument("--save-mesh", dest="save_mesh", default=False,
                        type=lambda x: str(x).lower() in ("true",))
    parser.add_argument("--split", default="test",
                        choices=["train", "test", "val"])
    parser.add_argument("--batch-size", dest="batch_size", type=int,
                        default=1, help="Images per forward pass.")
    parser.add_argument("--focal-length", dest="focal_length", type=float,
                        default=DEFAULT_FOCAL_LENGTH,
                        help="Focal length of the weak-perspective camera.")
    # Accepted for the reference CLI's compatibility; the demo is
    # headless, so interactive windows are not supported.
    parser.add_argument("--show", default=False,
                        type=lambda x: str(x).lower() in ("true",))
    parser.add_argument("--pause", default=-1, type=float)
    parser.add_argument("--device", default="cuda",
                        help="cuda (the card) or cpu")
    return parser


if __name__ == "__main__":
    from shapy_tpu_torch.utils.config import load_config
    from shapy_tpu_torch.utils.device import (exit_on_device_failure,
                                              raise_open_file_limit)

    args = build_parser().parse_args()
    cfg = load_config({}, args.exp_cfgs, args.exp_opts)
    raise_open_file_limit()
    exit_on_device_failure(args.device)  # exit 3: the card is absent
    sys.exit(
        main(
            cfg,
            demo_output_folder=args.output_folder,
            datasets=args.datasets,
            save_vis=args.save_vis,
            save_params=args.save_params,
            save_mesh=args.save_mesh,
            split=args.split,
            batch_size=args.batch_size,
            focal_length=args.focal_length,
            device=args.device,
        )
    )
