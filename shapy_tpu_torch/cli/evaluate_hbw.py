"""Offline HBW-test evaluation from a submission npz (port of
``shapy_tpu/cli/evaluate_hbw.py``).

    python -m shapy_tpu_torch.cli.evaluate_hbw --input-npz-file sub.npz \\
        --hbw-folder HBW [--model-type smpl] [--point-reg-gt P.pkl \\
        --point-reg-fit Q.pkl] [--body-model-folder M | --faces-path F.npz]

Loads {image_name (N,), v_shaped (N, V, 3)}, compares it against the
per-subject GT v_shaped npy files and prints V2V (SMPL-X only), P2P-20k
and the height/chest/waist/hips (mm) and mass (kg) errors in the
reference's format. On the card the errors run through kernels K8b
(translation-aligned V2V), K8a (P2P-20k) and K1-AoS (the measurements of
both meshes' triangles, all faces).

The meshes' faces and measurement anchors come from one of three routes:
``--faces-path`` (an npz with ``faces``, anchors from the repository's
YAMLs, ``--body-measurement-folder`` choosing the definitions), the
synthetic SMPL-X / SMPL models (``SHAPY_TPU_SYNTHETIC_BODY=1``), or the
release files in ``--body-model-folder`` (default ``HBW/body_models``).
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict

import numpy as np
import torch

from shapy_tpu_torch.core.geometry import gather_triangles
from shapy_tpu_torch.eval.metrics import (
    SparsePointRegressor,
    aligned_point_error,
    point_regress_error,
)
from shapy_tpu_torch.utils.device import full_f32_matmul, get_device


def evaluate_submission(
    labels,
    fits: np.ndarray,
    gt_lookup,
    model_type: str = "smplx",
    point_regressor_gt: SparsePointRegressor | None = None,
    point_regressor_fit: SparsePointRegressor | None = None,
    measurements_gt=None,
    measurements_fit=None,
    gt_faces: np.ndarray | None = None,
    fit_faces: np.ndarray | None = None,
    batch_size: int = 16,
    device: str | torch.device = "cuda",
) -> Dict[str, float]:
    """Mean errors over the submission; ``gt_lookup`` maps a label to its
    GT v_shaped (V, 3). The measurements take the triangles
    ``v[:, faces]`` of ``gt_faces`` / ``fit_faces`` (F, 3), by default
    each measurement module's own faces, and measure all of them. The
    measurement modules are moved to ``device`` in place."""
    device = get_device(device)
    if point_regressor_gt is not None:
        point_regressor_gt = point_regressor_gt.to(device)
        point_regressor_fit = point_regressor_fit.to(device)
    faces = {}
    for key, m, f in (("gt", measurements_gt, gt_faces),
                      ("fit", measurements_fit, fit_faces)):
        if m is not None:
            m.to(device)
            f = np.asarray(m.faces.cpu() if f is None else f, np.int64)
            faces[key] = (int(f.max()), torch.as_tensor(f, device=device))

    def batch_metrics(fit_v, gt_v):
        out = {}
        if model_type == "smplx":
            out["v2v_t"] = aligned_point_error(
                fit_v, gt_v, "translation").mean(dim=-1)
        if point_regressor_gt is not None:
            point_regressor_fit.check_mesh(fit_v)
            point_regressor_gt.check_mesh(gt_v)
            idx1, w1, idx2, w2, order = point_regressor_fit.kernel_rows(
                point_regressor_gt)
            out["p2p_t"] = point_regress_error(
                fit_v, gt_v, idx1, w1, idx2, w2, align=True,
                order=order).mean(dim=-1)
        if measurements_gt is not None:
            m_gt = measurements_gt(
                gather_triangles(gt_v, faces["gt"][1]))["measurements"]
            m_fit = measurements_fit(
                gather_triangles(fit_v, faces["fit"][1]))["measurements"]
            for k in ("height", "chest", "waist", "hips", "mass"):
                out[f"{k}_error"] = torch.abs(m_gt[k]["tensor"]
                                              - m_fit[k]["tensor"])
        return out

    accum: Dict[str, list] = {}
    for start in range(0, len(fits), batch_size):
        sl = slice(start, min(start + batch_size, len(fits)))
        gt = np.stack([gt_lookup(label) for label in labels[sl]])
        for key, v in (("gt", gt), ("fit", fits[sl])):
            if key in faces and faces[key][0] >= v.shape[1]:
                raise ValueError(f"{key} faces index beyond the "
                                 f"{v.shape[1]} vertices of the meshes")
        fit_v = torch.as_tensor(np.asarray(fits[sl], np.float32)).to(device)
        gt_v = torch.as_tensor(np.asarray(gt, np.float32)).to(device)
        with torch.inference_mode(), full_f32_matmul():
            batch = batch_metrics(fit_v.contiguous(), gt_v.contiguous())
            names = list(batch)
            host = torch.stack([batch[k] for k in names]).cpu().numpy()
        for k, v in zip(names, host):
            accum.setdefault(k, []).append(v)
    return {k: float(np.concatenate(v).mean()) for k, v in accum.items()}


def _synthetic_measurements(model_type: str):
    """Synthetic body model (subdivisions 5) of ``model_type`` and its
    all-faces measurement module, as the JAX CLI's synthetic route."""
    from shapy_tpu_torch.measure.measurements import (
        BodyMeasurements,
        MeasurementAnchors,
    )
    from shapy_tpu_torch.models.body.assets import make_synthetic_model_data
    from shapy_tpu_torch.models.body.model import SMPL, SMPLX

    cls = {"smplx": SMPLX, "smpl": SMPL}[model_type]
    body = cls(make_synthetic_model_data(model_type, subdivisions=5))
    anchors = MeasurementAnchors.synthetic(body.faces,
                                           body.v_template.numpy())
    return BodyMeasurements(anchors, body.faces)


def main(
    input_npz_file: str,
    hbw_folder: str,
    model_type: str = "smplx",
    point_reg_gt: str = "",
    point_reg_fit: str = "",
    body_measurement_folder: str = "",
    body_model_folder: str = "",
    faces_path: str = "",
    device: str = "cuda",
) -> int:
    """Score a submission and print the reference's lines; see the module
    docstring for the three routes to faces and anchors."""
    from shapy_tpu_torch.measure.measurements import BodyMeasurements
    from shapy_tpu_torch.models.body.model import SMPLX, build_body_model

    device = get_device(device)
    submission = np.load(input_npz_file)
    labels = [str(x) for x in submission["image_name"]]
    fits = np.asarray(submission["v_shaped"], np.float32)

    preg_gt = preg_fit = None
    if point_reg_gt and os.path.exists(point_reg_gt):
        preg_gt = SparsePointRegressor.from_pickle(point_reg_gt,
                                                   device=device)
        preg_fit = (SparsePointRegressor.from_pickle(point_reg_fit,
                                                     device=device)
                    if point_reg_fit and point_reg_fit != point_reg_gt
                    else preg_gt)

    definitions = (os.path.join(body_measurement_folder,
                                "measurement_defitions.yaml")
                   if body_measurement_folder else None)
    smplx = model_type == "smplx"
    gt_faces = fit_faces = None
    if faces_path:
        gt_faces = fit_faces = np.asarray(np.load(
            os.path.expandvars(faces_path), allow_pickle=True)["faces"],
            np.int64)
        meas = BodyMeasurements(None, gt_faces, model_type="smplx",
                                meas_definition_path=definitions)
        meas_fit = meas if smplx else BodyMeasurements(
            None, gt_faces, model_type=model_type)
    elif os.environ.get("SHAPY_TPU_SYNTHETIC_BODY", "0") == "1":
        meas = _synthetic_measurements("smplx")
        meas_fit = meas if smplx else _synthetic_measurements(model_type)
    else:
        folder = body_model_folder or os.path.join(hbw_folder, "body_models")
        meas = BodyMeasurements(None, SMPLX(model_folder=folder).faces,
                                model_type="smplx",
                                meas_definition_path=definitions)
        # SMPL submissions index an SMPL-topology mesh: gathering them
        # with SMPL-X faces would read past their vertices.
        meas_fit = meas if smplx else BodyMeasurements(
            None, build_body_model(model_type, model_folder=folder).faces,
            model_type=model_type)

    def gt_lookup(label: str) -> np.ndarray:
        split, subject = label.split("/")[:2]
        sid = subject.split("_")[0]
        return np.load(os.path.join(hbw_folder, "smplx", split, f"{sid}.npy"))

    results = evaluate_submission(
        labels, fits, gt_lookup, model_type=model_type,
        point_regressor_gt=preg_gt, point_regressor_fit=preg_fit,
        measurements_gt=meas, measurements_fit=meas_fit, gt_faces=gt_faces,
        fit_faces=fit_faces, device=device)

    if "v2v_t" in results:
        print(f"V2V Error: {results['v2v_t'] * 1000:.0f} mm")
    if "p2p_t" in results:
        print(f"P2P-20k Error: {results['p2p_t'] * 1000:.0f} mm")
    for k in ("chest", "waist", "hips", "height"):
        if f"{k}_error" in results:
            print(f"{k} Error: {results[f'{k}_error'] * 1000:.0f} mm")
    if "mass_error" in results:
        print(f"mass Error: {results['mass_error']:.0f} kg")
    return 0


def check_submission_format(
    input_npz_file: str,
    image_names_path: str = "",
    model_type: str = "smplx",
) -> bool:
    """Submission validator: npz with image_name (N,) and v_shaped
    (N, 10475, 3) for smplx / (N, 6890, 3) for smpl."""
    expected_v = {"smplx": 10475, "smpl": 6890}[model_type]
    try:
        data = np.load(input_npz_file)
        ok = True
        if "image_name" not in data or "v_shaped" not in data:
            print("Missing required keys: image_name, v_shaped")
            return False
        # Member decompression is lazy: a truncated archive can pass
        # np.load yet fail here, so the array reads stay inside the guard.
        names = data["image_name"]
        v = data["v_shaped"]
    except Exception as exc:
        print(f"Cannot read submission npz {input_npz_file}: {exc}")
        return False
    if v.ndim != 3 or v.shape[1] != expected_v or v.shape[2] != 3:
        print(f"v_shaped must be (N, {expected_v}, 3); got {v.shape}")
        ok = False
    if len(names) != len(v):
        print("image_name and v_shaped lengths differ")
        ok = False
    if image_names_path and os.path.exists(image_names_path):
        expected_names = np.load(image_names_path, allow_pickle=True)
        if sorted(map(str, names)) != sorted(map(str, expected_names)):
            print("image_name entries do not match the test-set list")
            ok = False
    if ok:
        print("Submission format OK")
    return ok


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="HBW offline evaluation")
    parser.add_argument("--input-npz-file", required=True)
    parser.add_argument("--hbw-folder", default="")
    parser.add_argument("--model-type", default="smplx",
                        choices=["smpl", "smplx"])
    parser.add_argument("--point-reg-gt", default="")
    parser.add_argument("--point-reg-fit", default="")
    parser.add_argument("--body-measurement-folder", default="")
    parser.add_argument("--body-model-folder", default="",
                        help="SMPL/SMPL-X model folder")
    parser.add_argument("--check-format-only", action="store_true")
    parser.add_argument("--image-names-path", default="")
    parser.add_argument("--faces-path", default="",
                        help="npz with a 'faces' array: use this mesh "
                             "topology instead of loading a body model")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default: the card)")
    return parser


def cli(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.check_format_only:
        return 0 if check_submission_format(
            args.input_npz_file, args.image_names_path,
            args.model_type) else 1
    return main(args.input_npz_file, args.hbw_folder, args.model_type,
                args.point_reg_gt, args.point_reg_fit,
                args.body_measurement_folder, args.body_model_folder,
                args.faces_path, args.device)


if __name__ == "__main__":
    sys.exit(cli())
