"""Virtual measurements CLI: betas npz -> anthropometric measurements
(port of ``shapy_tpu/cli/virtual_measurements.py``).

The same flags (``--input-folder``, ``--output-folder``,
``--meas_definition_path``, ``--meas_vertices_path``,
``--smpl_model_path``, ``--num_betas``, ``--gender``, ``--no-render``)
and the same per-file line ("    Virtual measurements:     mass: X kg
..."), plus ``--device`` (the card by default). The measurements are
kernel K1 on all faces. ``SHAPY_TPU_SYNTHETIC_BODY=1`` uses the synthetic
SMPL-X body (``SHAPY_TPU_TEST_SUBDIV`` subdivisions, 5 by default) when
the licensed files are absent.

The rendered overlay needs ``render/``, which is not ported: without
``--no-render`` the CLI raises ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

NOT_PORTED = ("the measurement overlay needs the renderer (render/), not "
              "ported yet: ROADMAP 'Next, in order', the renderer item; "
              "pass --no-render (render=False)")


def main(
    demo_input_folder: str = "demo_input",
    demo_output_folder: str = "demo_output",
    meas_definition_path: str = "",
    meas_vertices_path: str = "",
    smpl_model_path: str = "../data/body_models",
    gender: str = "neutral",
    num_betas: int = 10,
    render: bool = True,
    device: str = "cuda",
) -> int:
    if render:
        raise NotImplementedError(NOT_PORTED)
    import torch

    from shapy_tpu_torch.measure.measurements import (
        BodyMeasurements,
        MeasurementAnchors,
    )
    from shapy_tpu_torch.models.body.assets import make_synthetic_model_data
    from shapy_tpu_torch.models.body.model import SMPLX
    from shapy_tpu_torch.utils.device import get_device

    device = get_device(device)
    os.makedirs(demo_output_folder, exist_ok=True)
    npz_files = sorted(
        f for f in os.listdir(demo_input_folder) if f.endswith("npz"))

    if os.environ.get("SHAPY_TPU_SYNTHETIC_BODY", "0") == "1":
        subdiv = int(os.environ.get("SHAPY_TPU_TEST_SUBDIV", "5"))
        model = SMPLX(make_synthetic_model_data("smplx", subdivisions=subdiv),
                      num_betas=num_betas, gender=gender)
        anchors = MeasurementAnchors.synthetic(model.faces,
                                               model.v_template.numpy())
        measurements_module = BodyMeasurements(anchors, model.faces)
    else:
        model = SMPLX(model_folder=smpl_model_path, num_betas=num_betas,
                      gender=gender)
        measurements_module = BodyMeasurements(
            None, model.faces, model_type="smplx",
            meas_definition_path=meas_definition_path or None,
            meas_vertices_path=meas_vertices_path or None)
    model, measurements_module = model.to(device), measurements_module.to(
        device)

    for npz_file in npz_files:
        print(f"Processing: {npz_file}")
        data = np.load(os.path.join(demo_input_folder, npz_file))
        betas = torch.as_tensor(np.asarray(data["betas"], np.float32)
                                .reshape(1, -1), device=device)
        with torch.no_grad():
            v_shaped = model.forward_shape(betas)["v_shaped"]
            m = measurements_module.forward_from_vertices(
                v_shaped, use_face_subsets=False)["measurements"]
        mmts_str = "    Virtual measurements: "
        for k in ("mass", "height", "chest", "waist", "hips"):
            value = float(m[k]["tensor"][0])
            unit = "kg" if k == "mass" else "m"
            mmts_str += f"    {k}: {value:.2f} {unit}"
        print(mmts_str)
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="SMPL-X virtual measurements demo",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("--output-folder", dest="output_folder",
                        default="demo_output", type=str)
    parser.add_argument("--input-folder", dest="input_folder",
                        default="demo_input", type=str)
    parser.add_argument("--meas_definition_path",
                        dest="meas_definition_path", default="", type=str)
    parser.add_argument("--meas_vertices_path", dest="meas_vertices_path",
                        default="", type=str)
    parser.add_argument("--smpl_model_path", dest="smpl_model_path",
                        default="../data/body_models", type=str)
    parser.add_argument("--num_betas", dest="num_betas", default=10,
                        type=int)
    parser.add_argument("--gender", dest="gender", default="neutral",
                        type=str)
    parser.add_argument("--no-render", dest="render", action="store_false")
    parser.add_argument("--device", dest="device", default="cuda", type=str)
    return parser


if __name__ == "__main__":
    args = build_parser().parse_args()
    sys.exit(
        main(
            demo_input_folder=args.input_folder,
            demo_output_folder=args.output_folder,
            meas_definition_path=args.meas_definition_path,
            meas_vertices_path=args.meas_vertices_path,
            smpl_model_path=args.smpl_model_path,
            gender=args.gender,
            num_betas=args.num_betas,
            render=args.render,
            device=args.device,
        )
    )
