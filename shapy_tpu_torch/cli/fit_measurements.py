"""Fit SMPL-X betas to target anthropometric measurements (port of
``examples/fit_measurements.py``; the port's CLIs live in ``cli/``).

The same flags (``--model-folder`` / ``--model-type`` / ``--gender`` /
``--num-betas`` / ``--height`` / ``--mass`` / ``--chest`` / ``--waist`` /
``--hips`` / ``--num-steps`` / ``--output-ply``; a negative target is
unused) and output lines, plus ``--device`` (the card by default). Adam
on the betas through kernels K1 and its backward
(:func:`~shapy_tpu_torch.measure.fit_measurements.fit_betas_to_measurements`).

Without licensed assets:

    SHAPY_TPU_SYNTHETIC_BODY=1 python -m shapy_tpu_torch.cli.fit_measurements \\
        --height 1.8 --chest 1.0
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional, Sequence

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Fit body shape to virtual measurements")
    parser.add_argument("--model-folder", default="", type=str)
    parser.add_argument("--model-type", default="smplx", type=str,
                        choices=["smpl", "smplh", "smplx"])
    parser.add_argument("--gender", type=str, default="neutral")
    parser.add_argument("--num-betas", default=10, type=int)
    parser.add_argument("--height", type=float, default=1.80)
    parser.add_argument("--mass", type=float, default=-1)
    parser.add_argument("--chest", type=float, default=-1)
    parser.add_argument("--waist", type=float, default=-1)
    parser.add_argument("--hips", type=float, default=-1)
    parser.add_argument("--num-steps", type=int, default=200)
    parser.add_argument("--output-ply", type=str, default="")
    parser.add_argument("--device", type=str, default="cuda")
    return parser


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)

    from shapy_tpu_torch.measure.fit_measurements import (
        fit_betas_to_measurements,
    )
    from shapy_tpu_torch.measure.measurements import (
        BodyMeasurements,
        MeasurementAnchors,
    )
    from shapy_tpu_torch.models.body.assets import make_synthetic_model_data
    from shapy_tpu_torch.models.body.model import build_body_model
    from shapy_tpu_torch.utils.device import get_device

    device = get_device(args.device)
    if os.environ.get("SHAPY_TPU_SYNTHETIC_BODY", "0") == "1" or (
            not args.model_folder):
        model = build_body_model(
            args.model_type,
            model_data=make_synthetic_model_data(
                args.model_type, subdivisions=4),
            num_betas=args.num_betas,
        )
        anchors = MeasurementAnchors.synthetic(
            model.faces, model.v_template.numpy())
        meas = BodyMeasurements(anchors, model.faces)
    else:
        model = build_body_model(
            args.model_type, model_folder=args.model_folder,
            gender=args.gender, num_betas=args.num_betas,
        )
        meas = BodyMeasurements(None, model.faces,
                                model_type=args.model_type)
    model, meas = model.to(device), meas.to(device)

    targets = {
        k: v for k, v in (
            ("height", args.height), ("mass", args.mass),
            ("chest", args.chest), ("waist", args.waist),
            ("hips", args.hips),
        ) if v > 0
    }
    if not targets:
        print("No positive measurement targets given", file=sys.stderr)
        return 1

    result = fit_betas_to_measurements(
        model, meas, targets, num_steps=args.num_steps)
    fitted = {k: float(v[0]) for k, v in result["measurements"].items()}
    betas = result["betas"].cpu().numpy()
    print("targets: ", {k: round(v, 4) for k, v in targets.items()})
    print("fitted:  ", {k: round(v, 4) for k, v in fitted.items()
                        if k in targets})
    print("betas:   ", np.round(betas[0], 3).tolist())

    if args.output_ply:
        from shapy_tpu_torch.render.ply import save_ply

        import torch

        with torch.no_grad():
            v = model.forward_shape(result["betas"])["v_shaped"]
        save_ply(args.output_ply, v[0].cpu().numpy(), model.faces)
        print(f"wrote {args.output_ply}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
