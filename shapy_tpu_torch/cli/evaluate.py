"""Model evaluation entry point, HBW-val / 3DPW / SSP-3D (port of
``shapy_tpu/cli/evaluate.py``).

    python -m shapy_tpu_torch.cli.evaluate --exp-cfg configs/shapy_eval_shape.yaml \\
        [--exp-opts key.path=value ...] [--output-folder evaluation] \\
        [--split val] [--device cpu]

Layered config -> regressor (``cli.demo.build_demo_regressor``, BN
folded, the backbone in bf16 on the card and f32 on the CPU) -> the
split's data loaders -> ``Evaluator.run`` -> one printed line per metric
(``name: value``, mm for the vertex, joint and circumference errors, kg
for mass), as the JAX CLI prints them.

The crop differs from the JAX CLI's on purpose. The JAX CLI crops each
image on the host with ``cv2.warpAffine`` (bilinear on fixed-point
1/32-pixel coordinates); the machine with the card has no ``cv2``. This
CLI builds its loaders with ``return_full_imgs=True``: the collate pads
the batch's full images and stacks their crop affines, and
``apply_from_full_images`` crops, normalises and casts them on the device
(kernel K2) in exact f32 coordinates. Its metrics therefore match the JAX
functions composed the same way (``build_all_data_loaders(...,
return_full_imgs=True)``, ``apply_from_full_images``,
``Evaluator.run``), not the JAX CLI's printed lines bit for bit.

One card: ``--num-devices`` above 1 raises (the JAX CLI shards the batch
over a device mesh). The batches go to ``--device`` (the card unless the
CPU is asked for); nothing falls back to the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict

import torch


def main(exp_cfg: Dict, output_folder: str = "evaluation",
         split: str = "val", num_devices_data: int = 0,
         device: str | torch.device = "cuda") -> int:
    """Evaluate the config's model on its ``split`` datasets and print the
    metrics; returns the exit code (1 where no dataset is configured)."""
    from shapy_tpu_torch.cli.demo import build_demo_regressor
    from shapy_tpu_torch.data.build import build_all_data_loaders
    from shapy_tpu_torch.eval.evaluator import build_evaluator
    from shapy_tpu_torch.eval.loop import adapt_eval_batches
    from shapy_tpu_torch.utils.device import get_device

    if num_devices_data > 1:
        raise ValueError("the port evaluates on one card: --num-devices "
                         f"{num_devices_data} is not supported")
    device = get_device(device)
    os.makedirs(output_folder, exist_ok=True)

    # Fail fast before the (expensive) model build if no datasets are
    # configured for this split.
    ds_cfg = dict(exp_cfg.get("datasets") or {})
    has_data = any(
        (dict(ds_cfg.get(part) or {}).get("splits") or {}).get(split)
        for part in ("pose", "shape")
    )
    if not has_data:
        print("No evaluation datasets configured", file=sys.stderr)
        return 1

    checkpoint = os.path.expandvars(exp_cfg.get("pretrained", "") or "")
    regressor = build_demo_regressor(exp_cfg, checkpoint, device=device)
    regressor.prepare_for_eval_(
        torch.bfloat16 if device.type == "cuda" else torch.float32)
    keypoint_names = regressor.model.keypoint_names

    loaders = build_all_data_loaders(
        exp_cfg,
        split=split,
        target_keypoint_names=keypoint_names,
        return_full_imgs=True,
        enable_augment=False,
    )
    if not loaders:
        print("No evaluation datasets configured", file=sys.stderr)
        return 1

    def model_fn(images, model_batch):
        return regressor.apply_from_full_images(
            images, model_batch["crop_to_image_affines"],
            model_batch["crop_size"])

    evaluator = build_evaluator(exp_cfg, keypoint_names=keypoint_names,
                                device=device)
    crop_sizes = {
        part: int(dict(dict(ds_cfg.get(part) or {}).get("transforms")
                       or {}).get("crop_size", 256))
        for part in loaders}
    results = evaluator.run(
        model_fn,
        {part: adapt_eval_batches(loader, device, crop_sizes[part])
         for part, loader in loaders.items()},
        last_stage=f"stage_{regressor.num_stages - 1:02d}",
    )
    for ds_name, metrics in results.items():
        print(f"=== {ds_name} ===")
        for name, value in sorted(metrics.items()):
            scale = 1000.0 if any(
                t in name for t in ("v2v", "p2p", "mpjpe", "height_error",
                                    "chest_error", "waist_error",
                                    "hips_error")
            ) else 1.0
            unit = " mm" if scale == 1000.0 else (
                " kg" if "mass" in name else ""
            )
            print(f"{name}: {value * scale:.2f}{unit}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="shapy_tpu_torch evaluation",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("--exp-cfg", dest="exp_cfgs", nargs="+",
                        required=True)
    parser.add_argument("--exp-opts", dest="exp_opts", nargs="*",
                        default=[])
    parser.add_argument("--output-folder", default="evaluation")
    parser.add_argument("--split", default="val")
    parser.add_argument("--num-devices", type=int, default=0,
                        help="one card: a value above 1 raises")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the card) or cpu")
    return parser


if __name__ == "__main__":
    from shapy_tpu_torch.utils.config import load_config

    args = build_parser().parse_args()
    cfg = load_config({}, args.exp_cfgs, args.exp_opts)
    sys.exit(main(cfg, args.output_folder, args.split, args.num_devices,
                  args.device))
