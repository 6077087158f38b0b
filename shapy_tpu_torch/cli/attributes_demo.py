"""Attribute-model demos, A2S (attributes -> betas) and S2A (betas ->
attribute ratings) (port of ``shapy_tpu/cli/attributes_demo.py``).

    python -m shapy_tpu_torch.cli.attributes_demo --exp-cfg configs/s2a.yaml \\
        [--exp-opts key.path=value ...] [--demo-output-folder out] \\
        [--smpl-model-path ../data/body_models] [--no-render] \\
        [--device cpu]

The JAX CLI's flags, plus ``--device`` (the card unless the CPU is asked
for); the same checkpoint resolution (``checkpoint_path``, else
``<output_dir>/last.ckpt``) and the same printed lines: per model its
predicted betas (A2S), per image its rating table (S2A). A2S renders each
predicted body (SMPL-X from ``--smpl-model-path``, else a synthetic one)
through :func:`~shapy_tpu_torch.render.render_mesh_overlay` and writes
``<demo-output-folder>/<id>.png`` with the port's PNG writer.

**Deliberate difference.** The JAX CLI renders inside a catch-all and
prints "Rendering skipped" on any error; here a failure raises.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch


def _checkpoint(cfg) -> str:
    output_dir = os.path.expandvars(cfg.get("output_dir", "output"))
    return cfg.get("checkpoint_path") or os.path.join(output_dir,
                                                       "last.ckpt")


def render_bodies(prediction: np.ndarray, ids, demo_output_folder: str,
                  smpl_model_path: str, model_gender: str,
                  device: torch.device) -> None:
    """One PNG a body: the betas' shaped mesh, centred, turned to face
    the camera 2.5 m away, lit and supersampled."""
    from shapy_tpu_torch.models.body.assets import make_synthetic_model_data
    from shapy_tpu_torch.models.body.model import SMPLX
    from shapy_tpu_torch.render import render_mesh_overlay, write_png

    os.makedirs(demo_output_folder, exist_ok=True)
    if os.path.isdir(os.path.expandvars(smpl_model_path)):
        body = SMPLX(model_folder=os.path.expandvars(smpl_model_path),
                     gender=model_gender)
    else:
        body = SMPLX(make_synthetic_model_data("smplx", subdivisions=4))
    body = body.to(device)
    with torch.no_grad():
        v = body.forward_shape(torch.as_tensor(
            prediction, dtype=torch.float32, device=device))["v_shaped"]
    v = v.cpu().numpy()
    for idx in range(len(prediction)):
        verts = (v[idx] - v[idx].mean(0)) * [1, -1, -1]
        verts[:, 2] += 2.5
        img = render_mesh_overlay(
            np.ones((512, 512, 3), np.float32), verts, body.faces,
            focal_length=500.0, shading_mode="phong", supersample=2)
        write_png(os.path.join(demo_output_folder, f"{ids[idx]}.png"),
                  (np.clip(img, 0, 1) * 255).astype(np.uint8))


def run_a2s(cfg, demo_output_folder: str, smpl_model_path: str,
            render: bool = True, device: torch.device = None) -> int:
    from shapy_tpu_torch.models.attributes.a2b import A2B
    from shapy_tpu_torch.models.attributes.demo_data import DemoA2SData

    checkpoint_path = _checkpoint(cfg)
    if os.path.exists(checkpoint_path):
        model = A2B.load_from_checkpoint(checkpoint_path, cfg=cfg)
    else:
        print(f"Checkpoint not found: {checkpoint_path}; using "
              "an untrained polynomial", file=sys.stderr)
        model = A2B(cfg)
    model = model.to(device)

    dataset = DemoA2SData(
        ds_gender=cfg.get("ds_gender", "female"),
        model_gender=cfg.get("model_gender", "neutral"),
        model_type=cfg.get("model_type", "smplx"),
        rating_folder=cfg.get("rating_folder", "../samples/attributes/"),
    )
    features = model.create_input_feature_vec(dataset.db)
    prediction = model.a2b.predict(model.preprocess(features))

    for idx, betas in enumerate(prediction):
        print(f"Predicted betas for {dataset.db['ids'][idx]}")
        print(betas)

    if render:
        render_bodies(prediction, dataset.db["ids"], demo_output_folder,
                      smpl_model_path, cfg.get("model_gender", "neutral"),
                      device)
    return 0


def run_s2a(cfg, demo_output_folder: str, device: torch.device = None
            ) -> int:
    from shapy_tpu_torch.models.attributes.b2a import B2A
    from shapy_tpu_torch.models.attributes.demo_data import DemoS2AData

    checkpoint_path = _checkpoint(cfg)
    if os.path.exists(checkpoint_path):
        model = B2A.load_from_checkpoint(checkpoint_path, cfg=cfg)
    else:
        print(f"Checkpoint not found: {checkpoint_path}; using "
              "an untrained polynomial", file=sys.stderr)
        model = B2A(cfg)
    model = model.to(device)

    dataset = DemoS2AData(
        betas_folder=cfg.get("betas_folder", "../samples/shapy_fit/"),
        ds_genders_path=cfg.get("ds_genders_path",
                                "../samples/genders.yaml"),
        model_gender=cfg.get("model_gender", "neutral"),
        model_type=cfg.get("model_type", "smplx"),
    )
    ds_gender = cfg.get("ds_gender", "female")
    dataset.create_db(ds_gender)

    test_input = dataset.db[dataset.betas_key][:, : model.betas_size]
    if len(test_input) == 0:
        print(f"No {ds_gender} samples found", file=sys.stderr)
        return 1
    prediction = model.b2a.predict(test_input)

    for img_idx, img_id in enumerate(dataset.db["filename"]):
        print(f"\n Results for image {img_id}")
        for name, estimate in zip(model.output_names, prediction[img_idx]):
            print(f"{name:20s}: {float(estimate):.2f}")
    return 0


def main(cfg, demo_output_folder: str = "demo_output",
         smpl_model_path: str = "../data/body_models",
         render: bool = True, device: str | torch.device = "cuda") -> int:
    from shapy_tpu_torch.utils.device import get_device

    device = get_device(device)
    network_type = cfg.get("type", "a2b")
    if network_type == "a2b":
        return run_a2s(cfg, demo_output_folder, smpl_model_path, render,
                       device)
    if network_type == "b2a":
        return run_s2a(cfg, demo_output_folder, device)
    raise ValueError(f"Unknown attribute model type: {network_type}")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="A2S / S2A demos",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("--exp-cfg", dest="exp_cfgs", nargs="+",
                        default=[])
    parser.add_argument("--exp-opts", dest="exp_opts", nargs="*",
                        default=[])
    # The underscore spellings are the reference's flags; both work.
    parser.add_argument("--demo-output-folder", "--demo_output_folder",
                        default="../samples/attributes/predictions")
    parser.add_argument("--smpl-model-path", "--smpl_model_path",
                        default="../data/body_models")
    parser.add_argument("--no-render", dest="render",
                        action="store_false")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the card) or cpu")
    return parser


if __name__ == "__main__":
    from shapy_tpu_torch.utils.config import load_config

    args = build_parser().parse_args()
    cfg = load_config({}, args.exp_cfgs, args.exp_opts)
    sys.exit(main(cfg, args.demo_output_folder, args.smpl_model_path,
                  args.render, args.device))
