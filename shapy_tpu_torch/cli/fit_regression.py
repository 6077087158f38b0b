"""Train / evaluate the A2S (a2b) and S2A (b2a) attribute models (port of
``shapy_tpu/cli/fit_regression.py``).

    python -m shapy_tpu_torch.cli.fit_regression --exp-cfg configs/s2a.yaml \\
        [--exp-opts key.path=value ...] [--train] [--device cpu]

The JAX CLI's flags, plus ``--device`` (the card unless the CPU is asked
for). ``--train`` fits the config's model on its database's train split
(``dataset``, ``db_folder``; the synthetic database with
``use_synthetic_db`` or ``dataset: synthetic-db``), prints the val and test
report and saves a polynomial as ``<output_dir>/last.ckpt.npz``; without
it, the model of ``<output_dir>/last.ckpt(.npz)`` is evaluated on the val
split: per metric for a2b, the LaTeX table rows for b2a. The printed
lines are the JAX CLI's.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict

import numpy as np
import torch


def main(cfg: Dict, train: bool, eval_test: bool = False,
         device: str | torch.device = "cuda") -> int:
    from shapy_tpu_torch.models.attributes.build import MODEL_DICT, build
    from shapy_tpu_torch.models.attributes.polynomial import Polynomial
    from shapy_tpu_torch.models.attributes.regression_data import (
        RegressionDataset,
    )
    from shapy_tpu_torch.utils.device import get_device

    device = get_device(device)
    ds_names = cfg.get("dataset", ["caesar"])
    ds_name = ds_names[0] if isinstance(ds_names, (list, tuple)) \
        else ds_names
    output_dir = os.path.expandvars(cfg.get("output_dir", "output"))
    os.makedirs(output_dir, exist_ok=True)
    checkpoint_path = os.path.join(output_dir, "last.ckpt")
    network_type = cfg.get("type", "a2b")

    def make_dataset(name):
        if name == "synthetic-db" or cfg.get("use_synthetic_db"):
            return RegressionDataset.synthetic(
                ds_gender=cfg.get("ds_gender", "female"),
                model_gender=cfg.get("model_gender", "neutral"),
                model_type=cfg.get("model_type", "smplx"),
                num_betas=int(cfg.get("num_shape_comps", 10)),
            )
        return RegressionDataset(
            ds_name=name,
            ds_gender=cfg.get("ds_gender", "female"),
            model_gender=cfg.get("model_gender", "neutral"),
            model_type=cfg.get("model_type", "smplx"),
            db_folder=cfg.get("db_folder", "../data/dbs"),
        )

    def network(model):
        return getattr(model, "a2b", getattr(model, "b2a", None))

    if train:
        dataset = make_dataset(ds_name)
        fitter = build(cfg).to(device)
        report = fitter.fit(dataset.db)
        print("Validation report:")
        for split, metrics in report.items():
            for k, v in metrics.items():
                print(f"  {split}/{k}: {float(np.mean(v)):.4f}")
        net = network(fitter)
        if isinstance(net, Polynomial):
            net.save_checkpoint(checkpoint_path + ".npz")
            print(f"Saved checkpoint: {checkpoint_path}.npz")
        return 0

    npz_path = checkpoint_path + ".npz"
    if not (os.path.exists(checkpoint_path) or os.path.exists(npz_path)):
        print(f"No checkpoint found at {checkpoint_path}",
              file=sys.stderr)
        return 1
    model = MODEL_DICT[network_type](cfg)
    net = network(model)
    if isinstance(net, Polynomial) and os.path.exists(npz_path):
        net.load_state_dict(Polynomial.load_checkpoint(npz_path).state_dict())
    elif os.path.exists(checkpoint_path):
        model = MODEL_DICT[network_type].load_from_checkpoint(
            checkpoint_path, cfg=cfg)
    model = model.to(device)

    eval_sets = ["caesar", "models"] if network_type == "a2b" \
        else ["caesar"]
    if cfg.get("use_synthetic_db"):
        eval_sets = ["synthetic-db"]
    for name in eval_sets:
        dataset = make_dataset(name)
        if "val" not in dataset.db:
            continue
        beta_key = f"betas_{model.model_type}_{model.model_gender}"
        if network_type == "a2b":
            xv = model.create_input_feature_vec(dataset.db["val"])
            yv = np.asarray(
                dataset.db["val"][beta_key])[:, : model.betas_size]
            pred = model.a2b.predict(model.preprocess(xv))
            report = model.validate(yv, pred)
            print(f"Results on {name} validation set:")
            for k, v in report.items():
                print(f"  {k}: {v:.4f}")
        else:
            xv = np.asarray(dataset.db["val"][beta_key])[
                :, : model.betas_size]
            yv = np.asarray(dataset.db["val"]["rating"])
            pred = model.b2a.predict(xv)
            m = model.metrics(yv[:, model.selected_attr_idx]
                              if yv.shape[1] != pred.shape[1] else yv,
                              pred)
            print(f"Reporting results on {name} validation set")
            for i, nme in enumerate(model.output_names):
                l1m = float(m["l1_mean"][i])
                l1std = float(m["l1_std"][i])
                acc = float(m["class_accuracy"][i]) * 100
                print(f"{nme:20s} &   ${l1m:.2f} \\pm {l1std:.2f}$   &"
                      f"   ${acc:.2f}\\%$   &   &   \\\\")
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="A2S and S2A regressor",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("--exp-cfg", dest="exp_cfgs", nargs="+",
                        default=[])
    parser.add_argument("--exp-opts", dest="exp_opts", nargs="*",
                        default=[])
    parser.add_argument("--train", action="store_true")
    parser.add_argument("--eval-test", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the card) or cpu")
    return parser


if __name__ == "__main__":
    from shapy_tpu_torch.utils.config import load_config

    args = build_parser().parse_args()
    cfg = load_config({}, args.exp_cfgs, args.exp_opts)
    sys.exit(main(cfg, args.train, args.eval_test, args.device))
