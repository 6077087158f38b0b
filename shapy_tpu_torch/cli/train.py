"""Training entry point (port of ``shapy_tpu/cli/train.py``).

    python -m shapy_tpu_torch.cli.train --exp-cfg configs/train_shapy.yaml \\
        [--exp-opts key.path=value ...] [--output-folder output] \\
        [--num-steps N] [--device cpu]

Layered config -> regressor (``cli.demo.build_demo_regressor``, the
backbone in ``network.<model>.compute_dtype`` on the card and f32 on the
CPU) -> the pose and shape training loaders -> the losses of the
config's ``losses`` section (with the gender-shape prior where its stats
files exist) -> ``Trainer`` with checkpoints under
``<output-folder>/checkpoints`` (resumed from there), the adversarial
step where ``use_adv_training`` is set, and the evaluator every
``eval_steps`` steps on the ``val`` split (once before training and once
at the end too). It prints the last summary step's losses and one line
per evaluation, ``{'eval': dataset, 'step': step, metric: value ...}``,
as the JAX CLI does, and returns its exit code (1 where no training
dataset is configured).

The crop differs from the JAX CLI's on purpose, as in ``cli/evaluate.py``:
the loaders keep uint8 full images (``return_full_imgs``), and each step
crops them with the augmentations' affines, applies the drawn channel
noise, normalises and casts on the device (kernel K2, one launch a step),
where the JAX CLI warps each image on the host with ``cv2``. So training
needs no ``cv2``; the augmentations that do (``max_size``, motion blur,
downsampling) raise if a config asks for them.

One card: ``--num-devices`` above 1 raises (the JAX CLI shards the batch
over a device mesh). Everything runs on ``--device`` (the card unless
the CPU is asked for); nothing falls back to the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict

import torch


def _crop_size(exp_cfg: Dict) -> int:
    """The crops' side, one for every stream (one K2 launch a step)."""
    ds_cfg = dict(exp_cfg.get("datasets") or {})
    sizes = {int(dict(dict(ds_cfg.get(part) or {}).get("transforms")
                      or {}).get("crop_size", 256))
             for part in ("pose", "shape") if ds_cfg.get(part)}
    if len(sizes) > 1:
        raise ValueError(f"the pose and shape streams crop to different "
                         f"sizes {sorted(sizes)}; one step crops once")
    return sizes.pop() if sizes else 256


def main(exp_cfg: Dict, output_folder: str = "output", num_steps: int = 0,
         num_devices_data: int = 0,
         device: str | torch.device = "cuda") -> int:
    """Train the config's model; returns the exit code."""
    from shapy_tpu_torch.cli.demo import build_demo_regressor
    from shapy_tpu_torch.data.build import build_all_data_loaders
    from shapy_tpu_torch.eval.loop import make_eval_fn
    from shapy_tpu_torch.io.checkpoint import Checkpointer
    from shapy_tpu_torch.losses.priors import GenderShapePrior
    from shapy_tpu_torch.train.losses import RegressorLosses
    from shapy_tpu_torch.train.trainer import Trainer
    from shapy_tpu_torch.utils.device import get_device

    if num_devices_data > 1:
        raise ValueError("the port trains on one card: --num-devices "
                         f"{num_devices_data} is not supported")
    device = get_device(device)
    os.makedirs(output_folder, exist_ok=True)
    pretrained = os.path.expandvars(exp_cfg.get("pretrained", "") or "")
    regressor = build_demo_regressor(exp_cfg, pretrained, device=device)
    network = dict(exp_cfg.get("network") or {})
    net_sub = dict(network.get("smplx") or network.get("smpl") or {})
    bf16 = str(net_sub.get("compute_dtype", "")) in ("bfloat16", "bf16")
    regressor.prepare_for_train_(
        torch.bfloat16 if bf16 and device.type == "cuda" else torch.float32)
    keypoint_names = regressor.model.keypoint_names
    crop_size = _crop_size(exp_cfg)

    loaders = build_all_data_loaders(
        exp_cfg, split="train", target_keypoint_names=keypoint_names,
        return_full_imgs=True, image_dtype="uint8")
    if not loaders:
        print("No training datasets configured", file=sys.stderr)
        return 1

    loss_cfg = dict(exp_cfg.get("losses") or {})
    shape_prior = None
    prior_cfg = dict((dict(loss_cfg.get("body") or {}).get("shape")
                      or {}).get("prior") or {})
    if prior_cfg.get("type") == "gender-shape":
        gs = dict(prior_cfg.get("gender_shape") or {})
        f_path = os.path.expandvars(gs.get("female_stats_path", ""))
        m_path = os.path.expandvars(gs.get("male_stats_path", ""))
        if os.path.exists(f_path) and os.path.exists(m_path):
            shape_prior = GenderShapePrior(female_stats_path=f_path,
                                           male_stats_path=m_path)
    losses = RegressorLosses(loss_cfg, gender_shape_prior=shape_prior)

    optim_cfg = dict(exp_cfg.get("optim") or {})
    trainer = Trainer(
        regressor, losses, optim_cfg=optim_cfg,
        checkpointer=Checkpointer(
            save_dir=os.path.join(output_folder, "checkpoints"),
            pretrained=pretrained),
        summary_steps=int(exp_cfg.get("summary_steps", 100)),
        checkpoint_steps=int(exp_cfg.get("checkpoint_steps", 1000)),
        max_duration=float(exp_cfg.get("max_duration", float("inf"))),
        use_adv_training=bool(exp_cfg.get("use_adv_training", False)),
        device=device,
        disc_cfg=dict(network.get("discriminator") or {}),
        adv_loss_cfg=dict(loss_cfg.get("discriminator") or {}),
        disc_optim_cfg=dict(optim_cfg.get("discriminator") or {}) or None,
        crop_size=crop_size)
    trainer.resume()

    # The evaluator in the loop: every eval_steps steps on the val split,
    # once before training (the baseline) and once at the end.
    eval_fn = None
    eval_steps = int(exp_cfg.get("eval_steps", 0))
    eval_results: Dict = {}
    if eval_steps > 0:
        val_loaders = build_all_data_loaders(
            exp_cfg, split="val", target_keypoint_names=keypoint_names,
            return_full_imgs=True, enable_augment=False,
            image_dtype="uint8")
        if val_loaders:
            eval_fn = make_eval_fn(regressor, val_loaders, exp_cfg,
                                   results_sink=eval_results,
                                   keypoint_names=keypoint_names,
                                   crop_size=crop_size)
            eval_fn(trainer.state.step)

    if num_steps <= 0:
        num_steps = int(optim_cfg.get("num_steps", 1000))
    metrics = trainer.fit(loaders, num_steps=num_steps, eval_fn=eval_fn,
                          eval_steps=eval_steps)
    if eval_fn is not None and trainer.state.step % eval_steps:
        eval_fn(trainer.state.step)
    print({k: round(v, 4) for k, v in metrics.items()})
    for step, by_ds in sorted(eval_results.items()):
        for ds, vals in by_ds.items():
            print({"eval": ds, "step": step,
                   **{k: round(float(v), 5) for k, v in vals.items()}})
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="shapy_tpu_torch training",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--exp-cfg", dest="exp_cfgs", nargs="+",
                        default=[])
    parser.add_argument("--exp-opts", dest="exp_opts", nargs="*",
                        default=[])
    parser.add_argument("--output-folder", default="output")
    parser.add_argument("--num-steps", type=int, default=0)
    parser.add_argument("--num-devices", type=int, default=0,
                        help="one card: a value above 1 raises")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the card) or cpu")
    return parser


if __name__ == "__main__":
    from shapy_tpu_torch.utils.config import load_config

    args = build_parser().parse_args()
    cfg = load_config({}, args.exp_cfgs, args.exp_opts)
    sys.exit(main(cfg, args.output_folder, args.num_steps,
                  args.num_devices, args.device))
