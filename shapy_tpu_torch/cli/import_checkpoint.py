"""One-shot conversion: the reference's torch checkpoint -> the port's
native checkpoint (port of ``shapy_tpu/cli/import_checkpoint.py``).

    python -m shapy_tpu_torch.cli.import_checkpoint \\
        --torch-checkpoint path/to/shapy_ckpt --exp-cfg config.yaml \\
        --output-dir converted/ [--device cpu]

The demo and evaluation CLIs import a reference checkpoint on the fly
(``pretrained:`` in the config); this tool imports it once into the
config's regressor (``io.model_import.load_reference_model_checkpoint``:
``backbone.*``, ``regressor.module.*``, ``regressor.mean_param``) and
writes ``{"model": state}`` through ``io.checkpoint.Checkpointer`` (the
trainer's layout: parameters, BN running stats and ``param_mean``; the
body model's constants left out) with its pointer files, then prints
``wrote <path> (<n> arrays)``. The regressor is built on ``--device``,
the card unless the CPU is asked for.
"""

from __future__ import annotations

import argparse
import os
import sys

# The body model's and the measurements' constants: built from their
# assets, not trained, so not saved (as the trainer's checkpoints).
_CONSTANTS = ("model.", "body_measurements.")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Convert a reference torch checkpoint to the port's")
    parser.add_argument("--torch-checkpoint", required=True)
    parser.add_argument("--exp-cfg", dest="exp_cfgs", nargs="+",
                        default=[])
    parser.add_argument("--exp-opts", dest="exp_opts", nargs="*",
                        default=[])
    parser.add_argument("--output-dir", default="converted_checkpoint")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the card) or cpu")
    args = parser.parse_args(argv)

    from shapy_tpu_torch.cli.demo import build_demo_regressor
    from shapy_tpu_torch.io.checkpoint import Checkpointer
    from shapy_tpu_torch.utils.config import load_config

    if not os.path.exists(args.torch_checkpoint):
        print(f"checkpoint not found: {args.torch_checkpoint}",
              file=sys.stderr)
        return 1

    cfg = load_config({}, args.exp_cfgs, args.exp_opts)
    regressor = build_demo_regressor(cfg, args.torch_checkpoint,
                                     device=args.device)
    state = {k: v.cpu() for k, v in regressor.state_dict().items()
             if not k.startswith(_CONSTANTS)}
    path = Checkpointer(save_dir=args.output_dir).save(
        {"model": state}, step=0, is_best=True)
    print(f"wrote {path} ({len(state)} arrays)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
