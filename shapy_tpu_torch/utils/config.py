"""Layered configuration (port of ``shapy_tpu/utils/config.py``):
defaults merged with one or more ``--exp-cfg`` YAML files, then with
``--exp-opts`` dot-list overrides, over plain nested dicts.

The YAML files are read by :mod:`shapy_tpu_torch.utils.yaml_subset`, not
PyYAML (the port runs where PyYAML is not installed); the repository's
configs read as ``yaml.safe_load`` reads them.
"""

from __future__ import annotations

import argparse
import ast
import copy
from typing import Any, Dict, List, Optional, Sequence

from shapy_tpu_torch.utils import yaml_subset


def deep_merge(base: Dict, override: Dict) -> Dict:
    """Recursive dict merge; override wins; lists are replaced."""
    out = copy.deepcopy(base)
    for key, value in (override or {}).items():
        if (
            key in out
            and isinstance(out[key], dict)
            and isinstance(value, dict)
        ):
            out[key] = deep_merge(out[key], value)
        else:
            out[key] = copy.deepcopy(value)
    return out


def _parse_value(text: str) -> Any:
    # OmegaConf's dotlist accepts YAML-style lowercase booleans/null;
    # ast.literal_eval alone would keep them as truthy strings ('false'
    # is True under bool()) and silently invert flag overrides.
    low = text.strip().lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("null", "none", "~"):
        return None
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        return text


def parse_dotlist(opts: Sequence[str]) -> Dict:
    """['a.b=1', 'c=[1,2]'] -> nested dict (OmegaConf.from_cli)."""
    result: Dict = {}
    for opt in opts:
        if "=" not in opt:
            raise ValueError(f"Expected key=value, got: {opt}")
        key, value = opt.split("=", 1)
        node = result
        parts = key.split(".")
        for i, p in enumerate(parts[:-1]):
            node = node.setdefault(p, {})
            if not isinstance(node, dict):
                raise ValueError(
                    f"--exp-opts {opt!r}: {'.'.join(parts[:i + 1])!r} "
                    f"is a {type(node).__name__}, not a config section"
                )
        node[parts[-1]] = _parse_value(value)
    return result


def load_config(
    defaults: Optional[Dict] = None,
    exp_cfgs: Sequence[str] = (),
    exp_opts: Sequence[str] = (),
) -> Dict:
    """defaults <- YAML files (in order) <- dotlist overrides."""
    cfg = copy.deepcopy(defaults or {})
    for path in exp_cfgs:
        if not path:
            continue
        cfg = deep_merge(cfg, yaml_subset.load(path) or {})
    if exp_opts:
        cfg = deep_merge(cfg, parse_dotlist(exp_opts))
    return cfg


def parse_args(
    argv: Optional[List[str]] = None,
    defaults: Optional[Dict] = None,
    description: str = "shapy_tpu_torch",
    extra_args=None,
) -> Dict:
    """CLI entry mirroring reference cmd_parser.py:12-49."""
    parser = argparse.ArgumentParser(
        description=description,
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument(
        "--exp-cfg", type=str, dest="exp_cfgs", nargs="+", default=[],
        help="Experiment YAML config file(s)",
    )
    parser.add_argument(
        "--exp-opts", default=[], dest="exp_opts", nargs="*",
        help="Dot-list config overrides (key.path=value)",
    )
    if extra_args:
        extra_args(parser)
    args = parser.parse_args(argv)
    cfg = load_config(defaults, args.exp_cfgs, args.exp_opts)
    cfg["_args"] = vars(args)
    return cfg
