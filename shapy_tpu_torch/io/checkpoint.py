"""Checkpoint save / load with pointer files (port of
``shapy_tpu/io/checkpoint.py``, whose spec is the reference's
``utils/checkpointer.py``).

A checkpoint is one ``torch.save`` file ``<save_dir>/ckpt_{step:08d}``
(the JAX package writes an orbax directory of that name). Beside it,
the ``latest_checkpoint`` and ``best_checkpoint`` pointer files hold the
absolute path of the newest and of the best checkpoint. ``load`` resolves,
in order: an explicit path, the best or latest pointer, then the
``pretrained`` directory's pointers or its newest ``ckpt_*``.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict, Mapping, Optional

import torch

logger = logging.getLogger(__name__)

LATEST_POINTER = "latest_checkpoint"
BEST_POINTER = "best_checkpoint"


class Checkpointer:
    """Writes and finds the checkpoints of one run under ``save_dir``."""

    def __init__(self, save_dir: str = "checkpoints", pretrained: str = ""):
        self.save_dir = os.path.abspath(
            os.path.expanduser(os.path.expandvars(save_dir)))
        self.pretrained = os.path.expanduser(os.path.expandvars(pretrained))
        os.makedirs(self.save_dir, exist_ok=True)

    def _write_pointer(self, pointer: str, path: str) -> None:
        with open(os.path.join(self.save_dir, pointer), "w") as f:
            f.write(path)

    def _read_pointer(self, pointer: str) -> Optional[str]:
        p = os.path.join(self.save_dir, pointer)
        if not os.path.exists(p):
            return None
        with open(p) as f:
            path = f.read().strip()
        return path if path and os.path.exists(path) else None

    def save(self, state: Dict[str, Any], step: int,
             is_best: bool = False) -> str:
        """Write ``state`` (tensors, numbers, nested dicts and lists) as
        ``ckpt_{step:08d}`` and point ``latest_checkpoint`` (and, with
        ``is_best``, ``best_checkpoint``) at it. The file appears whole or
        not at all."""
        path = os.path.join(self.save_dir, f"ckpt_{step:08d}")
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(state, tmp)
        os.replace(tmp, path)
        self._write_pointer(LATEST_POINTER, path)
        if is_best:
            self._write_pointer(BEST_POINTER, path)
        logger.info("Saved checkpoint %s", path)
        return path

    def load(self, path: Optional[str] = None, use_best: bool = False
             ) -> Optional[Dict[str, Any]]:
        """The checkpoint at ``path``, or the one the pointers name (the
        best with ``use_best``), or the pretrained directory's; None when
        there is none. Tensors land on the CPU; only tensors, numbers and
        containers are unpickled."""
        if path is None:
            path = self._read_pointer(BEST_POINTER if use_best
                                      else LATEST_POINTER)
        if path is None and self.pretrained and os.path.isdir(
                self.pretrained):
            sub = Checkpointer(self.pretrained)
            path = (sub._read_pointer(BEST_POINTER)
                    or sub._read_pointer(LATEST_POINTER))
            if path is None:
                cands = sorted(d for d in os.listdir(self.pretrained)
                               if d.startswith("ckpt_"))
                if cands:
                    path = os.path.join(self.pretrained, cands[-1])
        if path is None:
            logger.info("No checkpoint found in %s", self.save_dir)
            return None
        logger.info("Loading checkpoint %s", path)
        return torch.load(path, map_location="cpu", weights_only=True)


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, Mapping):
            out.update(_flatten(value, f"{name}."))
        else:
            out[name] = value
    return out


def merge_loaded_params(params: Mapping, loaded: Mapping,
                        strict: bool = False) -> Dict[str, Any]:
    """``params`` (a ``state_dict`` or nested dicts of tensors) with every
    leaf that ``loaded`` has under the same dotted name replaced by the
    loaded one; the other leaves stay. Missing and unexpected keys are
    logged, and raise ``KeyError`` with ``strict``."""
    flat_params, flat_loaded = _flatten(params), _flatten(loaded)
    missing = [k for k in flat_params if k not in flat_loaded]
    unexpected = [k for k in flat_loaded if k not in flat_params]
    if missing:
        logger.warning("Missing keys in checkpoint: %d (%s)", len(missing),
                       ", ".join(missing[:8]))
    if unexpected:
        logger.warning("Unexpected keys in checkpoint: %d (%s)",
                       len(unexpected), ", ".join(unexpected[:8]))
    if strict and (missing or unexpected):
        raise KeyError(f"Strict load failed: {len(missing)} missing, "
                       f"{len(unexpected)} unexpected")

    def merge(tree: Mapping, prefix: str = "") -> Dict[str, Any]:
        out = {}
        for key, value in tree.items():
            name = f"{prefix}{key}"
            out[key] = (merge(value, f"{name}.") if isinstance(value, Mapping)
                        else flat_loaded.get(name, value))
        return out

    return merge(params)
