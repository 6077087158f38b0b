"""Reference checkpoints of the attribute network zoo -> the port's
networks (port of ``shapy_tpu/models/attributes/ckpt_import.py``).

The reference keeps a trained A2B / B2A network under the ``a2b.`` /
``b2a.`` prefix of its Lightning ``state_dict``, with torch parameter
names. The port's networks carry those names (:mod:`.networks`), so the
block loads through ``load_state_dict``: no folding and no renaming.
Two things are settled here:

* BatchNorm1d: a block that holds running statistics of a norm layer
  (``norm_layer``, ``norm1`` / ``norm2``, ``downsample.1``) gets a
  network built with BN (run in eval mode), whatever its config says
  (the reference's default normalization is BN);
* what the JAX importer refuses, the port refuses with the same message:
  a norm layer with weights but no running statistics (LayerNorm,
  GroupNorm).

A linear without ``bias`` in the block (the reference drops it before
BN) loads a zero bias, as the JAX importer does.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from shapy_tpu_torch.models.attributes.networks import build_network

_NORM = re.compile(r"^(.*(?:norm_layer|norm\d|downsample\.1))\.(\w+)$")


def tensor_state_dict(sd: Mapping) -> Dict[str, torch.Tensor]:
    """Values (tensors or numpy arrays) -> tensors."""
    return {k: v if torch.is_tensor(v) else torch.as_tensor(np.asarray(v))
            for k, v in sd.items()}


def block(sd: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    """The entries under ``prefix``, the prefix taken off."""
    return tensor_state_dict({k[len(prefix):]: v for k, v in sd.items()
                              if k.startswith(prefix)})


def block_batch_norm(sd: Mapping) -> bool:
    """Whether a network block holds BN statistics; raises on a norm layer
    that cannot be BN."""
    norms: Dict[str, set] = {}
    for key in sd:
        m = _NORM.match(key)
        if m:
            norms.setdefault(m.group(1), set()).add(m.group(2))
    for norm, names in sorted(norms.items()):
        if "running_mean" not in names and "weight" in names:
            raise ValueError(
                f"{norm}: LayerNorm/GroupNorm cannot be folded into a "
                "linear at import; re-export the checkpoint without "
                "sample-dependent normalization")
    return bool(norms)


def load_network(net: nn.Module, sd: Mapping) -> nn.Module:
    """Load a network block (prefix already taken off) into ``net``:
    every parameter and buffer of ``net`` must be in it, apart from
    linears' biases (zero) and BN's ``num_batches_tracked``; nothing else
    may be in it."""
    sd = tensor_state_dict(sd)
    missing, unexpected = net.load_state_dict(sd, strict=False)
    if unexpected:
        raise KeyError(f"unexpected keys {unexpected[:8]}")
    modules = dict(net.named_modules())
    for key in missing:
        owner, _, name = key.rpartition(".")
        m = modules.get(owner)
        if name == "bias" and isinstance(m, nn.Linear):
            with torch.no_grad():
                m.bias.zero_()
        elif name != "num_batches_tracked":
            raise KeyError(f"missing key {key}")
    return net


def network_from_state_dict(network_cfg: Optional[Dict], input_dim: int,
                            output_dim: int, sd: Mapping, prefix: str = "a2b."
                            ) -> nn.Module:
    """``build_network`` of the config, with BN where the block under
    ``prefix`` holds BN statistics, and the block loaded."""
    sub = block(sd, prefix)
    net = build_network(network_cfg, input_dim, output_dim,
                        batch_norm=block_batch_norm(sub))
    return load_network(net, sub).eval()
