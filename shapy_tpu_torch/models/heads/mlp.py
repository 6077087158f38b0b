"""MLP head (port of ``shapy_tpu/models/heads/mlp.py``).

Blocks of Linear named ``layer_{idx:03d}`` (the Linear at position 0),
then ``output_layer``: the JAX param names. No normalisation; no
activation, as the SHAPY config, or a ReLU after every hidden Linear (the
discriminators' MLPs). In training, dropout follows every hidden Linear
(``shapy_tpu/models/heads/mlp.py:70-74``), its masks drawn from an
explicit ``torch.Generator``.
Initialisation follows the JAX package's distributions, drawn from a
``torch.Generator``: uniform(+-1/sqrt(fan_in)) hidden layers and a
xavier-uniform(gain) output layer with zero bias.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn


class MLP(nn.Module):
    def __init__(self, input_dim: int, output_dim: int,
                 layers: Sequence[int] = (1024, 1024), gain: float = 0.01,
                 generator: Optional[torch.Generator] = None,
                 dropout: float = 0.0, activation: Optional[str] = None):
        super().__init__()
        if activation not in (None, "relu"):
            raise ValueError(f"MLP activation not ported: {activation}")
        self.activation = activation
        self.num_layers = len(layers)
        self.dropout = float(dropout)
        d = input_dim
        for i, width in enumerate(layers):
            lin = nn.Linear(d, width)
            bound = 1.0 / math.sqrt(d)
            with torch.no_grad():
                lin.weight.uniform_(-bound, bound, generator=generator)
                lin.bias.uniform_(-bound, bound, generator=generator)
            setattr(self, f"layer_{i:03d}", nn.Sequential(lin))
            d = width
        self.output_layer = nn.Linear(d, output_dim)
        a = gain * math.sqrt(6.0 / (d + output_dim))
        with torch.no_grad():
            self.output_layer.weight.uniform_(-a, a, generator=generator)
            self.output_layer.bias.zero_()

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """In training with dropout, ``generator`` (on x's device) draws
        the keep masks: x / (1 - p) where kept, else 0."""
        drop = self.training and self.dropout > 0.0
        if drop and generator is None:
            raise ValueError("MLP: dropout in training needs a generator")
        keep = 1.0 - self.dropout
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i:03d}")(x)
            if self.activation == "relu":
                x = torch.relu(x)
            if drop:
                u = torch.rand(x.shape, generator=generator, device=x.device,
                               dtype=x.dtype)
                x = torch.where(u < keep, x / keep, torch.zeros_like(x))
        return self.output_layer(x)
