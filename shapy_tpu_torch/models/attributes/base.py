"""The interface every attribute network shares: an ``nn.Module`` with
the JAX package's ``predict`` / ``fit`` surface (its ``FlaxRegressor``).

``predict`` takes and returns numpy arrays and runs the module in eval
mode on the device its parameters lie on. ``fit`` trains with Adam on
the mean squared error, each step on ``batch_size`` rows drawn with
replacement from an explicit ``torch.Generator``, the module in eval mode
as the JAX package's ``fit`` applies it (no dropout; BatchNorm1d on its
running statistics). Buffers (the iterative regressor's ``param_mean``,
BN's statistics) stay fixed. Matmuls run in full f32 (no TF32), as the
head's do.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from shapy_tpu_torch.utils.device import full_f32_matmul


class AttributeNetwork(nn.Module):
    """Base of the network zoo; ``learning_rate``, ``num_steps`` and
    ``batch_size`` are ``fit``'s, set by ``build_network`` from the
    network's config."""

    learning_rate: float = 1e-3
    num_steps: int = 2000
    batch_size: int = 256

    @property
    def device(self) -> torch.device:
        for t in self.parameters():
            return t.device
        for t in self.buffers():
            return t.device
        return torch.device("cpu")

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=torch.float32,
                               device=self.device)

    def predict(self, x) -> np.ndarray:
        self.eval()
        with torch.no_grad(), full_f32_matmul():
            return self(self._tensor(x)).cpu().numpy()

    def make_optimizer(self) -> torch.optim.Optimizer:
        return torch.optim.Adam(self.parameters(), lr=self.learning_rate)

    def fit_step(self, optimizer: torch.optim.Optimizer, xb: torch.Tensor,
                 yb: torch.Tensor) -> torch.Tensor:
        """One Adam step on the mean squared error of ``(xb, yb)``."""
        with full_f32_matmul():
            loss = torch.mean((self(xb) - yb) ** 2)
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
        optimizer.step()
        return loss.detach()

    def fit(self, X, Y, generator: Optional[torch.Generator] = None
            ) -> "AttributeNetwork":
        """``num_steps`` steps on ``X`` -> ``Y``; ``generator`` (a CPU
        generator, seed 1 when None) draws the mini-batches' rows."""
        self.eval()
        self.requires_grad_(True)
        X, Y = self._tensor(X), self._tensor(Y)
        if generator is None:
            generator = torch.Generator().manual_seed(1)
        rows = torch.randint(0, X.shape[0], (
            self.num_steps, min(self.batch_size, X.shape[0])),
            generator=generator).to(X.device)
        optimizer = self.make_optimizer()
        for idx in rows:
            self.fit_step(optimizer, X[idx], Y[idx])
        return self
