"""Polynomial regression, the shipped S2A / A2S model type (port of
``shapy_tpu/models/attributes/polynomial.py``).

A degree-d expansion (all ``combinations_with_replacement`` of the input
indices of sizes 1..d, no bias column) followed by ``linear``, an
``nn.Linear``: the reference's parameter names, so its ``linear.weight``
/ ``linear.bias`` load as they are. The index tables are non-persistent
buffers, one (num_k, k) table a degree: ``expand`` is a gather and a
product, then one matmul. The fit is the closed-form ridge of
``sklearn.linear_model.Ridge(alpha, fit_intercept=False)`` on
``[1, poly(X)]``, solved on the host in float64 as in the JAX package
(the constant column's coefficient becomes the bias).
"""

from __future__ import annotations

from itertools import chain, combinations_with_replacement
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from shapy_tpu_torch.models.attributes.base import AttributeNetwork


def polynomial_combinations(
    n_features: int, degree: int
) -> Tuple[Tuple[int, ...], ...]:
    """All index tuples of sizes 1..degree."""
    return tuple(
        chain.from_iterable(
            combinations_with_replacement(range(n_features), i)
            for i in range(1, degree + 1)
        )
    )


class Polynomial(AttributeNetwork):
    """Feature expansion + ``linear``."""

    def __init__(
        self,
        input_dim: int,
        output_dim: int,
        degree: int = 2,
        alpha: float = 0.0,
        weight: Optional[np.ndarray] = None,
        bias: Optional[np.ndarray] = None,
    ):
        super().__init__()
        self.input_dim = int(input_dim)
        self.output_dim = int(output_dim)
        self.degree = int(degree)
        self.alpha = float(alpha)

        combos = polynomial_combinations(self.input_dim, self.degree)
        self.coeff_size = len(combos)
        self._index_tables = []
        for k in range(1, self.degree + 1):
            idx = np.asarray([c for c in combos if len(c) == k],
                             dtype=np.int64).reshape(-1, k)
            self._index_tables.append(idx)
            self.register_buffer(f"index_{k}", torch.from_numpy(idx),
                                 persistent=False)
        self.linear = nn.Linear(self.coeff_size, self.output_dim)
        with torch.no_grad():
            self.linear.weight.copy_(torch.as_tensor(
                np.zeros((self.output_dim, self.coeff_size))
                if weight is None else np.asarray(weight)))
            self.linear.bias.copy_(torch.as_tensor(
                np.zeros(self.output_dim) if bias is None
                else np.asarray(bias)))
        self.eval()

    # -- feature expansion --------------------------------------------------
    def expand(self, x: torch.Tensor) -> torch.Tensor:
        """(B, n) -> (B, coeff_size) polynomial features."""
        return torch.cat([x[:, getattr(self, f"index_{k}")].prod(-1)
                          for k in range(1, self.degree + 1)], dim=-1)

    def expand_np(self, x: np.ndarray) -> np.ndarray:
        feats = [np.prod(x[:, idx], axis=-1) for idx in self._index_tables]
        return np.concatenate(feats, axis=-1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear(self.expand(x.to(self.linear.weight.dtype)))

    # -- fitting ------------------------------------------------------------
    def fit(self, X, Y, generator: Optional[torch.Generator] = None
            ) -> "Polynomial":
        """Closed-form ridge on [1, poly(X)], the alpha penalty on every
        column; ``generator`` is unused (the solve draws nothing)."""
        X = np.asarray(X, dtype=np.float64)
        Y = np.asarray(Y, dtype=np.float64)
        if Y.ndim == 1:
            Y = Y[:, None]
        A = np.concatenate(
            [np.ones((X.shape[0], 1)), self.expand_np(X)], axis=1
        )
        AtA = A.T @ A + self.alpha * np.eye(A.shape[1])
        coef = np.linalg.solve(AtA, A.T @ Y)  # (1 + coeff_size, out)
        with torch.no_grad():
            self.linear.weight.copy_(torch.as_tensor(coef[1:].T))
            self.linear.bias.copy_(torch.as_tensor(coef[0]))
        return self

    # -- checkpoint I/O -----------------------------------------------------
    def save_checkpoint(self, path: str) -> None:
        np.savez(
            path,
            weight=self.linear.weight.detach().cpu().numpy(),
            bias=self.linear.bias.detach().cpu().numpy(),
            input_dim=self.input_dim,
            output_dim=self.output_dim,
            degree=self.degree,
            alpha=self.alpha,
        )

    @classmethod
    def load_checkpoint(cls, path: str) -> "Polynomial":
        """The npz of :meth:`save_checkpoint`, or the reference's torch
        checkpoint ``{'model': state_dict, 'hparams': {...}}``."""
        if str(path).endswith(".npz"):
            with np.load(path) as d:
                return cls(
                    int(d["input_dim"]),
                    int(d["output_dim"]),
                    int(d["degree"]),
                    float(d["alpha"]),
                    weight=d["weight"],
                    bias=d["bias"],
                )
        from shapy_tpu_torch.io.pickles import load_torch_file

        ckpt = load_torch_file(path)
        hparams = ckpt["hparams"]
        obj = cls(
            int(hparams["input_dim"]),
            int(hparams["output_dim"]),
            int(hparams.get("degree", 2)),
            float(hparams.get("alpha", 0.0)),
        )
        sd = ckpt["model"]
        obj.linear.load_state_dict({"weight": sd["linear.weight"],
                                    "bias": sd["linear.bias"]})
        return obj
