"""Small attribute-package utilities (port of
``shapy_tpu/models/attributes/utils.py``): the betas jitter of A2S
training and a standalone closed-form ridge regression, on the host in
float64 as in the JAX package."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def sample_in_sphere(
    rng: np.random.Generator,
    num_samples: int,
    dim: int,
    radius: float = 1.0,
) -> np.ndarray:
    """Uniform samples inside a ``dim``-ball of the given radius, drawn
    from ``rng`` in the JAX package's order (directions, then radii)."""
    direction = rng.normal(size=(num_samples, dim))
    direction /= np.maximum(
        np.linalg.norm(direction, axis=1, keepdims=True), 1e-12
    )
    r = radius * rng.uniform(size=(num_samples, 1)) ** (1.0 / dim)
    return direction * r


def ridge_fit(
    X: np.ndarray,
    Y: np.ndarray,
    alpha: float = 1.0,
    fit_intercept: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """Closed-form ridge regression in float64; returns (weight (out, in),
    bias (out,))."""
    X = np.asarray(X, np.float64)
    Y = np.asarray(Y, np.float64)
    if Y.ndim == 1:
        Y = Y[:, None]
    if fit_intercept:
        x_mean = X.mean(axis=0)
        y_mean = Y.mean(axis=0)
        Xc = X - x_mean
        Yc = Y - y_mean
    else:
        Xc, Yc = X, Y
    A = Xc.T @ Xc + alpha * np.eye(X.shape[1])
    W = np.linalg.solve(A, Xc.T @ Yc)  # (in, out)
    weight = W.T
    bias = (
        y_mean - x_mean @ W if fit_intercept
        else np.zeros(Y.shape[1])
    )
    return weight, np.asarray(bias).reshape(-1)


def ridge_predict(X: np.ndarray, weight: np.ndarray, bias: np.ndarray
                  ) -> np.ndarray:
    return np.asarray(X) @ weight.T + bias
