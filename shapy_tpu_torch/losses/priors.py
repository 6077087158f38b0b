"""Parameter priors (port of ``shapy_tpu/losses/priors.py``): the L1,
L2, identity, mean, threshold, penalty, barrier and GMM priors, the
normal and gender-routed shape priors, and :func:`build_prior`. Each prior
is a callable on a parameter tensor. The gender prior takes an int gender
vector (0 neutral / 1 male / 2 female) and selects per row with masks."""

from __future__ import annotations

import math
import os
import pickle
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F


def l2_prior(x: torch.Tensor, *args, **kwargs) -> torch.Tensor:
    """0.5 x the mean of x^2 over all elements."""
    return 0.5 * (x * x).mean()


def l1_prior(x: torch.Tensor, *args, **kwargs) -> torch.Tensor:
    """The mean over the leading dims of each row's sum of |x| over the
    last dim."""
    return x.abs().sum(-1).mean()


def identity_prior(x: torch.Tensor, *args, **kwargs) -> torch.Tensor:
    """Squared distance of each 3x3 block from the identity, / B."""
    m = x.reshape(-1, 3, 3)
    eye = torch.eye(3, dtype=x.dtype, device=x.device)
    return ((m - eye) ** 2).sum() / x.shape[0]


def make_mean_prior(mean) -> Callable:
    mean = torch.as_tensor(np.asarray(mean))

    def prior(x: torch.Tensor, *args, **kwargs) -> torch.Tensor:
        m = mean.to(device=x.device, dtype=x.dtype)
        return ((x - m[None]) ** 2).sum() / x.shape[0]

    return prior


def make_threshold_prior(margin: float = 1.0, norm: str = "l2",
                         epsilon: float = 1e-7) -> Callable:
    """|x| beyond ``margin``, averaged over the entries past it."""

    def prior(x: torch.Tensor, *args, **kwargs) -> torch.Tensor:
        mask = x.abs() > margin
        vals = torch.where(mask, x, torch.zeros_like(x))
        count = mask.to(x.dtype).sum() + epsilon
        if norm == "l1":
            return vals.abs().sum() / count
        return (vals * vals).sum() / count

    return prior


def make_penalty_prior(margin: float = 1.0, norm: str = "l2",
                       epsilon: float = 1e-7,
                       use_vector: bool = True) -> Callable:
    """A hinge on the parameter vector's norm past ``margin`` (or, without
    ``use_vector``, on each entry outside [-margin, margin])."""

    def prior(x: torch.Tensor, *args, **kwargs) -> torch.Tensor:
        flat = x.reshape(x.shape[0], -1)
        if use_vector:
            if norm == "l1":
                pn, m = flat.abs().sum(-1), margin
            else:
                pn, m = (flat * flat).sum(-1), margin ** 2
            hinge = F.relu(pn - m)
            nz = (hinge > 0).to(x.dtype).sum() + epsilon
            return hinge.sum() / nz
        upper = F.relu(flat - margin)
        lower = F.relu(-(flat + margin))
        un = (upper > 0).to(x.dtype).sum() + epsilon
        ln = (lower > 0).to(x.dtype).sum() + epsilon
        if norm == "l1":
            return upper.abs().sum() / un + lower.abs().sum() / ln
        return (upper ** 2).sum() / un + (lower ** 2).sum() / ln

    return prior


def make_barrier_prior(margin: float = 1.0, barrier: str = "log",
                       epsilon: float = 1e-7,
                       symmetric: bool = True) -> Callable:
    """A log or inverse barrier that keeps the parameters inside
    [-margin, margin]."""
    m = float(margin)

    def prior(x: torch.Tensor, *args, **kwargs) -> torch.Tensor:
        if barrier == "log":
            loss = -math.log(m) - torch.log(-(x - m) + epsilon).mean()
            if symmetric:
                loss = loss - math.log(m) - torch.log((x + m) + epsilon).mean()
            return loss
        loss = -1.0 / (x - m + epsilon).mean()
        if symmetric:
            loss = loss + (1.0 / (x + m)).mean() - 1.0
        return loss

    return prior


def make_gmm_prior(path: str, num_gaussians: int = 6,
                   epsilon: float = 1e-16, use_max: bool = False
                   ) -> Callable:
    """Negative log-likelihood of the pose under the GMM pickled at
    ``path`` (a dict of ``means`` / ``covars`` / ``weights``, or an object
    with ``means_`` / ``covars_`` / ``weights_``, read as latin1): the
    log-sum-exp over the components, or with ``use_max`` the least
    per-component NLL, the mean over the batch. Precisions, log-weights
    and log-determinants are computed in f64 with numpy and kept in
    f32."""
    path = os.path.expanduser(os.path.expandvars(path))
    with open(path, "rb") as f:
        gmm = pickle.load(f, encoding="latin1")
    if isinstance(gmm, dict):
        means, covs, weights = gmm["means"], gmm["covars"], gmm["weights"]
    else:
        means, covs, weights = gmm.means_, gmm.covars_, gmm.weights_

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32))

    means = f32(means)
    precisions = f32(np.stack([np.linalg.inv(c) for c in covs]))
    log_weights = f32(np.log(weights))
    logdets = f32([np.linalg.slogdet(c)[1] for c in covs])
    D = means.shape[-1]
    log_2pi = float(np.float32(np.log(2 * np.pi)))

    def prior(pose: torch.Tensor, *args, **kwargs) -> torch.Tensor:
        mu, prec, lw, ld = (t.to(pose.device) for t in
                            (means, precisions, log_weights, logdets))
        flat = pose.reshape(pose.shape[0], -1)[:, :D]
        diff = flat[:, None, :] - mu[None]  # (B, K, D)
        mah = torch.einsum("bkd,kde,bke->bk", diff, prec, diff)
        if use_max:
            comp = -0.5 * (mah + ld[None] + D * log_2pi) - lw[None]
            return comp.min(-1).values.mean()
        exponent = lw[None] - 0.5 * D * log_2pi - 0.5 * ld[None] - 0.5 * mah
        return (-torch.logsumexp(exponent, -1)).mean()

    return prior


class NormalShapePrior:
    """Mahalanobis prior from an npz with 'mean' + 'covariance' (or the
    arrays themselves); the precision is the pseudo-inverse, in f32."""

    def __init__(self, stats_path: Optional[str] = None,
                 mean: Optional[np.ndarray] = None,
                 covariance: Optional[np.ndarray] = None):
        if stats_path is not None:
            data = np.load(os.path.expandvars(stats_path))
            mean, covariance = data["mean"], data["covariance"]
        self.mean = torch.as_tensor(np.asarray(mean), dtype=torch.float32)
        self.precision = torch.as_tensor(
            np.linalg.pinv(np.asarray(covariance)), dtype=torch.float32)

    def __call__(self, betas: torch.Tensor) -> torch.Tensor:
        """Per-row Mahalanobis distance (B,)."""
        n = betas.shape[-1]
        diff = betas - self.mean[None, :n].to(betas.device)
        prec = self.precision[:n, :n].to(betas.device)
        return torch.einsum("bi,ij,bj->b", diff, prec, diff)


class GenderShapePrior:
    """Female / male rows get their gendered normal prior, neutral rows
    the squared norm; the mean over the batch. ``prior_type`` 'normal' is
    the one the JAX package takes too: any other raises there and here."""

    def __init__(self, female_stats_path=None, male_stats_path=None,
                 female_prior: Optional[NormalShapePrior] = None,
                 male_prior: Optional[NormalShapePrior] = None,
                 prior_type: str = "normal", **kwargs):
        if prior_type != "normal":
            raise NotImplementedError(prior_type)
        self.female = female_prior or NormalShapePrior(female_stats_path)
        self.male = male_prior or NormalShapePrior(male_stats_path)

    def __call__(self, betas: torch.Tensor,
                 genders: Optional[torch.Tensor] = None) -> torch.Tensor:
        B = betas.shape[0]
        if genders is None:
            return (betas * betas).sum() / B
        g = genders.reshape(-1)
        per_row = torch.where(
            g == 2, self.female(betas),
            torch.where(g == 1, self.male(betas), (betas * betas).sum(-1)))
        return per_row.sum() / B


def build_prior(prior_type: str = "l2", **kwargs) -> Callable:
    """The prior named ``prior_type``, built from its config keys."""
    if prior_type == "l2":
        return l2_prior
    if prior_type == "l1":
        return l1_prior
    if prior_type == "identity":
        return identity_prior
    if prior_type == "mean":
        return make_mean_prior(kwargs["mean"])
    if prior_type == "threshold":
        return make_threshold_prior(**kwargs)
    if prior_type == "penalty":
        return make_penalty_prior(**kwargs)
    if prior_type == "barrier":
        return make_barrier_prior(**kwargs)
    if prior_type == "gmm":
        return make_gmm_prior(**kwargs)
    if prior_type == "gender-shape":
        return GenderShapePrior(**dict(kwargs.get("gender_shape", kwargs)))
    raise ValueError(f"Unknown prior type: {prior_type}")
