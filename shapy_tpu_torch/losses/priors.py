"""Shape priors (port of the ``NormalShapePrior`` and
``GenderShapePrior`` of ``shapy_tpu/losses/priors.py``). The gender prior
takes an int gender vector (0 neutral / 1 male / 2 female) and selects
per row with masks."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch


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
    the squared norm; the mean over the batch."""

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
