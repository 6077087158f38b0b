"""Probabilistic A2S heads: attributes -> a distribution over betas
(port of ``shapy_tpu/models/attributes/prob.py``).

:class:`MVNHead` maps features to the mean and a Cholesky factor of a
multivariate normal; :class:`ConditionalFlow` is a stack of conditional
affine couplings over a standard normal. :class:`A2BProbabilistic` wraps
either one (or, loaded from a reference checkpoint, a head of
:mod:`.prob_import`) with ``log_prob``, ``sample`` (from an explicit
``torch.Generator``), ``predict``, ``fit`` (Adam on the NLL) and
``neg_log_likelihood``.

The JAX flow's ``forward`` (base -> data) and ``inverse`` (data -> base)
are :meth:`ConditionalFlow.to_data` / :meth:`ConditionalFlow.to_base`
here; calling the flow is its log density, as calling the JAX module is.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from shapy_tpu_torch.models.attributes.features import select_features
from shapy_tpu_torch.utils.device import full_f32_matmul


class MVNHead(nn.Module):
    """Features -> (mean, lower-triangular Cholesky factor): ReLU
    ``layers``, then ``mean``, ``diag`` (softplus + 1e-4) and ``off`` (the
    strictly lower entries in ``tril_indices`` order)."""

    def __init__(self, input_dim: int, out_dim: int,
                 hidden_dims: Sequence[int] = (256, 256)):
        super().__init__()
        dims = [int(input_dim), *[int(h) for h in hidden_dims]]
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in
                                    zip(dims[:-1], dims[1:]))
        D = int(out_dim)
        self.out_dim = D
        self.mean = nn.Linear(dims[-1], D)
        self.diag = nn.Linear(dims[-1], D)
        self.off = nn.Linear(dims[-1], D * (D - 1) // 2)
        rows, cols = np.tril_indices(D, k=-1)
        self.register_buffer("tril_rows", torch.from_numpy(rows),
                             persistent=False)
        self.register_buffer("tril_cols", torch.from_numpy(cols),
                             persistent=False)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        for layer in self.layers:
            x = F.relu(layer(x))
        D = self.out_dim
        diag = F.softplus(self.diag(x)) + 1e-4
        tril = x.new_zeros(x.shape[:-1] + (D, D))
        tril[..., self.tril_rows, self.tril_cols] = self.off(x)
        return self.mean(x), tril + torch.diag_embed(diag)


def mvn_log_prob(y: torch.Tensor, mean: torch.Tensor, tril: torch.Tensor
                 ) -> torch.Tensor:
    """Log density of N(mean, L L^T) at y, batched."""
    d = y - mean
    z = torch.linalg.solve_triangular(tril, d[..., None], upper=False)[..., 0]
    logdet = torch.sum(torch.log(torch.diagonal(tril, dim1=-2, dim2=-1)),
                       dim=-1)
    k = y.shape[-1]
    return (-0.5 * torch.sum(z * z, dim=-1) - logdet
            - 0.5 * k * math.log(2 * math.pi))


class CouplingLayer(nn.Module):
    """Conditional affine coupling: the half ``b`` of y moves by a scale
    (2 tanh) and shift computed from the other half ``a`` and the
    conditioning features; ``flip`` swaps the halves."""

    def __init__(self, dim: int, cond_dim: int, hidden: int = 128,
                 flip: bool = False):
        super().__init__()
        d1 = dim // 2
        self.d1, self.flip = d1, flip
        a_dim, b_dim = (dim - d1, d1) if flip else (d1, dim - d1)
        self.fc1 = nn.Linear(a_dim + int(cond_dim), hidden)
        self.fc2 = nn.Linear(hidden, hidden)
        self.scale = nn.Linear(hidden, b_dim)
        self.shift = nn.Linear(hidden, b_dim)

    def forward(self, y: torch.Tensor, cond: torch.Tensor,
                inverse: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        a, b = y[..., :self.d1], y[..., self.d1:]
        if self.flip:
            a, b = b, a
        h = F.relu(self.fc1(torch.cat([a, cond], dim=-1)))
        h = F.relu(self.fc2(h))
        scale = torch.tanh(self.scale(h)) * 2.0
        shift = self.shift(h)
        if inverse:
            b = (b - shift) * torch.exp(-scale)
            logdet = -torch.sum(scale, dim=-1)
        else:
            b = b * torch.exp(scale) + shift
            logdet = torch.sum(scale, dim=-1)
        if self.flip:
            a, b = b, a
        return torch.cat([a, b], dim=-1), logdet


class ConditionalFlow(nn.Module):
    """Conditional couplings (every other one flipped) over a standard
    normal base."""

    def __init__(self, dim: int, cond_dim: int, num_layers: int = 6,
                 hidden: int = 128):
        super().__init__()
        self.dim = int(dim)
        self.layers = nn.ModuleList(
            CouplingLayer(dim, cond_dim, hidden, flip=bool(i % 2))
            for i in range(int(num_layers)))

    def to_data(self, z: torch.Tensor, cond: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """base -> data, and the log-determinant."""
        logdet = z.new_zeros(z.shape[:-1])
        for layer in self.layers:
            z, ld = layer(z, cond)
            logdet = logdet + ld
        return z, logdet

    def to_base(self, y: torch.Tensor, cond: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """data -> base, and the log-determinant."""
        logdet = y.new_zeros(y.shape[:-1])
        for layer in reversed(self.layers):
            y, ld = layer(y, cond, inverse=True)
            logdet = logdet + ld
        return y, logdet

    def forward(self, y: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        """Log density of the data under the flow."""
        z, logdet = self.to_base(y, cond)
        base = (-0.5 * torch.sum(z * z, dim=-1)
                - 0.5 * self.dim * math.log(2 * math.pi))
        return base + logdet


class A2BProbabilistic(nn.Module):
    """Probabilistic attributes -> betas regressor (``probabilistic.type``
    mvn or flow; a reference checkpoint's head through
    :meth:`load_from_checkpoint`)."""

    def __init__(self, cfg: Optional[Dict] = None,
                 generator: Optional[torch.Generator] = None, **kwargs):
        super().__init__()
        cfg = dict(cfg or {}, **kwargs)
        self.cfg = cfg
        self.betas_size = int(cfg.get("num_shape_comps", 10))
        self.selected_attr, self.selected_attr_idx, self.selected_mmts = (
            select_features(cfg)
        )
        self.input_dim = len(self.selected_attr) + len(self.selected_mmts)
        prob_cfg = dict(cfg.get("probabilistic") or {})
        self.head_type = prob_cfg.get("type", "mvn")
        if self.head_type == "mvn":
            self.module = MVNHead(
                self.input_dim, self.betas_size,
                tuple(prob_cfg.get("hidden_dims", (256, 256))),
            )
        else:
            self.module = ConditionalFlow(
                self.betas_size,
                self.input_dim,
                int(prob_cfg.get("num_layers", 6)),
                int(prob_cfg.get("hidden", 128)),
            )
        from shapy_tpu_torch.models.attributes.networks import (
            reset_parameters_,
        )

        reset_parameters_(self.module, generator if generator is not None
                          else torch.Generator().manual_seed(0))
        self.head = None
        self.eval()

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def _tensor(self, x) -> torch.Tensor:
        if torch.is_tensor(x):
            return x.to(self.device, torch.float32)
        return torch.as_tensor(np.asarray(x), dtype=torch.float32,
                               device=self.device)

    # -- log prob / sampling ----------------------------------------------
    def log_prob(self, betas, features) -> torch.Tensor:
        betas, features = self._tensor(betas), self._tensor(features)
        with full_f32_matmul():
            if self.head is not None:  # a reference checkpoint's head
                return -self.head.neg_log_likelihood(features, betas)
            if self.head_type == "mvn":
                mean, tril = self.module(features)
                return mvn_log_prob(betas, mean, tril)
            return self.module(betas, features)

    def _normal(self, shape, generator: torch.Generator) -> torch.Tensor:
        return torch.randn(shape, generator=generator,
                           device=generator.device).to(self.device)

    def sample(self, features, generator: torch.Generator,
               num_samples: int = 1) -> torch.Tensor:
        """(num_samples, B, betas) draws, their noise from ``generator``."""
        features = self._tensor(features)
        with full_f32_matmul():
            if self.head is not None:  # (B, N, D) -> (N, B, D)
                return self.head.sample(num_samples, features,
                                        generator).transpose(0, 1)
            B = features.shape[0]
            z = self._normal((num_samples, B, self.betas_size), generator)
            if self.head_type == "mvn":
                mean, tril = self.module(features)
                return mean[None] + torch.einsum("bij,sbj->sbi", tril, z)
            cond = features.expand((num_samples,) + features.shape)
            y, _ = self.module.to_data(z.reshape(-1, self.betas_size),
                                       cond.reshape(-1, self.input_dim))
            return y.reshape(num_samples, B, self.betas_size)

    def predict(self, features) -> np.ndarray:
        """Point estimate: the MVN mean / the flow's image of z = 0."""
        if self.head is not None:
            return self.head.predict(features)
        features = self._tensor(features)
        with torch.no_grad(), full_f32_matmul():
            if self.head_type == "mvn":
                mean, _ = self.module(features)
                return mean.cpu().numpy()
            z = features.new_zeros((features.shape[0], self.betas_size))
            y, _ = self.module.to_data(z, features)
            return y.cpu().numpy()

    # -- training ----------------------------------------------------------
    def nll(self, xb: torch.Tensor, yb: torch.Tensor) -> torch.Tensor:
        """The batch's mean negative log-likelihood."""
        if self.head_type == "mvn":
            mean, tril = self.module(xb)
            return -torch.mean(mvn_log_prob(yb, mean, tril))
        return -torch.mean(self.module(yb, xb))

    def nll_step(self, optimizer: torch.optim.Optimizer, xb: torch.Tensor,
                 yb: torch.Tensor) -> torch.Tensor:
        with full_f32_matmul():
            loss = self.nll(xb, yb)
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
        optimizer.step()
        return loss.detach()

    def fit(self, features, betas, num_steps: int = 2000,
            learning_rate: float = 1e-3, batch_size: int = 256,
            seed: int = 0, generator: Optional[torch.Generator] = None
            ) -> "A2BProbabilistic":
        """Maximum likelihood: ``num_steps`` Adam steps on ``batch_size``
        rows drawn with replacement from ``generator`` (CPU, seeded with
        ``seed`` when None)."""
        X = self._tensor(features)
        Y = self._tensor(betas)[:, : self.betas_size]
        optimizer = torch.optim.Adam(self.module.parameters(),
                                     lr=learning_rate)
        if generator is None:
            generator = torch.Generator().manual_seed(seed)
        rows = torch.randint(0, X.shape[0], (
            num_steps, min(batch_size, X.shape[0])),
            generator=generator).to(X.device)
        for idx in rows:
            self.nll_step(optimizer, X[idx], Y[idx])
        return self

    # -- reference checkpoint import ----------------------------------------
    @classmethod
    def load_from_checkpoint(cls, path: str, cfg: Optional[Dict] = None
                             ) -> "A2BProbabilistic":
        """A reference A2BProbabilistic Lightning checkpoint: its head (an
        MVN over a zoo network, or the nflows flow) is a
        :mod:`.prob_import` twin, ``head``; ``log_prob`` / ``sample`` /
        ``predict`` keep this class's interface."""
        from shapy_tpu_torch.models.attributes.prob_import import (
            probabilistic_from_checkpoint,
        )

        head, conf = probabilistic_from_checkpoint(path, cfg)
        obj = cls.__new__(cls)
        nn.Module.__init__(obj)
        obj.cfg = conf
        obj.betas_size = head.distr_dim
        obj.selected_attr, obj.selected_attr_idx, obj.selected_mmts = (
            select_features(conf)
        )
        obj.input_dim = len(obj.selected_attr) + len(obj.selected_mmts)
        obj.head_type = ("mvn-torch" if hasattr(head, "mean_L")
                         else "flow-torch")
        obj.module = None
        obj.head = head
        return obj.eval()

    def neg_log_likelihood(self, features, betas) -> torch.Tensor:
        """The head's NLL (the reference heads' own formula for an
        imported checkpoint)."""
        if self.head is not None:
            with full_f32_matmul():
                return self.head.neg_log_likelihood(
                    self._tensor(features), self._tensor(betas))
        return -self.log_prob(betas, features)
