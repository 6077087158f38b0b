"""The reference's probabilistic heads, for its checkpoints (port of
``shapy_tpu/models/attributes/prob_import.py``).

The reference's ``A2BProbabilistic`` wraps one of two heads
(``attributes_betas/prob.py``):

* ``MultiVariateNormalRegressor`` (:class:`RefMVNRegressor`): a zoo
  network ``net`` maps features to ``[mean, Cholesky elements]``, a
  softplus'd diagonal (``covariance='diagonal'``) or the raw
  ``tril_indices``-ordered entries (``'tril'``);
* ``FlowRegressor`` (:class:`RefFlowRegressor`): nflows blocks
  ``flow._transform._transforms.{3b..3b+2}`` = [ActNorm, LULinear, the
  reference's conditional coupling] over a standard normal. The coupling
  keeps the reference's quirks verbatim: its parameters come from the
  context only, and both its passthrough and its transformed half read
  the first half of the vector.

The MVN's NLL keeps the reference's own formula, the log of the *sum* of
the diagonal where a log-determinant would sum the logs. The modules carry
the reference's names, so a checkpoint's ``a2b.`` block loads through
``load_state_dict`` (nflows' ``initialized`` flags and the base
distribution's buffers are not parameters and are skipped).
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from shapy_tpu_torch.models.attributes.ckpt_import import (
    block,
    load_network,
    network_from_state_dict,
)
from shapy_tpu_torch.models.attributes.networks import build_network
from shapy_tpu_torch.utils.device import full_f32_matmul


def _tensor(x, like: torch.Tensor) -> torch.Tensor:
    if torch.is_tensor(x):
        return x.to(like.device, torch.float32)
    return torch.as_tensor(np.asarray(x), dtype=torch.float32,
                           device=like.device)


class RefMVNRegressor(nn.Module):
    """``MultiVariateNormalRegressor``'s twin."""

    def __init__(self, input_dim: int, distr_dim: int,
                 cfg: Optional[Dict] = None):
        super().__init__()
        cfg = dict(cfg or {})
        prob_cfg = dict(cfg.get("probabilistic") or {})
        gauss = dict(prob_cfg.get("gaussian") or {})
        self.covariance_type = gauss.get("covariance", "diagonal")
        self.distr_dim = int(distr_dim)
        self.input_dim = int(input_dim)
        if self.covariance_type == "diagonal":
            out = 2 * self.distr_dim
            rows = cols = np.arange(self.distr_dim)
        elif self.covariance_type == "tril":
            out = self.distr_dim + self.distr_dim * (
                self.distr_dim + 1) // 2
            rows, cols = np.tril_indices(self.distr_dim)
        else:
            raise ValueError(
                f"Unknown covariance type: {self.covariance_type}")
        self.out_dim = out
        self.network_cfg = dict(cfg.get("network") or {})
        self.register_buffer("rows", torch.as_tensor(rows, dtype=torch.long),
                             persistent=False)
        self.register_buffer("cols", torch.as_tensor(cols, dtype=torch.long),
                             persistent=False)
        self.net = build_network(self.network_cfg, self.input_dim, out)

    def mean_L(self, cond) -> Tuple[torch.Tensor, torch.Tensor]:
        t = self.net(_tensor(cond, next(self.net.parameters())))
        mean = t[:, : self.distr_dim]
        elems = t[:, self.distr_dim:]
        if self.covariance_type == "diagonal":
            elems = F.softplus(elems)
        L = t.new_zeros((t.shape[0], self.distr_dim, self.distr_dim))
        L[:, self.rows, self.cols] = elems
        return mean, L

    def neg_log_likelihood(self, cond, values) -> torch.Tensor:
        """The reference's NLL: ``L^-T L^-1`` as the precision and
        ``2 log(sum(diag L))``."""
        mean, L = self.mean_L(cond)
        inv_L = torch.linalg.inv(L)
        L_diag = torch.diagonal(L, dim1=1, dim2=2)
        diff = _tensor(values, mean) - mean
        prec = inv_L.transpose(1, 2) @ inv_L
        return 0.5 * (
            self.distr_dim * math.log(2 * math.pi)
            + 2 * torch.log(L_diag.sum(dim=-1))
            + (diff * torch.einsum("bmn,bn->bm", prec, diff)).sum(dim=-1)
        )

    def sample(self, N: int, cond, generator: torch.Generator
               ) -> torch.Tensor:
        """(B, N, D) draws."""
        mean, L = self.mean_L(cond)
        z = torch.randn((mean.shape[0], N, self.distr_dim),
                        generator=generator,
                        device=generator.device).to(mean.device)
        return mean[:, None] + torch.einsum("bmn,bsn->bsm", L, z)

    def predict(self, cond) -> np.ndarray:
        with torch.no_grad(), full_f32_matmul():
            mean, _ = self.mean_L(cond)
        return mean.cpu().numpy()

    def load_block(self, sd: Mapping, prefix: str) -> "RefMVNRegressor":
        self.net = network_from_state_dict(self.network_cfg, self.input_dim,
                                           self.out_dim, sd, prefix + "net.")
        return self


class ActNorm(nn.Module):
    """nflows ``ActNorm`` in eval mode."""

    def __init__(self, features: int):
        super().__init__()
        self.log_scale = nn.Parameter(torch.zeros(features))
        self.shift = nn.Parameter(torch.zeros(features))

    def forward(self, x, cond=None):
        out = torch.exp(self.log_scale) * x + self.shift
        return out, self.log_scale.sum() * x.new_ones(x.shape[0])

    def inverse(self, x, cond=None):
        out = (x - self.shift) * torch.exp(-self.log_scale)
        return out, -self.log_scale.sum() * x.new_ones(x.shape[0])


class LULinear(nn.Module):
    """nflows ``LULinear``: y = L(Ux) + b, L unit lower-triangular, U's
    diagonal softplus(.) + eps."""

    def __init__(self, features: int, eps: float = 1e-3):
        super().__init__()
        D = int(features)
        n_tri = D * (D - 1) // 2
        self.eps = eps
        self.bias = nn.Parameter(torch.zeros(D))
        self.lower_entries = nn.Parameter(torch.zeros(n_tri))
        self.upper_entries = nn.Parameter(torch.zeros(n_tri))
        self.unconstrained_upper_diag = nn.Parameter(torch.zeros(D))
        lo, up = np.tril_indices(D, k=-1), np.triu_indices(D, k=1)
        for name, idx in (("lower_rows", lo[0]), ("lower_cols", lo[1]),
                          ("upper_rows", up[0]), ("upper_cols", up[1])):
            self.register_buffer(name, torch.as_tensor(idx, dtype=torch.long),
                                 persistent=False)

    def lower_upper(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        D = self.bias.shape[0]
        lower = self.bias.new_zeros((D, D))
        lower[self.lower_rows, self.lower_cols] = self.lower_entries
        lower = lower + torch.eye(D, device=lower.device)
        diag = F.softplus(self.unconstrained_upper_diag) + self.eps
        upper = self.bias.new_zeros((D, D))
        upper[self.upper_rows, self.upper_cols] = self.upper_entries
        return lower, upper + torch.diag(diag), torch.log(diag).sum()

    def forward(self, x, cond=None):
        lower, upper, logdet = self.lower_upper()
        out = x @ upper.T @ lower.T + self.bias
        return out, logdet * x.new_ones(x.shape[0])

    def inverse(self, x, cond=None):
        lower, upper, logdet = self.lower_upper()
        t = (x - self.bias).T
        t = torch.linalg.solve_triangular(lower, t, upper=False,
                                          unitriangular=True)
        t = torch.linalg.solve_triangular(upper, t, upper=True)
        return t.T, -logdet * x.new_ones(x.shape[0])


class ConditionalCoupling(nn.Module):
    """The reference's ``ConditionalAffineCoupling``, quirks kept: the
    ``network`` reads the context only, and both halves read
    ``x[:, :dim]``."""

    def __init__(self, network: nn.Module, dim: int, scale: bool):
        super().__init__()
        self.network = network
        self.dim = dim
        self.use_scale = scale

    def _params(self, cond):
        p = self.network(cond)
        transl = p[:, : self.dim]
        s = (F.softplus(p[:, self.dim:]) if self.use_scale
             else torch.ones_like(transl))
        return transl, s

    def forward(self, x, cond):
        transl, s = self._params(cond)
        top = x[:, : self.dim]
        bottom = x[:, : self.dim]  # the reference's quirk
        return (torch.cat([top, s * bottom + transl], dim=1),
                torch.sum(torch.log(s), dim=1))

    def inverse(self, x, cond):
        transl, s = self._params(cond)
        top = x[:, : self.dim]
        bottom = x[:, : self.dim]
        return (torch.cat([top, (bottom - transl) / s], dim=1),
                -torch.sum(torch.log(s), dim=1))


class _Composite(nn.Module):
    def __init__(self, transforms):
        super().__init__()
        self._transforms = nn.ModuleList(transforms)


class _Flow(nn.Module):
    def __init__(self, transforms):
        super().__init__()
        self._transform = _Composite(transforms)


class RefFlowRegressor(nn.Module):
    """The reference ``FlowRegressor``'s twin: data -> noise through
    [ActNorm, LULinear, coupling] x ``num_blocks``, a standard normal
    base."""

    def __init__(self, input_dim: int, distr_dim: int,
                 cfg: Optional[Dict] = None):
        super().__init__()
        cfg = dict(cfg or {})
        prob_cfg = dict(cfg.get("probabilistic") or {})
        flow_cfg = dict(prob_cfg.get("flow") or {})
        self.distr_dim = int(distr_dim)
        self.input_dim = int(input_dim)
        self.num_blocks = int(flow_cfg.get("num_blocks", 4))
        norm_type = flow_cfg.get("norm_type", "actnorm")
        perm_type = flow_cfg.get("perm_type", "lu-linear")
        coupling_type = flow_cfg.get("coupling_type", "lulinear")
        if norm_type != "actnorm" or perm_type != "lu-linear":
            raise ValueError(
                "only actnorm + lu-linear flow blocks are importable "
                f"(got norm={norm_type}, perm={perm_type})"
            )
        self.coupling_scale = coupling_type != "conditional-additive"
        self.network_cfg = dict(cfg.get("network") or {})
        half = self.distr_dim // 2
        self.coupling_out = half + (half if self.coupling_scale else 0)
        blocks = []
        for _ in range(self.num_blocks):
            blocks += [ActNorm(self.distr_dim), LULinear(self.distr_dim),
                       ConditionalCoupling(
                           build_network(self.network_cfg, self.input_dim,
                                         self.coupling_out),
                           half, self.coupling_scale)]
        self.flow = _Flow(blocks)

    @property
    def blocks(self):
        return self.flow._transform._transforms

    def load_block(self, sd: Mapping, prefix: str) -> "RefFlowRegressor":
        base = prefix + "flow._transform._transforms."
        for b in range(self.num_blocks):
            self.blocks[3 * b + 2].network = network_from_state_dict(
                self.network_cfg, self.input_dim, self.coupling_out, sd,
                f"{base}{3 * b + 2}.network.")
        own = {k: v for k, v in block(sd, prefix).items()
               if not k.endswith(".initialized")
               and not k.startswith("flow._distribution.")}
        load_network(self, own)
        return self

    # data -> noise (nflows' forward)
    def _transform(self, values, cond):
        x = _tensor(values, cond)
        total = x.new_zeros(x.shape[0])
        for blk in self.blocks:
            x, ld = blk(x, cond)
            total = total + ld
        return x, total

    def _inverse(self, noise, cond):
        x = _tensor(noise, cond)
        total = x.new_zeros(x.shape[0])
        for blk in reversed(self.blocks):
            x, ld = blk.inverse(x, cond)
            total = total + ld
        return x, total

    def _cond(self, cond) -> torch.Tensor:
        return _tensor(cond, self.blocks[0].shift)

    def neg_log_likelihood(self, cond, values) -> torch.Tensor:
        cond = self._cond(cond)
        noise, logabsdet = self._transform(values, cond)
        log_prob = (-0.5 * torch.sum(noise ** 2, dim=1)
                    - 0.5 * self.distr_dim * math.log(2 * math.pi))
        return -(log_prob + logabsdet)

    def predict(self, cond) -> np.ndarray:
        """The reference's point estimate: the inverse of z = 0."""
        cond = self._cond(cond)
        with torch.no_grad(), full_f32_matmul():
            mean, _ = self._inverse(cond.new_zeros(
                (cond.shape[0], self.distr_dim)), cond)
        return mean.cpu().numpy()

    def sample(self, N: int, cond, generator: torch.Generator
               ) -> torch.Tensor:
        """(B, N, D) draws."""
        cond = self._cond(cond)
        B = cond.shape[0]
        z = torch.randn((B * N, self.distr_dim), generator=generator,
                        device=generator.device).to(cond.device)
        samples, _ = self._inverse(z, cond.repeat_interleave(N, dim=0))
        return samples.reshape(B, N, self.distr_dim)


def build_distr_regressor(cfg: Dict, input_dim: int, distr_dim: int):
    prob_type = dict(cfg.get("probabilistic") or {}).get(
        "type", "gaussian")
    if prob_type in ("gaussian", "multivariate-normal"):
        return RefMVNRegressor(input_dim, distr_dim, cfg)
    if prob_type == "flow":
        return RefFlowRegressor(input_dim, distr_dim, cfg)
    raise ValueError(f"Unknown distribution predictor type: {prob_type}")


def probabilistic_from_checkpoint(path: str, cfg: Optional[Dict] = None):
    """A reference A2BProbabilistic Lightning checkpoint -> (its head,
    the merged cfg)."""
    from shapy_tpu_torch.models.attributes.b2a import _checkpoint_cfg
    from shapy_tpu_torch.models.attributes.features import select_features

    conf, sd = _checkpoint_cfg(path, cfg)
    attrs, _, mmts = select_features(conf)
    head = build_distr_regressor(conf, len(attrs) + len(mmts),
                                 int(conf.get("num_shape_comps", 10)))
    return head.load_block(sd, "a2b.").eval(), conf
