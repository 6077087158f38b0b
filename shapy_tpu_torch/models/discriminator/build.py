"""The adversarial pose discriminators (port of
``shapy_tpu/models/discriminator/build.py``).

``HMRDiscriminator`` is the reference's topology: two joint-shared dense
layers 9 -> C -> C (a 1x1 conv over the joints), a shared dense to one
logit a joint, and a (J C -> Z -> Z -> 1) MLP over all joints, every
weight spectrally normalised. ``PoseDiscriminator`` is the independent
variant: a small ReLU MLP a joint, one over all joints and one over the
betas.

Spectral normalisation keeps the JAX semantics, not those of
``torch.nn.utils.spectral_norm``: a forward divides each weight by
sigma = u^T W v from one power-iteration step on the persistent ``u``
with both vectors detached (so d sigma / d W = u v^T), and leaves ``u``
as it is; :meth:`HMRDiscriminator.refresh_u_` moves every ``u`` one step
at the current weights, once a train step after the discriminator's
update. ``u`` is a buffer: it takes no gradient and no optimizer step.

The dense layers keep the JAX layout, weight (nin, nout) and ``x @ w``,
so the JAX params load by name (``io.from_jax.load_from_jax``). They are
plain products, as in the JAX package, where no Pallas kernel computes
them.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from shapy_tpu_torch.models.heads.mlp import MLP


def power_iteration(weight: torch.Tensor, u: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One power-iteration step on ``weight`` (nin, nout), the JAX
    ``_spectral_sigma`` of its transpose: (sigma, new u), with v and the
    new u detached."""
    v = weight @ u
    v = (v / (torch.linalg.vector_norm(v) + 1e-12)).detach()
    w2d = weight.T
    u_new = w2d @ v
    u_new = (u_new / (torch.linalg.vector_norm(u_new) + 1e-12)).detach()
    return u_new @ (w2d @ v), u_new


class SNDense(nn.Module):
    """``x @ (weight / sigma) + bias``, sigma from the buffer ``u`` (or
    ``x @ weight + bias`` without spectral normalisation)."""

    def __init__(self, nin: int, nout: int, spectral_norm: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        bound = (1.0 / nin) ** 0.5
        self.spectral_norm = spectral_norm
        self.weight = nn.Parameter(
            torch.empty(nin, nout).uniform_(-bound, bound,
                                            generator=generator))
        self.bias = nn.Parameter(
            torch.empty(nout).uniform_(-bound, bound, generator=generator))
        self.register_buffer("u", torch.randn(nout, generator=generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        if self.spectral_norm:
            w = w / power_iteration(w, self.u)[0]
        return x @ w + self.bias

    @torch.no_grad()
    def refresh_u_(self) -> None:
        if self.spectral_norm:
            self.u.copy_(power_iteration(self.weight, self.u)[1])


class HMRDiscriminator(nn.Module):
    """rotmats (B, J, 3, 3) or (B, J, 9) -> (B, J + 1) logits: one a joint,
    then one of the whole pose. Weights drawn from ``seed`` with the JAX
    package's distributions (torch's Linear default), ``u`` normal."""

    LAYERS = ("conv1", "conv2", "part_disc", "linear1", "linear2",
              "linear3")

    def __init__(self, num_joints: int = 21, num_channels: int = 32,
                 nzfeat: int = 1024, use_spectral_norm: bool = True,
                 seed: int = 0):
        super().__init__()
        self.num_joints = num_joints
        gen = torch.Generator().manual_seed(seed)
        C, J, Z = num_channels, num_joints, nzfeat
        sizes = {"conv1": (9, C), "conv2": (C, C), "part_disc": (C, 1),
                 "linear1": (J * C, Z), "linear2": (Z, Z),
                 "linear3": (Z, 1)}
        for name in self.LAYERS:
            setattr(self, name, SNDense(*sizes[name], use_spectral_norm,
                                        generator=gen))

    def forward(self, rotmats: torch.Tensor) -> torch.Tensor:
        B = rotmats.shape[0]
        x = rotmats.reshape(B, self.num_joints, 9)
        x = torch.relu(self.conv1(x))
        x = torch.relu(self.conv2(x))
        part = self.part_disc(x).reshape(B, self.num_joints)
        h = torch.relu(self.linear1(x.reshape(B, -1)))
        h = torch.relu(self.linear2(h))
        return torch.cat([part, self.linear3(h)], dim=1)

    def refresh_u_(self) -> None:
        """One power-iteration step of every layer's ``u`` at the current
        weights."""
        for name in self.LAYERS:
            getattr(self, name).refresh_u_()


class PoseDiscriminator(nn.Module):
    """rotmats (B, J, 3, 3) [+ betas (B, num_betas)] -> (B, J + 1 [+ 1])
    logits: a ReLU MLP (9 -> hidden -> 1) a joint, one over all joints
    (J 9 -> 4 hidden -> 4 hidden -> 1), and one over the betas."""

    def __init__(self, num_joints: int = 21, num_betas: int = 10,
                 hidden: int = 32, seed: int = 0):
        super().__init__()
        self.num_joints = num_joints
        gen = torch.Generator().manual_seed(seed)
        for j in range(num_joints):
            setattr(self, f"joint_{j:02d}",
                    MLP(9, 1, (hidden,), gain=1.0, generator=gen,
                        activation="relu"))
        self.all_joints = MLP(num_joints * 9, 1, (hidden * 4, hidden * 4),
                              gain=1.0, generator=gen, activation="relu")
        self.shape = MLP(num_betas, 1, (hidden,), gain=1.0, generator=gen,
                         activation="relu")

    def forward(self, rotmats: torch.Tensor,
                betas: Optional[torch.Tensor] = None) -> torch.Tensor:
        B = rotmats.shape[0]
        flat = rotmats.reshape(B, self.num_joints, 9)
        outs = [getattr(self, f"joint_{j:02d}")(flat[:, j])
                for j in range(self.num_joints)]
        outs.append(self.all_joints(flat.reshape(B, -1)))
        if betas is not None:
            outs.append(self.shape(betas))
        return torch.cat(outs, dim=-1)

    def refresh_u_(self) -> None:
        """No spectral normalisation: nothing to refresh."""


def build_discriminator(cfg: Optional[Dict] = None) -> nn.Module:
    """'hmr' (the default) -> :class:`HMRDiscriminator`; 'per-joint' ->
    :class:`PoseDiscriminator`."""
    cfg = dict(cfg or {})
    disc_type = cfg.get("type", "hmr")
    if disc_type == "hmr":
        return HMRDiscriminator(
            num_joints=int(cfg.get("num_joints", 21)),
            num_channels=int(cfg.get("num_channels", 32)),
            nzfeat=int(cfg.get("nzfeat", 1024)),
            use_spectral_norm=bool(cfg.get("use_spectral_norm", True)))
    if disc_type == "per-joint":
        return PoseDiscriminator(
            num_joints=int(cfg.get("num_joints", 21)),
            num_betas=int(cfg.get("num_betas", 10)),
            hidden=int(cfg.get("hidden", 32)))
    raise ValueError(f"Unknown discriminator type: {disc_type}")
