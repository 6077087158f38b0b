"""Adversarial (GAN) losses of the discriminator's training (port of
``shapy_tpu/losses/adversarial.py``).

Each loss holds the discriminator ``disc`` (a module, rotations -> (B, K)
logits) and gives

  generator_loss(fake)                               -> scalar
  discriminator_loss(fake, real, generator, tau)     -> (scalar, aux dict)

The JAX package passes the discriminator's params to each call; here the
module's current parameters are the ones used.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch


def _split_scores(disc: Callable, fake: torch.Tensor, real: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One discriminator call on the fake and real rows together."""
    scores = disc(torch.cat([fake, real], dim=0))
    return scores[:fake.shape[0]], scores[fake.shape[0]:]


class LSGANLoss:
    """Least-squares GAN: the generator drives fake scores to 1, the
    discriminator real scores to 1 and fake ones to 0; each row's scores
    are sum-squared, then the batch mean."""

    def __init__(self, disc: Callable, weight: float = 1.0):
        self.disc = disc
        self.weight = weight

    def generator_loss(self, fake: torch.Tensor) -> torch.Tensor:
        scores = self.disc(fake)
        return ((scores - 1.0) ** 2).sum(1).mean() * self.weight

    def discriminator_loss(self, fake: torch.Tensor, real: torch.Tensor,
                           generator: Optional[torch.Generator] = None,
                           tau: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """``generator`` and ``tau`` are taken (and unused) so that both
        losses share a call."""
        fake_scores, real_scores = _split_scores(self.disc, fake, real)
        loss_real = ((real_scores - 1.0) ** 2).sum(1).mean()
        loss_fake = (fake_scores ** 2).sum(1).mean()
        return (loss_real + loss_fake) * self.weight, {
            "real_scores": real_scores, "fake_scores": fake_scores}


class WassersteinGANGP:
    """WGAN with gradient penalty: the mean fake score less the mean real
    one, plus ``gp_weight`` x mean((|grad D(x~)| - gamma)^2) / gamma^2 at
    x~ = tau real + (1 - tau) fake, a tau ~ U[0, 1) a row."""

    def __init__(self, disc: Callable, weight: float = 1.0,
                 gp_weight: float = 1.0, gamma: float = 1.0):
        self.disc = disc
        self.weight = weight
        self.gp_weight = gp_weight
        self.gamma = gamma

    def generator_loss(self, fake: torch.Tensor) -> torch.Tensor:
        return -self.disc(fake).mean() * self.weight

    def gradient_penalty(self, fake: torch.Tensor, real: torch.Tensor,
                         tau: torch.Tensor) -> torch.Tensor:
        """The penalty at the interpolates of ``tau`` (B, 1, ...); its
        gradient to the discriminator's weights goes through the
        gradient (a second-order graph). The interpolates are a constant
        of the discriminator's update."""
        B = real.shape[0]
        x = (tau * real + (1.0 - tau) * fake).detach().requires_grad_()
        (grads,) = torch.autograd.grad(self.disc(x).sum(), x,
                                       create_graph=True)
        norms = torch.linalg.vector_norm(grads.reshape(B, -1), dim=1)
        return ((norms - self.gamma) ** 2).mean() / self.gamma ** 2

    def discriminator_loss(self, fake: torch.Tensor, real: torch.Tensor,
                           generator: Optional[torch.Generator] = None,
                           tau: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """``tau`` (B, 1, ...) as given, else drawn from ``generator`` (on
        the rows' device). Training must draw a new tau every step, so
        one of the two is required."""
        fake_scores, real_scores = _split_scores(self.disc, fake, real)
        loss_fake = fake_scores.mean()
        loss_real = real_scores.mean()
        if tau is None:
            if generator is None:
                raise ValueError("WassersteinGANGP.discriminator_loss "
                                 "needs a generator or tau")
            tau = torch.rand((real.shape[0],) + (1,) * (real.dim() - 1),
                             generator=generator, device=real.device,
                             dtype=fake.dtype)
        gp = self.gradient_penalty(fake, real, tau)
        return loss_fake - loss_real + self.gp_weight * gp, {
            "wasserstein_distance": loss_real - loss_fake, "gp": gp}


def build_adv_loss(disc: Callable, disc_cfg: Optional[Dict] = None):
    """'lsgan' (the default) or 'wgan-gp' (its ``wgan_gp`` section's
    ``gp_weight`` and ``gamma``), with the config's ``weight``."""
    cfg = dict(disc_cfg or {})
    adv_type = cfg.get("type", "lsgan")
    weight = float(cfg.get("weight", 1.0))
    if adv_type == "lsgan":
        return LSGANLoss(disc, weight=weight)
    if adv_type == "wgan-gp":
        wgan = dict(cfg.get("wgan_gp") or {})
        return WassersteinGANGP(disc, weight=weight,
                                gp_weight=float(wgan.get("gp_weight", 1.0)),
                                gamma=float(wgan.get("gamma", 1.0)))
    raise ValueError(f"Unknown adversarial loss: {adv_type}")
