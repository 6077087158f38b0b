"""Optimizer construction and the train step (port of
``shapy_tpu/train/step.py``) on ``torch.optim``.

``build_optimizer`` gives the JAX package's optax chains the torch
optimizers with the same update rules: Adam / SGD / RMSprop with coupled
weight decay (added to the gradient before the optimizer), AdamW with
decoupled decay (its default 1e-2 when unset), RMSprop's eps outside the
square root, parameters whose name contains 'bias' in a group of their
own (lr x ``bias_lr_factor``, ``weight_decay_bias``), and the multi-step,
step and exponential schedules as a ``LambdaLR`` that the step advances
after each update, so update k uses the rate optax gives count k.

The train step differentiates the losses of a train-mode forward; the
adversarial step then updates the discriminator too. BN
running stats are buffers, updated only by the forward's EMA (kernel K4
on the card); ``param_mean`` stays a buffer unless ``learn_mean`` is set.
The JAX package keeps ``param_mean`` among its params with a zeroed
gradient, so its coupled weight decay still moves it (ROADMAP fault F4);
the port does not copy that.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch
from torch import nn

from shapy_tpu_torch.utils.device import full_f32_matmul


def _schedule(optim_cfg: Dict) -> Callable[[int], float]:
    """Factor of the base lr at update count k, as the optax schedules
    of the JAX package."""
    sched = dict(optim_cfg.get("scheduler") or {})
    kind = sched.get("type", "none")
    if kind == "multi-step-lr":
        gamma = float(sched.get("gamma", 0.1))
        milestones = [int(m) for m in sched.get("milestones", [])]
        return lambda k: gamma ** sum(k >= m for m in milestones)
    if kind == "step-lr":
        step, gamma = int(sched.get("step_size", 1000)), float(
            sched.get("gamma", 0.1))
        return lambda k: gamma ** (k // step)
    if kind in ("exp", "exponential"):
        steps, gamma = int(sched.get("decay_steps", 1000)), float(
            sched.get("gamma", 0.99))
        return lambda k: gamma ** (k / steps)
    return lambda k: 1.0


def build_optimizer(named_params: Iterable[Tuple[str, nn.Parameter]],
                    optim_cfg: Optional[Dict] = None
                    ) -> Tuple[torch.optim.Optimizer,
                               torch.optim.lr_scheduler.LambdaLR]:
    """Adam / AdamW / SGD / RMSprop over ``named_params`` (trainable
    ones only) with the bias group, and its schedule."""
    cfg = dict(optim_cfg or {})
    lr = float(cfg.get("lr", 1e-4))
    weight_decay_cfg = cfg.get("weight_decay", None)
    weight_decay = float(weight_decay_cfg or 0.0)
    weight_decay_bias = float(cfg.get("weight_decay_bias", 0.0))
    bias_lr_factor = float(cfg.get("bias_lr_factor", 1.0))
    opt_type = cfg.get("type", "adam")

    if opt_type in ("adam", "adamw"):
        adam_cfg = dict(cfg.get("adam") or {})
        betas = tuple(float(b) for b in adam_cfg.get("betas", (0.9, 0.999)))
        kwargs = {"betas": betas, "eps": float(adam_cfg.get("eps", 1e-8))}
        if opt_type == "adamw":
            cls = torch.optim.AdamW
            if weight_decay_cfg is None:
                weight_decay = float(adam_cfg.get("weight_decay", 1e-2))
        else:
            cls = torch.optim.Adam
    elif opt_type == "sgd":
        sgd_cfg = dict(cfg.get("sgd") or {})
        cls = torch.optim.SGD
        kwargs = {"momentum": float(sgd_cfg.get("momentum", 0.9)),
                  "nesterov": bool(sgd_cfg.get("nesterov", False))}
    elif opt_type == "rmsprop":
        rms_cfg = dict(cfg.get("rmsprop") or {})
        cls = torch.optim.RMSprop  # eps outside the sqrt, as optax here
        kwargs = {"alpha": float(rms_cfg.get("alpha", 0.99)),
                  "eps": float(rms_cfg.get("eps", 1e-8)),
                  "momentum": float(rms_cfg.get("momentum", 0.0))}
    else:
        raise ValueError(f"Unknown optimizer type: {opt_type}")

    plain, bias = [], []
    for name, p in named_params:
        if p.requires_grad:
            (bias if "bias" in name else plain).append(p)
    groups = [g for g in (
        {"params": plain, "lr": lr, "weight_decay": weight_decay},
        {"params": bias, "lr": lr * bias_lr_factor,
         "weight_decay": weight_decay_bias}) if g["params"]]
    optimizer = cls(groups, **kwargs)
    scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer,
                                                  _schedule(cfg))
    return optimizer, scheduler


@dataclass
class TrainState:
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LambdaLR
    step: int = 0

    def state_dict(self) -> Dict:
        """The optimizer's and the schedule's state and the step, for a
        checkpoint (the parameters are the module's)."""
        return {"optimizer": self.optimizer.state_dict(),
                "scheduler": self.scheduler.state_dict(), "step": self.step}

    def load_state_dict(self, state: Dict) -> None:
        """Restore what :meth:`state_dict` saved, in place (the optimizer
        moves its moments to its parameters' device)."""
        self.optimizer.load_state_dict(state["optimizer"])
        self.scheduler.load_state_dict(state["scheduler"])
        self.step = int(state["step"])


def init_train_state(regressor: nn.Module, optim_cfg: Optional[Dict] = None,
                     learn_mean: bool = False) -> TrainState:
    """The optimizer over the regressor's trainable parameters. With
    ``learn_mean`` the ``param_mean`` buffer becomes a parameter first
    (the reference's ``learn_mean``)."""
    if learn_mean and "param_mean" in regressor._buffers:
        mean = regressor._buffers.pop("param_mean")
        regressor.param_mean = nn.Parameter(mean.clone())
    optimizer, scheduler = build_optimizer(regressor.named_parameters(),
                                           optim_cfg)
    return TrainState(optimizer, scheduler)


class TrainStep:
    """One update: ``forward`` (train-mode ``apply`` + losses),
    ``backward`` and ``update`` (optimizer and schedule), or all three by
    calling it. Returns the detached loss dict."""

    def __init__(self, regressor: nn.Module, losses: Callable,
                 state: TrainState):
        self.regressor = regressor
        self.losses = losses
        self.state = state

    def forward(self, images: torch.Tensor, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        out = self.regressor.apply(images, batch=batch, train=True,
                                   generator=generator)
        return self.losses(out, batch)

    def backward(self, loss_dict: Dict[str, torch.Tensor]) -> None:
        self.state.optimizer.zero_grad(set_to_none=True)
        with full_f32_matmul():
            loss_dict["total"].backward()

    def update(self) -> None:
        self.state.optimizer.step()
        self.state.scheduler.step()
        self.state.step += 1

    def __call__(self, images, batch, generator=None
                 ) -> Dict[str, torch.Tensor]:
        loss_dict = self.forward(images, batch, generator)
        self.backward(loss_dict)
        self.update()
        return {k: v.detach() for k, v in loss_dict.items()}


def make_train_step(regressor: nn.Module, losses: Callable,
                    state: TrainState) -> TrainStep:
    """``step(images, batch, generator) -> loss dict``; the regressor
    must be in train mode (``prepare_for_train_``)."""
    return TrainStep(regressor, losses, state)


class AdversarialTrainStep(TrainStep):
    """The regressor's update, then the discriminator's, in one call (the
    JAX ``make_adversarial_train_step``):

    1. the regressor: its losses plus ``adv_loss.generator_loss`` of the
       last stage's ``pose_key`` rotations, taken against the
       discriminator's weights before its update (the discriminator takes
       no gradient from it);
    2. the discriminator: ``adv_loss.discriminator_loss`` of those
       rotations, detached, against ``batch['real_body_pose']``, the
       WGAN-GP's tau drawn from ``gp_generator``; then every spectral-norm
       ``u`` moves one power-iteration step at the new weights.

    ``disc_state`` is the discriminator's optimizer, schedule and step.
    Returns the detached loss dict with ``adv_gen``, ``adv_disc`` and the
    adversarial loss's scalar extras (``adv_gp`` ...)."""

    def __init__(self, regressor: nn.Module, losses: Callable,
                 state: TrainState, disc: nn.Module, adv_loss,
                 disc_state: TrainState, pose_key: str = "body_pose"):
        super().__init__(regressor, losses, state)
        self.disc = disc
        self.adv_loss = adv_loss
        self.disc_state = disc_state
        self.pose_key = pose_key

    def forward(self, images, batch, generator=None):
        out = self.regressor.apply(images, batch=batch, train=True,
                                   generator=generator)
        loss_dict = self.losses(out, batch)
        fake = out[f"stage_{self.regressor.num_stages - 1:02d}"][
            self.pose_key]
        self.disc.requires_grad_(False)
        try:
            with full_f32_matmul():
                g_adv = self.adv_loss.generator_loss(fake)
        finally:
            self.disc.requires_grad_(True)
        total = loss_dict["total"] + g_adv
        self.fake = fake.detach()
        return dict(loss_dict, adv_gen=g_adv, total=total)

    def __call__(self, images, batch, generator=None, gp_generator=None
                 ) -> Dict[str, torch.Tensor]:
        metrics = super().__call__(images, batch, generator)
        fake, self.fake = self.fake, None
        opt, sched = self.disc_state.optimizer, self.disc_state.scheduler
        with full_f32_matmul():
            d_loss, aux = self.adv_loss.discriminator_loss(
                fake, batch["real_body_pose"], generator=gp_generator)
            opt.zero_grad(set_to_none=True)
            d_loss.backward()
        opt.step()
        sched.step()
        self.disc_state.step += 1
        with full_f32_matmul():
            self.disc.refresh_u_()
        metrics["adv_disc"] = d_loss.detach()
        for k, v in aux.items():
            if v.dim() == 0:
                metrics[f"adv_{k}"] = v.detach()
        return metrics


def make_adversarial_train_step(regressor: nn.Module, losses: Callable,
                                state: TrainState, disc: nn.Module,
                                adv_loss, disc_state: TrainState,
                                pose_key: str = "body_pose"
                                ) -> AdversarialTrainStep:
    """``step(images, batch, generator, gp_generator) -> loss dict``; the
    batch must hold ``real_body_pose``."""
    return AdversarialTrainStep(regressor, losses, state, disc, adv_loss,
                                disc_state, pose_key)
