"""Fit body shape to target measurements (port of
``shapy_tpu/measure/fit_measurements.py``).

Adam on the betas, so that the virtual measurements (height, chest,
waist, hips, optionally mass) match given targets. Every step runs the
body model's shape blend, the measurements on all faces (kernel K1, or
K1-exact in "exact" slice mode, on the card) and their backward kernels.
``torch.optim.Adam`` has optax's defaults (b1 0.9, b2 0.999, eps 1e-8)
and the same update.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch


def fit_betas_to_measurements(
    body_model,
    measurements_module,
    targets: Dict[str, float],
    init_betas: Optional[torch.Tensor] = None,
    weights: Optional[Dict[str, float]] = None,
    num_steps: int = 200,
    learning_rate: float = 0.05,
    shape_prior_weight: float = 1e-3,
    batch_size: int = 1,
) -> Dict[str, object]:
    """Returns {'betas' (B, num_betas), 'measurements' {name: (B,)}, on the
    body model's device, and 'losses' (num_steps,) numpy}.

    The loss is ``shape_prior_weight * sum(betas^2) / batch_size + sum_k
    w_k * mean((m_k - t_k)^2)``. The losses stay on the device until the
    end: no step waits for the host."""
    dev = body_model.v_template.device
    if init_betas is None:
        init_betas = torch.zeros((batch_size, body_model.num_betas))
    betas = torch.as_tensor(init_betas, dtype=torch.float32).to(
        dev, copy=True).requires_grad_()
    if weights is None:
        weights = {k: 1.0 for k in targets}
    target = {k: torch.full((batch_size,), float(v), device=dev)
              for k, v in targets.items()}

    def measure(b: torch.Tensor) -> Dict[str, torch.Tensor]:
        v_shaped = body_model.forward_shape(b)["v_shaped"]
        meas = measurements_module.forward_from_vertices(
            v_shaped, use_face_subsets=False)["measurements"]
        return {k: v["tensor"] for k, v in meas.items()}

    opt = torch.optim.Adam([betas], lr=learning_rate)
    losses = []
    for _ in range(num_steps):
        meas = measure(betas)
        loss = shape_prior_weight * torch.sum(betas ** 2) / batch_size
        for k, t in target.items():
            loss = loss + weights.get(k, 1.0) * torch.mean((meas[k] - t) ** 2)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    with torch.no_grad():
        final = measure(betas)
    return {
        "betas": betas.detach(),
        "measurements": final,
        "losses": (torch.stack(losses).cpu().numpy() if losses
                   else np.zeros(0, np.float32)),
    }
