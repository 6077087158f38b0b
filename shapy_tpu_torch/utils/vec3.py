"""Dot and cross products of 3-vectors in one fixed order.

The plain versions of K6 (``ops/tri_tri.py``), K7 (``ops/repulsion.py``)
and K9 (``eval/metrics.py``) take every decision that their kernels take:
a sign, an overlap, a box test, a nearest neighbour. So each 3-term dot
product is summed x, then y, then z, one product at a time, as the
kernels (built with ``--fmad=false``) sum it; ``torch.einsum`` or a
matmul would round it in another order, or with FMAs.
"""

from __future__ import annotations

import torch


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a . b over the last axis of size 3, summed x, then y, then z."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def cross3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a x b over the last axis, one component at a time."""
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]],
                       dim=-1)
