"""Per-sample augmentation RNG, fresh across epochs (a copy of
``shapy_tpu/data/rng.py``).

``augment_rng`` mixes the sample index with a process-wide access counter
(thread-safe: loader workers share dataset objects), so repeat accesses to
the same index draw anew while a fixed seed keeps runs reproducible for a
deterministic access order. Eval accesses (``is_train=False``) stay
index-seeded, so evaluation is reproducible per image.
"""

from __future__ import annotations

import itertools
import threading

import numpy as np

_counter = itertools.count()
_lock = threading.Lock()
_base_seed = 0


def set_augment_seed(seed: int) -> None:
    """Reset the process-wide augmentation seed (and the access counter)."""
    global _base_seed, _counter
    with _lock:
        _base_seed = int(seed)
        _counter = itertools.count()


def augment_rng(index: int, is_train: bool = True) -> np.random.Generator:
    if not is_train:
        return np.random.default_rng(index)
    with _lock:
        c = next(_counter)
    return np.random.default_rng((_base_seed, int(index), c))
