"""Per-sample augmentation RNG, fresh across epochs (a copy of
``shapy_tpu/data/rng.py``, with draw keys).

``augment_rng`` mixes the sample index with a process-wide access counter
(thread-safe: loader workers share dataset objects), so repeat accesses to
the same index draw anew while a fixed seed keeps runs reproducible for a
deterministic access order. Eval accesses (``is_train=False``) stay
index-seeded, so evaluation is reproducible per image.

One addition: inside :func:`draw_key` a thread's draws are seeded by the
key (the data loader gives each fetch its epoch, batch and slot) in place
of the counter. The counter's order is the order in which the loader's
worker threads happen to fetch, and it runs on across runs in one
process; a keyed draw is the same in every run, so a resumed training
run augments as the uninterrupted one did.
"""

from __future__ import annotations

import contextlib
import itertools
import threading

import numpy as np

_counter = itertools.count()
_lock = threading.Lock()
_base_seed = 0
_local = threading.local()


def set_augment_seed(seed: int) -> None:
    """Reset the process-wide augmentation seed (and the access counter)."""
    global _base_seed, _counter
    with _lock:
        _base_seed = int(seed)
        _counter = itertools.count()


@contextlib.contextmanager
def draw_key(*key: int):
    """Within the block, this thread's training draws are seeded by
    (seed, index, *key) instead of the access counter."""
    saved = getattr(_local, "key", None)
    _local.key = tuple(int(k) for k in key)
    try:
        yield
    finally:
        _local.key = saved


def augment_rng(index: int, is_train: bool = True) -> np.random.Generator:
    if not is_train:
        return np.random.default_rng(index)
    key = getattr(_local, "key", None)
    if key is not None:
        return np.random.default_rng((_base_seed, int(index), *key))
    with _lock:
        c = next(_counter)
    return np.random.default_rng((_base_seed, int(index), c))
