"""Batch samplers for the mixed-dataset streams (a numpy copy of
``shapy_tpu/data/samplers.py``): ``EqualSampler`` forms batches round-robin
across datasets with a cap on the fraction of 2D-only items,
``ShapeSampler`` importance-samples by a weight / BMI histogram with
optional gender balancing, ``ShardedSampler`` keeps one process's strided
slice of each global batch. All work over a ConcatDataset-style global
index. ``shard_sampler_by_process`` reads ``torch.distributed`` where a
process group is initialised (the JAX package reads jax's process count).
"""

from __future__ import annotations

from itertools import cycle
from typing import List, Sequence

import numpy as np


def weights_to_probabilities(values: np.ndarray, num_bins: int = 10
                             ) -> np.ndarray:
    """Inverse-frequency importance weights over a histogram of values
    (rare weights/BMIs get sampled more). NaNs get mean probability."""
    values = np.asarray(values, np.float64)
    valid = np.isfinite(values)
    probs = np.full(values.shape, 1.0 / max(len(values), 1))
    if valid.sum() > 1:
        hist, edges = np.histogram(values[valid], bins=num_bins)
        bin_idx = np.clip(
            np.searchsorted(edges, values[valid], side="right") - 1,
            0, num_bins - 1,
        )
        inv = 1.0 / np.maximum(hist[bin_idx], 1)
        probs[valid] = inv
        # NaN rows get the MEAN of the valid inverse weights — the same
        # scale; the former raw 1/N would under- or over-sample
        # unannotated rows depending on dataset size.
        probs[~valid] = inv.mean()
    probs /= probs.sum()
    return probs


class EqualSampler:
    """Round-robin across datasets with a 2D-only ratio cap."""

    def __init__(self, datasets: Sequence, batch_size: int = 1,
                 ratio_2d: float = 0.5, shuffle: bool = False,
                 seed: int = 0):
        self.datasets = list(datasets)
        self.batch_size = batch_size
        self.ratio_2d = ratio_2d
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)

        self.offsets = []
        self.sizes = []
        self.only_2d = []
        start = 0
        for d in self.datasets:
            self.offsets.append(start)
            self.sizes.append(len(d))
            self.only_2d.append(bool(d.only_2d()))
            start += len(d)
        self.length = start
        if ratio_2d < 1.0 and all(self.only_2d):
            raise ValueError(
                f"Invalid 2D ratio {ratio_2d} with only-2D data"
            )

    def __len__(self) -> int:
        return int(round(self.length / self.batch_size))

    def __iter__(self):
        iters = []
        for i, size in enumerate(self.sizes):
            order = (
                self.rng.permutation(size) if self.shuffle
                else np.arange(size)
            )
            iters.append(cycle(order.tolist()))

        max_2d = int(self.batch_size * self.ratio_2d)
        for _ in range(len(self)):
            idxs: List[int] = []
            n_2d = 0
            while len(idxs) < self.batch_size:
                for i, it in enumerate(iters):
                    if self.only_2d[i] and n_2d >= max_2d:
                        continue
                    idxs.append(next(it) + self.offsets[i])
                    n_2d += int(self.only_2d[i])
                    if len(idxs) >= self.batch_size:
                        break
            idxs = np.asarray(idxs)
            if self.shuffle:
                self.rng.shuffle(idxs)
            yield idxs


def _dataset_values(d, key: str) -> np.ndarray:
    """Per-item importance values ('weight' kg / 'bmi') without decoding
    any images: a dataset-level array attribute if present, else the
    per-item metadata dicts (ModelAgencyDataset.items). Missing values
    become NaN (mean-probability rows in the histogram weighting)."""
    attr = getattr(d, key, None)
    if attr is not None and not callable(attr):
        return np.asarray(attr, np.float64)
    items = getattr(d, "items", None)
    if items is not None:
        def one(it):
            if key == "bmi":
                w, h = it.get("weight"), it.get("height")
                return (float(w) / float(h) ** 2
                        if w is not None and h not in (None, 0) else np.nan)
            v = it.get(key)
            return float(v) if v is not None else np.nan
        return np.asarray([one(it) for it in items], np.float64)
    return np.full(len(d), np.nan)


def _dataset_genders(d) -> np.ndarray:
    for attr in ("gender", "genders"):
        v = getattr(d, attr, None)
        if v is not None and not callable(v):
            return np.asarray(v)
    items = getattr(d, "items", None)
    if items is not None:
        return np.asarray(
            [str(it.get("gender") or "neutral") for it in items])
    return np.asarray(["neutral"] * len(d))


class ShapeSampler:
    """Importance sampling by weight/BMI histogram + gender balancing."""

    def __init__(self, datasets: Sequence, batch_size: int = 1,
                 importance_key: str = "weight", shuffle: bool = False,
                 balance_genders: bool = True, seed: int = 0):
        assert importance_key in ("bmi", "weight")
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.balance_genders = balance_genders
        self.rng = np.random.default_rng(seed)

        all_probs = []
        all_genders = []
        start = 0
        self.length = 0
        for d in datasets:
            values = _dataset_values(d, importance_key)
            all_probs.append(weights_to_probabilities(values))
            all_genders.append(_dataset_genders(d).astype(str))
            start += len(d)
            self.length += len(d)
        # Normalise across datasets proportionally to their size
        sizes = np.asarray([len(p) for p in all_probs], np.float64)
        weights = sizes / sizes.sum()
        self.probs = np.concatenate(
            [p * w for p, w in zip(all_probs, weights)]
        )
        self.probs /= self.probs.sum()
        self.genders = np.concatenate(all_genders)
        self.gender_labels = np.unique(self.genders)

    def __len__(self) -> int:
        return int(round(self.length / self.batch_size))

    def __iter__(self):
        for _ in range(len(self)):
            if self.balance_genders and len(self.gender_labels) > 1:
                per = self.batch_size // len(self.gender_labels)
                idxs = []
                for g in self.gender_labels:
                    mask = self.genders == g
                    p = self.probs[mask]
                    p = p / p.sum()
                    pool = np.nonzero(mask)[0]
                    idxs.append(
                        self.rng.choice(pool, size=per, replace=True, p=p)
                    )
                extra = self.batch_size - per * len(self.gender_labels)
                if extra:
                    idxs.append(
                        self.rng.choice(len(self.probs), size=extra,
                                        p=self.probs)
                    )
                idxs = np.concatenate(idxs)
            else:
                idxs = self.rng.choice(
                    len(self.probs), size=self.batch_size, p=self.probs
                )
            if self.shuffle:
                self.rng.shuffle(idxs)
            yield idxs


class ShardedSampler:
    """Per-process shard of a global batch sampler (multi-host input).

    Every process iterates the SAME global batch stream (same seed) and
    keeps the ``shard_id``-th strided slice of each batch, so together
    the processes cover each global batch exactly once — the host-sharded
    replacement for the reference's single-process loaders (SURVEY §2.8:
    per-host EqualSampler logic). Local batch = batch_size / num_shards.
    """

    def __init__(self, sampler, num_shards: int = 1, shard_id: int = 0):
        assert 0 <= shard_id < num_shards
        self.sampler = sampler
        self.num_shards = int(num_shards)
        self.shard_id = int(shard_id)

    def __len__(self) -> int:
        return len(self.sampler)

    def __iter__(self):
        for idxs in self.sampler:
            idxs = np.asarray(idxs)
            if len(idxs) % self.num_shards != 0:
                # Unequal local batches would give the processes
                # inconsistent array shapes and hang or fail a collective —
                # fail loudly at the source instead.
                raise ValueError(
                    f"global batch size {len(idxs)} is not divisible by "
                    f"num_shards={self.num_shards}; every process must "
                    "get an equal local batch"
                )
            yield idxs[self.shard_id::self.num_shards]


def shard_sampler_by_process(sampler):
    """Wrap with the ``torch.distributed`` process group's world size and
    rank; a no-op where no group is initialised or it has one process."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return sampler
    n = dist.get_world_size()
    if n <= 1:
        return sampler
    return ShardedSampler(sampler, num_shards=n, shard_id=dist.get_rank())
