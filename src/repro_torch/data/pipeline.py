"""Batching (numpy): the labeled server loader and the per-client
unlabeled loaders, a copy of the JAX package's ``data/pipeline.py``
(``Loader``, ``client_loaders``, ``stack_client_batches_many``) without its
sharded device placement and the prefetcher's restartable-iterator hooks.
The same seeds draw the same sample streams."""
from __future__ import annotations

import numpy as np

from repro_torch.data.synthetic import Dataset


class Loader:
    """Infinite shuffled batch sampler over a (subset of a) dataset.

    Samples are drawn from a seeded permutation of the index set; a batch
    that reaches the end of the permutation finishes the epoch and goes on
    into a fresh permutation, so every loader wraps at exactly
    ``len(self)`` draws."""

    def __init__(self, ds: Dataset, indices: np.ndarray | None, batch: int,
                 seed: int):
        self.ds = ds
        self.idx = (np.arange(len(ds.y)) if indices is None
                    else np.asarray(indices))
        if len(self.idx) == 0:
            raise ValueError("Loader needs a non-empty index set")
        self.batch = batch
        self.rng = np.random.RandomState(seed)
        self._order = self.rng.permutation(self.idx)
        self._cursor = 0

    def __len__(self):
        return len(self.idx)

    def _take(self, n: int) -> np.ndarray:
        take = np.empty(n, dtype=self.idx.dtype)
        filled = 0
        while filled < n:
            avail = len(self._order) - self._cursor
            if avail == 0:
                self._order = self.rng.permutation(self.idx)
                self._cursor = 0
                avail = len(self._order)
            m = min(n - filled, avail)
            take[filled: filled + m] = \
                self._order[self._cursor: self._cursor + m]
            self._cursor += m
            filled += m
        return take

    def next(self) -> tuple[np.ndarray, np.ndarray]:
        take = self._take(self.batch)
        return self.ds.x[take], self.ds.y[take]


def client_loaders(ds: Dataset, parts: list[np.ndarray], batch: int,
                   seed: int) -> list[Loader]:
    """One loader per client partition, client ``i`` seeded ``seed+31i``."""
    return [Loader(ds, parts[i], batch, seed + 31 * i)
            for i in range(len(parts))]


def stack_client_batches(loaders: list[Loader], active: list[int]):
    """One batch per active client -> stacked (N, B, ...) arrays."""
    xs, ys = zip(*(loaders[i].next() for i in active))
    return np.stack(xs), np.stack(ys)


def stack_client_batches_many(loaders: list[Loader], active: list[int],
                              k: int) -> tuple[np.ndarray, np.ndarray]:
    """``k`` iterations of client batches -> ``(K, N, B, ...)`` stacks, in
    the iteration-major draw order of ``k`` successive
    :func:`stack_client_batches` calls."""
    xs, ys = zip(*(stack_client_batches(loaders, active) for _ in range(k)))
    return np.stack(xs), np.stack(ys)
