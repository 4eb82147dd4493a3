"""Batching (numpy): the labeled server loader and the per-client
unlabeled loaders, a copy of the JAX package's ``data/pipeline.py``
(``Loader``, ``client_loaders``, ``stack_client_batches_many``) without its
sharded device placement.  The same seeds draw the same sample streams.

Loaders are restartable iterators: :meth:`Loader.state_dict` /
:meth:`Loader.load_state_dict` / :meth:`Loader.clone` capture and restore
the whole sampling state (RNG, permutation, cursor), which the round
prefetcher (``data/prefetch.py``) rolls back to when a speculative draw
is not the one the round asks for."""
from __future__ import annotations

import copy

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

    def state_dict(self) -> dict:
        """The whole sampling state; restoring it replays the stream."""
        return {"rng": self.rng.get_state(), "order": self._order.copy(),
                "cursor": self._cursor}

    def load_state_dict(self, sd: dict) -> None:
        self.rng.set_state(sd["rng"])
        self._order = sd["order"].copy()
        self._cursor = sd["cursor"]

    def clone(self) -> "Loader":
        """An independent loader going on with this one's stream (the
        dataset arrays shared, the sampling state copied)."""
        other = copy.copy(self)
        other.rng = np.random.RandomState()
        other.load_state_dict(self.state_dict())
        return other

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

    def next_many(self, k: int) -> tuple[np.ndarray, np.ndarray]:
        """``k`` batches as ``(K, B, ...)`` stacks, drawn as ``k``
        successive :meth:`next` calls draw them."""
        xs, ys = zip(*(self.next() for _ in range(k)))
        return np.stack(xs), np.stack(ys)


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
