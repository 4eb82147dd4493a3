"""Client data partitioning (numpy), a copy of the JAX package's
``data/partition.py``: uniform (IID) and Dirichlet(alpha) non-IID."""
from __future__ import annotations

import numpy as np


def uniform_partition(seed: int, n: int, n_clients: int) -> list[np.ndarray]:
    rng = np.random.RandomState(seed)
    idx = rng.permutation(n)
    return [np.sort(s) for s in np.array_split(idx, n_clients)]


def dirichlet_partition(seed: int, labels: np.ndarray, n_clients: int,
                        alpha: float, min_per_client: int = 2
                        ) -> list[np.ndarray]:
    """Per-class Dirichlet allocation across clients."""
    rng = np.random.RandomState(seed)
    n_classes = int(labels.max()) + 1
    shares = [[] for _ in range(n_clients)]
    for c in range(n_classes):
        idx = np.where(labels == c)[0]
        rng.shuffle(idx)
        p = rng.dirichlet(np.full(n_clients, alpha))
        cuts = (np.cumsum(p) * len(idx)).astype(int)[:-1]
        for i, part in enumerate(np.split(idx, cuts)):
            shares[i].append(part)
    out = []
    for i in range(n_clients):
        s = np.concatenate(shares[i]) if shares[i] else np.empty(0, int)
        out.append(s)
    # guarantee a minimum per client (steal from the largest)
    for i in range(n_clients):
        while len(out[i]) < min_per_client:
            j = int(np.argmax([len(o) for o in out]))
            out[i] = np.append(out[i], out[j][-1])
            out[j] = out[j][:-1]
    return [np.sort(o) for o in out]
