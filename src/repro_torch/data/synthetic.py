"""The synthetic image classification task (numpy), a copy of the JAX
package's ``data/synthetic.py``: class-conditional low-frequency prototype
patterns with random shifts, noise and brightness.  The same seed gives the
same arrays as the JAX package's version."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Dataset(NamedTuple):
    x: np.ndarray       # images (N, H, W, 3) float32
    y: np.ndarray       # labels (N,) int32


def _upsample(img: np.ndarray, factor: int) -> np.ndarray:
    """Nearest+linear-ish upsample of (h, w, c) by integer factor."""
    img = np.repeat(np.repeat(img, factor, axis=0), factor, axis=1)
    k = factor
    pad = np.pad(img, ((k, k), (k, k), (0, 0)), mode="edge")
    out = (pad[:-2 * k] + pad[2 * k:] + pad[k:-k]) / 3.0
    out = (out[:, :-2 * k] + out[:, 2 * k:] + out[:, k:-k]) / 3.0
    return out


def make_image_dataset(seed: int, *, num_classes: int = 10, n: int = 4096,
                       image_size: int = 32, noise: float = 0.35,
                       class_probs: np.ndarray | None = None) -> Dataset:
    rng = np.random.RandomState(seed)
    base = image_size // 4
    protos = rng.randn(num_classes, base, base, 3).astype(np.float32)
    protos = np.stack([_upsample(p, 4) for p in protos])
    protos = (protos - protos.min()) / (np.ptp(protos) + 1e-6)

    if class_probs is None:
        y = rng.randint(0, num_classes, size=n)
    else:
        y = rng.choice(num_classes, size=n, p=class_probs)
    xs = protos[y].copy()
    for i in range(n):
        dx, dy = rng.randint(-3, 4, size=2)
        xs[i] = np.roll(np.roll(xs[i], dx, axis=0), dy, axis=1)
    xs += noise * rng.randn(*xs.shape).astype(np.float32)
    xs += rng.uniform(-0.15, 0.15, size=(n, 1, 1, 1)).astype(np.float32)
    xs = np.clip(xs, 0.0, 1.0)
    return Dataset(x=xs.astype(np.float32), y=y.astype(np.int32))


def train_test_split(ds: Dataset, n_test: int, seed: int = 0):
    rng = np.random.RandomState(seed)
    idx = rng.permutation(len(ds.y))
    test, train = idx[:n_test], idx[n_test:]
    return Dataset(ds.x[train], ds.y[train]), Dataset(ds.x[test], ds.y[test])
