"""SGD with momentum, the paper's optimizer (the JAX package's
``optim/optimizers.py::sgd``), on parameter trees.

``init(params)`` gives the momentum buffers; ``update(grads, mu, lr)``
gives the new parameters' updates and buffers:
    mu <- momentum * mu + g;   update = -lr * mu
and :func:`apply_updates` adds them in fp32."""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.tree import tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., tuple[Any, Any]]


def sgd(momentum: float = 0.9) -> Optimizer:
    def init(params):
        return tree_map(torch.zeros_like, params)

    def update(grads, mu, params, lr):
        mu = tree_map(lambda m, g: momentum * m + g, mu, grads)
        return tree_map(lambda u: -lr * u, mu), mu

    return Optimizer(init, update)


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p.float() + u.float()).to(p.dtype),
                    params, updates)
