"""Nested dict/list parameter trees: the port's counterpart of ``jax.tree``.

Parameters are plain nested dicts and lists of tensors with the JAX
package's structure (``{"bottom": {"convs": [{"w", "b"}, ...]}, ...}``), so
a tree maps one to one onto its JAX counterpart."""
from __future__ import annotations

from typing import Any, Callable

import torch


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leafwise over trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        items = [tree_map(fn, t, *(r[i] for r in rest))
                 for i, t in enumerate(tree)]
        return (type(tree)(*items) if hasattr(tree, "_fields")
                else type(tree)(items))
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    """Leaves in a fixed order (dict insertion order, list order)."""
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def tree_unflatten(tree: Any, leaves: list) -> Any:
    """A tree of ``tree``'s structure holding ``leaves`` in leaf order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def tree_stack(trees: list) -> Any:
    """Trees of one structure -> one tree of their leaves stacked on a new
    leading axis (None leaves stay None)."""
    return tree_map(lambda *ts: None if ts[0] is None else torch.stack(ts),
                    *trees)
