"""Numpy checkpoints (the JAX package's ``checkpoint/io.py``): a tree goes
to an ``.npz`` keyed by tree path (``bottom/convs/0/w``), with a JSON
sidecar for what the run keeps beside it (history, arch, baseline).

The arrays are written in the JAX package's layout (``convert.py``: conv
weights HWIO, client stacks N,HWIO), so that a checkpoint written by
either package loads in the other.  Restoring needs a template tree of
the port's with the same structure."""
from __future__ import annotations

import json
import os
from typing import Any, Iterator

import numpy as np

from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.tree import tree_unflatten


def _flatten(tree: Any, prefix: str = "") -> Iterator[tuple[str, Any]]:
    """(tree path, leaf) pairs; dict keys and list indices join with /."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        yield prefix, tree
        return
    for k, sub in items:
        yield from _flatten(sub, f"{prefix}/{k}" if prefix else str(k))


def save_pytree(path: str, tree: Any) -> None:
    arrays = dict(_flatten(params_to_numpy(tree)))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **arrays)


def load_pytree(path: str, template: Any) -> Any:
    """The tree at ``path`` in the port's layout, each leaf at its template
    leaf's dtype and device."""
    leaves = []
    with np.load(path) as data:
        for key, tmpl in _flatten(template):
            if key not in data:
                raise KeyError(f"checkpoint missing {key!r}")
            leaf = params_from_numpy(data[key], tmpl.device)
            if leaf.shape != tmpl.shape:
                raise ValueError(f"{key}: shape {tuple(leaf.shape)} != "
                                 f"{tuple(tmpl.shape)}")
            leaves.append(leaf.to(tmpl.dtype))
    return tree_unflatten(template, leaves)


def save_state(path: str, tree: Any, meta: dict) -> None:
    save_pytree(path + ".npz", tree)
    with open(path + ".json", "w") as f:
        json.dump(meta, f, indent=2)


def restore_state(path: str, template: Any) -> tuple[Any, dict]:
    tree = load_pytree(path + ".npz", template)
    with open(path + ".json") as f:
        meta = json.load(f)
    return tree, meta
