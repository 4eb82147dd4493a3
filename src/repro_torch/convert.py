"""Carry weights and state between the JAX package and this port.

Both sides use the same tree structure (``{"bottom", "top", "proj"}``, conv
layers as lists of ``{"w", "b"}``).  Only the conv weights change layout:
JAX's HWIO against PyTorch's OIHW, with a leading client axis on stacked
client bottoms.  Dense weights are (d_in, d_out) on both sides.

The functions take and give numpy arrays, not JAX arrays, so the port
stays free of JAX: a caller holding JAX arrays passes
``jax.device_get(tree)``."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engine import SemiSFLState
from repro_torch.core.queue import FeatureQueue
from repro_torch.tree import tree_map

# conv weight rank -> axis order, JAX layout to port layout
_TO_PORT = {4: (3, 2, 0, 1),            # HWIO -> OIHW
            5: (0, 4, 3, 1, 2)}         # N,HWIO -> N,OIHW (client stacks)
_TO_JAX = {4: (2, 3, 1, 0), 5: (0, 3, 4, 2, 1)}


def params_from_numpy(tree, device: str | torch.device = "cpu"):
    """A parameter (or momentum-buffer) tree of numpy arrays in the JAX
    package's layout -> the port's tree of tensors on ``device``."""
    def one(a):
        a = np.asarray(a)
        if a.ndim in _TO_PORT:
            a = np.transpose(a, _TO_PORT[a.ndim])
        return torch.from_numpy(np.array(a, copy=True)).to(device)
    return tree_map(one, tree)


def params_to_numpy(tree):
    """The port's tree of tensors -> numpy arrays in the JAX layout."""
    def one(t):
        a = t.detach().cpu().numpy()
        if a.ndim in _TO_JAX:
            a = np.ascontiguousarray(np.transpose(a, _TO_JAX[a.ndim]))
        return a
    return tree_map(one, tree)


def queue_from_numpy(z, label, conf, valid, ptr,
                     device: str | torch.device = "cpu") -> FeatureQueue:
    t = lambda a: torch.from_numpy(np.array(a, copy=True)).to(device)
    return FeatureQueue(z=t(np.asarray(z, np.float32)),
                        label=t(np.asarray(label, np.int32)),
                        conf=t(np.asarray(conf, bool)),
                        valid=t(np.asarray(valid, bool)), ptr=int(ptr))


def queue_to_numpy(q: FeatureQueue) -> dict:
    return {"z": q.z.cpu().numpy(), "label": q.label.cpu().numpy(),
            "conf": q.conf.cpu().numpy(), "valid": q.valid.cpu().numpy(),
            "ptr": int(q.ptr)}


def state_from_numpy(params, teacher, momentum, queue: dict, round_: int,
                     step: int, device: str | torch.device = "cpu"
                     ) -> SemiSFLState:
    """A :class:`SemiSFLState` from the JAX state's pieces as numpy:
    params, teacher, the SGD momentum buffers (``opt.mu``) and the queue's
    fields."""
    return SemiSFLState(
        params=params_from_numpy(params, device),
        teacher=params_from_numpy(teacher, device),
        opt=params_from_numpy(momentum, device),
        queue=queue_from_numpy(device=device, **queue),
        round=int(round_), step=int(step))
