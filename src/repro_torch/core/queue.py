"""The global two-level memory queue Q (Section III), as in the JAX
package's ``core/queue.py``.

A ring buffer over projected teacher features with, per entry, the label
(ground truth for supervised-phase entries, pseudo-label otherwise), a
confidence flag (always True for labeled entries) and a validity flag.
The ring pointer is a ``()`` int32 tensor on the queue's device, as JAX's
is, so the slot arithmetic stays on the device and a captured ``enqueue``
(``core/scan.py``) writes the next slots on every replay.  ``enqueue``
returns a new queue and leaves its input untouched, as the JAX version
does, so a caller may keep the old one."""
from __future__ import annotations

from typing import NamedTuple

import torch


class FeatureQueue(NamedTuple):
    z: torch.Tensor          # (Q, proj_dim) projected teacher features
    label: torch.Tensor      # (Q,) int32 labels / pseudo-labels
    conf: torch.Tensor       # (Q,) bool, confidence reached tau
    valid: torch.Tensor      # (Q,) bool, slot holds a real entry
    ptr: torch.Tensor        # () int32 ring pointer


def init_queue(queue_len: int, proj_dim: int,
               device: torch.device | str) -> FeatureQueue:
    return FeatureQueue(
        z=torch.zeros(queue_len, proj_dim, device=device),
        label=torch.zeros(queue_len, dtype=torch.int32, device=device),
        conf=torch.zeros(queue_len, dtype=torch.bool, device=device),
        valid=torch.zeros(queue_len, dtype=torch.bool, device=device),
        ptr=torch.zeros((), dtype=torch.int32, device=device),
    )


def enqueue(q: FeatureQueue, z: torch.Tensor, labels: torch.Tensor,
            conf: torch.Tensor | None = None) -> FeatureQueue:
    """Insert a batch at the ring pointer (wrap-around).

    Matches one-at-a-time insertion for any batch size: when ``B > Q`` only
    the trailing ``Q`` entries survive the wrap.  The leading ``B - Q``
    entries are dropped before the scatter, so every slot index is unique
    and the result is deterministic."""
    b = z.shape[0]
    qlen = q.z.shape[0]
    if conf is None:
        conf = torch.ones(b, dtype=torch.bool, device=z.device)
    offset = max(b - qlen, 0)
    if offset:
        z, labels, conf = z[offset:], labels[offset:], conf[offset:]
    slots = (q.ptr + offset + torch.arange(z.shape[0], device=z.device,
                                           dtype=torch.int32)) % qlen
    slots = slots.long()
    new = FeatureQueue(z=q.z.clone(), label=q.label.clone(),
                       conf=q.conf.clone(), valid=q.valid.clone(),
                       ptr=(q.ptr + b) % qlen)
    # device-side scatters only (no host scalar), so a CUDA graph can
    # capture them
    new.z.index_copy_(0, slots, z.detach().to(q.z.dtype))
    new.label.index_copy_(0, slots, labels.to(torch.int32))
    new.conf.index_copy_(0, slots, conf)
    new.valid.index_fill_(0, slots, True)
    return new
