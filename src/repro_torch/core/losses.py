"""SemiSFL loss functions (the JAX package's ``core/losses.py``).

  * Eq. (1): consistency regularization, CE of student predictions on
    strongly augmented inputs against teacher pseudo-labels, masked by the
    confidence threshold tau.
  * Eq. (3): supervised-contrastive loss over projected features,
    references = current batch + memory queue.
  * Eq. (5): clustering regularization, projected student features pulled
    toward same-pseudo-label teacher clusters in the queue.

All losses mean-reduce over the samples that take part; anchors with an
empty positive set contribute zero."""
from __future__ import annotations

import torch

# Eq. (5) in its (B, |Q|) form is the clustering kernel's plain version: one
# implementation serves both names
from repro_torch.kernels.ref import clustering_loss_ref as clustering_loss
from repro_torch.kernels.ref import masked_contrastive as _masked_contrastive


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean CE over (optionally masked) samples. logits (..., M)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, labels[..., None].long())[..., 0]
    if mask is None:
        return -ll.mean()
    mask = mask.float()
    return -(ll * mask).sum() / mask.sum().clamp(min=1.0)


def cross_entropy_sum(logits: torch.Tensor, labels: torch.Tensor,
                      mask: torch.Tensor | None = None):
    """Sum form of :func:`cross_entropy`: ``(nll_sum, count)``."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, labels[..., None].long())[..., 0]
    if mask is None:
        # a fill on the device, not a host copy, so that a CUDA graph can
        # capture it
        return -ll.sum(), torch.full((), float(ll.numel()),
                                     dtype=torch.float32, device=ll.device)
    mask = mask.float()
    return -(ll * mask).sum(), mask.sum()


def clustering_anchor_count(pseudo: torch.Tensor, anchor_ok: torch.Tensor,
                            queue_labels: torch.Tensor,
                            queue_conf: torch.Tensor,
                            queue_valid: torch.Tensor) -> torch.Tensor:
    """Number of anchors with a non-empty positive set: the denominator of
    Eq. (5)."""
    pos = (pseudo[:, None] == queue_labels[None, :]) \
        & (queue_conf & queue_valid)[None, :]
    pos = pos & anchor_ok[:, None]
    return pos.any(dim=-1).sum()


def pseudo_labels(teacher_logits: torch.Tensor, tau: float):
    """Eq. (1) machinery: argmax labels, confidence mask, confidence."""
    probs = torch.softmax(teacher_logits.float(), dim=-1)
    conf, labels = probs.max(dim=-1)
    return labels, conf > tau, conf


def supervised_contrastive_loss(z: torch.Tensor, labels: torch.Tensor,
                                queue_z: torch.Tensor,
                                queue_labels: torch.Tensor,
                                queue_valid: torch.Tensor,
                                temperature: float) -> torch.Tensor:
    """Eq. (3): references = (batch minus self) + labeled queue entries."""
    b = z.shape[0]
    ref = torch.cat([z, queue_z], dim=0)
    ref_labels = torch.cat([labels.to(queue_labels.dtype), queue_labels])
    ones = torch.ones(b, dtype=torch.bool, device=z.device)
    ref_valid = torch.cat([ones, queue_valid])
    pos = labels[:, None] == ref_labels[None, :]
    not_self = ~torch.eye(b, ref.shape[0], dtype=torch.bool, device=z.device)
    return _masked_contrastive(z, ref, pos & not_self, ref_valid, temperature)
