"""Split-model utilities (the JAX package's ``core/split.py``): the
projection head w_p (Section III, Table V), the pooling that turns
split-layer activations into per-sample vectors for the contrastive
losses, and the shape of what a client ships across the cut."""
from __future__ import annotations

import torch

from repro_torch.configs import ArchConfig
from repro_torch.models.common import dense_init


def feature_dim(cfg: ArchConfig) -> int:
    """Width of a pooled split-layer feature: the channels of the conv
    maps at the split for the CNN family, ``d_model`` for the LMs."""
    if cfg.arch_type == "cnn":
        return cfg.cnn_channels[min(cfg.split_layer,
                                    len(cfg.cnn_channels)) - 1]
    return cfg.d_model


def feature_shape(cfg: ArchConfig, batch: int,
                  seq_len: int | None = None) -> tuple[int, ...]:
    """Shape of one split-layer activation batch on the wire: ``(B, H',
    W', C)`` conv maps at the cut for the CNN family, ``(B, S, d_model)``
    for the sequence models."""
    if cfg.arch_type == "cnn":
        from repro_torch.models.cnn import CNNModel
        model = CNNModel(cfg)
        hw, c = model.feat_shape(model.split)
        return (batch, hw, hw, c)
    if seq_len is None:
        raise ValueError("feature_shape needs seq_len= for sequence archs "
                         "(the cut activation is (B, S, d_model))")
    return (batch, seq_len, cfg.d_model)


def proj_dim(cfg: ArchConfig) -> int:
    """Width of the projected embedding z (and of the queue's entries)."""
    if cfg.semisfl.proj_head == "none":
        return feature_dim(cfg)
    return cfg.semisfl.proj_dim


def pool_features(feats: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) conv maps or (B, S, d) token features at the split ->
    (B, C) or (B, d)."""
    if feats.dim() == 4:
        return feats.mean(dim=(1, 2))
    if feats.dim() == 3:
        return feats.mean(dim=1)
    return feats


def init_projection_head(cfg: ArchConfig, generator: torch.Generator,
                         device: torch.device | str) -> dict:
    s = cfg.semisfl
    d_in = feature_dim(cfg)
    if s.proj_head == "none":
        return {}
    if s.proj_head == "linear":
        return {"w1": dense_init(d_in, s.proj_dim, generator, device)}
    return {"w1": dense_init(d_in, s.proj_hidden, generator, device),
            "w2": dense_init(s.proj_hidden, s.proj_dim, generator, device)}


def apply_projection_head(p: dict, feats: torch.Tensor) -> torch.Tensor:
    """Pooled features -> l2-normalized projected embedding z."""
    x = feats.float()
    if "w1" in p:
        x = x @ p["w1"]
    if "w2" in p:
        x = torch.relu(x) @ p["w2"]
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp(
        min=1e-6)
