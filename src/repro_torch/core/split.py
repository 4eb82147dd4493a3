"""Split-model utilities (the JAX package's ``core/split.py``): the
projection head w_p (Section III, Table V) and the pooling that turns
split-layer activations into per-sample vectors for the contrastive
losses."""
from __future__ import annotations

import torch

from repro_torch.configs import ArchConfig
from repro_torch.models.common import dense_init


def feature_dim(cfg: ArchConfig) -> int:
    """Channels of the global-average-pooled conv maps at the split."""
    return cfg.cnn_channels[min(cfg.split_layer, len(cfg.cnn_channels)) - 1]


def pool_features(feats: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) split-layer activations -> (B, C)."""
    if feats.dim() == 4:
        return feats.mean(dim=(1, 2))
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
