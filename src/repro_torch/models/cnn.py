"""The paper's benchmark CNNs (customized CNN / AlexNet / VGG13 / VGG16) as
split classifiers: the JAX package's ``models/cnn.py`` in PyTorch.

A stack of 3x3 SAME conv + ReLU layers (``cfg.cnn_channels``) with 2x2
max-pool at channel-width changes and after the last conv, then the FC
stack (``cfg.cnn_fc``) and the classifier.  ``bottom`` = convs[:split]
(client), ``top`` = the rest (server).

Parameters are nested dicts with the JAX package's structure.  Conv weights
are OIHW (PyTorch's layout; ``convert.py`` maps JAX's HWIO), dense weights
are (d_in, d_out) as in JAX.  Images and cut features are NHWC at the public
functions, as in JAX; inside, the convs run NCHW, and the maps are put back
in NHWC order before the flatten, so the FC-1 weight rows mean what they
mean in JAX."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs import ArchConfig
from repro_torch.models.common import dense_init


def _pool_at(channels) -> list[bool]:
    out = []
    for i, c in enumerate(channels):
        last = i == len(channels) - 1
        change = (not last) and channels[i + 1] != c
        out.append(last or change)
    return out


def _conv_init(cin: int, cout: int, generator: torch.Generator,
               device) -> dict:
    w = torch.randn(cout, cin, 3, 3, generator=generator,
                    device=generator.device)
    w = w * math.sqrt(2.0 / (9 * cin))
    return {"w": w.to(device), "b": torch.zeros(cout, device=device)}


def _conv_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    """3x3 SAME conv + bias + ReLU on NCHW maps."""
    return torch.relu(F.conv2d(x, p["w"], p["b"], padding=1))


class CNNModel:
    def __init__(self, cfg: ArchConfig):
        self.cfg = cfg
        self.split = min(cfg.split_layer, len(cfg.cnn_channels))
        self.pool_at = _pool_at(cfg.cnn_channels)

    def feat_shape(self, upto: int) -> tuple[int, int]:
        """(spatial size, channels) after the first ``upto`` convs."""
        hw, c = self.cfg.image_size, 3
        for i in range(upto):
            c = self.cfg.cnn_channels[i]
            if self.pool_at[i]:
                hw //= 2
        return hw, c

    def init(self, generator: torch.Generator, device) -> dict:
        cfg = self.cfg
        convs, cin = [], 3
        for cout in cfg.cnn_channels:
            convs.append(_conv_init(cin, cout, generator, device))
            cin = cout
        hw, c = self.feat_shape(len(cfg.cnn_channels))
        feat = hw * hw * c
        fcs = []
        for width in cfg.cnn_fc:
            fcs.append({"w": dense_init(feat, width, generator, device),
                        "b": torch.zeros(width, device=device)})
            feat = width
        top = {"convs": convs[self.split:], "fcs": fcs,
               "cls": {"w": dense_init(feat, cfg.num_classes, generator,
                                       device),
                       "b": torch.zeros(cfg.num_classes, device=device)}}
        return {"bottom": {"convs": convs[: self.split]}, "top": top}

    def _convs(self, convs: list, x: torch.Tensor, first: int) -> torch.Tensor:
        for i, p in enumerate(convs):
            x = _conv_apply(p, x)
            if self.pool_at[first + i]:
                x = F.max_pool2d(x, 2, 2)
        return x

    def bottom_apply(self, params: dict, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) images -> (B, H', W', C) cut features."""
        x = images.float().permute(0, 3, 1, 2)
        return self._convs(params["convs"], x, 0).permute(0, 2, 3, 1)

    def top_apply(self, params: dict, features: torch.Tensor,
                  dropout_masks: list | None = None) -> torch.Tensor:
        """(B, H', W', C) cut features -> (B, classes) logits.

        ``dropout_masks``: one (B, width) keep mask per FC layer, given
        only for a train-mode forward of a config with FC dropout.
        Inverted dropout: kept activations are scaled by 1/(1 - rate)."""
        x = self._convs(params["convs"], features.permute(0, 3, 1, 2),
                        self.split)
        b = x.shape[0]
        x = x.permute(0, 2, 3, 1).reshape(b, -1)        # JAX's NHWC order
        rate = self.cfg.cnn_dropout
        for li, p in enumerate(params["fcs"]):
            x = torch.relu(x @ p["w"] + p["b"])
            if dropout_masks is not None:
                x = torch.where(dropout_masks[li], x / (1.0 - rate), 0.0)
        return x @ params["cls"]["w"] + params["cls"]["b"]

    def draw_dropout_masks(self, batch: int, generator: torch.Generator,
                           device) -> list | None:
        """Per-sample keep masks for a train-mode top forward, or None for
        a config without FC dropout."""
        rate = self.cfg.cnn_dropout
        if rate <= 0.0:
            return None
        return [(torch.rand(batch, w, generator=generator,
                            device=generator.device) < 1.0 - rate).to(device)
                for w in self.cfg.cnn_fc]
