"""Initializers shared by the port's models (the JAX package's
``models/common.py``), drawing from an explicit ``torch.Generator``."""
from __future__ import annotations

import math

import torch


def dense_init(d_in: int, d_out: int, generator: torch.Generator,
               device: torch.device | str) -> torch.Tensor:
    """(d_in, d_out) weight, N(0, 1/d_in), JAX's layout."""
    w = torch.randn(d_in, d_out, generator=generator,
                    device=generator.device)
    return (w * (1.0 / math.sqrt(d_in))).to(device)
