"""Rotary position embeddings, standard and partial (the JAX package's
``models/rope.py`` without M-RoPE, which waits for the vision path)."""
from __future__ import annotations

import torch


def rope_freqs(rot_dim: int, theta: float,
               device: torch.device | str = "cpu") -> torch.Tensor:
    """Inverse frequencies for a rotary table. Shape (rot_dim // 2,)."""
    exps = torch.arange(0, rot_dim, 2, dtype=torch.float32,
                        device=device) / rot_dim
    return 1.0 / torch.pow(theta, exps)


def rope_angles(positions: torch.Tensor, rot_dim: int,
                theta: float) -> torch.Tensor:
    """positions (..., S) -> angles (..., S, rot_dim // 2), fp32."""
    inv = rope_freqs(rot_dim, theta, positions.device)
    return positions[..., None].float() * inv


def _rotate(x: torch.Tensor, cos: torch.Tensor,
            sin: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               rope_pct: float = 1.0) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) int. Partial rotary via
    ``rope_pct``: only the leading ``rot_dim`` features rotate."""
    hd = x.shape[-1]
    rot_dim = int(hd * rope_pct)
    rot_dim -= rot_dim % 2
    if rot_dim == 0:
        return x
    ang = rope_angles(positions, rot_dim, theta)           # (B, S, rot/2)
    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)        # (B, S, 1, rot/2)
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    x_rot, x_pass = x[..., :rot_dim], x[..., rot_dim:]
    return torch.cat([_rotate(x_rot, cos, sin), x_pass], dim=-1)


def default_positions(seq: int, offset: int = 0,
                      device: torch.device | str = "cpu") -> torch.Tensor:
    """(1, S) positions ``offset .. offset + S - 1``; the caller broadcasts
    them over the batch."""
    return torch.arange(seq, device=device)[None, :] + offset
