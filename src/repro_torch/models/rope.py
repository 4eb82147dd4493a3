"""Rotary position embeddings: standard, partial (stablelm) and M-RoPE
(qwen2-vl), the JAX package's ``models/rope.py``.

M-RoPE splits the rotary frequency slots into (temporal, height, width)
sections and takes each section's angles from its own position plane.
Text-only tokens repeat one position in all three planes, which reduces
exactly to standard RoPE."""
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


def apply_mrope(x: torch.Tensor, positions_3d: torch.Tensor, theta: float,
                sections: tuple[int, ...]) -> torch.Tensor:
    """M-RoPE. x: (B, S, H, hd); positions_3d: (3, B, S) int planes
    (temporal, height, width); sections: each plane's count of frequency
    slots, in order, summing to hd // 2.  Slot d's angle is its plane's
    position times slot d's inverse frequency: the product JAX forms for
    every plane before it selects one (by a one-hot contraction, exact),
    so the angles are the same floats."""
    hd = x.shape[-1]
    if sum(sections) != hd // 2:
        raise ValueError(f"M-RoPE sections {sections} do not sum to "
                         f"head_dim // 2 = {hd // 2}")
    dev = positions_3d.device
    # each slot's plane, made on the device (no tensor from a host list,
    # which a CUDA graph's capture refuses)
    plane_of_slot = torch.cat([torch.full((n,), p, dtype=torch.long,
                                          device=dev)
                               for p, n in enumerate(sections)])
    pos = positions_3d.float().index_select(0, plane_of_slot)  # (hd/2, B, S)
    ang = pos.permute(1, 2, 0) * rope_freqs(hd, theta, dev)    # (B, S, hd/2)
    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    return _rotate(x, cos, sin)


def default_positions(seq: int, offset: int = 0,
                      device: torch.device | str = "cpu") -> torch.Tensor:
    """(1, S) positions ``offset .. offset + S - 1``; the caller broadcasts
    them over the batch."""
    return torch.arange(seq, device=device)[None, :] + offset


def default_mrope_positions(batch: int, seq: int, offset: int = 0,
                            device: torch.device | str = "cpu"
                            ) -> torch.Tensor:
    """Text-only (3, B, S) M-RoPE positions: all three planes equal, which
    reduces M-RoPE to RoPE."""
    p = default_positions(seq, offset, device).expand(batch, seq)
    return torch.stack([p, p, p])
