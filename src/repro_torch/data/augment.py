"""Weak / strong augmentation (Section III step (3)), the JAX package's
``data/augment.py`` with its random draws taken as tensors.

Weak: random horizontal flip, then a random crop of the 4-pixel reflection
padded image (the paper's a_w).  Strong: weak, then ``n_ops`` ops drawn from
(brightness, contrast) with per-sample magnitudes, then cutout and a final
clip (the RandAugment-style a_s).

Images are NHWC.  The draws are per sample, so one call can augment many
clients' batches at once; :func:`sample_weak` and :func:`sample_strong` draw
them from a ``torch.Generator``, one op index per client call and slot as
the JAX version's ``lax.switch`` does.  Given the same draws, the results
match the JAX functions."""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

PAD = 4
N_OPS = 2
MAGNITUDE = 0.5
CUTOUT_FRAC = 0.25
N_STRONG_OPS = 2          # brightness, contrast


class WeakDraws(NamedTuple):
    flip: torch.Tensor     # (B,) bool, mirror the width axis
    dx: torch.Tensor       # (B,) int64 crop row offset in [0, 2 * PAD]
    dy: torch.Tensor       # (B,) int64 crop column offset in [0, 2 * PAD]


class StrongDraws(NamedTuple):
    weak: WeakDraws
    op: torch.Tensor       # (N_OPS, B) int64: 0 brightness, 1 contrast
    u: torch.Tensor        # (N_OPS, B) float32 uniform magnitude draws
    cy: torch.Tensor       # (B,) int64 cutout row corner
    cx: torch.Tensor       # (B,) int64 cutout column corner


def cutout_size(h: int, frac: float = CUTOUT_FRAC) -> int:
    return max(1, int(h * frac))


def _randint(high: int, n: int, gen: torch.Generator) -> torch.Tensor:
    return torch.randint(0, high, (n,), generator=gen, device=gen.device)


def sample_weak(n: int, gen: torch.Generator) -> WeakDraws:
    """Weak draws for ``n`` samples."""
    return WeakDraws(
        flip=torch.rand(n, generator=gen, device=gen.device) < 0.5,
        dx=_randint(2 * PAD + 1, n, gen), dy=_randint(2 * PAD + 1, n, gen))


def sample_strong(n_calls: int, batch: int, hw: int,
                  gen: torch.Generator) -> StrongDraws:
    """Strong draws for ``n_calls`` client calls of ``batch`` samples each
    (flattened call-major): one op index per call and slot, everything
    else per sample."""
    n = n_calls * batch
    op = torch.randint(0, N_STRONG_OPS, (N_OPS, n_calls), generator=gen,
                       device=gen.device).repeat_interleave(batch, dim=1)
    high = hw - cutout_size(hw) + 1
    return StrongDraws(
        weak=sample_weak(n, gen), op=op,
        u=torch.rand(N_OPS, n, generator=gen, device=gen.device),
        cy=_randint(high, n, gen), cx=_randint(high, n, gen))


def weak_augment(x: torch.Tensor, d: WeakDraws) -> torch.Tensor:
    b, h, w, _ = x.shape
    x = torch.where(d.flip[:, None, None, None], x.flip(2), x)
    xp = F.pad(x.permute(0, 3, 1, 2), (PAD, PAD, PAD, PAD),
               mode="reflect").permute(0, 2, 3, 1)
    rows = d.dx[:, None] + torch.arange(h, device=x.device)       # (B, h)
    cols = d.dy[:, None] + torch.arange(w, device=x.device)       # (B, w)
    bi = torch.arange(b, device=x.device)[:, None, None]
    return xp[bi, rows[:, :, None], cols[:, None, :]]


def strong_augment(x: torch.Tensor, d: StrongDraws) -> torch.Tensor:
    b, h, w, _ = x.shape
    x = weak_augment(x, d.weak)
    for i in range(d.op.shape[0]):
        shift = (d.u[i] * 2 - 1)[:, None, None, None] * MAGNITUDE
        bright = x + shift
        f = 1.0 + shift
        mean = x.mean(dim=(1, 2, 3), keepdim=True)
        contrast = (x - mean) * f + mean
        x = torch.where((d.op[i] == 0)[:, None, None, None], bright,
                        contrast)
    ch = cutout_size(h)
    ys = torch.arange(h, device=x.device)[None, :, None]
    xs = torch.arange(w, device=x.device)[None, None, :]
    cy, cx = d.cy[:, None, None], d.cx[:, None, None]
    mask = (ys >= cy) & (ys < cy + ch) & (xs >= cx) & (xs < cx + ch)
    x = torch.where(mask[..., None], 0.5, x)
    return torch.clamp(x, 0.0, 1.0)
