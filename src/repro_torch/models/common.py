"""Shared building blocks of the port's models (the JAX package's
``models/common.py``): initializers drawing from an explicit
``torch.Generator``, norms, activations and the MLP.

Parameters are nested dicts of tensors; dense weights are (d_in, d_out),
as in JAX.  Norms compute in fp32 and return the input's dtype."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def dense_init(d_in: int, d_out: int, generator: torch.Generator,
               device: torch.device | str,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(d_in, d_out) weight, N(0, 1/d_in), JAX's layout; drawn in fp32 on
    the generator's device, then cast to ``dtype``.  On the ``meta``
    device nothing is drawn: only the shape and dtype exist."""
    if torch.device(device).type == "meta":
        return torch.empty(d_in, d_out, device="meta", dtype=dtype)
    w = torch.randn(d_in, d_out, generator=generator,
                    device=generator.device)
    return (w * (1.0 / math.sqrt(d_in))).to(device=device, dtype=dtype)


def embed_init(vocab: int, d: int, generator: torch.Generator,
               device: torch.device | str,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(vocab, d) embedding table, N(0, 0.02^2); shape only on ``meta``."""
    if torch.device(device).type == "meta":
        return torch.empty(vocab, d, device="meta", dtype=dtype)
    w = torch.randn(vocab, d, generator=generator, device=generator.device)
    return (w * 0.02).to(device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_norm(d: int, kind: str, device: torch.device | str,
              dtype: torch.dtype) -> dict:
    p = {"scale": torch.ones(d, device=device, dtype=dtype)}
    if kind != "rmsnorm":
        p["bias"] = torch.zeros(d, device=device, dtype=dtype)
    return p


def apply_norm(p: dict, x: torch.Tensor, kind: str,
               eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm or LayerNorm over the last axis, in fp32 inside."""
    xf = x.float()
    if kind == "rmsnorm":
        var = (xf * xf).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps)
        return (y * p["scale"].float()).to(x.dtype)
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


def rms_norm_headwise(scale: torch.Tensor, x: torch.Tensor,
                      eps: float = 1e-6) -> torch.Tensor:
    """Per-head RMSNorm over the trailing head_dim (qwen3 qk-norm)."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Activations / MLP
# ---------------------------------------------------------------------------

_ACTS = {"silu": F.silu, "gelu": lambda x: F.gelu(x, approximate="tanh"),
         "relu": F.relu}


def init_mlp(d: int, d_ff: int, gated: bool, generator: torch.Generator,
             device: torch.device | str, dtype: torch.dtype) -> dict:
    p = {"up": dense_init(d, d_ff, generator, device, dtype),
         "down": dense_init(d_ff, d, generator, device, dtype)}
    if gated:
        p["gate"] = dense_init(d, d_ff, generator, device, dtype)
    return p


def apply_mlp(p: dict, x: torch.Tensor, act: str,
              gated: bool) -> torch.Tensor:
    f = _ACTS[act]
    h = x @ p["up"]
    h = f(x @ p["gate"]) * h if gated else f(h)
    return h @ p["down"]
