"""The Mamba2 selective-state-space layer (arXiv:2405.21060 form) of
zamba2, for the port: the JAX package's ``models/ssm.py``.

Prefill runs the selective scan through the ``mamba2_scan`` wrapper (the
CUDA kernel on the card, its plain version on the CPU) where the JAX model
runs its jnp stand-in ``ssd_chunked`` and then a second scan,
``_final_state``, for the state that decode starts from: the port's scan
returns that state with y, so the prompt is scanned once.  Like the JAX
model, prefill starts from a zero state and a zero-padded conv window,
whatever the cache holds.  Decode is the O(1) recurrent update in plain
PyTorch, as the JAX model computes it outside any kernel.  Caches are
returned anew, as JAX returns them."""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch import kernels
from repro_torch.configs import ArchConfig, SSMConfig
from repro_torch.models.common import apply_norm, dense_init, init_norm


class SSMCache(NamedTuple):
    conv: torch.Tensor   # (B, conv_width - 1, conv_channels) rolling window
    state: torch.Tensor  # (B, nh, hd, N) recurrent SSM state, fp32


def _dims(cfg: ArchConfig):
    s = cfg.ssm or SSMConfig()
    d_in = s.expand * cfg.d_model
    nh = d_in // s.head_dim
    conv_ch = d_in + 2 * s.state_dim
    return s, d_in, nh, conv_ch


def init_ssm_cache(batch: int, cfg: ArchConfig, dtype: torch.dtype,
                   device: torch.device | str) -> SSMCache:
    s, _, nh, conv_ch = _dims(cfg)
    return SSMCache(
        conv=torch.zeros(batch, s.conv_width - 1, conv_ch, dtype=dtype,
                         device=device),
        state=torch.zeros(batch, nh, s.head_dim, s.state_dim, device=device))


def init_ssm(cfg: ArchConfig, generator: torch.Generator,
             device: torch.device | str, dtype: torch.dtype) -> dict:
    s, d_in, nh, conv_ch = _dims(cfg)
    d = cfg.d_model
    conv_w = torch.randn(s.conv_width, conv_ch, generator=generator,
                         device=generator.device) * 0.1
    return {
        # -> [z (d_in), x (d_in), B (N), C (N), dt (nh)]
        "in_proj": dense_init(d, 2 * d_in + 2 * s.state_dim + nh, generator,
                              device, dtype),
        "conv_w": conv_w.to(device=device, dtype=dtype),
        "conv_b": torch.zeros(conv_ch, dtype=dtype, device=device),
        "A_log": torch.zeros(nh, device=device),
        "D": torch.ones(nh, device=device),
        "dt_bias": torch.zeros(nh, device=device),
        "norm": init_norm(d_in, "rmsnorm", device, dtype),
        "out_proj": dense_init(d_in, d, generator, device, dtype),
    }


def _split_proj(proj: torch.Tensor, cfg: ArchConfig):
    s, d_in, _, _ = _dims(cfg)
    z = proj[..., :d_in]
    xbc = proj[..., d_in: 2 * d_in + 2 * s.state_dim]
    dt = proj[..., 2 * d_in + 2 * s.state_dim:]
    return z, xbc, dt


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv of width k over xbc (B, S, C), zero-padded in
    front, then SiLU; the taps summed in the JAX model's order."""
    k, s = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = pad[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + pad[:, i: i + s] * w[i]
    return F.silu(out + b)


def scan_views(conv_out: torch.Tensor, cfg: ArchConfig):
    """x (B, S, nh, hd), B and C (B, S, N): views of the conv output
    (B, S, d_in + 2N) as the scan reads them, through their strides."""
    s, d_in, nh, _ = _dims(cfg)
    b, S, _ = conv_out.shape
    return (conv_out[..., :d_in].reshape(b, S, nh, s.head_dim),
            conv_out[..., d_in: d_in + s.state_dim],
            conv_out[..., d_in + s.state_dim:])


def apply_ssm(p: dict, cfg: ArchConfig, x: torch.Tensor, *,
              mode: str = "train", cache: Optional[SSMCache] = None
              ) -> tuple[torch.Tensor, Optional[SSMCache]]:
    """The Mamba2 layer on x (B, S, d_model); in decode mode S is 1 and the
    step starts from ``cache``.  Returns (out, new cache); in train mode,
    or in prefill without a cache, the cache comes back as it was given."""
    s, d_in, nh, _ = _dims(cfg)
    b, S, _ = x.shape
    proj = x @ p["in_proj"]
    z, xbc, dt = _split_proj(proj, cfg)
    A = -torch.exp(p["A_log"])
    dt = F.softplus(dt.float() + p["dt_bias"])

    new_cache = cache
    if mode == "decode":
        if cache is None:
            raise ValueError("Mamba2 decode needs a cache")
        window = torch.cat([cache.conv, xbc], 1)               # (B, w, C)
        conv_out = F.silu(torch.einsum("bwc,wc->bc", window, p["conv_w"])
                          + p["conv_b"])
        xs = conv_out[:, :d_in].reshape(b, nh, s.head_dim)
        Bv = conv_out[:, d_in: d_in + s.state_dim].float()     # (B, N)
        Cv = conv_out[:, d_in + s.state_dim:].float()
        dt1 = dt[:, 0]                                         # (B, nh)
        alpha = torch.exp(dt1 * A)
        xdt = xs.float() * dt1[..., None]                      # (B, nh, hd)
        state = cache.state * alpha[..., None, None] + torch.einsum(
            "bhd,bn->bhdn", xdt, Bv)
        y = torch.einsum("bhdn,bn->bhd", state, Cv)
        y = y + p["D"][None, :, None] * xs.float()
        y = y.reshape(b, 1, d_in).to(x.dtype)
        new_cache = SSMCache(conv=window[:, 1:], state=state)
    else:
        conv_out = _causal_conv(xbc, p["conv_w"], p["conv_b"])
        xs, Bv, Cv = scan_views(conv_out, cfg)
        y4, state = kernels.mamba2_scan(xs, dt, A, Bv, Cv, p["D"])
        y = y4.reshape(b, S, d_in)
        if mode == "prefill" and cache is not None:
            # As the reference does (models/ssm.py:171), the new conv window
            # holds the last conv_width - 1 rows of the *post-conv, post-SiLU*
            # conv_out, while decode (models/ssm.py:143) concatenates it with
            # the *raw* xbc of the new token: the first conv_width - 1 decode
            # steps convolve mixed quantities.  The port is held to the JAX
            # package, so it keeps this.  Only the tail is concatenated, so
            # the cache does not hold on to the whole conv output.
            keep = s.conv_width - 1
            new_cache = SSMCache(
                conv=torch.cat([cache.conv, conv_out[:, -keep:]],
                               1)[:, -keep:].contiguous(),
                state=state)

    y = apply_norm(p["norm"], y * F.silu(z), "rmsnorm")
    return y @ p["out_proj"], new_cache
