"""xLSTM blocks (arXiv:2405.04517) for the port: the JAX package's
``models/xlstm.py``.  mLSTM (matrix memory) runs its prefill and training
pass chunkwise (the carry-free terms of all chunks at once, the carry chunk
by chunk, where JAX scans a step over the chunks), and its decode as the
O(1) recurrent step; sLSTM (scalar memory, strictly sequential) runs its prefill
through the ``slstm_scan`` wrapper (the CUDA kernel on the card, its plain
version on the CPU) where the JAX model scans ``slstm_step``, and its
decode as ``slstm_step`` in plain PyTorch, as the JAX model computes it
outside any kernel.

The fp32 islands of the reference are kept: the sLSTM input projection
``x.float() @ w + b``, the mLSTM gate projection ``up.float() @ w_if``, and
both recurrent states in fp32.  The sLSTM recurrent weights are fp32, as
the JAX model stores them by default.  Caches are returned anew, as JAX
returns them; nothing is written in place."""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch import kernels
from repro_torch.configs import ArchConfig, XLSTMConfig
from repro_torch.kernels.ref import N_MIN, NEG_INF
from repro_torch.models.common import (apply_mlp, apply_norm, dense_init,
                                       init_mlp, init_norm)


class MLSTMCache(NamedTuple):
    C: torch.Tensor   # (B, nh, dk, dv) matrix memory
    n: torch.Tensor   # (B, nh, dk) normalizer
    m: torch.Tensor   # (B, nh) stabilizer


class SLSTMCache(NamedTuple):
    h: torch.Tensor   # (B, d)
    c: torch.Tensor   # (B, d)
    n: torch.Tensor   # (B, d)
    m: torch.Tensor   # (B, d)


def _mlstm_dims(cfg: ArchConfig):
    x = cfg.xlstm or XLSTMConfig()
    d_in = int(x.mlstm_proj_factor * cfg.d_model)
    nh = max(1, d_in // x.mlstm_head_dim)
    hd = d_in // nh
    return x, d_in, nh, hd


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def init_mlstm(cfg: ArchConfig, generator: torch.Generator,
               device: torch.device | str, dtype: torch.dtype) -> dict:
    _, d_in, nh, _ = _mlstm_dims(cfg)
    d = cfg.d_model
    return {
        "up": dense_init(d, d_in, generator, device, dtype),
        "up_gate": dense_init(d, d_in, generator, device, dtype),
        "wq": dense_init(d_in, d_in, generator, device, dtype),
        "wk": dense_init(d_in, d_in, generator, device, dtype),
        "wv": dense_init(d_in, d_in, generator, device, dtype),
        "w_if": dense_init(d_in, 2 * nh, generator, device),
        "b_if": torch.cat([torch.zeros(nh, device=device),
                           torch.full((nh,), 3.0, device=device)]),
        "norm": init_norm(d_in, "rmsnorm", device, dtype),
        "pre_norm": init_norm(d, "layernorm", device, dtype),
        "down": dense_init(d_in, d, generator, device, dtype),
    }


def _zero_mlstm_state(batch: int, nh: int, hd: int,
                      device: torch.device | str) -> MLSTMCache:
    return MLSTMCache(
        C=torch.zeros(batch, nh, hd, hd, device=device),
        n=torch.zeros(batch, nh, hd, device=device),
        m=torch.full((batch, nh), NEG_INF, device=device))


def init_mlstm_cache(batch: int, cfg: ArchConfig,
                     device: torch.device | str) -> MLSTMCache:
    _, _, nh, hd = _mlstm_dims(cfg)
    return _zero_mlstm_state(batch, nh, hd, device)


def _mlstm_qkv_gates(p: dict, cfg: ArchConfig, x: torch.Tensor):
    _, _, nh, hd = _mlstm_dims(cfg)
    b, s, _ = x.shape
    up = x @ p["up"]
    gate = F.silu(x @ p["up_gate"])
    q = (up @ p["wq"]).reshape(b, s, nh, hd)
    k = (up @ p["wk"]).reshape(b, s, nh, hd) / math.sqrt(hd)
    v = (up @ p["wv"]).reshape(b, s, nh, hd)
    if_pre = up.float() @ p["w_if"] + p["b_if"]
    logi = if_pre[..., :nh]                               # (b, s, nh)
    logf = F.logsigmoid(if_pre[..., nh:])                 # (b, s, nh) <= 0
    return q, k, v, logi, logf, gate


def mlstm_step(carry: MLSTMCache, q, k, v, logi, logf
               ) -> tuple[MLSTMCache, torch.Tensor]:
    """One recurrent step. q, k, v: (B, nh, hd); logi, logf: (B, nh)."""
    m_new = torch.maximum(logf + carry.m, logi)
    f = torch.exp(logf + carry.m - m_new)[..., None]
    i = torch.exp(logi - m_new)[..., None]
    qf, kf, vf = q.float(), k.float(), v.float()
    C = f[..., None] * carry.C \
        + i[..., None] * kf[..., :, None] * vf[..., None, :]
    n = f * carry.n + i * kf
    num = torch.einsum("bhk,bhkv->bhv", qf, C)
    den = torch.maximum(torch.einsum("bhk,bhk->bh", qf, n).abs(),
                        torch.exp(-m_new))[..., None]
    return MLSTMCache(C, n, m_new), (num / den).to(q.dtype)


def mlstm_chunked(q, k, v, logi, logf, cache: Optional[MLSTMCache],
                  chunk: int) -> tuple[torch.Tensor, MLSTMCache]:
    """Chunkwise-parallel mLSTM. q, k, v: (b, S, nh, hd).  The chunk is
    halved until it divides S; within a chunk the contributions are a
    masked (c, c) product, and (C, n, m) is carried across chunks.  JAX
    scans a step over the chunks; here every term that does not depend on
    the carry is formed for all chunks at once (a chunk axis j), and only
    the carry's recurrences run chunk by chunk: the stabilizer m (two ops a
    chunk), then the matrix memory C and normalizer n with each chunk's
    read of them (five).  Each element is the same expression as JAX's, so
    the forward agrees with a chunk-by-chunk loop bit for bit; the loop's
    launches a chunk (tens of small ops, in three forward passes and a
    backward a training step) left the card idle."""
    b, S, nh, hd = q.shape
    c = min(chunk, S)
    while S % c:
        c //= 2
    nc = S // c
    if cache is None:
        cache = _zero_mlstm_state(b, nh, hd, q.device)
    tril = torch.tril(torch.ones(c, c, dtype=torch.bool, device=q.device))
    ch = lambda t: t.reshape(b, nc, c, *t.shape[2:])
    qf, kf, vf = (ch(t).float() for t in (q, k, v))    # (b, j, c, nh, hd)
    li, lf = ch(logi), ch(logf)                          # (b, j, c, nh)
    Fc = torch.cumsum(lf, dim=2)                         # inclusive
    # D(t, s) = F[t] - F[s] + logi[s], s <= t
    D = Fc[:, :, :, None, :] - Fc[:, :, None, :, :] + li[:, :, None, :, :]
    D = D.masked_fill(~tril[None, None, :, :, None], -math.inf)
    Ftot = Fc[:, :, -1]                                  # (b, j, nh)
    tail = Ftot[:, :, None, :] - Fc + li                 # (b, j, c, nh)
    tail_max = tail.amax(dim=2)
    # the stabilizer each chunk starts from, and the one it hands on
    m_in, m = [], cache.m
    for j in range(nc):
        m_in.append(m)
        m = torch.maximum(Ftot[:, j] + m, tail_max[:, j])
    m_out = torch.stack(m_in[1:] + [m], 1)
    m_in = torch.stack(m_in, 1)                          # (b, j, nh)
    inter_log = Fc + m_in[:, :, None, :]
    # the floor a fill on the device (no host copy: a CUDA graph captures
    # it)
    m_new = torch.maximum(torch.maximum(D.amax(dim=3), inter_log),
                          inter_log.new_full((), NEG_INF))
    W = torch.exp(D - m_new[:, :, :, None, :])           # (b, j, t, s, nh)
    inter_w = torch.exp(inter_log - m_new)               # (b, j, c, nh)
    wC = torch.exp(tail - m_out[:, :, None, :])
    decay = torch.exp(Ftot + m_in - m_out)
    # the matrix memory and normalizer each chunk reads, and the update
    C, n = cache.C, cache.n
    qC, n_in = [], []
    for j in range(nc):
        qC.append(torch.einsum("bthk,bhkv->bthv", qf[:, j], C))
        n_in.append(n)
        C = decay[:, j, :, None, None] * C + torch.einsum(
            "bshk,bshv->bhkv", wC[:, j, :, :, None] * kf[:, j], vf[:, j])
        n = decay[:, j, :, None] * n \
            + torch.einsum("bsh,bshk->bhk", wC[:, j], kf[:, j])
    qC, n_in = torch.stack(qC, 1), torch.stack(n_in, 1)
    scores = torch.einsum("bjthd,bjshd->bjtsh", qf, kf)
    num = torch.einsum("bjtsh,bjshv->bjthv", scores * W, vf) \
        + inter_w[..., None] * qC
    nvec = torch.einsum("bjtsh,bjshk->bjthk", W, kf) \
        + inter_w[..., None] * n_in[:, :, None]
    den = torch.maximum(torch.einsum("bjthk,bjthk->bjth", qf, nvec).abs(),
                        torch.exp(-m_new))
    h = (num / den[..., None]).to(q.dtype).reshape(b, S, nh, hd)
    return h, MLSTMCache(C, n, m)


def apply_mlstm(p: dict, cfg: ArchConfig, x: torch.Tensor, *,
                mode: str = "train", cache: Optional[MLSTMCache] = None):
    _, d_in, _, _ = _mlstm_dims(cfg)
    b, s, _ = x.shape
    q, k, v, logi, logf, gate = _mlstm_qkv_gates(p, cfg, x)
    if mode == "decode":
        new_cache, h = mlstm_step(cache, q[:, 0], k[:, 0], v[:, 0],
                                  logi[:, 0], logf[:, 0])
        h = h[:, None]
    else:
        h, new_cache = mlstm_chunked(q, k, v, logi, logf,
                                     cache if mode == "prefill" else None,
                                     chunk=128)
        if mode != "prefill":
            new_cache = cache
    h = apply_norm(p["norm"], h.reshape(b, s, d_in), "rmsnorm") * gate
    return h @ p["down"], new_cache


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def init_slstm(cfg: ArchConfig, generator: torch.Generator,
               device: torch.device | str, dtype: torch.dtype) -> dict:
    x = cfg.xlstm or XLSTMConfig()
    d, nh = cfg.d_model, cfg.num_heads
    hd = d // nh
    r = torch.randn(nh, hd, 4 * hd, generator=generator,
                    device=generator.device) / math.sqrt(hd)
    return {
        "w": dense_init(d, 4 * d, generator, device),
        "r": r.to(device),
        "b": torch.cat([torch.zeros(2 * d, device=device),
                        torch.full((d,), 3.0, device=device),   # f bias
                        torch.zeros(d, device=device)]),
        "norm": init_norm(d, "layernorm", device, dtype),
        "ffn": init_mlp(d, int(x.slstm_ff_factor * d), True, generator,
                        device, dtype),
        "ffn_norm": init_norm(d, "layernorm", device, dtype),
    }


def init_slstm_cache(batch: int, cfg: ArchConfig,
                     device: torch.device | str) -> SLSTMCache:
    z = torch.zeros(batch, cfg.d_model, device=device)
    return SLSTMCache(h=z, c=z, n=z, m=torch.full_like(z, NEG_INF))


def slstm_step(p: dict, cfg: ArchConfig, carry: SLSTMCache,
               wx: torch.Tensor) -> tuple[SLSTMCache, torch.Tensor]:
    """wx: precomputed W x_t + b, (B, 4d) ordered [z, i, f, o]."""
    d, nh = cfg.d_model, cfg.num_heads
    hd = d // nh
    hprev = carry.h.reshape(-1, nh, hd)
    rec = torch.einsum("bhd,hdk->bhk", hprev.float(), p["r"].float())
    # r output per head ordered [z, i, f, o] within the head -> interleave
    rec = rec.reshape(-1, nh, 4, hd).transpose(1, 2).reshape(-1, 4 * d)
    zt, it, ft, ot = (wx + rec).chunk(4, dim=-1)
    m_new = torch.maximum(ft + carry.m, it)  # exp-input, exp-forget gating
    i = torch.exp(it - m_new)
    f = torch.exp(ft + carry.m - m_new)
    c = f * carry.c + i * torch.tanh(zt)
    n = f * carry.n + i
    h = torch.sigmoid(ot) * c / torch.maximum(n, n.new_full((), N_MIN))
    return SLSTMCache(h=h, c=c, n=n, m=m_new), h


def apply_slstm(p: dict, cfg: ArchConfig, x: torch.Tensor, *,
                mode: str = "train", cache: Optional[SLSTMCache] = None):
    b, s, d = x.shape
    wx = x.float() @ p["w"] + p["b"]                 # (B, S, 4d) [z,i,f,o]
    if cache is None:
        cache = init_slstm_cache(b, cfg, x.device)
    if mode == "decode":
        new_cache, h = slstm_step(p, cfg, cache, wx[:, 0])
        hs = h[:, None]
    else:
        nh = cfg.num_heads
        hd = d // nh
        hs, final = kernels.slstm_scan(
            wx.view(b, s, 4, nh, hd), p["r"],
            tuple(t.reshape(b, nh, hd) for t in cache))
        hs = hs.reshape(b, s, d)
        new_cache = (SLSTMCache(*(t.reshape(b, d) for t in final))
                     if mode == "prefill" else cache)
    return hs.to(x.dtype), new_cache


def apply_slstm_block(p: dict, cfg: ArchConfig, x: torch.Tensor, *,
                      mode: str = "train",
                      cache: Optional[SLSTMCache] = None):
    h, new_cache = apply_slstm(p, cfg, apply_norm(p["norm"], x, "layernorm"),
                               mode=mode, cache=cache)
    x = x + h
    x = x + apply_mlp(p["ffn"], apply_norm(p["ffn_norm"], x, "layernorm"),
                      "gelu", True)
    return x, new_cache


def apply_mlstm_block(p: dict, cfg: ArchConfig, x: torch.Tensor, *,
                      mode: str = "train",
                      cache: Optional[MLSTMCache] = None):
    h, new_cache = apply_mlstm(p, cfg,
                               apply_norm(p["pre_norm"], x, "layernorm"),
                               mode=mode, cache=cache)
    return x + h, new_cache
