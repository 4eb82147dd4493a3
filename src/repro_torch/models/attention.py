"""GQA attention with RoPE or M-RoPE, QKV bias, qk-norm, sliding window,
KV-cache decode (a ring buffer for sliding-window attention) and
cross-attention over given K/V: the JAX package's ``models/attention.py``.

Train and prefill attention go through the flash-attention wrapper
(``repro_torch.kernels.flash_attention``: the CUDA kernels on the card,
forward and, where a gradient is recorded, backward; the plain version
under autograd on the CPU), where the JAX model runs its jnp stand-in
``_chunked_attend``.  The wrapper reads the model's (B, S, H, hd)
projections through (B, H, S, hd) views and gives its output back in the
model's layout, so no transposed copy is made on the card.  Self-attention
decode stays plain PyTorch, as the JAX package computes it outside any
kernel; cross-attention decode (one query row over the given K/V) goes
through the flash wrapper, as JAX runs it through ``_chunked_attend``.

The cache is updated in place: ``cache_update`` and ``cache_prefill`` write
into the given buffers and return them (JAX returns new arrays), which
saves a copy of every layer's cache per generated token."""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch import kernels
from repro_torch.configs import ArchConfig
from repro_torch.models.common import dense_init, rms_norm_headwise
from repro_torch.models.rope import apply_mrope, apply_rope


class KVCache(NamedTuple):
    """Decode-time cache. For sliding-window attention the buffer is a ring
    of length ``window`` and ``pos`` tracks absolute kv positions."""

    k: torch.Tensor          # (B, S_buf, KVH, hd)
    v: torch.Tensor          # (B, S_buf, KVH, hd)
    pos: torch.Tensor        # (B, S_buf) absolute position of each slot, -1 = empty


def init_kv_cache(batch: int, max_len: int, n_kv: int, head_dim: int,
                  window: int, dtype: torch.dtype,
                  device: torch.device | str) -> KVCache:
    buf = min(window, max_len) if window else max_len
    return KVCache(
        k=torch.zeros(batch, buf, n_kv, head_dim, dtype=dtype, device=device),
        v=torch.zeros(batch, buf, n_kv, head_dim, dtype=dtype, device=device),
        pos=torch.full((batch, buf), -1, dtype=torch.int64, device=device),
    )


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def init_attention(cfg: ArchConfig, generator: torch.Generator,
                   device: torch.device | str, dtype: torch.dtype) -> dict:
    d, h, kvh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd = cfg.resolved_head_dim
    p = {
        "wq": dense_init(d, h * hd, generator, device, dtype),
        "wk": dense_init(d, kvh * hd, generator, device, dtype),
        "wv": dense_init(d, kvh * hd, generator, device, dtype),
        "wo": dense_init(h * hd, d, generator, device, dtype),
    }
    zeros = lambda n: torch.zeros(n, dtype=dtype, device=device)
    if cfg.attn_bias:
        p["bq"], p["bk"], p["bv"] = zeros(h * hd), zeros(kvh * hd), zeros(
            kvh * hd)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(hd, dtype=dtype, device=device)
        p["k_norm"] = torch.ones(hd, dtype=dtype, device=device)
    return p


# ---------------------------------------------------------------------------
# Core attention math
# ---------------------------------------------------------------------------

def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool, window: int) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Skv, KVH, hd) -> (B, Sq, H, hd),
    through the flash wrapper on (B, H, S, hd) views."""
    out = kernels.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), causal=causal,
                                  window=window)
    return out.transpose(1, 2)


def _decode_attend(q: torch.Tensor, cache: KVCache, cur_pos: torch.Tensor,
                   window: int) -> torch.Tensor:
    """One-token attention against the cache.

    q: (B, 1, H, hd); cur_pos: (B,) absolute position of the new token.
    Scores in fp32 (JAX's ``preferred_element_type``), the weights cast to
    the cache's dtype for the product with V, as in JAX."""
    b, _, h, hd = q.shape
    kvh = cache.k.shape[2]
    g = h // kvh
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(b, kvh, g, hd)
    logits = torch.einsum("bkgd,bskd->bkgs", qg.float(),
                          cache.k.float()) * scale
    valid = cache.pos >= 0
    valid &= cache.pos <= cur_pos[:, None]
    if window:
        valid &= cache.pos > (cur_pos[:, None] - window)
    logits = logits.masked_fill(~valid[:, None, None, :], -math.inf)
    w = torch.softmax(logits, dim=-1).to(cache.v.dtype)
    out = torch.einsum("bkgs,bskd->bkgd", w, cache.v)
    return out.reshape(b, 1, h, hd)


def cache_update(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor,
                 pos: torch.Tensor) -> KVCache:
    """Insert one token (B, 1, KVH, hd) at absolute position ``pos`` (B,),
    in place."""
    buf = cache.k.shape[1]
    slot = pos % buf
    bidx = torch.arange(k_new.shape[0], device=pos.device)
    cache.k[bidx, slot] = k_new[:, 0]
    cache.v[bidx, slot] = v_new[:, 0]
    cache.pos[bidx, slot] = pos
    return cache


def cache_prefill(cache: KVCache, k: torch.Tensor,
                  v: torch.Tensor) -> KVCache:
    """Write a full prefix (B, S, KVH, hd) into the cache (S <= buffer),
    in place."""
    s = k.shape[1]
    buf = cache.k.shape[1]
    if s > buf:  # sliding window: only the last `buf` tokens matter
        k, v = k[:, -buf:], v[:, -buf:]
        start = s - buf
    else:
        start = 0
    pos = torch.arange(start, start + k.shape[1], device=k.device)
    slot = pos % buf
    cache.k[:, slot] = k
    cache.v[:, slot] = v
    cache.pos[:, slot] = pos
    return cache


# ---------------------------------------------------------------------------
# Full attention module
# ---------------------------------------------------------------------------

def apply_attention(
    p: dict,
    cfg: ArchConfig,
    x: torch.Tensor,
    *,
    positions: torch.Tensor,           # (B, S), or (3, B, S) for M-RoPE
    mode: str = "train",               # train | prefill | decode
    cache: Optional[KVCache] = None,
    causal: bool = True,
    kv_override: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
) -> tuple[torch.Tensor, Optional[KVCache]]:
    """Self-attention of x (B, S, d_model), causal unless ``causal`` is
    False; in decode mode S is 1 and the new token's k/v go into ``cache``
    first, at the position of the last plane of M-RoPE positions (JAX's
    ``positions[-1]``).  With ``kv_override`` = (k, v), each (B, Skv, KVH,
    hd), it is cross-attention: only q is projected (and q-normed), no
    rotary embedding is applied, the cache is not touched, and decode
    attends to all of the given K/V with no mask, as in JAX."""
    b, s, d = x.shape
    h, kvh = cfg.num_heads, cfg.num_kv_heads
    hd = cfg.resolved_head_dim
    window = cfg.sliding_window

    q = x @ p["wq"]
    if "bq" in p:
        q = q + p["bq"]
    q = q.reshape(b, s, h, hd)
    if kv_override is not None:
        k, v = kv_override
    else:
        k = x @ p["wk"]
        v = x @ p["wv"]
        if "bk" in p:
            k, v = k + p["bk"], v + p["bv"]
        k = k.reshape(b, s, kvh, hd)
        v = v.reshape(b, s, kvh, hd)

    if "q_norm" in p:
        q = rms_norm_headwise(p["q_norm"], q)
        if kv_override is None:
            k = rms_norm_headwise(p["k_norm"], k)

    if cfg.rope_kind != "none" and kv_override is None:
        if cfg.rope_kind == "mrope":
            q = apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections)
            k = apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections)
        else:
            q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_pct)
            k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_pct)

    new_cache = cache
    if mode == "decode" and kv_override is None:
        if cache is None:
            raise ValueError("decode attention needs a cache")
        cur_pos = positions[-1] if positions.dim() == 3 else positions
        cur_pos = cur_pos.reshape(b, -1)[:, -1]
        new_cache = cache_update(cache, k, v, cur_pos)
        out = _decode_attend(q, new_cache, cur_pos, window)
    elif mode == "decode":          # cross-attention decode: the given K/V
        out = _attend(q, k, v, causal=False, window=0)
    else:
        out = _attend(q, k, v, causal=causal, window=window)
        if mode == "prefill" and cache is not None and kv_override is None:
            new_cache = cache_prefill(cache, k, v)

    y = out.reshape(b, s, h * hd) @ p["wo"]
    return y, new_cache
