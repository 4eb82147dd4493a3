"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434): the JAX
package's ``models/mla.py``.

KV states are compressed into a ``kv_lora_rank`` latent (plus one
rope-carrying key slice shared by the heads), which is what the decode
cache holds.  Decode uses the absorbed form: W_uk and W_uv fold into the
query and output sides, so each step works in latent space and never
decompresses the cache:

    logits = (q_nope W_uk) . latent  +  q_rope . k_rope
    out    = (softmax(logits) latent) W_uv

as plain tensor operations (JAX computes it outside any kernel).  Prefill
decompresses k_nope and v per head, broadcasts k_rope over the heads and
hands (B, H, S, d) views of q, k (d = nope + rope) and v (d = v_head_dim)
to the flash wrapper, causal, where JAX runs its chunked jnp softmax; the
scale is 1 / sqrt(nope + rope).  On the card a bf16 prefill goes through
the wgmma kernel (DeepSeek-V2's (192, 128) pair), which raises on views it
cannot read; nothing falls back.  Training takes the same branch: the
gradient flows back through the flash backward kernels at the pair
(``kernels.FlashAttention``), the q/k concatenation and k_rope's
broadcast over the heads (summed back into the one shared slice).

The cache is written in place, as the attention cache is."""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch import kernels
from repro_torch.configs import ArchConfig
from repro_torch.models.common import apply_norm, dense_init, init_norm
from repro_torch.models.rope import apply_rope


class MLACache(NamedTuple):
    latent: torch.Tensor   # (B, S, kv_lora_rank)
    k_rope: torch.Tensor   # (B, S, qk_rope_head_dim), shared by the heads
    length: torch.Tensor   # (B,) filled length


def init_mla_cache(batch: int, max_len: int, cfg: ArchConfig,
                   dtype: torch.dtype,
                   device: torch.device | str) -> MLACache:
    return MLACache(
        latent=torch.zeros(batch, max_len, cfg.kv_lora_rank, dtype=dtype,
                           device=device),
        k_rope=torch.zeros(batch, max_len, cfg.qk_rope_head_dim, dtype=dtype,
                           device=device),
        length=torch.zeros(batch, dtype=torch.int64, device=device))


def init_mla(cfg: ArchConfig, generator: torch.Generator,
             device: torch.device | str, dtype: torch.dtype) -> dict:
    d, h = cfg.d_model, cfg.num_heads
    nope, rdim = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    lora, vdim = cfg.kv_lora_rank, cfg.v_head_dim
    dense = lambda i, o: dense_init(i, o, generator, device, dtype)
    return {
        "wq_a": dense(d, cfg.q_lora_rank),
        "q_norm": init_norm(cfg.q_lora_rank, "rmsnorm", device, dtype),
        "wq_b": dense(cfg.q_lora_rank, h * (nope + rdim)),
        "wkv_a": dense(d, lora + rdim),
        "kv_norm": init_norm(lora, "rmsnorm", device, dtype),
        # stored split for the absorbed decode path
        "w_uk": dense(lora, h * nope),
        "w_uv": dense(lora, h * vdim),
        "wo": dense(h * vdim, d),
    }


def _project_q(p: dict, cfg: ArchConfig, x: torch.Tensor,
               positions: torch.Tensor):
    b, s, _ = x.shape
    nope = cfg.qk_nope_head_dim
    q = apply_norm(p["q_norm"], x @ p["wq_a"], "rmsnorm") @ p["wq_b"]
    q = q.reshape(b, s, cfg.num_heads, nope + cfg.qk_rope_head_dim)
    q_rope = apply_rope(q[..., nope:], positions, cfg.rope_theta)
    return q[..., :nope], q_rope


def _project_kv_latent(p: dict, cfg: ArchConfig, x: torch.Tensor,
                       positions: torch.Tensor):
    b, s, _ = x.shape
    lora = cfg.kv_lora_rank
    kv = x @ p["wkv_a"]
    latent = apply_norm(p["kv_norm"], kv[..., :lora], "rmsnorm")
    k_rope = kv[..., lora:].reshape(b, s, 1, cfg.qk_rope_head_dim)
    return latent, apply_rope(k_rope, positions, cfg.rope_theta)[:, :, 0]


def _decode(p: dict, cfg: ArchConfig, q_nope: torch.Tensor,
            q_rope: torch.Tensor, cache: MLACache,
            cur_pos: torch.Tensor) -> torch.Tensor:
    """Absorbed attention of one new token (B, 1, H, .) against the cache:
    scores in fp32 (JAX's ``preferred_element_type``), the weights cast to
    the cache's dtype for the product with the latents.  (B, 1, H v)."""
    b, h = q_nope.shape[0], cfg.num_heads
    lora, nope, vdim = cfg.kv_lora_rank, cfg.qk_nope_head_dim, cfg.v_head_dim
    scale = 1.0 / math.sqrt(nope + cfg.qk_rope_head_dim)
    q_lat = torch.einsum("bhd,lhd->bhl", q_nope[:, 0],
                         p["w_uk"].reshape(lora, h, nope))
    logits = torch.einsum("bhl,bsl->bhs", q_lat.float(),
                          cache.latent.float())
    logits = logits + torch.einsum("bhr,bsr->bhs", q_rope[:, 0].float(),
                                   cache.k_rope.float())
    logits = logits * scale
    kv_pos = torch.arange(cache.latent.shape[1], device=cur_pos.device)
    mask = kv_pos[None, :] <= cur_pos[:, None]
    logits = logits.masked_fill(~mask[:, None, :], -math.inf)
    w = torch.softmax(logits, dim=-1).to(cache.latent.dtype)
    out_lat = torch.einsum("bhs,bsl->bhl", w, cache.latent)
    out = torch.einsum("bhl,lhv->bhv", out_lat,
                       p["w_uv"].reshape(lora, h, vdim))
    return out.reshape(b, 1, h * vdim)


def apply_mla(p: dict, cfg: ArchConfig, x: torch.Tensor, *,
              positions: torch.Tensor, mode: str = "train",
              cache: Optional[MLACache] = None
              ) -> tuple[torch.Tensor, Optional[MLACache]]:
    """Causal MLA of x (B, S, d_model); in decode mode S is 1 and the new
    token's latent and k_rope go into ``cache`` first; in prefill mode the
    prompt's fill it."""
    b, s, _ = x.shape
    h, vdim = cfg.num_heads, cfg.v_head_dim
    q_nope, q_rope = _project_q(p, cfg, x, positions)
    latent, k_rope = _project_kv_latent(p, cfg, x, positions)

    if mode == "decode":
        if cache is None:
            raise ValueError("decode attention needs a cache")
        cur_pos = positions.reshape(b, -1)[:, -1]
        bidx = torch.arange(b, device=x.device)
        cache.latent[bidx, cur_pos] = latent[:, 0]
        cache.k_rope[bidx, cur_pos] = k_rope[:, 0]
        torch.maximum(cache.length, cur_pos + 1, out=cache.length)
        out = _decode(p, cfg, q_nope, q_rope, cache, cur_pos)
        return out @ p["wo"], cache

    # train / prefill: decompress the latent into per-head k_nope and v
    k_nope = (latent @ p["w_uk"]).reshape(b, s, h, cfg.qk_nope_head_dim)
    v = (latent @ p["w_uv"]).reshape(b, s, h, vdim)
    k_rope_h = k_rope[:, :, None, :].expand(b, s, h, cfg.qk_rope_head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope_h], dim=-1)
    out = kernels.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), causal=True)
    y = out.transpose(1, 2).reshape(b, s, h * vdim) @ p["wo"]

    if mode == "prefill" and cache is not None:
        smax = cache.latent.shape[1]
        n = min(s, smax)
        cache.latent[:, :n] = latent[:, s - n:]
        cache.k_rope[:, :n] = k_rope[:, s - n:]
        cache.length.fill_(n)
    return y, cache
