"""The split LMs (the JAX package's ``models/transformer.py``:
``DecoderLM`` with dense or MoE layers, GQA attention or MLA,
DeepSeek-style unscanned prefix layers, and vision inputs (patch
embeddings ahead of the text, M-RoPE); ``HybridMamba``, ``XLSTMModel`` and
the encoder-decoder ``EncDecModel``) and the port's model builder.

Parameters are ``{"bottom": ..., "top": ...}`` from construction:

  bottom = embeddings + the first ``cfg.split_layer`` blocks   (client)
  top    = the remaining blocks + final norm + LM head          (server)

Where JAX stacks a segment's layers on a leading axis and scans over them,
the port keeps a list of per-layer parameter dicts (``"stack"``, a
DeepSeek bottom's ``"prefix"``, or ``"groups"`` for xLSTM) and loops in
Python; ``convert.lm_params_from_numpy`` unstacks the JAX tree.  The
long-context window override is not ported."""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs import ArchConfig
from repro_torch.models import xlstm as xl
from repro_torch.models.attention import (KVCache, apply_attention,
                                          init_attention, init_kv_cache)
from repro_torch.models.common import (apply_mlp, apply_norm, dense_init,
                                       embed_init, init_mlp, init_norm)
from repro_torch.models.mla import apply_mla, init_mla, init_mla_cache
from repro_torch.models.moe import apply_moe, init_moe
from repro_torch.models.rope import (default_mrope_positions,
                                     default_positions)
from repro_torch.models.ssm import apply_ssm, init_ssm, init_ssm_cache


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _lm_logits(params: dict, x: torch.Tensor) -> torch.Tensor:
    return x @ params["lm_head"]


def _positions(batch_inputs: dict, b: int, s: int, device: torch.device,
               mrope: bool = False) -> torch.Tensor:
    """The batch's ``positions`` (its ``mrope_positions`` for M-RoPE),
    else (B, S) positions ((3, B, S) for M-RoPE) from its ``pos`` offset
    (0 by default)."""
    key = "mrope_positions" if mrope else "positions"
    if key in batch_inputs:
        return batch_inputs[key]
    off = batch_inputs.get("pos", 0)
    if mrope:
        return default_mrope_positions(b, s, off, device)
    return default_positions(s, off, device).expand(b, s)


def _no_aux(x: torch.Tensor) -> torch.Tensor:
    """The auxiliary loss of layers that have none: a zero fp32 scalar on
    x's device."""
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _remat(fn, *args):
    """``fn(*args)``, recomputed in the backward pass (non-reentrant
    ``torch.utils.checkpoint``).  The RNG state is not stashed: the stash
    reads and restores the device generator's state at every call, which
    a CUDA graph's capture need not allow, and no layer draws random
    numbers in training, so no number changes."""
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


# ===========================================================================
# Attention-family layer (GQA attention or MLA, cross-attention for the
# decoder of an encoder-decoder model; dense MLP or MoE)
# ===========================================================================

def _init_attn_layer(cfg: ArchConfig, idx: int, generator: torch.Generator,
                     device: torch.device | str, cross: bool = False) -> dict:
    """Layer ``idx``'s parameters: MLA where the config uses it, else
    attention; with ``cross``, a cross-attention block and its pre-norm
    (``cross_norm``, ``cross``); an MoE where ``cfg.moe`` makes layer
    ``idx`` one, else the dense MLP."""
    dt = _dtype(cfg)
    p = {"attn_norm": init_norm(cfg.d_model, cfg.norm, device, dt),
         "attn": (init_mla if cfg.use_mla else init_attention)(
             cfg, generator, device, dt)}
    if cross:
        p["cross_norm"] = init_norm(cfg.d_model, cfg.norm, device, dt)
        p["cross"] = init_attention(cfg, generator, device, dt)
    p["mlp_norm"] = init_norm(cfg.d_model, cfg.norm, device, dt)
    if cfg.moe is not None and cfg.moe.is_moe_layer(idx):
        p["moe"] = init_moe(cfg, generator, device, dt)
    else:
        p["mlp"] = init_mlp(cfg.d_model, cfg.d_ff, cfg.mlp_gated, generator,
                            device, dt)
    return p


def _apply_attn_layer(p: dict, cfg: ArchConfig, x: torch.Tensor, *,
                      positions: torch.Tensor, mode: str, cache,
                      causal: bool = True, cross_kv=None):
    """(x after the layer, its new cache, its aux loss: the MoE's
    load-balance loss, or None for a dense MLP, which has none).  Its
    self-attention is causal unless ``causal`` is False (MLA's always
    is); given ``cross_kv`` = (k, v), the layer then cross-attends to them
    (non-causal, through its ``cross`` block) before its MLP."""
    h = apply_norm(p["attn_norm"], x, cfg.norm)
    if cfg.use_mla:
        attn_out, new_cache = apply_mla(p["attn"], cfg, h,
                                        positions=positions, mode=mode,
                                        cache=cache)
    else:
        attn_out, new_cache = apply_attention(
            p["attn"], cfg, h, positions=positions, mode=mode, cache=cache,
            causal=causal)
    x = x + attn_out
    if cross_kv is not None:
        h = apply_norm(p["cross_norm"], x, cfg.norm)
        c_out, _ = apply_attention(p["cross"], cfg, h, positions=positions,
                                   mode=mode, cache=None, causal=False,
                                   kv_override=cross_kv)
        x = x + c_out
    h = apply_norm(p["mlp_norm"], x, cfg.norm)
    if "moe" in p:
        out, aux = apply_moe(p["moe"], cfg, h)
    else:
        out, aux = apply_mlp(p["mlp"], h, cfg.act, cfg.mlp_gated), None
    return x + out, new_cache, aux


def _run_attn_stack(stack: list, cfg: ArchConfig, x: torch.Tensor, *,
                    positions: torch.Tensor, mode: str,
                    caches: Optional[list], causal: bool = True,
                    cross_kv: Optional[list] = None):
    """Run x through a segment's layers in order; returns x, the new caches
    (None without caches) and the segment's aux loss, summed from a zero
    fp32 scalar in layer order as JAX's scan carries it.  ``cross_kv`` is
    each layer's (k, v) to cross-attend to (an encoder-decoder model's
    decoder), or None.  A train-mode pass that records gradients keeps
    only each layer's input (and its cross K/V) and recomputes the layer
    in the backward pass, as the JAX model's ``jax.checkpoint`` over its
    layer scan does (JAX's decoder scan keeps its activations): memory
    changes, the numbers do not."""
    new_caches = [] if caches is not None else None
    remat = mode == "train" and torch.is_grad_enabled()
    aux = _no_aux(x)
    for i, p_i in enumerate(stack):
        kv = (None, None) if cross_kv is None else cross_kv[i]
        if remat:
            x, aux_i = _remat(_train_layer, p_i, cfg, x, positions, causal,
                              *kv)
        else:
            x, c, aux_i = _apply_attn_layer(
                p_i, cfg, x, positions=positions, mode=mode,
                cache=None if caches is None else caches[i], causal=causal,
                cross_kv=None if cross_kv is None else kv)
            if new_caches is not None:
                new_caches.append(c)
        if aux_i is not None:
            aux = aux + aux_i
    return x, new_caches, aux


def _train_layer(p: dict, cfg: ArchConfig, x: torch.Tensor,
                 positions: torch.Tensor, causal: bool = True,
                 cross_k: Optional[torch.Tensor] = None,
                 cross_v: Optional[torch.Tensor] = None):
    """A layer in train mode: (x, aux loss or None)."""
    x, _, aux = _apply_attn_layer(
        p, cfg, x, positions=positions, mode="train", cache=None,
        causal=causal, cross_kv=None if cross_k is None else (cross_k,
                                                              cross_v))
    return x, aux


def _init_stacked_kv_cache(n: int, batch: int, max_len: int,
                           cfg: ArchConfig, device: torch.device | str
                           ) -> Optional[list]:
    """n layers' caches: :class:`MLACache` where the config uses MLA, else
    :class:`KVCache`; None for no layer."""
    if n == 0:
        return None
    if cfg.use_mla:
        return [init_mla_cache(batch, max_len, cfg, _dtype(cfg), device)
                for _ in range(n)]
    return [init_kv_cache(batch, max_len, cfg.num_kv_heads,
                          cfg.resolved_head_dim, cfg.sliding_window or 0,
                          _dtype(cfg), device) for _ in range(n)]


# ===========================================================================
# Model
# ===========================================================================

class DecoderLM:
    """Decoder-only LM with dense or MoE layers and GQA attention or MLA,
    split at ``max(cfg.split_layer, prefix_n)``.  A DeepSeek-style model
    (``cfg.moe.first_moe_layer`` > 0) keeps its first layers, with the
    dense MLP, as a bottom ``"prefix"`` segment apart from the ``"stack"``
    (JAX's unscanned prefix layers); a segment's layers are all built as
    its first layer's index says, as JAX's stacked segments are.  A vision
    model (``cfg.modality == "vision"``: Qwen2-VL) puts a batch's
    ``patch_embeds`` (B, P, d_model) ahead of its token embeddings and
    takes its ``mrope_positions`` (3, B, P + S) for M-RoPE."""

    def __init__(self, cfg: ArchConfig):
        self.cfg = cfg
        self.prefix_n = (cfg.moe.first_moe_layer
                         if cfg.moe is not None else 0)
        self.split = max(cfg.split_layer, self.prefix_n)

    # -- init ---------------------------------------------------------------
    def init(self, generator: torch.Generator,
             device: torch.device | str) -> dict:
        """Parameters drawn from ``generator`` (in fp32 on its device), in
        ``cfg.dtype`` on ``device`` but for the fp32 MoE routers."""
        cfg = self.cfg
        dt = _dtype(cfg)
        n_b = self.split - self.prefix_n
        n_t = cfg.num_layers - self.split
        layers = lambda n, idx: [_init_attn_layer(cfg, idx, generator, device)
                                 for _ in range(n)]
        bottom = {"embed": embed_init(cfg.vocab_size, cfg.d_model, generator,
                                      device, dt)}
        if self.prefix_n:
            bottom["prefix"] = layers(self.prefix_n, 0)
        bottom["stack"] = layers(n_b, self.prefix_n)
        top = {"stack": layers(n_t, self.split),
               "final_norm": init_norm(cfg.d_model, cfg.norm, device, dt),
               "lm_head": dense_init(cfg.d_model, cfg.vocab_size, generator,
                                     device, dt)}
        return {"bottom": bottom, "top": top}

    # -- caches ---------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int,
                   device: torch.device | str) -> dict:
        """Each segment's list of per-layer caches (None for an empty
        segment); a prefix model's bottom also has its ``"prefix"``."""
        cfg = self.cfg
        seg = lambda n: _init_stacked_kv_cache(n, batch, max_len, cfg,
                                               device)
        bottom = {"stack": seg(self.split - self.prefix_n)}
        if self.prefix_n:
            bottom["prefix"] = seg(self.prefix_n)
        return {"bottom": bottom,
                "top": {"stack": seg(cfg.num_layers - self.split)}}

    # -- apply -------------------------------------------------------------
    def bottom_apply(self, params: dict, batch_inputs: dict, *,
                     mode: str = "train", cache: Optional[dict] = None):
        """Client side: embed the tokens (behind the patch embeddings of a
        vision model) and run the prefix and bottom layers.  Returns
        (features, new cache, extras for ``top_apply``: the positions and
        the bottom's aux loss)."""
        tokens = batch_inputs["tokens"]
        x = params["embed"][tokens]
        if self.cfg.modality == "vision" and "patch_embeds" in batch_inputs:
            x = torch.cat([batch_inputs["patch_embeds"].to(x.dtype), x],
                          dim=1)
        b, s = x.shape[:2]
        positions = _positions(batch_inputs, b, s, tokens.device,
                               self.cfg.rope_kind == "mrope")
        cache = cache or {}
        new_cache = {}
        aux = None
        for seg in ("prefix", "stack"):
            if seg not in params:
                continue
            x, new_cache[seg], aux_s = _run_attn_stack(
                params[seg], self.cfg, x, positions=positions, mode=mode,
                caches=cache.get(seg))
            aux = aux_s if aux is None else aux + aux_s
        return x, new_cache, {"positions": positions, "aux_loss": aux}

    def top_apply(self, params: dict, features: torch.Tensor, *,
                  extras: dict, mode: str = "train",
                  cache: Optional[dict] = None):
        """Server side: the top layers, the final norm and the LM head.
        ``aux_loss`` is the top's plus the bottom's (``extras``), fp32: the
        MoE layers' load-balance losses, zero for dense layers, as in
        JAX."""
        cfg = self.cfg
        cache = cache or {"stack": None}
        x, new_stack_cache, aux = _run_attn_stack(
            params["stack"], cfg, features, positions=extras["positions"],
            mode=mode, caches=cache.get("stack"))
        x = apply_norm(params["final_norm"], x, cfg.norm)
        out = {"logits": _lm_logits(params, x),
               "aux_loss": aux + extras.get("aux_loss", 0.0)}
        return out, {"stack": new_stack_cache}


class HybridMamba(DecoderLM):
    """zamba2: Mamba2 layers, with one weight-shared attention + MLP block
    applied after every ``shared_attn_period``-th layer.  ``stack`` is a
    list of per-layer ``{"norm", "ssm"}``; each side of the split owns its
    replica of the shared block (``shared_attn``), untied across the split
    as in JAX.  A segment's cache is ``{"ssm": [SSMCache per layer],
    "shared_kv": [KVCache per application of the shared block]}``."""

    def __init__(self, cfg: ArchConfig):
        self.cfg = cfg
        # snap the split to a period boundary so that each side applies the
        # shared block a whole number of times
        per = self._period()
        self.split = max(per, (cfg.split_layer // per) * per)
        self.split = min(self.split, max(per, cfg.num_layers - per))

    def _period(self) -> int:
        return self.cfg.shared_attn_period or self.cfg.num_layers

    def _init_mamba_stack(self, n: int, generator: torch.Generator,
                          device: torch.device | str) -> list:
        cfg, dt = self.cfg, _dtype(self.cfg)
        return [{"norm": init_norm(cfg.d_model, cfg.norm, device, dt),
                 "ssm": init_ssm(cfg, generator, device, dt)}
                for _ in range(n)]

    def init(self, generator: torch.Generator,
             device: torch.device | str) -> dict:
        """Parameters drawn from ``generator`` (in fp32 on its device), in
        ``cfg.dtype`` on ``device`` but for the fp32 ``A_log``, ``D`` and
        ``dt_bias`` of each Mamba2 layer."""
        cfg = self.cfg
        dt = _dtype(cfg)
        n_b, n_t = self.split, cfg.num_layers - self.split
        bottom = {"embed": embed_init(cfg.vocab_size, cfg.d_model, generator,
                                      device, dt),
                  "stack": self._init_mamba_stack(n_b, generator, device),
                  "shared_attn": _init_attn_layer(cfg, 0, generator, device)}
        top = {"stack": self._init_mamba_stack(n_t, generator, device),
               "shared_attn": _init_attn_layer(cfg, 0, generator, device),
               "final_norm": init_norm(cfg.d_model, cfg.norm, device, dt),
               "lm_head": dense_init(cfg.d_model, cfg.vocab_size, generator,
                                     device, dt)}
        return {"bottom": bottom, "top": top}

    def _seg_cache(self, n: int, batch: int, max_len: int,
                   device: torch.device | str) -> dict:
        cfg = self.cfg
        n_apps = n // self._period()
        return {"ssm": [init_ssm_cache(batch, cfg, _dtype(cfg), device)
                        for _ in range(n)],
                "shared_kv": _init_stacked_kv_cache(max(n_apps, 1), batch,
                                                    max_len, cfg, device)}

    def init_cache(self, batch: int, max_len: int,
                   device: torch.device | str) -> dict:
        """Each segment's SSM caches and shared-block KV caches (the
        long-context ring buffers are not ported)."""
        n_b, n_t = self.split, self.cfg.num_layers - self.split
        return {"bottom": self._seg_cache(n_b, batch, max_len, device),
                "top": self._seg_cache(n_t, batch, max_len, device)}

    def _run_segment(self, params: dict, x: torch.Tensor, *,
                     positions: torch.Tensor, mode: str,
                     cache: Optional[dict], layer0: int):
        """Run x through a segment's Mamba2 layers, applying the shared
        block after every ``period``-th layer of the whole model.  A
        train-mode pass that records gradients keeps only the input of each
        Mamba2 layer and of each application of the shared block, and
        recomputes it in the backward pass, as the JAX model's
        ``jax.checkpoint`` over its layer body does (the numbers do not
        change); train mode returns the SSM caches it was given, as JAX
        does."""
        cfg = self.cfg
        per = self._period()
        n = len(params["stack"])
        cache = cache or {}
        ssm_caches = cache.get("ssm") or [
            init_ssm_cache(x.shape[0], cfg, _dtype(cfg), x.device)
            for _ in range(n)]
        shared_kv = cache.get("shared_kv")
        remat = mode == "train" and torch.is_grad_enabled()
        new_ssm = []
        for idx, p_i in enumerate(params["stack"]):
            if remat:
                x = _remat(_train_block, _apply_mamba_layer, p_i, cfg, x,
                           None)
                new_ssm.append(ssm_caches[idx])
            else:
                x, c = _apply_mamba_layer(p_i, cfg, x, mode=mode,
                                          cache=ssm_caches[idx])
                new_ssm.append(c)
            if (layer0 + idx + 1) % per == 0:
                app = (layer0 + idx + 1) // per - 1 - layer0 // per
                # the JAX model's do_shared: the same computation as an
                # attention layer with a dense MLP
                if remat:
                    x = _remat(_train_layer, params["shared_attn"], cfg, x,
                               positions)[0]
                    continue
                x, kv, _ = _apply_attn_layer(
                    params["shared_attn"], cfg, x, positions=positions,
                    mode=mode,
                    cache=None if shared_kv is None else shared_kv[app])
                if shared_kv is not None:
                    shared_kv[app] = kv
        return x, {"ssm": new_ssm, "shared_kv": shared_kv}

    def bottom_apply(self, params: dict, batch_inputs: dict, *,
                     mode: str = "train", cache: Optional[dict] = None):
        """Client side: embed the tokens and run the bottom layers."""
        tokens = batch_inputs["tokens"]
        b, s = tokens.shape
        x = params["embed"][tokens]
        positions = _positions(batch_inputs, b, s, tokens.device)
        x, new_cache = self._run_segment(params, x, positions=positions,
                                         mode=mode, cache=cache, layer0=0)
        return x, new_cache, {"positions": positions,
                              "aux_loss": _no_aux(x)}

    def top_apply(self, params: dict, features: torch.Tensor, *,
                  extras: dict, mode: str = "train",
                  cache: Optional[dict] = None):
        """Server side: the top layers, the final norm and the LM head.
        ``aux_loss`` is the bottom's (``extras``): Mamba2 layers and the
        shared block have none, so it is a zero fp32 scalar, as in JAX."""
        x, new_cache = self._run_segment(
            params, features, positions=extras["positions"], mode=mode,
            cache=cache, layer0=self.split)
        x = apply_norm(params["final_norm"], x, self.cfg.norm)
        return {"logits": _lm_logits(params, x),
                "aux_loss": _no_aux(x) + extras.get("aux_loss", 0.0)}, \
            new_cache


def _apply_mamba_layer(p: dict, cfg: ArchConfig, x: torch.Tensor, *,
                       mode: str, cache):
    """A Mamba2 layer with its pre-norm and residual: (x, new SSM cache)."""
    out, c = apply_ssm(p["ssm"], cfg, apply_norm(p["norm"], x, cfg.norm),
                       mode=mode, cache=cache)
    return x + out, c


def _train_block(apply, p: dict, cfg: ArchConfig, x: torch.Tensor,
                 cache) -> torch.Tensor:
    return apply(p, cfg, x, mode="train", cache=cache)[0]


class XLSTMModel:
    """xlstm-1.3b: groups of (period - 1) mLSTM blocks + 1 sLSTM block, the
    split snapped to a group boundary.  ``groups`` is a list of per-group
    dicts ``{"mlstm": [per-block params], "slstm": params}``; the caches
    follow the same structure.  The blocks take no positions; the extras
    carry them (and a zero aux loss) as the JAX model's do."""

    def __init__(self, cfg: ArchConfig):
        self.cfg = cfg
        per = cfg.xlstm.slstm_period
        self.n_groups = cfg.num_layers // per
        g = max(1, round(cfg.split_layer / per))
        self.split_groups = min(g, self.n_groups - 1)
        self.split = self.split_groups * per

    def _init_groups(self, n: int, generator: torch.Generator,
                     device: torch.device | str) -> list:
        cfg, dt = self.cfg, _dtype(self.cfg)
        per = cfg.xlstm.slstm_period
        return [{"mlstm": [xl.init_mlstm(cfg, generator, device, dt)
                           for _ in range(per - 1)],
                 "slstm": xl.init_slstm(cfg, generator, device, dt)}
                for _ in range(n)]

    def init(self, generator: torch.Generator,
             device: torch.device | str) -> dict:
        """Parameters drawn from ``generator`` (in fp32 on its device), in
        ``cfg.dtype`` on ``device`` but for the fp32 sLSTM ``w``, ``r`` and
        ``b`` and mLSTM ``w_if`` and ``b_if``."""
        cfg = self.cfg
        dt = _dtype(cfg)
        bottom = {"embed": embed_init(cfg.vocab_size, cfg.d_model, generator,
                                      device, dt),
                  "groups": self._init_groups(self.split_groups, generator,
                                              device)}
        top = {"groups": self._init_groups(self.n_groups - self.split_groups,
                                           generator, device),
               "final_norm": init_norm(cfg.d_model, cfg.norm, device, dt),
               "lm_head": dense_init(cfg.d_model, cfg.vocab_size, generator,
                                     device, dt)}
        return {"bottom": bottom, "top": top}

    def _group_cache(self, n: int, batch: int,
                     device: torch.device | str) -> dict:
        cfg = self.cfg
        per = cfg.xlstm.slstm_period
        return {"groups": [
            {"mlstm": [xl.init_mlstm_cache(batch, cfg, device)
                       for _ in range(per - 1)],
             "slstm": xl.init_slstm_cache(batch, cfg, device)}
            for _ in range(n)]}

    def init_cache(self, batch: int, max_len: int,
                   device: torch.device | str) -> dict:
        """The recurrent state of every block; its size does not depend on
        ``max_len``."""
        return {
            "bottom": self._group_cache(self.split_groups, batch, device),
            "top": self._group_cache(self.n_groups - self.split_groups, batch,
                                     device),
        }

    def _run_groups(self, groups: list, x: torch.Tensor, *, mode: str,
                    cache: Optional[dict]):
        """Run x through the groups in order.  A train-mode pass that
        records gradients keeps only each block's input and recomputes
        the block in the backward pass, so each group is recomputed as the
        JAX model's ``jax.checkpoint`` over its group scan recomputes it
        (the numbers do not change).  JAX keeps a group's input; here a
        block's, as the dense stack keeps a layer's: a group's recompute
        holds the mLSTM chunk loop's saved tensors of all its blocks at
        once, and at xLSTM-1.3B's top (7 mLSTM blocks, 4 x 4096 tokens)
        that ran the step out of an 80 GB card.  Train mode returns the
        caches it was given, as JAX does."""
        cfg = self.cfg
        if cache is None:
            cache = self._group_cache(len(groups), x.shape[0], x.device)
        new_groups = []
        for g_p, g_c in zip(groups, cache["groups"]):
            if mode == "train" and torch.is_grad_enabled():
                for m_p, m_c in zip(g_p["mlstm"], g_c["mlstm"]):
                    x = _remat(_train_block, xl.apply_mlstm_block, m_p,
                               cfg, x, m_c)
                x = _remat(_train_block, xl.apply_slstm_block, g_p["slstm"],
                           cfg, x, g_c["slstm"])
                new_groups.append(g_c)
                continue
            new_m = []
            for m_p, m_c in zip(g_p["mlstm"], g_c["mlstm"]):
                x, c = xl.apply_mlstm_block(m_p, cfg, x, mode=mode, cache=m_c)
                new_m.append(c)
            x, new_s = xl.apply_slstm_block(g_p["slstm"], cfg, x, mode=mode,
                                            cache=g_c["slstm"])
            new_groups.append({"mlstm": new_m, "slstm": new_s})
        return x, {"groups": new_groups}

    def bottom_apply(self, params: dict, batch_inputs: dict, *,
                     mode: str = "train", cache: Optional[dict] = None):
        """Client side: embed the tokens and run the bottom groups.
        Returns (features, new cache, extras for ``top_apply``)."""
        tokens = batch_inputs["tokens"]
        b, s = tokens.shape
        x = params["embed"][tokens]
        x, new_cache = self._run_groups(params["groups"], x, mode=mode,
                                        cache=cache)
        return x, new_cache, {"aux_loss": _no_aux(x),
                              "positions": _positions(batch_inputs, b, s,
                                                      tokens.device)}

    def top_apply(self, params: dict, features: torch.Tensor, *,
                  extras: dict, mode: str = "train",
                  cache: Optional[dict] = None):
        """Server side: the top groups, the final norm and the LM head.
        ``aux_loss`` is the bottom's (``extras``): xLSTM blocks have none,
        so it is a zero fp32 scalar, as in JAX."""
        x, new_cache = self._run_groups(params["groups"], features, mode=mode,
                                        cache=cache)
        x = apply_norm(params["final_norm"], x, self.cfg.norm)
        return {"logits": _lm_logits(params, x),
                "aux_loss": _no_aux(x) + extras.get("aux_loss", 0.0)}, \
            new_cache


class EncDecModel:
    """seamless-m4t: a non-causal encoder over frame embeddings (the audio
    frontend a stub) and a causal decoder whose layers cross-attend to the
    encoder's output; the split lies inside the encoder, at
    ``min(max(1, n_enc // 2), n_enc - 1)`` layers.

      bottom = ``frame_proj`` + the first ``split`` encoder layers
      top    = the other encoder layers, ``enc_norm``, the decoder
               (``dec_embed``, ``dec_stack`` of cross-attending layers),
               ``final_norm`` and the LM head

    The top computes every decoder layer's cross K/V from the encoder's
    output once.  Serving: the prefill writes them into the cache's
    ``cross_k`` / ``cross_v`` (L, B, max_len, KVH, hd) from row 0 and the
    decoder's self-attention caches (``dec_self``, a list of
    :class:`KVCache` of ``min(max_len, 4096)`` slots); a decode step runs
    the top only (the client is idle and hands no features).  As in JAX,
    the decoder cross-attends to the whole ``max_len`` buffer in the
    prefill and in decode, its rows past the S written included (zeros),
    so the result depends on ``max_len``: the reference's behaviour, kept
    here as it is."""

    def __init__(self, cfg: ArchConfig):
        self.cfg = cfg
        n_enc = cfg.num_encoder_layers
        self.split = min(max(1, n_enc // 2), n_enc - 1)

    def init(self, generator: torch.Generator,
             device: torch.device | str) -> dict:
        """Parameters drawn from ``generator`` (in fp32 on its device), in
        ``cfg.dtype`` on ``device``."""
        cfg = self.cfg
        dt = _dtype(cfg)
        layers = lambda n, idx, cross=False: [
            _init_attn_layer(cfg, idx, generator, device, cross)
            for _ in range(n)]
        bottom = {"frame_proj": dense_init(cfg.d_model, cfg.d_model,
                                           generator, device, dt),
                  "stack": layers(self.split, 0)}
        top = {"stack": layers(cfg.num_encoder_layers - self.split,
                               self.split),
               "enc_norm": init_norm(cfg.d_model, cfg.norm, device, dt),
               "dec_embed": embed_init(cfg.vocab_size, cfg.d_model,
                                       generator, device, dt),
               "dec_stack": layers(cfg.num_layers, 0, True),
               "final_norm": init_norm(cfg.d_model, cfg.norm, device, dt),
               "lm_head": dense_init(cfg.d_model, cfg.vocab_size, generator,
                                     device, dt)}
        return {"bottom": bottom, "top": top}

    def init_cache(self, batch: int, max_len: int,
                   device: torch.device | str) -> dict:
        """The top's decoder self-attention caches (``min(max_len, 4096)``
        slots, the generated length's budget) and the cross K/V of every
        decoder layer over ``max_len`` encoder rows; the bottom keeps
        none."""
        cfg = self.cfg
        shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads,
                 cfg.resolved_head_dim)
        zeros = lambda: torch.zeros(shape, dtype=_dtype(cfg), device=device)
        return {"bottom": None,
                "top": {"dec_self": _init_stacked_kv_cache(
                    cfg.num_layers, batch, min(max_len, 4096), cfg, device),
                        "cross_k": zeros(), "cross_v": zeros()}}

    def bottom_apply(self, params: dict, batch_inputs: dict, *,
                     mode: str = "train", cache=None):
        """Client side: project the (B, S, d_model) ``frames`` and run the
        bottom encoder layers (non-causal, positions 0 .. S - 1, each
        layer in train mode whatever ``mode`` is, as JAX).  In decode the
        client is idle: it hands on the batch's ``frames`` (None) and
        positions."""
        cfg = self.cfg
        if mode == "decode":
            tokens = batch_inputs["tokens"]
            pos = _positions(batch_inputs, *tokens.shape, tokens.device)
            return batch_inputs.get("frames"), cache, {
                "aux_loss": _no_aux(pos), "positions": pos}
        frames = batch_inputs["frames"]
        b, s, _ = frames.shape
        x = frames.to(_dtype(cfg)) @ params["frame_proj"]
        positions = default_positions(s, 0, frames.device).expand(b, s)
        x, _, aux = _run_attn_stack(params["stack"], cfg, x,
                                    positions=positions, mode="train",
                                    caches=None, causal=False)
        return x, None, {"aux_loss": aux, "positions": positions}

    def _cross_kv(self, p: dict, enc: torch.Tensor):
        """A decoder layer's cross K/V (B, S, KVH, hd) of the encoder's
        output: its ``cross`` block's key and value projections, with no
        bias, norm or rotary embedding, as in JAX."""
        cfg = self.cfg
        shape = enc.shape[:2] + (cfg.num_kv_heads, cfg.resolved_head_dim)
        return ((enc @ p["cross"]["wk"]).reshape(shape),
                (enc @ p["cross"]["wv"]).reshape(shape))

    def top_apply(self, params: dict, features, *, extras: dict,
                  mode: str = "train", cache: Optional[dict] = None):
        """Server side.  Train and prefill: the top encoder layers
        (non-causal), ``enc_norm``, each decoder layer's cross K/V, then
        the decoder over ``extras["dec_tokens"]`` (B, T) at positions 0 ..
        T - 1; a prefill with a cache writes the cross K/V into it and
        fills the decoder's self-attention caches.  Decode: the decoder
        alone, one token at ``extras["positions"]``, over the cached cross
        K/V.  ``aux_loss`` sums the top's, the decoder's and the bottom's
        (zero without MoE)."""
        cfg = self.cfg
        dev = extras["dec_tokens"].device
        if mode != "decode":
            enc, _, aux = _run_attn_stack(
                params["stack"], cfg, features,
                positions=extras["positions"], mode="train", caches=None,
                causal=False)
            enc = apply_norm(params["enc_norm"], enc, cfg.norm)
            cross = [self._cross_kv(p_i, enc) for p_i in params["dec_stack"]]
            tgt = extras["dec_tokens"]
            y = params["dec_embed"][tgt]
            dpos = default_positions(tgt.shape[1], 0, dev).expand(tgt.shape)
            if mode == "prefill" and cache is not None:
                s = enc.shape[1]
                for i, (k, v) in enumerate(cross):
                    cache["cross_k"][i, :, :s] = k
                    cache["cross_v"][i, :, :s] = v
                cross = list(zip(cache["cross_k"], cache["cross_v"]))
                dec_cache = cache["dec_self"]
            else:
                dec_cache = None
            mode_dec = "prefill" if mode == "prefill" else "train"
            y, new_self, aux2 = _run_attn_stack(
                params["dec_stack"], cfg, y, positions=dpos, mode=mode_dec,
                caches=dec_cache, cross_kv=cross)
        else:
            y = params["dec_embed"][extras["dec_tokens"]]
            y, new_self, aux2 = _run_attn_stack(
                params["dec_stack"], cfg, y, positions=extras["positions"],
                mode="decode", caches=cache["dec_self"],
                cross_kv=list(zip(cache["cross_k"], cache["cross_v"])))
            aux = _no_aux(y)
        y = apply_norm(params["final_norm"], y, cfg.norm)
        out = {"logits": _lm_logits(params, y),
               "aux_loss": aux + aux2 + extras.get("aux_loss", 0.0)}
        new_cache = None if cache is None else dict(cache, dec_self=new_self)
        return out, new_cache


def build_model(cfg: ArchConfig):
    """The model class of ``cfg``, as the JAX package's builder picks it:
    the paper's CNNs, the encoder-decoder model, the Zamba2 hybrid, xLSTM,
    else the decoder LM (dense, MoE, vision)."""
    if cfg.arch_type == "cnn":
        from repro_torch.models.cnn import CNNModel
        return CNNModel(cfg)
    if cfg.is_encoder_decoder:
        return EncDecModel(cfg)
    if cfg.block_kind == "mamba2":
        return HybridMamba(cfg)
    if cfg.block_kind == "xlstm":
        return XLSTMModel(cfg)
    return DecoderLM(cfg)
