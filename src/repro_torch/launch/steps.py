"""Split-inference serving steps of the decoder LMs (dense, xLSTM and the
Zamba2 hybrid): the JAX package's ``launch/steps.py::make_prefill_step``
and ``make_decode_step`` as plain functions, with no step plan, mesh or
sharding.

Each step runs the bottom (client) half, hands its features to the top
(server) half, and returns the cache of both halves.  KV caches (the dense
model's, Zamba2's shared block's) are written in place
(``models/attention.py``); the recurrent states of xLSTM and of Zamba2's
Mamba2 layers are returned anew.  xLSTM takes no positions and ignores the
decode step's."""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs import ArchConfig
from repro_torch.models.transformer import build_model


def make_prefill_step(cfg: ArchConfig) -> Callable:
    """``step(params, batch, cache) -> (last-position logits (B, V), cache)``
    for a batch ``{"tokens": (B, S)}`` of prompts."""
    model = build_model(cfg)

    @torch.inference_mode()
    def step(params: dict, batch: dict, cache: dict):
        feats, cache_b, extras = model.bottom_apply(
            params["bottom"], dict(batch), mode="prefill",
            cache=cache.get("bottom"))
        out, cache_t = model.top_apply(params["top"], feats, extras=extras,
                                       mode="prefill", cache=cache.get("top"))
        return out["logits"][:, -1], {"bottom": cache_b, "top": cache_t}

    return step


def make_decode_step(cfg: ArchConfig) -> Callable:
    """``step(params, batch, cache) -> (greedy next token (B,), cache)`` for
    a batch ``{"tokens": (B, 1), "pos": (B,)}`` of one token per sequence
    at absolute position ``pos``."""
    model = build_model(cfg)

    @torch.inference_mode()
    def step(params: dict, batch: dict, cache: dict):
        binputs = {"tokens": batch["tokens"],
                   "positions": batch["pos"][:, None]}
        feats, cache_b, extras = model.bottom_apply(
            params["bottom"], binputs, mode="decode",
            cache=cache.get("bottom"))
        out, cache_t = model.top_apply(params["top"], feats, extras=extras,
                                       mode="decode", cache=cache.get("top"))
        next_tok = out["logits"][:, -1].argmax(-1)
        return next_tok, {"bottom": cache_b, "top": cache_t}

    return step
