"""Split-inference serving launcher for the PyTorch port: batched prefill
then greedy decode through the bottom (client) / top (server) split of an
LM, dense (``qwen3-14b``), MoE with MLA and a dense prefix layer
(``deepseek-v2-236b``), MoE with a dense residual (``arctic-480b``),
vision with M-RoPE (``qwen2-vl-7b``), xLSTM (``xlstm-1.3b``), the Mamba2
hybrid (``zamba2-7b``) or encoder-decoder (``seamless-m4t-medium``) (the
JAX package's ``launch/serve.py``), on the card unless ``device="cpu"`` is
asked for:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b \
      --tokens 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v2-236b \
      --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-1.3b \
      --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \
      --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-vl-7b \
      --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch seamless-m4t-medium --device cpu

``serve`` keeps the JAX launcher's defaults (the smoke config of the
arch); ``serve_config`` runs any ``ArchConfig``, the full one included."""
from __future__ import annotations

import argparse
import time
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.configs import ArchConfig, smoke_config
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models.rope import default_mrope_positions
from repro_torch.models.transformer import build_model

# the stub frontend's patch embeddings ahead of a vision prompt, and the
# decoder tokens an encoder-decoder prefill starts from, as the JAX launcher
# draws them
PATCHES = DEC_TOKENS = 8


class ServeResult(NamedTuple):
    tokens: np.ndarray           # (B, gen_tokens) greedy token ids
    logits: torch.Tensor         # (B, V) last-position logits of the prefill
    prefill_s: float             # host wall time of the prefill
    decode_s: float              # host wall time of the decode steps


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve_config(cfg: ArchConfig, batch: int = 4, prompt_len: int = 32,
                 gen_tokens: int = 16, seed: int = 0, *,
                 params: Optional[dict] = None, device: str = "cuda",
                 log=print) -> ServeResult:
    """Prefill a batch of prompts, then decode ``gen_tokens - 1`` greedy
    steps.  The inputs come from ``np.random.RandomState(seed)`` as the
    JAX launcher draws them: prompt tokens; for a vision model also
    PATCHES ``randn`` patch embeddings ahead of them, with text-only M-RoPE
    positions over all of them; for an encoder-decoder model ``randn``
    frames of ``prompt_len`` and DEC_TOKENS zero decoder tokens instead.
    The decode positions are JAX's too: from ``prompt_len`` (DEC_TOKENS
    for an encoder-decoder model), so that a vision model's first decode
    steps take the positions, and the cache slots, of its last prompt
    tokens, as the JAX launcher does.  The weights are ``params`` or, when
    none are given, drawn on ``device`` from ``torch.Generator`` seed
    ``seed``.  Raises if a generated token is NaN, as the JAX launcher
    asserts."""
    dev = resolve_device(device)
    model = build_model(cfg)
    if params is None:
        params = model.init(torch.Generator(dev).manual_seed(seed), dev)
    cache = model.init_cache(batch, prompt_len + gen_tokens, dev)
    prefill = make_prefill_step(cfg)
    decode = make_decode_step(cfg)

    rng = np.random.RandomState(seed)
    host = lambda a: torch.from_numpy(a).to(dev)
    if cfg.is_encoder_decoder:
        batch_in = {"frames": host(rng.randn(batch, prompt_len, cfg.d_model)
                                   .astype(np.float32)),
                    "dec_tokens": torch.zeros((batch, DEC_TOKENS),
                                              dtype=torch.int64, device=dev)}
    else:
        batch_in = {"tokens": host(rng.randint(0, cfg.vocab_size,
                                               (batch, prompt_len)))}
        if cfg.modality == "vision":
            batch_in["patch_embeds"] = host(rng.randn(
                batch, PATCHES, cfg.d_model).astype(np.float32))
            batch_in["mrope_positions"] = default_mrope_positions(
                batch, prompt_len + PATCHES, 0, dev)
    pos0 = DEC_TOKENS if cfg.is_encoder_decoder else prompt_len

    # the spans mark the two phases in a torch.profiler trace
    with record_function("serve.prefill"):
        t0 = time.perf_counter()
        logits, cache = prefill(params, batch_in, cache)
        next_tok = logits.argmax(-1)
        _sync(dev)
        prefill_s = time.perf_counter() - t0
    log(f"prefill: batch={batch} len={prompt_len} ({prefill_s:.2f}s)")

    out_tokens = [next_tok]
    with record_function("serve.decode"):
        t0 = time.perf_counter()
        for i in range(gen_tokens - 1):
            step_batch = {"tokens": next_tok[:, None],
                          "pos": torch.full((batch,), pos0 + i,
                                            dtype=torch.int64, device=dev)}
            if cfg.rope_kind == "mrope":
                step_batch["mrope_positions"] = torch.full(
                    (3, batch, 1), pos0 + i, dtype=torch.int64, device=dev)
            next_tok, cache = decode(params, step_batch, cache)
            out_tokens.append(next_tok)
        toks = torch.stack(out_tokens, 1).cpu().numpy()
        decode_s = time.perf_counter() - t0
    log(f"decode: {gen_tokens - 1} steps in {decode_s:.2f}s "
        f"({(gen_tokens - 1) * batch / max(decode_s, 1e-9):.1f} tok/s)")
    if np.any(np.isnan(toks.astype(np.float64))):
        raise FloatingPointError("serving generated a NaN token")
    return ServeResult(toks, logits, prefill_s, decode_s)


def serve(arch: str = "qwen3-14b", batch: int = 4, prompt_len: int = 32,
          gen_tokens: int = 16, seed: int = 0, *, device: str = "cuda",
          log=print) -> np.ndarray:
    """The JAX launcher's ``serve``: the smoke config of ``arch``; returns
    the (B, gen_tokens) generated token ids."""
    return serve_config(smoke_config(arch), batch, prompt_len, gen_tokens,
                        seed, device=device, log=log).tokens


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-14b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    toks = serve(args.arch, args.batch, args.prompt_len, args.tokens,
                 device=args.device)
    print("generated token ids (first sequence):", toks[0][:16].tolist())


if __name__ == "__main__":
    main()
