"""Step builders of the LMs: the JAX package's ``launch/steps.py`` without
mesh or sharding.

  * ``make_train_step``: one SemiSFL cross-entity iteration on a decoder
    LM (dense or MoE layers, GQA attention or MLA: DeepSeek-V2's dense
    prefix layer and MLA + MoE layers, Arctic's MoE with a dense
    residual; the vision decoder, Qwen2-VL), on xLSTM, on the Zamba2
    hybrid or on the encoder-decoder model (SeamlessM4T)
    (``make_train_step(plan, dist, lr, wire=..., mesh=None)`` in JAX, its
    MoE on the dense path), with ``StepPlan`` / ``make_plan``, the state's
    and batch's shapes (the train branch of ``input_specs``) and a seeded
    initial state;
  * ``make_scanned_train_phase`` / ``make_prefetched_train_phase``: K
    steps as one CUDA graph of the step replayed K times, the state
    donated (``core/scan.py``), and that phase fed by the prefetch
    worker, as JAX's; ``make_train_phase`` is the same K steps as an eager
    loop, what the graph is held to;
  * ``make_prefill_step`` / ``make_decode_step``: split-inference serving
    of the dense, MoE/MLA (DeepSeek-V2, Arctic), vision, xLSTM, Zamba2 and
    encoder-decoder models.

Training.  The state is a dict ``{"client_bottoms", "teacher_bottoms",
"top", "t_top", "proj", "t_proj", "queue"}`` where JAX stacks the N clients'
bottoms on a leading axis; here ``client_bottoms`` and ``teacher_bottoms``
are lists of N bottom trees, each with a list of layers (``stack``; the
hybrid's Mamba2 layers, beside its ``shared_attn`` block) or of xLSTM groups
(``groups``) where JAX stacks them on a leading axis
(``convert.lm_train_state_from_numpy`` unstacks the JAX state).  A batch is
``{"tokens_weak", "tokens_strong"}``, each (N, b, S); a vision model's
also has ``patch_embeds`` (N, b, P, d_model) and ``mrope_positions`` (N,
3, b, P + S), both views' (the tokens then fill S - P of train_4k's S); an
encoder-decoder model's is ``{"frames_weak", "frames_strong"}`` (N, b, S,
d_model) and ``dec_tokens`` (N, b, min(S, 1024)) (``train_batch_shapes``
gives them all).  The clients' bottoms run one after another, where JAX
vmaps them, and each client's gradient is rescaled by N (Eq. (8)), as
``core/engine.py`` does for the CNNs.  On the
card attention differentiates through the flash kernels
(``kernels.FlashAttention``, MLA's at its (192, 128) head dims), the
sLSTM through its scan kernels (``kernels.slstm_scan``'s ``SLSTMScan``)
and the Mamba2 scan through its (``kernels.mamba2_scan``'s
``Mamba2Scan``); the mLSTM's chunk loop and the MoE's routing and grouped
expert products through autograd.  Each attention-family layer (a
DeepSeek bottom's prefix layers too), each xLSTM block, and each Mamba2
layer and application of the hybrid's shared block is recomputed in the
backward pass (``models/transformer.py``); the MoE layers' load-balance
losses, summed in layer order, enter the loss times 0.001.

Serving.  Each step runs the bottom (client) half, hands its features to
the top (server) half, and returns the cache of both halves.  KV caches
(the dense model's, Zamba2's shared block's, the encoder-decoder model's
decoder and cross K/V) and MLA's latent caches are written in place
(``models/attention.py``); the recurrent states of xLSTM and of Zamba2's
Mamba2 layers are returned anew.  xLSTM takes no positions and ignores the
decode step's.  A vision prefill takes ``patch_embeds`` and
``mrope_positions`` beside its tokens, a decode step its ``mrope_positions``
(3, B, 1); an encoder-decoder prefill takes ``frames`` and ``dec_tokens``,
and its decode steps run the top alone."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch import kernels
from repro_torch.configs import ArchConfig, InputShape
from repro_torch.core import losses
from repro_torch.core.ema import ema_update
from repro_torch.core.engine import requires_grad
from repro_torch.core.queue import FeatureQueue, enqueue, init_queue
from repro_torch.core.scan import scan_phase
from repro_torch.core.split import (apply_projection_head,
                                    init_projection_head, pool_features,
                                    proj_dim)
from repro_torch.core.wire import (WireFormatLike, fake_quantize,
                                   parse_wire_format, quantize_grad,
                                   resolve_fmt)
from repro_torch.data.prefetch import DevicePut, Prefetcher, ready
from repro_torch.device import resolve_device
from repro_torch.models.moe import expert_route
from repro_torch.models.transformer import (DecoderLM, EncDecModel,
                                            HybridMamba, XLSTMModel,
                                            build_model)
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


# ===========================================================================
# training
# ===========================================================================

@dataclass(frozen=True)
class StepPlan:
    """Static plan for one (arch, shape) pair."""

    cfg: ArchConfig
    shape: InputShape
    n_clients: int             # the clients' bottoms
    per_client_batch: int


def make_plan(cfg: ArchConfig, shape: InputShape, *,
              n_clients: int = 16) -> StepPlan:
    n = min(n_clients, shape.global_batch)
    return StepPlan(cfg=cfg, shape=shape, n_clients=n,
                    per_client_batch=shape.global_batch // n)


def _train_model(plan: StepPlan):
    model = build_model(plan.cfg)
    if not isinstance(model, (DecoderLM, HybridMamba, XLSTMModel,
                              EncDecModel)):
        raise NotImplementedError(
            f"{plan.cfg.name}: the port trains dense decoder LMs, the MoE, "
            "MLA and vision decoders, the Zamba2 hybrid, xLSTM and the "
            "encoder-decoder model here (the CNNs through core/engine.py)")
    return model


def init_train_state(plan: StepPlan, seed: int = 0,
                     device: str | torch.device = "cuda") -> dict:
    """A train state drawn from ``seed`` on ``device`` (which may be
    ``meta``, for shapes only): one model init whose bottom every client
    and every client's teacher starts from (the broadcast of a round's
    start), the teacher top and projection head copies of the student's,
    and an empty queue.  A bottom is the model's: embeddings and a list
    of layers (``stack``, and the hybrid's ``shared_attn`` block) or of
    xLSTM groups (``groups``)."""
    dev = torch.device(device)
    if dev.type != "meta":
        dev = resolve_device(device)
    gen = torch.Generator(device=dev if dev.type != "meta" else "cpu")
    gen.manual_seed(seed)
    cfg = plan.cfg
    params = _train_model(plan).init(gen, dev)
    proj = init_projection_head(cfg, gen, dev)
    copies = lambda tree, n: [tree_map(torch.clone, tree) for _ in range(n)]
    n = plan.n_clients
    return {"client_bottoms": copies(params["bottom"], n),
            "teacher_bottoms": copies(params["bottom"], n),
            "top": params["top"], "t_top": tree_map(torch.clone,
                                                     params["top"]),
            "proj": proj, "t_proj": tree_map(torch.clone, proj),
            "queue": init_queue(cfg.semisfl.queue_len, proj_dim(cfg), dev)}


def train_batch_shapes(plan: StepPlan) -> dict:
    """(shape, dtype) of each leaf of a train batch of N clients x b
    sequences of train_4k's length S, as JAX's ``_client_batch_struct``:
    token ids (int64 here); a vision model's P = min(frontend_tokens, S //
    4) patch embeddings ahead of S - P text tokens and its (3, b, S) M-RoPE
    positions a client; an encoder-decoder model's S frames a view and
    min(S, 1024) decoder tokens."""
    cfg = plan.cfg
    n, b, s = plan.n_clients, plan.per_client_batch, plan.shape.seq_len
    dt = getattr(torch, cfg.dtype)
    if cfg.is_encoder_decoder:
        frames = ((n, b, s, cfg.d_model), dt)
        return {"frames_weak": frames, "frames_strong": frames,
                "dec_tokens": ((n, b, min(s, 1024)), torch.int64)}
    out, s_text = {}, s
    if cfg.modality == "vision":
        p = min(cfg.frontend_tokens, s // 4)
        s_text = s - p
        out["patch_embeds"] = ((n, b, p, cfg.d_model), dt)
        out["mrope_positions"] = ((n, 3, b, s), torch.int64)
    tokens = ((n, b, s_text), torch.int64)
    return dict(out, tokens_weak=tokens, tokens_strong=tokens)


def train_state_shapes(plan: StepPlan) -> dict:
    """(shape, dtype) of every leaf of the train state, with the state's
    structure (the train branch of the JAX ``input_specs``, layers or
    xLSTM groups in lists), and of the batch (:func:`train_batch_shapes`);
    nothing is allocated."""
    state = init_train_state(plan, device="meta")
    out = tree_map(lambda t: (tuple(t.shape), t.dtype), state)
    return {"state": out, "batch": train_batch_shapes(plan)}


def _client_inputs(cfg: ArchConfig, batch: dict, which: str,
                   i: int) -> dict:
    """Client ``i``'s bottom inputs for the weak or strong view (JAX's
    ``_lm_batch_inputs``, one client of the stack): its frames for an
    encoder-decoder model, else its tokens, with a vision model's patch
    embeddings and M-RoPE positions (the same for both views)."""
    if cfg.is_encoder_decoder:
        return {"frames": batch[f"frames_{which}"][i]}
    out = {"tokens": batch[f"tokens_{which}"][i]}
    if "patch_embeds" in batch:
        out["patch_embeds"] = batch["patch_embeds"][i]
        out["mrope_positions"] = batch["mrope_positions"][i]
    return out


# a leaf with more elements than this is updated in slices of its first
# dim, so that the update's fp32 temporaries stay small (DeepSeek-V2's
# 160 experts' up, gate and down weights, 1.26e9 elements a leaf, would
# take 5 GB each in fp32); every element's arithmetic is the same
UPDATE_SLICE = 1 << 26


def _sgd(p: torch.Tensor, g: torch.Tensor, lr: float) -> torch.Tensor:
    """p - lr g in fp32, rounded to p's dtype (JAX's ``sub``), a slice of
    at most about UPDATE_SLICE elements at a time."""
    if p.dim() == 0 or p.numel() <= UPDATE_SLICE:
        return (p.float() - lr * g.float()).to(p.dtype)
    out = torch.empty_like(p)
    rows = max(1, UPDATE_SLICE // (p.numel() // p.shape[0]))
    for i in range(0, p.shape[0], rows):
        out[i:i + rows] = (p[i:i + rows].float()
                           - lr * g[i:i + rows].float()).to(p.dtype)
    return out


def make_train_step(plan: StepPlan, lr: float = 0.02, *,
                    wire: WireFormatLike = None) -> Callable:
    """``step(state, batch) -> (new state, metrics)``: one LM-task SemiSFL
    iteration, as the JAX ``make_train_step`` with no mesh.

    Teacher path (no gradient): each client's teacher bottom on its weak
    tokens, the wire's uplink quantization of the features (one scale per
    client), the teacher top; token pseudo-labels and their confidence mask
    (tau); sequence pseudo-labels from the mean over S of the teacher's
    fp32 softmax, confident above tau / 2; the pooled teacher features
    through the teacher projection head (z for the queue).  Student path:
    each client's bottom on its strong tokens, quantized up (straight
    through) and with its cotangent quantized down, the top; loss = the
    masked token CE in sum form (sum of NLL / max(count, 1)) + Eq. (5)
    through the clustering kernel + 0.001 aux.  Updates: plain SGD on top
    and projection head, on each client's bottom with N times its gradient
    (Eq. (8)), in fp32 and cast back; the clients' teacher EMA; the enqueue
    last.  ``t_top`` and ``t_proj`` do not move.  Metrics (0-d tensors):
    loss, consistency, clustering, mask_rate."""
    cfg = plan.cfg
    s = cfg.semisfl
    model = _train_model(plan)
    n = plan.n_clients
    wf = parse_wire_format(wire)
    act_fmt = resolve_fmt(wf.activations)
    grad_fmt = resolve_fmt(wf.gradients)

    def bottoms_forward(bottoms: list, batch: dict, which: str):
        """Each client's bottom on its inputs of the ``which`` view ->
        stacked (N, b, S, d) features on the wire and the flat-batch extras
        for the top (JAX's ``flatten_extras``: each client's (b, S)
        positions concatenated to (N b, S), M-RoPE's (3, b, S) to (3, N b,
        S); an encoder-decoder model's (N, b, T) ``dec_tokens`` as (N b,
        T))."""
        student = which == "strong"
        outs = [model.bottom_apply(bottoms[i],
                                   _client_inputs(cfg, batch, which, i),
                                   mode="train") for i in range(n)]
        feats = torch.stack([f for f, _, _ in outs])
        if act_fmt is not None:
            # uplink: per-client quantized features (straight through)
            feats = fake_quantize(feats, act_fmt)
        if student and grad_fmt is not None:
            # downlink: the cotangent at the cut ships quantized
            feats = quantize_grad(feats, grad_fmt)
        pos = [e["positions"] for _, _, e in outs]
        extras = {"positions": torch.cat(pos, dim=pos[0].dim() - 2),
                  "aux_loss": torch.stack([e["aux_loss"]
                                           for _, _, e in outs]).sum()}
        if cfg.is_encoder_decoder:
            dec = batch["dec_tokens"]
            extras["dec_tokens"] = dec.reshape((-1,) + dec.shape[2:])
        return feats.reshape((-1,) + feats.shape[2:]), extras

    def top_forward(top: dict, feats: torch.Tensor, extras: dict) -> dict:
        return model.top_apply(top, feats, extras=extras, mode="train")[0]

    def step(state: dict, batch: dict):
        queue: FeatureQueue = state["queue"]
        with torch.no_grad():
            t_feats, t_extras = bottoms_forward(state["teacher_bottoms"],
                                                batch, "weak")
            t_logits = top_forward(state["t_top"], t_feats,
                                   t_extras)["logits"]
            # the teacher's fp32 softmax once (``losses.pseudo_labels``'
            # arithmetic): token pseudo-labels and their confidence, and
            # its mean over S for the sequence-level pseudo-labels of the
            # clustering term
            probs = torch.softmax(t_logits.float(), dim=-1)
            del t_logits
            conf_tok, pseudo_tok = probs.max(dim=-1)
            ok_tok = conf_tok > s.confidence_threshold
            probs_mean = probs.mean(dim=1)
            del probs, conf_tok
            conf_seq, pseudo_seq = probs_mean.max(-1)
            conf_seq = conf_seq > s.confidence_threshold * 0.5
            tz = apply_projection_head(state["t_proj"],
                                       pool_features(t_feats))
            del t_feats, probs_mean

        live = requires_grad({"bottoms": state["client_bottoms"],
                              "top": state["top"], "proj": state["proj"]})
        feats, extras = bottoms_forward(live["bottoms"], batch, "strong")
        out = top_forward(live["top"], feats, extras)
        nll_sum, m_cnt = losses.cross_entropy_sum(out["logits"], pseudo_tok,
                                                  ok_tok)
        h = nll_sum / m_cnt.clamp(min=1.0)
        z = apply_projection_head(live["proj"], pool_features(feats))
        c = kernels.clustering_loss(z, pseudo_seq, conf_seq, queue.z,
                                    queue.label, queue.conf, queue.valid,
                                    s.temperature)
        loss = h + c + out["aux_loss"].sum() * 0.001
        del out, feats, extras
        leaves = tree_leaves(live)
        grads = tree_unflatten(live, list(torch.autograd.grad(loss,
                                                              leaves)))
        del live, leaves
        with torch.no_grad():
            sub = lambda p, g: tree_map(lambda a, b: _sgd(a, b, lr), p, g)
            new_top = sub(state["top"], grads.pop("top"))
            new_proj = sub(state["proj"], grads.pop("proj"))
            # Eq. (8): each client applies its own gradient, N times its
            # share of the mean over the N b sequences; each client's
            # gradient is dropped once applied
            g_b, new_bottoms = grads.pop("bottoms"), []
            for i, p in enumerate(state["client_bottoms"]):
                g = tree_map(lambda g: g * n, g_b[i])
                g_b[i] = None
                new_bottoms.append(sub(p, g))
                del g
            del grads, g_b
            new_t_bottoms = [ema_update(t, b, s.ema_decay) for t, b in
                             zip(state["teacher_bottoms"], new_bottoms)]
            new_queue = enqueue(queue, tz, pseudo_seq, conf_seq)
            metrics = {"loss": loss.detach(), "consistency": h.detach(),
                       "clustering": c.detach(),
                       "mask_rate": 1.0 - ok_tok.float().mean()}
        new_state = dict(state, client_bottoms=new_bottoms, top=new_top,
                         proj=new_proj, teacher_bottoms=new_t_bottoms,
                         queue=new_queue)
        return new_state, metrics

    return step


def make_train_phase(plan: StepPlan, lr: float = 0.02, *,
                     wire: WireFormatLike = None) -> Callable:
    """``phase(state, batches) -> (state, metrics)``: K iterations of
    :func:`make_train_step` over batches whose leaves have a leading K
    axis, the metrics stacked to (K,) tensors on the device, as
    :func:`make_scanned_train_phase` returns them, but as an eager Python
    loop, one dispatch an op: what the captured phase is held to.  The
    caller's reference to ``state`` lives until the call returns, so from
    its second step on a K > 1 call holds one state more than a one-step
    call (Zamba2-7B at 66 layers: a 35.6 GiB state beside a 63.5 GiB step
    peak on an NVIDIA H100 80GB HBM3 at 700 W does not fit)."""
    step = make_train_step(plan, lr, wire=wire)

    def phase(state: dict, batches: dict):
        k = len(next(iter(batches.values())))
        out = []
        for i in range(k):
            state, metrics = step(state, {key: v[i]
                                          for key, v in batches.items()})
            out.append(metrics)
        return state, {key: torch.stack([m[key] for m in out])
                       for key in out[0]}

    return phase


def make_scanned_train_phase(plan: StepPlan, lr: float = 0.02, *,
                             wire: WireFormatLike = None) -> Callable:
    """``phase(state, batches) -> (state, metrics)``: JAX's
    ``make_scanned_train_phase`` without ``dist``: :func:`make_train_step`
    through ``core/scan.py::scan_phase`` with the state donated, as JAX's
    default.  On the card the step is warmed up, captured once as a CUDA
    graph and replayed K times; the graph adopts the first state's tensors
    and every call returns them updated in place, so a phase holds one
    state and the caller's old references hold the new one.  On the CPU it
    is the eager loop.  An MoE state whose expert products take the loop
    on its device (``models/moe.py::expert_route``: fp32 on the card) reads
    the experts' counts on the host, which a capture refuses: it raises
    before any step."""
    phase = scan_phase(make_train_step(plan, lr, wire=wire),
                       donate_carry=True)
    if plan.cfg.moe is None:
        return phase
    dtype = getattr(torch, plan.cfg.dtype)

    def checked(state: dict, batches: dict):
        dev = next(t.device for t in tree_leaves(batches)
                   if isinstance(t, torch.Tensor))
        if dev.type == "cuda" and expert_route(dtype, dev) != "grouped":
            raise ValueError(
                f"{plan.cfg.name}: the {plan.cfg.dtype} MoE's expert "
                f"products read their counts on the host on {dev}, which a "
                "CUDA graph cannot capture; use make_train_phase")
        return phase(state, batches)

    checked.graphs = phase.graphs
    return checked


def make_prefetched_train_phase(plan: StepPlan, lr: float = 0.02, *,
                                wire: WireFormatLike = None) -> Callable:
    """:func:`make_scanned_train_phase` fed by the prefetch worker, as
    JAX's ``make_prefetched_train_phase`` without a mesh:
    ``run(state, batch_thunks) -> (state, [stacked metrics per phase])``
    over zero-argument thunks, each building one phase's host batches
    (numpy arrays under :func:`train_batch_shapes`' keys, each with a
    leading K axis: ``{"tokens_weak", "tokens_strong"}`` (K, N, b, S) for
    a text model).  A
    worker thread (two phases deep) builds phase k+1's batches and moves
    them to the state's device with the port's pinned ``DevicePut``
    (pinned host memory, a copy on a side stream that the phase's stream
    waits on) while phase k runs.  The worker is joined before ``run``
    returns, also when a thunk raises (its error surfaces as a
    ``PrefetchError``, chained)."""
    phase = make_scanned_train_phase(plan, lr, wire=wire)

    def run(state: dict, batch_thunks):
        thunks = list(batch_thunks)
        dev = next(t.device for t in tree_leaves(state)
                   if isinstance(t, torch.Tensor))
        mover = DevicePut(dev)

        def move(thunk):
            b = thunk()
            return list(b), mover(*b.values())

        pf = Prefetcher(depth=2)
        metrics = []
        try:
            if thunks:
                pf.submit("batch0", lambda: move(thunks[0]))
            for i in range(len(thunks)):
                if i + 1 < len(thunks):
                    pf.submit(f"batch{i + 1}",
                              lambda t=thunks[i + 1]: move(t))
                keys, moved = pf.get()[1]
                state, ms = phase(state, dict(zip(keys, ready(moved))))
                metrics.append(ms)
        finally:
            pf.close()
        return state, metrics

    return run


# ===========================================================================
# serving
# ===========================================================================


def make_prefill_step(cfg: ArchConfig) -> Callable:
    """``step(params, batch, cache) -> (last-position logits (B, V), cache)``
    for a batch ``{"tokens": (B, S)}`` of prompts (with ``patch_embeds``
    and ``mrope_positions`` for a vision model), or ``{"frames": (B, S,
    d_model), "dec_tokens": (B, T)}`` for an encoder-decoder model (the
    logits then the decoder's last position's)."""
    model = build_model(cfg)

    @torch.inference_mode()
    def step(params: dict, batch: dict, cache: dict):
        feats, cache_b, extras = model.bottom_apply(
            params["bottom"], dict(batch), mode="prefill",
            cache=cache.get("bottom"))
        if cfg.is_encoder_decoder:
            extras = dict(extras, dec_tokens=batch["dec_tokens"])
        out, cache_t = model.top_apply(params["top"], feats, extras=extras,
                                       mode="prefill", cache=cache.get("top"))
        return out["logits"][:, -1], {"bottom": cache_b, "top": cache_t}

    return step


def make_decode_step(cfg: ArchConfig) -> Callable:
    """``step(params, batch, cache) -> (greedy next token (B,), cache)`` for
    a batch ``{"tokens": (B, 1), "pos": (B,)}`` of one token per sequence
    at absolute position ``pos`` (with ``mrope_positions`` (3, B, 1) for
    M-RoPE; an encoder-decoder model's tokens are the decoder's)."""
    model = build_model(cfg)

    @torch.inference_mode()
    def step(params: dict, batch: dict, cache: dict):
        pos = batch["pos"][:, None]
        binputs = {"tokens": batch["tokens"], "positions": pos}
        if cfg.rope_kind == "mrope":
            binputs["mrope_positions"] = batch["mrope_positions"]
        feats, cache_b, extras = model.bottom_apply(
            params["bottom"], binputs, mode="decode",
            cache=cache.get("bottom"))
        if cfg.is_encoder_decoder:
            extras = dict(extras, dec_tokens=batch["tokens"], positions=pos)
        out, cache_t = model.top_apply(params["top"], feats, extras=extras,
                                       mode="decode", cache=cache.get("top"))
        next_tok = out["logits"][:, -1].argmax(-1)
        return next_tok, {"bottom": cache_b, "top": cache_t}

    return step
