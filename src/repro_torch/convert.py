"""Carry weights and state between the JAX package and this port.

CNN trees have the same structure on both sides (``{"bottom", "top",
"proj"}``, conv layers as lists of ``{"w", "b"}``).  Only the conv weights
change layout: JAX's HWIO against PyTorch's OIHW, with a leading client
axis on stacked client bottoms.  Dense weights are (d_in, d_out) on both
sides.  Decoder-LM trees differ in one way: JAX stacks a segment's layers
on a leading axis (``"stack"``, and a DeepSeek bottom's ``"prefix"``), the
port keeps a list of per-layer trees; so does its KV or MLA cache.  An MoE
layer's experts are (E, d_in, d_out) tensors on both sides.  xLSTM trees are
stacked twice in JAX (``"groups"`` on a group axis, each group's ``"mlstm"``
blocks on a second one); the port keeps a list of groups, each with a list of
mLSTM blocks, and so does its recurrent cache.  The Zamba2 hybrid's ``stack``
is unstacked likewise and its ``shared_attn`` block is one tree on each side;
its cache holds a segment's SSM caches on a leading layer axis and its
shared-block KV caches on a leading application axis in JAX, lists in the port.
The encoder-decoder model's ``stack`` (each side's encoder layers) and
``dec_stack`` (the decoder's layers, each with its ``cross_norm`` and
``cross`` block) unstack likewise; its cache's decoder self-attention
caches (``dec_self``) become a list, its cross K/V stay (L, B, max_len,
KVH, hd) tensors on both sides.
The LM train state stacks the clients' bottoms on a leading client axis in JAX;
the port keeps a list of client trees.  bf16 arrays (``ml_dtypes.bfloat16`` in
numpy) come across bit for bit.

The functions take and give numpy arrays, not JAX arrays, so the port
stays free of JAX: a caller holding JAX arrays passes
``jax.device_get(tree)``."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.baselines import FLState
from repro_torch.core.engine import SemiSFLState
from repro_torch.core.queue import FeatureQueue
from repro_torch.models.attention import KVCache
from repro_torch.models.mla import MLACache
from repro_torch.models.ssm import SSMCache
from repro_torch.models.xlstm import MLSTMCache, SLSTMCache
from repro_torch.tree import tree_leaves, tree_map

# conv weight rank -> axis order, JAX layout to port layout
_TO_PORT = {4: (3, 2, 0, 1),            # HWIO -> OIHW
            5: (0, 4, 3, 1, 2)}         # N,HWIO -> N,OIHW (client stacks)
_TO_JAX = {4: (2, 3, 1, 0), 5: (0, 3, 4, 2, 1)}


def params_from_numpy(tree, device: str | torch.device = "cpu"):
    """A parameter (or momentum-buffer) tree of numpy arrays in the JAX
    package's layout -> the port's tree of tensors on ``device``."""
    def one(a):
        a = np.asarray(a)
        if a.ndim in _TO_PORT:
            a = np.transpose(a, _TO_PORT[a.ndim])
        return torch.from_numpy(np.array(a, copy=True)).to(device)
    return tree_map(one, tree)


def params_to_numpy(tree):
    """The port's tree of tensors -> numpy arrays in the JAX layout."""
    def one(t):
        a = t.detach().cpu().numpy()
        if a.ndim in _TO_JAX:
            a = np.ascontiguousarray(np.transpose(a, _TO_JAX[a.ndim]))
        return a
    return tree_map(one, tree)


def queue_from_numpy(z, label, conf, valid, ptr,
                     device: str | torch.device = "cpu") -> FeatureQueue:
    t = lambda a: torch.from_numpy(np.array(a, copy=True)).to(device)
    return FeatureQueue(z=t(np.asarray(z, np.float32)),
                        label=t(np.asarray(label, np.int32)),
                        conf=t(np.asarray(conf, bool)),
                        valid=t(np.asarray(valid, bool)),
                        ptr=t(np.asarray(ptr, np.int32)))


def queue_to_numpy(q: FeatureQueue) -> dict:
    return {"z": q.z.cpu().numpy(), "label": q.label.cpu().numpy(),
            "conf": q.conf.cpu().numpy(), "valid": q.valid.cpu().numpy(),
            "ptr": int(q.ptr)}


def state_from_numpy(params, teacher, momentum, queue: dict, round_: int,
                     step: int, device: str | torch.device = "cpu"
                     ) -> SemiSFLState:
    """A :class:`SemiSFLState` from the JAX state's pieces as numpy:
    params, teacher, the SGD momentum buffers (``opt.mu``) and the queue's
    fields."""
    return SemiSFLState(
        params=params_from_numpy(params, device),
        teacher=params_from_numpy(teacher, device),
        opt=params_from_numpy(momentum, device),
        queue=queue_from_numpy(device=device, **queue),
        round=int(round_),
        step=torch.tensor(int(step), dtype=torch.int32, device=device))


def fl_state_from_numpy(params, teacher, momentum, round_: int,
                        device: str | torch.device = "cpu") -> FLState:
    """A baseline's :class:`FLState` from the JAX ``FLState``'s pieces as
    numpy: params and teacher (FedMatch's ``{"sigma", "psi"}`` trees too)
    and the SGD momentum buffers (``opt.mu``)."""
    return FLState(params=params_from_numpy(params, device),
                   teacher=params_from_numpy(teacher, device),
                   opt=params_from_numpy(momentum, device), round=int(round_))


def _tensor(a, device) -> torch.Tensor:
    """A numpy array (bf16 included) as a tensor on ``device``, bit for
    bit."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a.view(np.int16), copy=True))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _unstack(tree) -> list:
    """A tree whose leaves share a leading layer axis -> one tree per
    layer."""
    n = len(tree_leaves(tree)[0])
    return [tree_map(lambda a, i=i: a[i], tree) for i in range(n)]


def lm_params_from_numpy(tree, device: str | torch.device = "cpu") -> dict:
    """The JAX ``DecoderLM.init``, ``HybridMamba.init``,
    ``XLSTMModel.init`` or ``EncDecModel.init`` tree as numpy -> the port's
    tree on ``device``.  A ``stack``, ``prefix`` or ``dec_stack`` (leading
    layer axis) becomes a list of per-layer trees (an MoE layer's router,
    experts and MLA weights, a decoder layer's cross block, as they are);
    ``groups`` (leading group axis, and a second block axis on each
    group's ``mlstm``) a list of per-group ``{"mlstm": [per-block trees],
    "slstm": tree}``; any other subtree (``embed``, ``shared_attn``, ...)
    comes across as it is."""
    return {"bottom": _lm_half_from_numpy(tree["bottom"], device),
            "top": _lm_half_from_numpy(tree["top"], device)}


# the subtrees that stack a segment's layers on a leading axis in JAX
_LAYER_SEGMENTS = ("prefix", "stack", "dec_stack")


def _lm_half_from_numpy(part: dict, device) -> dict:
    """One side of the split (a JAX ``bottom`` or ``top`` tree) -> the
    port's."""
    if part is None:
        return None
    to_t = lambda sub: tree_map(lambda a: _tensor(a, device), sub)
    out = {}
    for key, sub in part.items():
        if key in _LAYER_SEGMENTS:
            out[key] = ([] if sub is None else
                        [to_t(layer) for layer in _unstack(sub)])
        elif key == "groups":
            out[key] = ([] if sub is None else
                        [{"mlstm": [to_t(b) for b in _unstack(g["mlstm"])],
                          "slstm": to_t(g["slstm"])}
                         for g in _unstack(sub)])
        else:
            out[key] = to_t(sub)
    return out


def _array(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy, bit for bit; bf16 as ``ml_dtypes.bfloat16`` (the
    type JAX's arrays come back in), imported only when one is met."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _stack_trees(trees: list):
    """Trees of numpy arrays with one structure -> one tree of arrays with
    a leading axis (JAX's stacked layout; None leaves stay None)."""
    return tree_map(lambda *xs: None if xs[0] is None else np.stack(xs),
                    *trees)


def _lm_half_to_numpy(part: dict) -> dict:
    """The port's ``bottom`` or ``top`` tree -> numpy in the JAX layout
    (the inverse of :func:`_lm_half_from_numpy`): ``stack``, ``prefix``
    and ``dec_stack`` on a leading layer axis, an empty one None (a
    DeepSeek bottom's ``stack`` where its prefix layers fill the split);
    xLSTM's ``groups`` as ``{"mlstm": on (groups, blocks), "slstm": on
    (groups,)}``."""
    if part is None:
        return None
    out = {}
    for key, sub in part.items():
        leaves = tree_map(_array, sub)
        if key in _LAYER_SEGMENTS:
            leaves = _stack_trees(leaves) if leaves else None
        elif key == "groups" and leaves:
            leaves = {"mlstm": _stack_trees([_stack_trees(g["mlstm"])
                                             for g in leaves]),
                      "slstm": _stack_trees([g["slstm"] for g in leaves])}
        out[key] = leaves
    return out


def lm_train_state_from_numpy(state: dict,
                              device: str | torch.device = "cpu") -> dict:
    """The JAX LM train state (``launch/steps.py``'s ``input_specs``
    structure) as numpy -> the port's (``repro_torch.launch.steps``).
    JAX stacks the N clients' bottoms and teacher bottoms on a leading
    client axis, and each bottom's layers on a second one inside
    ``stack`` and ``prefix`` (xLSTM's groups inside ``groups``, and each
    group's mLSTM blocks on a third; an empty segment is None); the port
    keeps a list of N client trees, each with a list of per-layer trees
    (of per-group trees; an empty list for an empty segment).  An MoE
    layer's router, experts and shared or dense-residual MLPs and an MLA
    layer's weights unstack like any other layer's.  The top, teacher top
    and projection heads unstack as ``lm_params_from_numpy`` does; the
    queue goes through :func:`queue_from_numpy`."""
    def clients(stacked):
        n = len(tree_leaves(stacked)[0])
        return [_lm_half_from_numpy(tree_map(
            lambda a, i=i: None if a is None else a[i], stacked), device)
            for i in range(n)]
    to_t = lambda sub: tree_map(lambda a: _tensor(a, device), sub)
    q = state["queue"]
    return {"client_bottoms": clients(state["client_bottoms"]),
            "teacher_bottoms": clients(state["teacher_bottoms"]),
            "top": _lm_half_from_numpy(state["top"], device),
            "t_top": _lm_half_from_numpy(state["t_top"], device),
            "proj": to_t(state["proj"]), "t_proj": to_t(state["t_proj"]),
            "queue": queue_from_numpy(q[0], q[1], q[2], q[3], q[4],
                                      device=device)}


def lm_train_state_to_numpy(state: dict) -> dict:
    """The port's LM train state -> numpy in the JAX layout (the inverse of
    :func:`lm_train_state_from_numpy`, bit for bit): client and layer
    axes stacked, the queue as ``queue_to_numpy``'s dict."""
    clients = lambda trees: _stack_trees([_lm_half_to_numpy(t)
                                          for t in trees])
    return {"client_bottoms": clients(state["client_bottoms"]),
            "teacher_bottoms": clients(state["teacher_bottoms"]),
            "top": _lm_half_to_numpy(state["top"]),
            "t_top": _lm_half_to_numpy(state["t_top"]),
            "proj": tree_map(_array, state["proj"]),
            "t_proj": tree_map(_array, state["t_proj"]),
            "queue": queue_to_numpy(state["queue"])}


def lm_cache_from_numpy(cache, device: str | torch.device = "cpu") -> dict:
    """The JAX ``init_cache`` tree as numpy -> the port's cache on
    ``device``.  ``DecoderLM``: each segment's ``KVCache`` of (k, v, pos)
    or ``MLACache`` of (latent, k_rope, length) with a leading layer axis
    -> a list of per-layer :class:`KVCache` or :class:`MLACache` (None for
    an empty segment), a prefix model's bottom with its ``prefix`` (a
    model without prefix layers has None there in JAX, and no ``prefix``
    in the port).  ``HybridMamba``: each segment's ``{"ssm": (conv, state)
    on a layer axis, "shared_kv": (k, v, pos) on an application axis}`` ->
    ``{"ssm": [SSMCache], "shared_kv": [KVCache]}``.  ``XLSTMModel``: each
    segment's ``{"mlstm": (C, n, m) on (groups, blocks, ...), "slstm": (h,
    c, n, m) on (groups, ...)}`` -> ``{"groups": [{"mlstm": [MLSTMCache],
    "slstm": SLSTMCache}]}``.  ``EncDecModel``: the bottom's None and the
    top's ``{"dec_self": (k, v, pos) on a layer axis, "cross_k",
    "cross_v"}`` -> ``{"dec_self": [KVCache], "cross_k", "cross_v"}``, the
    cross K/V as they are."""
    t = lambda a: _tensor(a, device)
    i64 = lambda a: t(np.asarray(a, np.int64))

    def segment(c):
        if c is None:
            return None
        if hasattr(c, "latent"):
            return [MLACache(t(c.latent[i]), t(c.k_rope[i]),
                             i64(c.length[i])) for i in range(len(c.latent))]
        k, v, pos = c
        return [KVCache(t(k[i]), t(v[i]), i64(pos[i])) for i in range(len(k))]

    def xlstm_segment(c):
        mc, sc = c["mlstm"], c["slstm"]
        return {"groups": [
            {"mlstm": [MLSTMCache(*(t(a[g, j]) for a in mc))
                       for j in range(mc[0].shape[1])],
             "slstm": SLSTMCache(*(t(a[g]) for a in sc))}
            for g in range(mc[0].shape[0])]}

    def hybrid_segment(c):
        conv, state = c["ssm"]
        return {"ssm": [SSMCache(t(conv[i]), t(state[i]))
                        for i in range(len(conv))],
                "shared_kv": segment(c["shared_kv"])}

    if cache["bottom"] is None:
        top = cache["top"]
        return {"bottom": None, "top": {"dec_self": segment(top["dec_self"]),
                                        "cross_k": t(top["cross_k"]),
                                        "cross_v": t(top["cross_v"])}}
    if "ssm" in cache["bottom"]:
        return {seg: hybrid_segment(cache[seg]) for seg in ("bottom", "top")}
    if "stack" not in cache["bottom"]:
        return {seg: xlstm_segment(cache[seg]) for seg in ("bottom", "top")}
    bottom = {"stack": segment(cache["bottom"]["stack"])}
    if cache["bottom"].get("prefix") is not None:
        bottom["prefix"] = segment(cache["bottom"]["prefix"])
    return {"bottom": bottom, "top": {"stack": segment(cache["top"]["stack"])}}


def lm_cache_to_numpy(cache: dict) -> dict:
    """The port's cache -> numpy in the JAX layout: for ``DecoderLM``
    {segment: (k, v, pos)} or, with MLA, {segment: (latent, k_rope,
    length)} with a leading layer axis (k, v, latent and k_rope as fp32;
    None for an empty segment), a prefix model's bottom as {"prefix": ...,
    "stack": ...}; for ``HybridMamba`` {segment: {"ssm": (conv, state),
    "shared_kv": (k, v, pos)}} with leading layer and application axes (as
    fp32 but pos); for ``XLSTMModel`` {segment: {"mlstm": (C, n, m),
    "slstm": (h, c, n, m)}} with leading (groups, blocks) and (groups,)
    axes; for ``EncDecModel`` {"bottom": None, "top": {"dec_self": (k, v,
    pos), "cross_k", "cross_v"}} (as fp32 but pos)."""
    a = lambda t: t.float().cpu().numpy()

    def segment(c):
        if not c:
            return None
        return tuple(np.stack([
            layer[i].cpu().numpy() if layer[i].dtype == torch.int64
            else a(layer[i]) for layer in c]) for i in range(len(c[0])))

    def xlstm_segment(c):
        groups = c["groups"]
        return {"mlstm": tuple(np.stack([np.stack([a(blk[i])
                                                   for blk in g["mlstm"]])
                                         for g in groups])
                               for i in range(len(MLSTMCache._fields))),
                "slstm": tuple(np.stack([a(g["slstm"][i]) for g in groups])
                               for i in range(len(SLSTMCache._fields)))}

    def hybrid_segment(c):
        return {"ssm": tuple(np.stack([a(layer[i]) for layer in c["ssm"]])
                             for i in range(len(SSMCache._fields))),
                "shared_kv": segment(c["shared_kv"])}

    if cache["bottom"] is None:
        top = cache["top"]
        return {"bottom": None, "top": {"dec_self": segment(top["dec_self"]),
                                        "cross_k": a(top["cross_k"]),
                                        "cross_v": a(top["cross_v"])}}
    if "ssm" in cache["bottom"]:
        return {seg: hybrid_segment(cache[seg]) for seg in ("bottom", "top")}
    if "groups" in cache["bottom"]:
        return {seg: xlstm_segment(cache[seg]) for seg in ("bottom", "top")}
    bottom = segment(cache["bottom"]["stack"])
    if "prefix" in cache["bottom"]:
        bottom = {"prefix": segment(cache["bottom"]["prefix"]),
                  "stack": bottom}
    return {"bottom": bottom, "top": segment(cache["top"]["stack"])}
