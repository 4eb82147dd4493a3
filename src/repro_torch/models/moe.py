"""Mixture-of-Experts layer (the JAX package's ``models/moe.py``: the
router, the load-balance loss, the shared and dense-residual branches and
``apply_moe`` on its dense path).

The port computes the function of JAX's ``apply_moe_dense`` but runs only
the selected experts: the (token, expert) assignments are stable-sorted by
expert, and each expert takes one ``up``, ``gate`` and ``down`` product
over its rows, where JAX runs every expert on every token and weighs the
unselected ones 0.  The arithmetic is JAX's:

  * router logits in fp32 (``x.float() @ router``), softmax, top-k,
    the k weights renormalised by their sum floored at 1e-9;
  * the weights cast to the experts' dtype before the weighting, as
    ``combine.astype(y.dtype)`` does, and a token's k weighted outputs
    summed in fp32 (in increasing expert order, JAX's order over the
    expert axis) and rounded once;
  * then the shared experts' and the dense residual's outputs added, in
    that order.

The route reads no value on the host, so a CUDA graph can capture it
(``launch/steps.py::make_scanned_train_phase`` does, training): the
per-expert counts are a scatter-add on the device (JAX's ``one_hot(...).sum``
in integers), their running sum the group offsets, and the three products
are grouped products over the expert-sorted rows (``torch._grouped_mm``,
one launch each; no Pallas kernel stands behind this layer, JAX leaves its
einsums to XLA).  The rows are gathered from x's tokens, each repeated k
times, through the sort's permutation, so their gradient is a permutation
and a sum over each token's k copies, in a fixed order: two runs give the
same bits.  Which route a call takes is :func:`expert_route`'s: the grouped
products on the CPU and for bf16 on the card; the plain version, one
``up``/``gate``/``down`` product per expert with tokens, cut at counts read
on the host, for fp32 on the card (PyTorch checks ``_grouped_mm``'s
CUDA inputs for bf16) and wherever a caller asks for it (``route="loop"``, what the tests
hold the grouped route to).  The expert-parallel path (``apply_moe_ep``:
capacity drops, all_to_all) is not ported.

``ROUTING``, when set to a list, receives one record per call: a (E,)
tensor of the tokens each expert took and a 0-d tensor holding the
smallest gap, over the call's tokens, between the k-th and the (k+1)-th
routing probability (how near a token came to another expert), both on
the device and read by the caller after the call."""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs import ArchConfig, MoEConfig
from repro_torch.models.common import apply_mlp, dense_init, init_mlp

ROUTING: Optional[list] = None


def _stacked_init(n: int, d_in: int, d_out: int, generator: torch.Generator,
                  device: torch.device | str,
                  dtype: torch.dtype) -> torch.Tensor:
    """(n, d_in, d_out) weights, each N(0, 1/d_in), as ``dense_init`` draws
    one (fp32 on the generator's device, then cast); shape only on
    ``meta``."""
    if torch.device(device).type == "meta":
        return torch.empty(n, d_in, d_out, device="meta", dtype=dtype)
    w = torch.randn(n, d_in, d_out, generator=generator,
                    device=generator.device)
    return (w * (1.0 / math.sqrt(d_in))).to(device=device, dtype=dtype)


def init_moe(cfg: ArchConfig, generator: torch.Generator,
             device: torch.device | str, dtype: torch.dtype) -> dict:
    """The router (fp32, (d, E)), the experts' ``up``/``gate`` (E, d, f) and
    ``down`` (E, f, d), and the shared and dense-residual MLPs where the
    config has them."""
    m = cfg.moe
    d, f = cfg.d_model, m.d_ff_expert
    experts = {"up": _stacked_init(m.num_experts, d, f, generator, device,
                                   dtype),
               "down": _stacked_init(m.num_experts, f, d, generator, device,
                                     dtype)}
    if cfg.mlp_gated:
        experts["gate"] = _stacked_init(m.num_experts, d, f, generator,
                                        device, dtype)
    p = {"router": dense_init(d, m.num_experts, generator, device,
                              torch.float32),
         "experts": experts}
    if m.num_shared_experts:
        p["shared"] = init_mlp(d, f * m.num_shared_experts, cfg.mlp_gated,
                               generator, device, dtype)
    if m.d_ff_dense_residual:
        p["dense_residual"] = init_mlp(d, m.d_ff_dense_residual,
                                       cfg.mlp_gated, generator, device,
                                       dtype)
    return p


def _routing(router: torch.Tensor, x: torch.Tensor, m: MoEConfig):
    """x: (T, d) -> (weights (T, k) fp32, idx (T, k), probs (T, E) fp32),
    the k in decreasing probability."""
    probs = torch.softmax(x.float() @ router, dim=-1)
    weights, idx = torch.topk(probs, m.top_k, dim=-1)
    weights = weights / weights.sum(-1, keepdim=True).clamp_min(1e-9)
    return weights, idx, probs


def expert_counts(idx: torch.Tensor, num_experts: int) -> torch.Tensor:
    """(E,) int64: how many of the (T, k) assignments ``idx`` each expert
    took, summed on the device (no host read, unlike ``bincount`` on the
    card)."""
    flat = idx.reshape(-1)
    return torch.zeros(num_experts, dtype=torch.int64,
                       device=idx.device).scatter_add_(
        0, flat, torch.ones_like(flat))


def aux_load_balance_loss(probs: torch.Tensor, idx: torch.Tensor,
                          num_experts: int) -> torch.Tensor:
    """Switch-style load-balance loss: E * sum_e f_e * P_e, fp32."""
    me = probs.mean(0)
    ce = expert_counts(idx, num_experts).float() / idx.shape[0]
    return num_experts * (me * ce).sum()


def _common_branches(p: dict, cfg: ArchConfig,
                     x2d: torch.Tensor) -> Optional[torch.Tensor]:
    """The shared experts' output plus the dense residual's, or None."""
    out = None
    for name in ("shared", "dense_residual"):
        if name in p:
            y = apply_mlp(p[name], x2d, cfg.act, cfg.mlp_gated)
            out = y if out is None else out + y
    return out


def _act(h: torch.Tensor, act: str) -> torch.Tensor:
    """The ungated experts' activation (JAX's ``_act``: SiLU, else GELU)."""
    return F.silu(h) if act == "silu" else F.gelu(h, approximate="tanh")


def _expert(e: dict, i: int, x: torch.Tensor, cfg: ArchConfig
            ) -> torch.Tensor:
    """Expert i's MLP on its rows x (n, d); a gated expert is SiLU-gated
    whatever ``cfg.act`` says, as JAX's are."""
    h = x @ e["up"][i]
    h = F.silu(x @ e["gate"][i]) * h if cfg.mlp_gated else _act(h, cfg.act)
    return h @ e["down"][i]


def _experts_grouped(e: dict, rows: torch.Tensor, counts: torch.Tensor,
                     cfg: ArchConfig) -> torch.Tensor:
    """Every expert's MLP on its slice of the expert-sorted rows (T k, d),
    the slices cut at the running sum of ``counts`` on the device: three
    grouped products, as :func:`_expert` computes each slice."""
    offs = counts.cumsum(0).to(torch.int32)
    mm = lambda a, w: torch._grouped_mm(a, w, offs=offs)
    h = mm(rows, e["up"])
    h = F.silu(mm(rows, e["gate"])) * h if cfg.mlp_gated \
        else _act(h, cfg.act)
    return mm(h, e["down"])


def _experts_loop(e: dict, rows: torch.Tensor, counts: torch.Tensor,
                  cfg: ArchConfig) -> torch.Tensor:
    """The plain version of :func:`_experts_grouped`: one :func:`_expert`
    call per expert with rows, cut at the counts read on the host."""
    ys, start = [], 0
    for i, n in enumerate(counts.tolist()):
        if n:
            ys.append(_expert(e, i, rows[start:start + n], cfg))
            start += n
    return torch.cat(ys)


def expert_route(dtype: torch.dtype, device: torch.device | str) -> str:
    """``"grouped"`` on the CPU and for bf16 on the card (PyTorch checks
    ``_grouped_mm``'s CUDA inputs for bf16), else ``"loop"`` (which reads
    the counts on the host)."""
    return ("grouped" if torch.device(device).type == "cpu"
            or dtype == torch.bfloat16 else "loop")


def apply_moe(p: dict, cfg: ArchConfig, x: torch.Tensor, *,
              route: Optional[str] = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out (B, S, d) in x's dtype, aux loss fp32 scalar);
    ``route`` ("grouped" or "loop") overrides :func:`expert_route`."""
    m = cfg.moe
    b, s, d = x.shape
    x2d = x.reshape(-1, d)
    t, k = x2d.shape[0], m.top_k
    weights, idx, probs = _routing(p["router"], x2d, m)
    counts = expert_counts(idx, m.num_experts)
    aux = aux_load_balance_loss(probs, idx, m.num_experts)

    # each token's k assignments in increasing expert order, then all
    # assignments stable-sorted by expert
    idx_e, perm = idx.sort(dim=-1)
    w_e = weights.gather(-1, perm)
    order = torch.argsort(idx_e.reshape(-1), stable=True)
    if ROUTING is not None:
        with torch.no_grad():
            top = torch.topk(probs, min(k + 1, m.num_experts), dim=-1).values
            ROUTING.append({"counts": counts,
                            "gap": (top[:, k - 1] - top[:, -1]).min()})
    # row i of the sorted assignments is token order[i] // k's: each token
    # repeated k times, then permuted
    rows = x2d[:, None].expand(t, k, d).reshape(t * k, d)[order]
    route = route or expert_route(x.dtype, x.device)
    experts = {"grouped": _experts_grouped, "loop": _experts_loop}[route]
    y_sorted = experts(p["experts"], rows, counts, cfg)
    del rows
    y = torch.empty_like(y_sorted)
    y[order] = y_sorted                         # back to (token, k) order
    y = y.view(t, k, d)
    w = w_e.to(y.dtype).float()
    acc = y[:, 0].float() * w[:, 0, None]
    for j in range(1, k):
        acc = acc + y[:, j].float() * w[:, j, None]
    out = acc.to(x.dtype)
    common = _common_branches(p, cfg, x2d)
    if common is not None:
        out = out + common
    return out.reshape(b, s, d), aux
