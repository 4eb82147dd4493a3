"""Communication and wall-clock cost model (Section V-C testbed, Figs. 5-6):
the JAX package's ``core/commcost.py`` over the port's trees.

The paper measures time on 80 Jetson clients and an A6000 server over
Wi-Fi (0.8-8 Mbps up, 10-20 Mbps down).  This reproduces the accounting:
per-round bytes from the parameter and feature tensors at their on-wire
dtypes, with the split-link payloads quantized or sparsified by a
:class:`~repro_torch.core.wire.WireFormat`, and per-round seconds from a
link model with the paper's bandwidth ranges plus FLOP-rate compute
terms.  Nothing here is a measurement of the card."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.configs import ArchConfig
from repro_torch.core.wire import (WireFormat, quantized_bytes,
                                   topk_payload_bytes)
from repro_torch.tree import tree_leaves


def _itemsize(x) -> int:
    size = getattr(x, "element_size", None)     # a tensor
    return size() if size is not None else np.dtype(x.dtype).itemsize


def tree_bytes(tree) -> int:
    """Serialized bytes of a parameter tree (tensors or numpy arrays) at its
    leaves' dtypes."""
    return sum(int(np.prod(x.shape)) * _itemsize(x)
               for x in tree_leaves(tree))


def tree_params(tree) -> int:
    return sum(int(np.prod(x.shape)) for x in tree_leaves(tree))


@dataclass
class CostModel:
    up_mbps: tuple = (0.8, 8.0)      # client -> PS (paper Section V-C)
    down_mbps: tuple = (10.0, 20.0)  # PS -> client
    client_gflops: float = 20.0      # Jetson-class effective rate
    server_gflops: float = 2000.0    # A6000-class effective rate
    seed: int = 0

    def __post_init__(self):
        self.reset()

    def reset(self) -> None:
        """Rewind the link-draw stream to the seed: two models with the
        same seed give the same bills for the same calls."""
        self._rng = np.random.RandomState(self.seed)

    def link(self) -> tuple[float, float]:
        """One (up, down) bytes/s draw from this model's own stream."""
        up = self._rng.uniform(*self.up_mbps) * 1e6 / 8
        down = self._rng.uniform(*self.down_mbps) * 1e6 / 8
        return up, down


@dataclass
class RoundBill:
    bytes_up: float
    bytes_down: float
    seconds: float

    @property
    def bytes_total(self):
        return self.bytes_up + self.bytes_down


def _flops_per_sample(cfg: ArchConfig) -> float:
    """Forward FLOPs per sample (x3 for forward and backward)."""
    if cfg.arch_type == "cnn":
        f, cin, hw = 0.0, 3, cfg.image_size
        for cout in cfg.cnn_channels:
            f += 2 * 9 * cin * cout * hw * hw
            cin = cout
            hw //= 2
        feat = cin * hw * hw * 4  # rough: un-halved last pool compensation
        for fc in cfg.cnn_fc:
            f += 2 * feat * fc
            feat = fc
        f += 2 * feat * max(cfg.num_classes, 1)
        return f
    return 2.0 * cfg.param_count()


def round_bill(method: str, cfg: ArchConfig, *, bottom_bytes: int,
               full_bytes: int, feat_bytes_per_batch: int, k_s: int, k_u: int,
               n_active: int, batch: int, cost: CostModel,
               helpers: int = 2,
               wire: Optional[WireFormat] = None) -> RoundBill:
    """Bytes and seconds for one aggregation round of ``method``.

    ``bottom_bytes``, ``full_bytes`` and ``feat_bytes_per_batch`` are fp32
    serialized sizes (:func:`tree_bytes` of fp32 trees); ``wire`` rescales
    the split-link payloads: quantized activations and gradients bill
    element bytes plus one fp32 scale a tensor, top-k'd FedAvg deltas
    bill a value and an index a kept entry.  Full-model baselines exchange
    whole models and are unaffected.  Link draws come from ``cost.link()``:
    the same seed and calls give the same bills."""
    wire = WireFormat() if wire is None else wire
    fwd = _flops_per_sample(cfg)
    server_s = k_s * 3 * fwd * batch / (cost.server_gflops * 1e9)

    if method in ("semifl", "fedswitch", "fedmatch"):
        down = full_bytes * n_active * (1 + (helpers if method == "fedmatch"
                                             else 0))
        up = full_bytes * n_active
        client_s = []
        for _ in range(n_active):
            u, d = cost.link()
            comp = k_u * 3 * fwd * batch / (cost.client_gflops * 1e9)
            client_s.append(down / n_active / d + up / n_active / u + comp)
        return RoundBill(up, down, server_s + max(client_s))

    if method == "supervised-only":
        return RoundBill(0.0, 0.0, server_s)

    # split methods (semisfl, fedswitch-sl): the broadcast stays fp32; the
    # uplink bottom is a top-k delta against it; the per-step feature and
    # gradient payloads ship in the wire's formats (one tensor, hence one
    # scale, per client per step per view)
    bottom_elems = bottom_bytes // 4
    feat_elems = feat_bytes_per_batch // 4
    up_model_one = topk_payload_bytes(bottom_elems, wire.topk_frac)
    feat_one = quantized_bytes(feat_elems, wire.activations)
    grad_one = quantized_bytes(feat_elems, wire.gradients)
    down_models = 2 * bottom_bytes * n_active          # student + teacher
    up_models = up_model_one * n_active
    feat_up = 2 * feat_one * k_u * n_active            # student + teacher
    grad_down = grad_one * k_u * n_active
    client_s = []
    bottom_frac = bottom_bytes / max(full_bytes, 1)
    for _ in range(n_active):
        u, d = cost.link()
        comp = k_u * 3 * fwd * bottom_frac * batch / (cost.client_gflops * 1e9)
        comm = ((down_models + grad_down) / n_active / d
                + (up_models + feat_up) / n_active / u)
        client_s.append(comm + comp)
    server_semi = k_u * 3 * fwd * (1 - bottom_frac) * batch * n_active \
        / (cost.server_gflops * 1e9)
    return RoundBill(up_models + feat_up, down_models + grad_down,
                     server_s + server_semi + max(client_s))
