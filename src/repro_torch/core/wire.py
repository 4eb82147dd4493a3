"""Wire formats for the split link (the JAX package's ``core/wire.py``).

  * activations: int8/fp8 amax-scaled fake quantization of the uplink
    features with a straight-through gradient (:func:`fake_quantize`);
  * gradients: identity forward, quantized cotangent at the cut, which is
    what the server ships back to each client (:func:`quantize_grad`);
  * bottom deltas: top-k magnitude sparsification of each client's delta
    against the broadcast reference before FedAvg
    (:func:`sparse_delta_mean`);
  * the on-wire bytes of each payload (:func:`quantized_bytes`,
    :func:`topk_payload_bytes`), which ``core/commcost.py`` bills.

Both quantizers take a stack of client tensors (N, ...) and give every
client slice its own scale, as the JAX engine's vmapped calls do.  They run
on the quantize kernels through ``repro_torch.kernels``."""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Union

import torch

from repro_torch.kernels import quantize_dequantize
from repro_torch.tree import tree_map

# on-wire bytes per element for each quantized payload format
WIRE_DTYPES = {"fp32": 4, "int8": 1, "fp8": 1}
SCALE_BYTES = 4   # one fp32 amax scale rides along per quantized tensor
VALUE_BYTES = 4   # surviving top-k entries ship as fp32 values...
INDEX_BYTES = 4   # ...plus an int32 flat coordinate each


@dataclass(frozen=True)
class WireFormat:
    """What the split-link payloads look like on the wire."""
    activations: str = "fp32"   # uplink features (student + teacher views)
    gradients: str = "fp32"     # downlink cotangent at the cut
    topk_frac: float = 1.0      # kept fraction of each FedAvg bottom delta

    def __post_init__(self):
        for kind, fmt in (("activations", self.activations),
                          ("gradients", self.gradients)):
            if fmt not in WIRE_DTYPES:
                raise ValueError(
                    f"unknown {kind} wire format {fmt!r}; "
                    f"valid: {', '.join(sorted(WIRE_DTYPES))}")
        if not 0.0 < self.topk_frac <= 1.0:
            raise ValueError(
                f"topk_frac must be in (0, 1], got {self.topk_frac}")

    @property
    def identity(self) -> bool:
        """True when every payload is uncompressed fp32 (no-op wire)."""
        return (self.activations == "fp32" and self.gradients == "fp32"
                and self.topk_frac >= 1.0)


FP32 = WireFormat()

WireFormatLike = Union[WireFormat, str, None]


def parse_wire_format(spec: WireFormatLike) -> WireFormat:
    """``None``/``"fp32"`` -> identity; ``"int8"`` / ``"fp8"`` quantize
    both activations and gradients; a ``"topkF"`` component sparsifies the
    FedAvg deltas and composes with ``+``: ``"int8+topk0.1"``."""
    if isinstance(spec, WireFormat):
        return spec
    if spec is None:
        return FP32
    fmt, frac = "fp32", 1.0
    for part in str(spec).lower().split("+"):
        part = part.strip()
        if not part:
            continue
        if part.startswith("topk"):
            try:
                frac = float(part[4:])
            except ValueError:
                raise ValueError(
                    f"bad top-k fraction in wire format component "
                    f"{part!r} (want e.g. 'topk0.1')") from None
        elif part in WIRE_DTYPES:
            fmt = part
        else:
            raise ValueError(
                f"unknown wire format component {part!r} in {spec!r}; "
                f"valid: {', '.join(sorted(WIRE_DTYPES))} and 'topkF'")
    return WireFormat(activations=fmt, gradients=fmt, topk_frac=frac)


def resolve_fmt(fmt: str) -> Optional[str]:
    """``"fp32"`` -> None (no op is inserted), else the format name."""
    return None if fmt == "fp32" else fmt


class _FakeQuantize(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fmt):
        return quantize_dequantize(x, fmt, per_slice=True)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _QuantizeGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fmt):
        ctx.fmt = fmt
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return quantize_dequantize(g.contiguous(), ctx.fmt,
                                   per_slice=True), None


def fake_quantize(x: torch.Tensor, fmt: str) -> torch.Tensor:
    """Quantize-dequantize each client slice ``x[i]`` on the forward pass;
    straight-through gradient on the backward pass."""
    return _FakeQuantize.apply(x, fmt)


def quantize_grad(x: torch.Tensor, fmt: str) -> torch.Tensor:
    """Identity forward; the backward cotangent of each client slice (the
    gradient the server ships down the split link) is quantize-dequantized
    through ``fmt``."""
    return _QuantizeGrad.apply(x, fmt)


def topk_count(n: int, frac: float) -> int:
    """Kept entries for an ``n``-element payload."""
    return max(1, min(n, math.ceil(frac * n)))


def topk_sparsify(x: torch.Tensor, frac: float) -> torch.Tensor:
    """Zero all but the ``ceil(frac * size)`` largest-|.| entries of ``x``.
    Magnitude ties at the threshold all survive."""
    if frac >= 1.0:
        return x
    mag = x.reshape(-1).abs()
    kth = torch.topk(mag, topk_count(mag.numel(), frac)).values[-1]
    return torch.where(x.abs() >= kth, x, torch.zeros_like(x))


def sparse_delta_mean(stacked, reference, frac: float):
    """FedAvg over a stacked client axis from top-k sparsified deltas: each
    client uploads the top ``frac`` of its delta against the broadcast
    ``reference`` (per leaf); the server rebuilds ``reference +
    mean(deltas)``.  Exact FedAvg at ``frac == 1``."""
    def one(s, r):
        deltas = torch.func.vmap(lambda d: topk_sparsify(d, frac))(s - r[None])
        return r + deltas.mean(dim=0)
    return tree_map(one, stacked, reference)


# ---------------------------------------------------------------------------
# byte accounting (read by core.commcost)
# ---------------------------------------------------------------------------

def quantized_bytes(n_elems: float, fmt: str, *, n_tensors: int = 1) -> float:
    """On-wire bytes for ``n_elems`` elements in ``fmt`` (+ one fp32 amax
    scale per shipped tensor for the quantized formats)."""
    if fmt == "fp32":
        return 4.0 * n_elems
    return float(WIRE_DTYPES[fmt]) * n_elems + SCALE_BYTES * n_tensors


def topk_payload_bytes(n_elems: int, frac: float) -> float:
    """On-wire bytes for a top-k sparsified ``n_elems`` payload: fp32
    value + int32 flat index per kept entry."""
    if frac >= 1.0:
        return 4.0 * n_elems
    return float(topk_count(n_elems, frac)) * (VALUE_BYTES + INDEX_BYTES)
