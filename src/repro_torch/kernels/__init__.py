"""Public wrappers over the port's CUDA kernels.

The tensor's device decides the route: a tensor on the CPU goes to the
plain PyTorch version in ``ref``, a CUDA tensor to the hand-written kernel,
which raises if it cannot build or launch.  Nothing falls back from the
kernel to the plain version.  Every launch adds one to its count in
:func:`launch_counts`, so a run can show that it went through the kernels.

Nothing here imports a kernel's toolchain or builds a library when the
module is imported; the first CUDA call builds (``kernels.build``)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import clustering_loss as _cl
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import mamba2_scan as _m2
from repro_torch.kernels import quantize as _q
from repro_torch.kernels import ref
from repro_torch.kernels import slstm_scan as _sl


def _route(x: torch.Tensor, name: str) -> str:
    if x.device.type in ("cuda", "cpu"):
        return x.device.type
    raise ValueError(f"{name}: no route for a tensor on {x.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """(B, H, Sq, hd) x (B, KVH, Skv, hd) -> (B, H, Sq, hd): GQA attention,
    causal or not, with an optional sliding window; differentiable.  v may
    have a head dim of its own where the kernels take the pair (MLA's
    (192, 128)); the output has v's.  On the card any strides with a
    contiguous head dim go in, and the output has q's layout; where a
    gradient is recorded the call goes through :class:`FlashAttention`
    (forward kernel with its lse, backward kernels, at every head dim and
    pair the forward takes), else through the forward kernel alone.  On
    the CPU autograd differentiates the plain version."""
    if _route(q, "flash_attention") == "cuda":
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v)):
            return _fa.FlashAttention.apply(q, k, v, causal, window)
        return _fa.flash_attention_cuda(q, k, v, causal=causal,
                                        window=window)
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window)


def clustering_loss(z: torch.Tensor, pseudo: torch.Tensor,
                    anchor_ok: torch.Tensor, queue_z: torch.Tensor,
                    queue_label: torch.Tensor, queue_conf: torch.Tensor,
                    queue_valid: torch.Tensor,
                    temperature: float) -> torch.Tensor:
    """Fused Eq. (5); differentiable with respect to z (the queue is
    stop-gradient)."""
    if _route(z, "clustering_loss") == "cuda":
        return _cl.ClusteringLoss.apply(z, pseudo, anchor_ok, queue_z,
                                        queue_label, queue_conf, queue_valid,
                                        temperature)
    return ref.clustering_loss_ref(z, pseudo, anchor_ok, queue_z,
                                   queue_label, queue_conf, queue_valid,
                                   temperature)


def quantize_dequantize(x: torch.Tensor, fmt: str, *,
                        per_slice: bool = False) -> torch.Tensor:
    """Amax-scaled int8/fp8 fake quantization, one scale per tensor or,
    with ``per_slice``, one per leading slice.  On the card the slice size
    picks the route (``quantize.plan``): one launch a call where a thread
    block cluster holds a slice, else two passes.  Not differentiable: the
    straight-through and gradient-path wrappers live in ``core.wire``."""
    if _route(x, "quantize_dequantize") == "cuda":
        return _q.quantize_dequantize_cuda(x, fmt, per_slice=per_slice)
    return ref.quantize_dequantize_ref(x, fmt, per_slice=per_slice)


def slstm_scan(wx: torch.Tensor, r: torch.Tensor,
               state: Optional[ref.SLSTMState] = None
               ) -> tuple[torch.Tensor, ref.SLSTMState]:
    """The sLSTM recurrence: wx (B, S, 4, nh, hd) gate inputs [z, i, f, o]
    and r (nh, hd, 4 hd), fp32, from ``state`` = (h, c, n, m), each (B, nh,
    hd), or from zeros and m = -1e30.  Returns h (B, S, nh, hd) and the
    final (h, c, n, m); differentiable with respect to wx and r.  On the
    card wx may be any view whose unit dim is contiguous; where a gradient
    is recorded the call goes through :class:`SLSTMScan` (the forward
    kernel saving what the backward kernel reads; the state takes no
    gradient and the final state gives none), else through the forward
    kernel alone.  On the CPU autograd differentiates the plain version."""
    if _route(wx, "slstm_scan") == "cuda":
        if torch.is_grad_enabled() and (wx.requires_grad or r.requires_grad):
            h, *final = _sl.SLSTMScan.apply(
                wx, r, *(state if state is not None else (None,) * 4))
            return h, tuple(final)
        return _sl.slstm_scan_cuda(wx, r, state)
    return ref.slstm_scan_ref(wx, r, state)


def mamba2_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, D: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The Mamba2 (SSD) selective scan from a zero state: x (B, S, nh, hd),
    dt (B, S, nh) fp32, A and D (nh,) fp32, B and C (B, S, N) shared by all
    heads.  Returns y (B, S, nh, hd) in x's dtype and the final state (B,
    nh, hd, N) in fp32.  On the card x, B, C and dt may be any views whose
    last dim is contiguous; in bf16 (the tensor-core kernel) the rows of x,
    B and C must also be 16-byte aligned, as the model's conv-output slices
    are (``mamba2_scan.mma_layout_problem`` says why a view is refused).
    Differentiable with respect to all six inputs: on the card, where a
    gradient is recorded, the call goes through :class:`Mamba2Scan` (the
    forward kernel saving its chunk states, the backward kernel; the final
    state carries no gradient), else through the forward kernel alone.  On
    the CPU autograd differentiates the plain version."""
    if _route(x, "mamba2_scan") == "cuda":
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (x, dt, A, B, C, D)):
            return _m2.Mamba2Scan.apply(x, dt, A, B, C, D)
        return _m2.mamba2_scan_cuda(x, dt, A, B, C, D)
    return ref.mamba2_scan_ref(x, dt, A, B, C, D)


_COUNTS = (_cl.LAUNCHES, _q.LAUNCHES, _fa.LAUNCHES, _sl.LAUNCHES,
           _m2.LAUNCHES)


def launch_counts() -> dict[str, int]:
    """Launches of each kernel since the last reset."""
    return {k: v for counts in _COUNTS for k, v in counts.items()}


def reset_launch_counts() -> None:
    for counts in _COUNTS:
        for k in counts:
            counts[k] = 0


def add_launch_counts(counts: dict[str, int], times: int = 1) -> None:
    """Add ``times`` x ``counts`` to the launch counts.  A replayed CUDA
    graph (``core/scan.py``) launches the kernels it captured without the
    wrappers' Python running, so its executor adds the captured step's
    launches once a replay, and takes back what the wrappers counted while
    the graph was captured (``times=-1``), when nothing launched."""
    for table in _COUNTS:
        for k in table:
            table[k] += times * counts.get(k, 0)
