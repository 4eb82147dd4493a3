"""The Eq. (5) clustering loss on the card: ``csrc/clustering_loss.cu``
bound with ctypes, forward and backward in a ``torch.autograd.Function``.

Counterpart of the JAX package's ``kernels/clustering_loss.py``
(``clustering_loss_pallas``).  Each direction is two launches: a grid of
(TILE_B anchors x TILE_Q queue entries) tiles writes per-Q-block partials
into scratch allocated here, and a merge sums them in Q-block order.  The
forward saves the per-anchor ``lse`` and ``n_pos`` and the device-side
denominator; the backward recomputes the softmax from them.  Only ``z``
gets a gradient: the queue holds teacher features and is stop-gradient."""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

LAUNCHES = {"clustering_fwd": 0, "clustering_bwd": 0}

MAX_DIM = 128     # the staged rows hold at most 128 floats
# the tile of the (B, Q) logit matrix a block of the partial kernels takes;
# they state the .cu's kTileB and kTileQ, which a CPU test holds them to
TILE_B, TILE_Q = 16, 128

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.clustering_fwd.argtypes = [_P] * 7 + [_I, _I, _I, _F] + [_P] * 7
    lib.clustering_fwd.restype = _I
    lib.clustering_bwd.argtypes = [_P] * 7 + [_I, _I, _I, _F] + [_P] * 7
    lib.clustering_bwd.restype = _I
    lib.clustering_occupancy.argtypes = [_I, _P, _P]
    lib.clustering_occupancy.restype = _I
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    return _bind(build.load("clustering_loss"))


def _prepare(z, pseudo, anchor_ok, queue_z, queue_label, queue_conf,
             queue_valid):
    """Validate and lay out the kernel's inputs: fp32 features, int32
    labels, bool flags, all contiguous on one CUDA device."""
    if z.dim() != 2 or queue_z.dim() != 2 or z.shape[1] != queue_z.shape[1]:
        raise ValueError(f"z {tuple(z.shape)} and queue_z "
                         f"{tuple(queue_z.shape)} must be (B, d) and (Q, d)")
    b, d = z.shape
    if b < 1 or not 1 <= d <= MAX_DIM:
        raise ValueError(f"clustering kernel takes B >= 1 and "
                         f"1 <= d <= {MAX_DIM}, got B={b}, d={d}")
    q = queue_z.shape[0]
    ts = (z, pseudo, anchor_ok, queue_z, queue_label, queue_conf,
          queue_valid)
    if any(t.device != z.device for t in ts) or z.device.type != "cuda":
        raise ValueError("clustering kernel inputs must all lie on one "
                         "CUDA device")
    if pseudo.shape != (b,) or anchor_ok.shape != (b,):
        raise ValueError("pseudo and anchor_ok must be (B,)")
    if any(t.shape != (q,) for t in (queue_label, queue_conf, queue_valid)):
        raise ValueError("queue_label, queue_conf and queue_valid must be "
                         "(Q,)")
    c = lambda t, dt: t.to(dt).contiguous()
    return (c(z, torch.float32), c(pseudo, torch.int32),
            c(anchor_ok, torch.bool), c(queue_z.detach(), torch.float32),
            c(queue_label, torch.int32), c(queue_conf, torch.bool),
            c(queue_valid, torch.bool))


def _ptrs(ts):
    return [t.data_ptr() for t in ts]


def q_blocks(q: int) -> int:
    """Q-blocks of the partial kernels' grid, and rows of their scratch."""
    return -(-q // TILE_Q)


def clustering_fwd(inputs, inv_temp: float):
    """Launch the forward.  Returns (loss, lse, n_pos, denom), all on the
    device; denom = max(#anchors with positives, 1)."""
    z, qz = inputs[0], inputs[3]
    b, d = z.shape
    q = qz.shape[0]
    part = torch.empty((q_blocks(q), b, 4), device=z.device)
    pos_sum, n_pos, lse = (torch.empty(b, device=z.device) for _ in range(3))
    loss = torch.empty((), device=z.device)
    denom = torch.empty((), device=z.device)
    stream = torch.cuda.current_stream(z.device).cuda_stream
    build.check(_lib().clustering_fwd(
        *_ptrs(inputs), b, q, d, inv_temp, part.data_ptr(),
        pos_sum.data_ptr(), n_pos.data_ptr(), lse.data_ptr(),
        loss.data_ptr(), denom.data_ptr(), stream), "clustering_fwd launch")
    LAUNCHES["clustering_fwd"] += 1
    return loss, lse, n_pos, denom


def clustering_bwd(inputs, inv_temp: float, lse, n_pos, g, denom):
    """Launch the backward: dz for the scalar cotangent ``g``."""
    z, qz = inputs[0], inputs[3]
    b, d = z.shape
    q = qz.shape[0]
    part = torch.empty((q_blocks(q), b, d), device=z.device)
    dz = torch.empty_like(z)
    g = g.to(torch.float32).contiguous()
    stream = torch.cuda.current_stream(z.device).cuda_stream
    build.check(_lib().clustering_bwd(
        *_ptrs(inputs), b, q, d, inv_temp, lse.data_ptr(), n_pos.data_ptr(),
        g.data_ptr(), denom.data_ptr(), part.data_ptr(), dz.data_ptr(),
        stream), "clustering_bwd launch")
    LAUNCHES["clustering_bwd"] += 1
    return dz


def blocks_per_sm(d: int) -> tuple[int, int]:
    """The forward's and the backward's partial kernel: blocks resident on
    one SM of the current card at width ``d``, as the occupancy calculator
    gives it for their threads and shared memory."""
    fwd, bwd = ctypes.c_int(0), ctypes.c_int(0)
    build.check(_lib().clustering_occupancy(d, ctypes.byref(fwd),
                                            ctypes.byref(bwd)),
                "clustering occupancy query")
    return fwd.value, bwd.value


class ClusteringLoss(torch.autograd.Function):
    """Eq. (5) through the CUDA kernels; differentiable in z only."""

    @staticmethod
    def forward(ctx, z, pseudo, anchor_ok, queue_z, queue_label, queue_conf,
                queue_valid, temperature: float):
        inputs = _prepare(z, pseudo, anchor_ok, queue_z, queue_label,
                          queue_conf, queue_valid)
        inv_temp = 1.0 / temperature
        loss, lse, n_pos, denom = clustering_fwd(inputs, inv_temp)
        ctx.save_for_backward(*inputs, lse, n_pos, denom)
        ctx.inv_temp = inv_temp
        ctx.z_dtype = z.dtype
        return loss

    @staticmethod
    def backward(ctx, g):
        *inputs, lse, n_pos, denom = ctx.saved_tensors
        dz = clustering_bwd(inputs, ctx.inv_temp, lse, n_pos, g, denom)
        return (dz.to(ctx.z_dtype),) + (None,) * 7
