"""The sLSTM recurrence on the card: ``csrc/slstm_scan.cu`` bound with
ctypes.

Counterpart of the JAX package's ``kernels/slstm_scan.py``
(``slstm_scan``): wx (B, S, 4, nh, hd) gate inputs [z, i, f, o], r (nh,
hd, 4 hd) gate-major recurrent weights, fp32, plus an initial (h, c, n, m)
of (B, nh, hd) each, or none for zeros and m = -1e30.  Returns h (B, S, nh,
hd) and the final (h, c, n, m).  The kernel reads wx through its strides,
so a (B, S, 4, nh, hd) view of the model's contiguous (B, S, 4d)
projection goes in as it is.

R stays on chip for all S steps: :func:`plan` splits each head's units
into groups of U, one block a group holding R's columns of its units in
shared memory (and the first rows of each thread's share in registers),
and the blocks of a head exchange h through ``h_out`` with one barrier a
step.  The grid is launched cooperatively, so it must fit on the card at
once; a shape whose R cannot be held raises a ``ValueError`` before any
launch, and a refused launch raises.  One launch per call."""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.kernels import build

LAUNCHES = {"slstm_scan": 0}

# as csrc/slstm_scan.cu: batch rows a pass, wx ring slots, threads a block
# and k-slices a unit (neighbouring lanes, a power of two)
ROWS, RING, MAX_THREADS, MAX_SLICES = 4, 4, 256, 16

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_IP = ctypes.POINTER(ctypes.c_int)


@dataclass(frozen=True)
class Plan:
    """How the kernel spreads one call over the card."""
    units: int          # U: hidden units a block owns, in all four gates
    groups: int         # blocks a head: ceil(hd / U)
    blocks: int         # nh x groups, all resident at once
    slices: int         # J: k-slices of the hd-long sums; U x J threads
    threads: int
    r_bytes: int        # the block's columns of R: hd x 4U fp32
    smem_bytes: int     # the block's dynamic shared memory, R included


def _smem_floats(b: int, hd: int, u: int, j: int) -> int:
    """csrc/slstm_scan.cu's ``make_layout(B, hd, U, J).total``."""
    k_slice = 4 * -(-hd // (4 * j))
    stride = j * (k_slice + (8 if (k_slice // 4) % 2 else 4))
    return (4 * u * stride + -(-b // ROWS) * ROWS * stride
            + ROWS * 4 * u + RING * b * 4 * u + 4 * b * u)


def plan(b: int, nh: int, hd: int, n_sm: int, smem_per_block: int
         ) -> Plan:
    """Spread a head's R over as many blocks as the card's ``n_sm`` SMs
    give each head (one block an SM); the last group of a head holds the
    units left over.  Each block's shared memory must fit
    ``smem_per_block``.  Raises a ``ValueError`` naming the bytes and the
    capacity where R cannot be held on chip."""
    if min(b, nh, hd, n_sm) < 1:
        raise ValueError(f"slstm scan: no plan for B {b}, nh {nh}, hd {hd} "
                         f"on {n_sm} SMs")
    r_total = nh * hd * 4 * hd * 4
    units = -(-hd // max(1, min(hd, n_sm // nh)))
    groups = -(-hd // units)
    slices = 1                         # a power of two: lanes of a unit
    while (2 * slices <= min(MAX_SLICES, MAX_THREADS // units)
           and 2 * slices <= -(-hd // 4)):
        slices *= 2
    smem = 4 * _smem_floats(b, hd, units, slices)
    p = Plan(units, groups, nh * groups, slices, units * slices,
             hd * 4 * units * 4, smem)
    if p.blocks > n_sm or p.threads > MAX_THREADS or smem > smem_per_block:
        raise ValueError(
            f"slstm scan: R of {nh} heads of {hd} units ({r_total} bytes) "
            f"cannot be held on chip: {p.blocks} blocks of {units} units, "
            f"each {p.r_bytes} bytes of R and {smem} bytes of shared memory "
            f"in all, {p.threads} threads, against {n_sm} SMs of "
            f"{smem_per_block} bytes a block and {MAX_THREADS} threads")
    return p


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.slstm_scan_fwd.argtypes = [_P, _L, _L, _L, _L, _P, _P, _P, _P, _P,
                                   _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                   _I, _I, _IP, _IP, _P]
    lib.slstm_scan_fwd.restype = _I
    lib.slstm_scan_limits.argtypes = [_IP, _IP]
    lib.slstm_scan_limits.restype = _I
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    return _bind(build.load("slstm_scan"))


@functools.cache
def card_limits(device_index: int) -> tuple[int, int]:
    """(SMs, shared memory a block may opt in to) of a card."""
    n_sm, smem = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device_index):
        build.check(_lib().slstm_scan_limits(ctypes.byref(n_sm),
                                             ctypes.byref(smem)),
                    "slstm_scan card limits")
    return n_sm.value, smem.value


def _check(wx: torch.Tensor, r: torch.Tensor,
           state: Optional[tuple]) -> None:
    if wx.device.type != "cuda":
        raise ValueError(f"slstm scan: wx must lie on a CUDA device, not "
                         f"{wx.device}")
    if wx.dim() != 5 or wx.shape[2] != 4:
        raise ValueError(f"slstm scan: wx must be (B, S, 4, nh, hd), got "
                         f"{tuple(wx.shape)}")
    b, s, _, nh, hd = wx.shape
    if s < 1 or hd < 1:
        raise ValueError(f"slstm scan needs S >= 1 and hd >= 1, got S {s}, "
                         f"hd {hd}")
    if wx.stride(-1) != 1:
        raise ValueError("slstm scan: wx's unit dim must be contiguous")
    named = [("wx", wx, wx.shape), ("r", r, (nh, hd, 4 * hd))]
    if state is not None:
        if len(state) != 4:
            raise ValueError("slstm scan: the state is (h, c, n, m)")
        named += [(f, t, (b, nh, hd)) for f, t in zip("hcnm", state)]
    for name, t, shape in named:
        if t.device != wx.device or t.dtype != torch.float32:
            raise ValueError(f"slstm scan: {name} must be fp32 on "
                             f"{wx.device}, got {t.dtype} on {t.device}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"slstm scan: {name} is {tuple(t.shape)}, want "
                             f"{tuple(shape)}")
        if name != "wx" and not t.is_contiguous():
            raise ValueError(f"slstm scan: {name} must be contiguous")


def _launch(lib: ctypes.CDLL, wx: torch.Tensor, r: torch.Tensor,
            state: Optional[tuple]):
    """Plan and launch on checked inputs; raises where the plan refuses
    the shape or the card refuses the launch."""
    b, s, _, nh, hd = wx.shape
    p = plan(b, nh, hd, *card_limits(wx.device.index or 0))
    h_out = torch.empty(b, s, nh, hd, device=wx.device)
    final = tuple(torch.empty(b, nh, hd, device=wx.device) for _ in range(4))
    arrivals = torch.zeros(nh, dtype=torch.int32, device=wx.device)
    init = (0, 0, 0, 0) if state is None else tuple(
        t.data_ptr() for t in state)
    smem, resident = ctypes.c_int(0), ctypes.c_int(0)
    stream = torch.cuda.current_stream(wx.device).cuda_stream
    status = lib.slstm_scan_fwd(
        wx.data_ptr(), *wx.stride()[:4], r.data_ptr(), *init,
        h_out.data_ptr(), *(t.data_ptr() for t in final),
        arrivals.data_ptr(), b, s, nh, hd, p.units, p.slices,
        ctypes.byref(smem), ctypes.byref(resident), stream)
    if status == 82:                   # cudaErrorCooperativeLaunchTooLarge
        raise RuntimeError(f"slstm scan: {p.blocks} blocks of {p.threads} "
                           f"threads and {p.smem_bytes} bytes cannot all be "
                           f"resident: the card holds {resident.value}")
    build.check(status, "slstm_scan launch")
    if smem.value != p.smem_bytes:     # the plan's capacity rule is off
        raise RuntimeError(f"slstm scan: the kernel lays out {smem.value} "
                           f"bytes of shared memory, the plan {p.smem_bytes}")
    return h_out, final


def slstm_scan_cuda(wx: torch.Tensor, r: torch.Tensor,
                    state: Optional[tuple] = None):
    """Launch the kernel: h (B, S, nh, hd) and the final (h, c, n, m), all
    fp32, as ``ref.slstm_scan_ref`` computes them."""
    _check(wx, r, state)
    out = _launch(_lib(), wx, r, state)
    LAUNCHES["slstm_scan"] += 1
    return out


# the phases of a step that a build with SLSTM_PROFILE times, in order
PHASES = ("wx copies issued", "wait for the head's blocks",
          "sync after the wait", "h_{t-1} loaded", "wx in, sync",
          "partial sums", "butterfly, gate inputs, sync", "gates",
          "sync after the gates", "publish")


def step_profile(wx: torch.Tensor, r: torch.Tensor) -> dict[str, float]:
    """SM clocks of each phase of a step, averaged over the steps of one
    launch in its first block, from a diagnostic build of the kernel
    (``-DSLSTM_PROFILE``, a library of its own).  Not counted in
    ``LAUNCHES``: the main path never runs this build."""
    _check(wx, r, None)
    lib = _bind(build.load("slstm_scan", ("SLSTM_PROFILE",)))
    lib.slstm_scan_profile.argtypes = [_P]
    lib.slstm_scan_profile.restype = _I
    _launch(lib, wx, r, None)
    torch.cuda.synchronize(wx.device)
    clocks = (ctypes.c_longlong * len(PHASES))()
    build.check(lib.slstm_scan_profile(clocks), "slstm_scan profile read")
    return {name: c / wx.shape[1] for name, c in zip(PHASES, clocks)}
