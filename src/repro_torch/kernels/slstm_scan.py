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
launch, and a refused launch raises.  One launch per call.

Training: :class:`SLSTMScan` is the differentiable scan.  Its forward is
the same kernel told to also write each step's gate pre-activations and
(c, n, m); its backward is ``csrc/slstm_scan_bwd.cu`` (its own library),
planned by :func:`plan_bwd` on one of two routes by shape (R's columns
as bf16 fragments in registers and the product on the tensor cores, or R's
rows in shared memory and the product on the CUDA cores), which gives the
gradient on wx, and the gradient on R is one batched product
(``ref.slstm_dr``)."""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.kernels import build, ref

LAUNCHES = {"slstm_scan": 0, "slstm_scan_bwd": 0}

# as csrc/slstm_scan.cu: batch rows a pass, wx ring slots, threads a block
# and k-slices a unit (neighbouring lanes, a power of two)
ROWS, RING, MAX_THREADS, MAX_SLICES = 4, 4, 256, 16
# as csrc/slstm_scan_bwd.cu: its ring's slots and fields a slot (z~ i~ f~ o~
# c n m dh), and the floats of a thread's slice of R held in registers (its
# kRows and kMaxThreads are ROWS and MAX_THREADS)
BWD_RING, BWD_FIELDS, BWD_REG_K = 4, 8, 96
# the backward's routes, by the C entry point's number
BWD_ROUTES = ("simt", "mma")
# as csrc/slstm_scan_bwd.cu's mma route: warps a block (the hd rows of R
# split over them), units a block at most (its 4 U columns: 4 k-steps of
# 16), batch rows a tile (N of m16n8k16), its ring's slots, and m-tiles of 16
# rows a warp at most (hd <= 512)
MMA_WARPS, MMA_UNITS, MMA_ROWS, MMA_RING, MMA_MAX_MTILES = 8, 16, 8, 5, 4

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


def _smem_floats_bwd(b: int, hd: int, u: int, j: int) -> int:
    """csrc/slstm_scan_bwd.cu's ``make_layout(B, hd, U, J).total``: R's U
    rows of 4 hd and the head's dwx_t rows (B padded to a pass of ROWS), each
    in J slices of k_slice floats at an odd count of float4s apart, the
    saved-state ring, and 7 B U floats of state, carries and dh."""
    k_slice = 4 * -(-hd // j)
    row = j * (k_slice + (8 if (k_slice // 4) % 2 else 4))
    return (u * row + -(-b // ROWS) * ROWS * row
            + BWD_RING * BWD_FIELDS * b * u + 7 * b * u)


def _split(nh: int, hd: int, n_sm: int, slice_floats: int
           ) -> tuple[int, int, int]:
    """(units a block, groups a head, k-slices): as many blocks a head as
    the ``n_sm`` SMs give each head, and J a power of two up to MAX_SLICES
    with U x J <= MAX_THREADS and slices of at least 4 of the
    ``slice_floats`` a unit sums over."""
    units = -(-hd // max(1, min(hd, n_sm // nh)))
    slices = 1
    while (2 * slices <= min(MAX_SLICES, MAX_THREADS // units)
           and 2 * slices <= -(-slice_floats // 4)):
        slices *= 2
    return units, -(-hd // units), slices


def _refuse(what: str, nh: int, hd: int, p: "Plan", n_sm: int,
            smem_per_block: int) -> None:
    if p.blocks > n_sm or p.threads > MAX_THREADS or \
            p.smem_bytes > smem_per_block:
        raise ValueError(
            f"{what}: R of {nh} heads of {hd} units "
            f"({nh * hd * 4 * hd * 4} bytes) cannot be held on chip: "
            f"{p.blocks} blocks of {p.units} units, each {p.r_bytes} bytes "
            f"of R and {p.smem_bytes} bytes of shared memory in all, "
            f"{p.threads} threads, against {n_sm} SMs of {smem_per_block} "
            f"bytes a block and {MAX_THREADS} threads")


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
    units, groups, slices = _split(nh, hd, n_sm, hd)
    p = Plan(units, groups, nh * groups, slices, units * slices,
             hd * 4 * units * 4, 4 * _smem_floats(b, hd, units, slices))
    _refuse("slstm scan", nh, hd, p, n_sm, smem_per_block)
    return p


def _mma_mtiles(hd: int) -> int:
    """The mma route's m-tiles of 16 rows a warp: the least power of two
    whose MMA_WARPS warps cover R's hd rows."""
    mw = 1
    while MMA_WARPS * 16 * mw < hd:
        mw *= 2
    return mw


def _smem_floats_mma(b: int, u: int, groups: int) -> int:
    """csrc/slstm_scan_bwd.cu's ``make_mma_layout(B, U, G).total``: the
    block's dwx_t in fragment order (4 k-steps of 16, the rows padded to
    tiles of MMA_ROWS), the head's G partial sums of its units, the
    saved-state ring, and the initial state laid out as one of its
    slots."""
    nt = -(-b // MMA_ROWS)
    return (4 * nt * MMA_ROWS * 16 + groups * b * u
            + (MMA_RING + 1) * BWD_FIELDS * b * u)


@dataclass(frozen=True)
class BwdPlan(Plan):
    """The backward's plan: :class:`Plan`'s split of the heads' units into
    blocks, and the route.  On the ``simt`` route ``slices`` is J, the
    k-slices a unit (neighbouring lanes); on the ``mma`` route the m-tiles
    of 16 rows of R a warp."""
    route: str = "simt"


def _plan_mma(b: int, nh: int, hd: int, n_sm: int) -> Optional[BwdPlan]:
    """The mma route's plan, or None where R's columns do not tile its
    fragments: at most MMA_UNITS units a block, hd within MMA_WARPS x 16 x
    MMA_MAX_MTILES rows, and a gate thread for each of the block's B U
    pairs.  Its ``r_bytes`` are the fragments': 16 rows x 4 MMA_UNITS
    columns an m-tile, bf16 hi and lo."""
    units, groups, _ = _split(nh, hd, n_sm, 4 * hd)
    mw = _mma_mtiles(hd)
    if (units > MMA_UNITS or mw > MMA_MAX_MTILES
            or b * units > 32 * MMA_WARPS):
        return None
    return BwdPlan(units, groups, nh * groups, mw, 32 * MMA_WARPS,
                   MMA_WARPS * mw * 16 * 4 * MMA_UNITS * 4,
                   4 * _smem_floats_mma(b, units, groups), "mma")


def plan_bwd(b: int, nh: int, hd: int, n_sm: int, smem_per_block: int,
             route: Optional[str] = None) -> BwdPlan:
    """The backward kernel's plan: the forward's split of a head's units
    into blocks of U, each block holding the U x 4 hd of R that touch its
    units (the bytes the forward's block holds).  The route comes from the
    shape, before any launch: ``mma`` (the units' 4 U columns of R as bf16
    fragments in registers, the product on the tensor cores, partial sums
    of dh exchanged) where :func:`_plan_mma` tiles them and its shared
    memory fits, else ``simt`` (the units' rows of R in shared memory, the
    head's dwx_t exchanged, J k-slices of the 4 hd-long sums a unit, ROWS
    batch rows a pass).  ``route`` forces one (chip_smoke times both).
    Raises a ``ValueError`` naming the bytes and the capacity where R
    cannot be held on chip, or where a forced route does not take the
    shape."""
    if min(b, nh, hd, n_sm) < 1:
        raise ValueError(f"slstm scan backward: no plan for B {b}, nh {nh}, "
                         f"hd {hd} on {n_sm} SMs")
    if route not in (None, *BWD_ROUTES):
        raise ValueError(f"slstm scan backward: no route {route!r}")
    mma = _plan_mma(b, nh, hd, n_sm)
    if route is None:
        route = ("mma" if mma is not None
                 and mma.smem_bytes <= smem_per_block else "simt")
    if route == "mma":
        if mma is None:
            raise ValueError(f"slstm scan backward: the mma route does not "
                             f"take B {b}, {nh} heads of {hd}")
        p = mma
    else:
        units, groups, slices = _split(nh, hd, n_sm, 4 * hd)
        p = BwdPlan(units, groups, nh * groups, slices, units * slices,
                    hd * 4 * units * 4,
                    4 * _smem_floats_bwd(b, hd, units, slices), "simt")
    _refuse("slstm scan backward", nh, hd, p, n_sm, smem_per_block)
    return p


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.slstm_scan_fwd.argtypes = [_P, _L, _L, _L, _L, _P, _P, _P, _P, _P,
                                   _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                   _I, _I, _I, _I, _I, _I, _IP, _IP, _P]
    lib.slstm_scan_fwd.restype = _I
    lib.slstm_scan_limits.argtypes = [_IP, _IP]
    lib.slstm_scan_limits.restype = _I
    return lib


def _bind_bwd(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.slstm_scan_bwd.argtypes = [_P] * 13 + [_I] * 7 + [_IP, _IP, _P]
    lib.slstm_scan_bwd.restype = _I
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    return _bind(build.load("slstm_scan"))


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    return _bind_bwd(build.load("slstm_scan_bwd"))


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


def _after_launch(what: str, status: int, p: Plan, smem: ctypes.c_int,
                  resident: ctypes.c_int) -> None:
    """Raise where the card refused the launch or the kernel laid out
    other shared memory than the plan counted."""
    if status == 82:                   # cudaErrorCooperativeLaunchTooLarge
        raise RuntimeError(f"{what}: {p.blocks} blocks of {p.threads} "
                           f"threads and {p.smem_bytes} bytes cannot all be "
                           f"resident: the card holds {resident.value}")
    build.check(status, f"{what} launch")
    if smem.value != p.smem_bytes:     # the plan's capacity rule is off
        raise RuntimeError(f"{what}: the kernel lays out {smem.value} "
                           f"bytes of shared memory, the plan {p.smem_bytes}")


def _launch(lib: ctypes.CDLL, wx: torch.Tensor, r: torch.Tensor,
            state: Optional[tuple], save: bool = False):
    """Plan and launch on checked inputs; raises where the plan refuses
    the shape or the card refuses the launch.  With ``save`` the kernel
    also writes each step's pre-activations (B, S, 4, nh, hd) and c, n, m
    (B, S, nh, hd), returned third."""
    b, s, _, nh, hd = wx.shape
    p = plan(b, nh, hd, *card_limits(wx.device.index or 0))
    h_out = torch.empty(b, s, nh, hd, device=wx.device)
    final = tuple(torch.empty(b, nh, hd, device=wx.device) for _ in range(4))
    saved = ((torch.empty(b, s, 4, nh, hd, device=wx.device),)
             + tuple(torch.empty_like(h_out) for _ in range(3))
             if save else None)
    arrivals = torch.zeros(nh, dtype=torch.int32, device=wx.device)
    init = (0, 0, 0, 0) if state is None else tuple(
        t.data_ptr() for t in state)
    smem, resident = ctypes.c_int(0), ctypes.c_int(0)
    stream = torch.cuda.current_stream(wx.device).cuda_stream
    status = lib.slstm_scan_fwd(
        wx.data_ptr(), *wx.stride()[:4], r.data_ptr(), *init,
        h_out.data_ptr(), *(t.data_ptr() for t in final),
        *((t.data_ptr() for t in saved) if save else (0, 0, 0, 0)),
        arrivals.data_ptr(), b, s, nh, hd, p.units, p.slices,
        ctypes.byref(smem), ctypes.byref(resident), stream)
    _after_launch("slstm scan", status, p, smem, resident)
    return (h_out, final, saved) if save else (h_out, final)


def slstm_scan_cuda(wx: torch.Tensor, r: torch.Tensor,
                    state: Optional[tuple] = None, *, save: bool = False):
    """Launch the kernel: h (B, S, nh, hd) and the final (h, c, n, m), all
    fp32, as ``ref.slstm_scan_ref`` computes them; with ``save`` also what
    the backward reads, (pre, c, n, m): each step's gate pre-activations
    (B, S, 4, nh, hd) and cell state (B, S, nh, hd) each."""
    _check(wx, r, state)
    out = _launch(_lib(), wx, r, state, save)
    LAUNCHES["slstm_scan"] += 1
    return out


def slstm_scan_bwd_cuda(r: torch.Tensor, pre: torch.Tensor, c: torch.Tensor,
                        n: torch.Tensor, m: torch.Tensor,
                        state: Optional[tuple], dh: torch.Tensor,
                        plan: Optional[BwdPlan] = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the backward kernel: dwx (B, S, 4, nh, hd) and dh_0 (B, nh,
    hd), as ``ref.slstm_scan_bwd_ref`` computes them, from what
    :func:`slstm_scan_cuda` saved and the upstream gradient ``dh`` (B, S,
    nh, hd) on h; ``state`` is the forward's initial (h, c, n, m) or None.
    ``plan`` forces a route (chip_smoke times both); by default
    :func:`plan_bwd` picks it from the shape.  A shape whose R the plan
    cannot hold raises a ``ValueError`` before any launch."""
    dh = dh.float().contiguous()
    p = _check_bwd(r, pre, c, n, m, state, dh, plan)
    out = _launch_bwd(_bwd_lib(), r, pre, c, n, m, state, dh, p)
    LAUNCHES["slstm_scan_bwd"] += 1
    return out


def _check_bwd(r, pre, c, n, m, state, dh, plan) -> BwdPlan:
    """Raise on what the backward kernel does not take; else its plan."""
    b, s, _, nh, hd = pre.shape
    named = [("r", r, (nh, hd, 4 * hd)), ("pre", pre, (b, s, 4, nh, hd)),
             ("c", c, (b, s, nh, hd)), ("n", n, (b, s, nh, hd)),
             ("m", m, (b, s, nh, hd)), ("dh", dh, (b, s, nh, hd))]
    if state is not None:
        named += [(f, t, (b, nh, hd)) for f, t in zip("cnm", state[1:])]
    for name, t, shape in named:
        if (t.device != pre.device or pre.device.type != "cuda"
                or t.dtype != torch.float32 or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"slstm scan backward: {name} must be a "
                             f"contiguous fp32 {shape} tensor on a CUDA "
                             f"device, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    return plan or plan_bwd(b, nh, hd, *card_limits(pre.device.index or 0))


def _launch_bwd(lib: ctypes.CDLL, r, pre, c, n, m, state, dh, p):
    b, s, _, nh, hd = pre.shape
    dwx = torch.empty_like(pre)
    dh0 = torch.empty(b, nh, hd, device=pre.device)
    # the mma route's exchange: each block's partial sums of dh, one
    # (groups, B, hd) buffer a head and step parity
    part = (torch.empty(2, nh, p.groups, b, hd, device=pre.device)
            if p.route == "mma" else None)
    arrivals = torch.zeros(nh, dtype=torch.int32, device=pre.device)
    init = (0, 0, 0) if state is None else tuple(
        t.data_ptr() for t in state[1:])
    smem, resident = ctypes.c_int(0), ctypes.c_int(0)
    stream = torch.cuda.current_stream(pre.device).cuda_stream
    status = lib.slstm_scan_bwd(
        r.data_ptr(), pre.data_ptr(), c.data_ptr(), n.data_ptr(),
        m.data_ptr(), dh.data_ptr(), *init, dwx.data_ptr(), dh0.data_ptr(),
        0 if part is None else part.data_ptr(), arrivals.data_ptr(), b, s,
        nh, hd, BWD_ROUTES.index(p.route), p.units, p.slices,
        ctypes.byref(smem), ctypes.byref(resident), stream)
    _after_launch("slstm scan backward", status, p, smem, resident)
    return dwx, dh0


class SLSTMScan(torch.autograd.Function):
    """The differentiable sLSTM scan on the card: the forward kernel,
    saving each step's pre-activations and (c, n, m); the backward kernel
    for the gradient on wx; the gradient on R as one batched product of the
    h each step read with dwx (``ref.slstm_dr``).  The initial state is not
    differentiated (training starts from zeros and m = -1e30): a state
    tensor that requires a gradient raises, and the final state carries
    none.  Under a layer recomputed in the backward pass
    (``torch.utils.checkpoint``), the tensors saved here come from the
    recompute."""

    @staticmethod
    def forward(ctx, wx, r, h0, c0, n0, m0):
        if any(ctx.needs_input_grad[2:]):
            raise ValueError("slstm scan: the initial state is not "
                             "differentiated; pass one that requires no "
                             "gradient")
        state = None if h0 is None else (h0, c0, n0, m0)
        h_out, final, saved = slstm_scan_cuda(wx, r, state, save=True)
        ctx.mark_non_differentiable(*final)
        ctx.save_for_backward(r, h_out, *saved,
                              *(() if state is None else state))
        return (h_out, *final)

    @staticmethod
    def backward(ctx, dh, *_):
        r, h_out, pre, c, n, m, *state = ctx.saved_tensors
        state = tuple(state) or None
        dwx, _ = slstm_scan_bwd_cuda(r, pre, c, n, m, state, dh)
        dr = ref.slstm_dr(h_out, state and state[0], dwx)
        return dwx, dr, None, None, None, None


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


# the phases of a backward step that a build with SLSTM_PROFILE times: the
# saved-state ring's copies issued and waited for (simt; on the mma route
# the loop's turn alone); the gate math with its dwx stores (mma: after
# adding the head's partial sums); the publish and the barrier (mma: with
# the next step's state-only math in its shadow); the exchange's read
# through L2 (simt: the head's dwx_t; mma: the partial sums of the block's
# units); the product; the sums' way out (simt: the butterfly and dh
# stores; mma: the partial sums' stores, then the ring's copies issued and
# waited for)
BWD_PHASES = ("ring", "gate math", "barrier", "exchange read", "product",
              "sums out")


def bwd_step_profile(r: torch.Tensor, pre: torch.Tensor, c: torch.Tensor,
                     n: torch.Tensor, m: torch.Tensor, dh: torch.Tensor,
                     plan: Optional[BwdPlan] = None) -> dict[str, float]:
    """SM clocks of each phase of a backward step from the zero state,
    averaged over the steps of one launch in its first block's thread 0,
    from a diagnostic build (``-DSLSTM_PROFILE``, a library of its own) of
    the route ``plan`` names (:func:`plan_bwd`'s by default).  Not counted
    in ``LAUNCHES``: the main path never runs this build."""
    dh = dh.float().contiguous()
    p = _check_bwd(r, pre, c, n, m, None, dh, plan)
    lib = _bind_bwd(build.load("slstm_scan_bwd", ("SLSTM_PROFILE",)))
    lib.slstm_scan_bwd_profile.argtypes = [_P]
    lib.slstm_scan_bwd_profile.restype = _I
    _launch_bwd(lib, r, pre, c, n, m, None, dh, p)
    torch.cuda.synchronize(pre.device)
    clocks = (ctypes.c_longlong * len(BWD_PHASES))()
    build.check(lib.slstm_scan_bwd_profile(clocks),
                "slstm_scan_bwd profile read")
    return {name: v / pre.shape[1] for name, v in zip(BWD_PHASES, clocks)}
