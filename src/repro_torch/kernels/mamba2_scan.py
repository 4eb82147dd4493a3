"""The Mamba2 (SSD) selective scan on the card: ``csrc/mamba2_scan.cu``
bound with ctypes.

Counterpart of the JAX package's ``kernels/mamba2_scan.py``
(``mamba2_scan``): x (B, S, nh, hd), dt (B, S, nh) fp32, A and D (nh,)
fp32, B and C (B, S, N) of one group shared by all heads, from a zero
state.  Returns y (B, S, nh, hd) in x's dtype and, where the TPU kernel
returns y only, the final state (B, nh, hd, N) in fp32, the layout of the
model's decode cache.  The dtype picks the kernel: bf16 goes to
``mamba2_scan_kernel_mma`` (the chunk products on the tensor cores, fp32
operands split into bf16 terms, chunk loads by cp.async ahead of the
math), fp32 to the CUDA-core ``mamba2_scan_kernel`` (an mma on fp32 data
would be TF32).  Neither stands in for the other: a bf16 view the mma
kernel cannot read raises (``mma_layout_problem`` says why).  Both read x,
B, C and dt through their strides, so the model's slices of its conv
output go in as they are.  Any S >= 1; hd and N at most 64 (multiples of 8
in bf16).  One launch per call.

Training: ``mamba2_scan_cuda(..., save=True)`` launches the same kernel
with a buffer for the state at the start of every chunk of ``CHUNK``
steps, and ``mamba2_scan_bwd_cuda`` (``csrc/mamba2_scan_bwd.cu``, its own
library) walks the chunks in reverse from those states for the gradients
on x, dt, A, B, C and D; :class:`Mamba2Scan` is the autograd Function over
the two."""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.kernels import build

# "mamba2_scan" counts every launch, "mamba2_scan_mma" those of the bf16
# kernel, "mamba2_scan_bwd" every backward call (its launches: two on the
# simt route, three on the mma route), "mamba2_scan_bwd_mma" those on the
# mma route
LAUNCHES = {"mamba2_scan": 0, "mamba2_scan_mma": 0, "mamba2_scan_bwd": 0,
            "mamba2_scan_bwd_mma": 0}

MAX_DIM = 64                           # hd and N, padded to 64 in the kernel
CHUNK = 64                             # steps of a chunk, both kernels
# bf16 terms each fp32 operand of the bf16 kernel's products is split into;
# CHUNK and TERMS state the .cu's kL and kTerms, which a CPU test holds
# them to
TERMS = 2
# heads a backward block takes on the simt route (the first design), their
# dB and dC summed before it writes them as partials; the .cu's kHeads,
# which a CPU test holds it to
BWD_HEADS = 2
SIMT_SMEM = 185_152  # the first design's kSmemBytes
# the backward's routes: "mma" (bf16 on the tensor cores) and "simt" (the
# first design, fp32 on the CUDA cores, for fp32 inputs)
BWD_ROUTES = ("simt", "mma")
# as csrc/mamba2_scan_bwd.cu's mma route: threads a block (one head and
# batch row), blocks a cluster at most (kMmaCluster: the cluster's heads'
# dB, dC and dCB terms summed through DSMEM), fp32 terms of the lower
# triangle of a 64 x 64 tile packed by 16 x 16 tiles (kTriFloats: C B^T
# and dCB), floats of a cluster's partial set a batch row and chunk
# (kSlotFloats: dCB, dC, dB) and the shared memory a block (kMmaSmemBytes)
BWD_MMA_THREADS = 256
BWD_MMA_CLUSTER = 8
BWD_TRI_FLOATS = 10 * 16 * 16
BWD_SLOT_FLOATS = BWD_TRI_FLOATS + 2 * CHUNK * MAX_DIM
BWD_MMA_SMEM = 115_488
# bf16 terms each fp32 operand of the mma route's products is split into
# (kBwdTerms; 2 meet chip_smoke's tolerance in the CPU emulation, 1 does
# not: tests/test_torch_mamba2_bwd_split.py)
BWD_TERMS = 2
# the phases of a chunk that each route's MAMBA2_BWD_PROFILE build times,
# in its enum's order
BWD_PHASES = {
    "simt": ("B, C loads", "C B^T", "head loads, prefix sum",
             "M, G', Q, dCB", "dxdt, dx", "dC, dB terms", "da sums",
             "dS update", "dCB B, dCB^T C", "partial writes"),
    "mma": ("wait, loads issued", "B dS, G'^T dy, dx",
            "dy S0^T, y_inter, <dS, S0>", "barrier, Q's sums",
            "x dS^T, R, dS update", "barrier", "dS stored",
            "da, cluster sums"),
}
# the phases of a chunk that a build with MAMBA2_PROFILE times, in order
PROFILE_PHASES = ("wait for the chunk's loads", "C B^T and G", "C S",
                  "state update", "prefix sum", "wait for G", "G x",
                  "store")
PROFILE_WARPS = 8                      # the warps of one block

_P, _I = ctypes.c_void_p, ctypes.c_int


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    for fn in (lib.mamba2_scan_fwd, lib.mamba2_scan_mma_fwd):
        fn.argtypes = [_P] * 13 + [_I] * 5 + [_P]
        fn.restype = _I
    lib.mamba2_scan_mma_occupancy.argtypes = [_P]
    lib.mamba2_scan_mma_occupancy.restype = _I
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    return _bind(build.load("mamba2_scan"))


def _bind_bwd(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.mamba2_scan_bwd.argtypes = [_I] + [_P] * 20 + [_I] * 5 + [_P]
    lib.mamba2_scan_bwd.restype = _I
    lib.mamba2_scan_bwd_mma.argtypes = [_P] * 20 + [_I] * 6 + [_P]
    lib.mamba2_scan_bwd_mma.restype = _I
    return lib


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    return _bind_bwd(build.load("mamba2_scan_bwd"))


def mma_layout_problem(x: torch.Tensor, B: torch.Tensor,
                       C: torch.Tensor) -> Optional[str]:
    """Why the bf16 kernel's 16-byte cp.async loads cannot read x (B, S,
    nh, hd), B or C (B, S, N), or None: each must be bf16, its last dim
    contiguous and a multiple of 8 up to 64, its base 16-byte aligned, and
    every other stride of a dim longer than 1 a positive multiple of 16
    bytes.  It reads shapes, strides, addresses and dtypes only, so it runs
    on ``meta`` tensors without a card."""
    for name, t, axes in (("x", x, ("batch", "time", "head")),
                          ("B", B, ("batch", "time")),
                          ("C", C, ("batch", "time"))):
        if t.dtype != torch.bfloat16:
            return f"{name} is {t.dtype}, not torch.bfloat16"
        if t.dim() != len(axes) + 1 or t.shape[-1] % 8 \
                or not 8 <= t.shape[-1] <= MAX_DIM:
            return (f"{name}'s last dim of {tuple(t.shape)} is not a "
                    f"multiple of 8 in [8, {MAX_DIM}]")
        if t.stride(-1) != 1:
            return f"{name}'s last dim is not contiguous"
        if t.data_ptr() % 16:
            return (f"{name}'s base address is {t.data_ptr() % 16} bytes "
                    "past a 16-byte boundary")
        for axis, n, s in zip(axes, t.shape, t.stride()):
            if n > 1 and (s <= 0 or s * t.element_size() % 16):
                return (f"{name}'s {axis} stride of {s} elements is not a "
                        "positive multiple of 16 bytes")
    return None


def _check(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
           B: torch.Tensor, C: torch.Tensor, D: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"mamba2 scan: x must lie on a CUDA device, not "
                         f"{x.device}")
    if x.dim() != 4:
        raise ValueError(f"mamba2 scan: x must be (B, S, nh, hd), got "
                         f"{tuple(x.shape)}")
    b, s, nh, hd = x.shape
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"mamba2 scan takes fp32 or bf16 x, not {x.dtype}")
    n = B.shape[-1]
    if s < 1 or not 1 <= hd <= MAX_DIM or not 1 <= n <= MAX_DIM:
        raise ValueError(f"mamba2 scan needs S >= 1 and hd, N in [1, "
                         f"{MAX_DIM}], got S {s}, hd {hd}, N {n}")
    named = [("dt", dt, (b, s, nh), torch.float32),
             ("A", A, (nh,), torch.float32), ("D", D, (nh,), torch.float32),
             ("B", B, (b, s, n), x.dtype), ("C", C, (b, s, n), x.dtype)]
    for name, t, shape, dtype in named:
        if t.device != x.device or t.dtype != dtype:
            raise ValueError(f"mamba2 scan: {name} must be {dtype} on "
                             f"{x.device}, got {t.dtype} on {t.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"mamba2 scan: {name} is {tuple(t.shape)}, "
                             f"want {shape}")
    for name, t in (("x", x), ("B", B), ("C", C), ("A", A), ("D", D)):
        if t.stride(-1) != 1:
            raise ValueError(f"mamba2 scan: {name}'s last dim must be "
                             "contiguous")
    if x.dtype == torch.bfloat16:
        problem = mma_layout_problem(x, B, C)
        if problem:
            raise ValueError(f"mamba2 scan, bf16 (mma) kernel: {problem}")


def _strides(x, dt, B, C) -> list:
    """The (batch, time, head) strides of x and dt and the (batch, time)
    strides of B and C, as the C entry points take them."""
    out = [(ctypes.c_longlong * 3)(*t.stride()[:3]) for t in (x, dt)]
    return out + [(ctypes.c_longlong * 2)(*t.stride()[:2]) for t in (B, C)]


def _ptr(a) -> ctypes.c_void_p:
    return ctypes.cast(a, ctypes.c_void_p)


def chunks(s: int) -> int:
    """The kernels' chunks of ``CHUNK`` steps over S steps."""
    return -(-s // CHUNK)


def _launch(lib: ctypes.CDLL, x: torch.Tensor, dt: torch.Tensor,
            A: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
            D: torch.Tensor, save: bool = False) -> tuple:
    b, s, nh, hd = x.shape
    n = B.shape[-1]
    y = torch.empty(b, s, nh, hd, dtype=x.dtype, device=x.device)
    state = torch.empty(b, nh, hd, n, device=x.device)
    starts = (torch.empty(b, chunks(s), nh, hd, n, device=x.device) if save
              else None)
    strides = _strides(x, dt, B, C)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    fn = (lib.mamba2_scan_mma_fwd if x.dtype == torch.bfloat16
          else lib.mamba2_scan_fwd)
    build.check(fn(
        x.data_ptr(), _ptr(strides[0]), dt.data_ptr(), _ptr(strides[1]),
        A.data_ptr(), B.data_ptr(), _ptr(strides[2]), C.data_ptr(),
        _ptr(strides[3]), D.data_ptr(), y.data_ptr(), state.data_ptr(),
        0 if starts is None else starts.data_ptr(), b, s, nh, hd, n, stream),
        "mamba2_scan launch")
    return (y, state, starts) if save else (y, state)


def mamba2_scan_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                     B: torch.Tensor, C: torch.Tensor, D: torch.Tensor, *,
                     save: bool = False) -> tuple:
    """Launch the kernel of x's dtype: y (B, S, nh, hd) in x's dtype and
    the final state (B, nh, hd, N) in fp32, as ``ref.mamba2_scan_ref``
    computes them (the bf16 kernel's products carry fp32 operands as two
    bf16 terms each, to within 2^-16 of each operand).  With ``save``
    (the training variant) also the state at the start of every chunk,
    (B, ceil(S / CHUNK), nh, hd, N) fp32, where the backward starts each
    chunk from: ``ref.mamba2_scan_ref(..., chunk=CHUNK)``'s third output;
    y and the final state are the serving variant's bit for bit."""
    _check(x, dt, A, B, C, D)
    out = _launch(_lib(), x, dt, A, B, C, D, save)
    LAUNCHES["mamba2_scan"] += 1
    if x.dtype == torch.bfloat16:
        LAUNCHES["mamba2_scan_mma"] += 1
    return out


def _check_bwd(x, dt, A, B, C, D, states, dy,
               plan: Optional["BwdPlan"] = None) -> "BwdPlan":
    """The forward's checks on its inputs, then the saved states (B, ceil(S
    / CHUNK), nh, hd, N) fp32 contiguous and dy (B, S, nh, hd) in x's
    dtype on x's device; returns the plan (``plan`` must be the one that
    :func:`plan_bwd` gives these shapes on its route)."""
    _check(x, dt, A, B, C, D)
    b, s, nh, hd = x.shape
    want = (b, chunks(s), nh, hd, B.shape[-1])
    if states.device != x.device or states.dtype != torch.float32 \
            or tuple(states.shape) != want or not states.is_contiguous():
        raise ValueError(f"mamba2 scan backward: the saved states must be "
                         f"a contiguous fp32 {want} on {x.device}, got "
                         f"{states.dtype} {tuple(states.shape)} on "
                         f"{states.device}")
    if dy.device != x.device or dy.dtype != x.dtype \
            or tuple(dy.shape) != tuple(x.shape):
        raise ValueError(f"mamba2 scan backward: dy must be {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}, got {dy.dtype} "
                         f"{tuple(dy.shape)} on {dy.device}")
    p = plan_bwd(x.dtype, b, s, nh, hd, B.shape[-1],
                 route=plan.route if plan else None)
    if plan is not None and plan != p:
        raise ValueError(f"mamba2 scan backward: {plan} is not the plan for "
                         f"these shapes, {p}")
    return p


@dataclass(frozen=True)
class BwdPlan:
    """How the backward spreads one call over the card."""
    route: str          # "mma" or "simt"
    grid: tuple         # the main kernel's (x, y) blocks
    threads: int        # a block
    smem_bytes: int     # a block's dynamic shared memory
    cluster: int        # blocks a cluster (1 on the simt route)
    groups: int         # partial sets a batch row and chunk
    scratch_floats: int  # fp32 scratch the wrapper hands the kernels


def plan_bwd(dtype: torch.dtype, b: int, s: int, nh: int, hd: int, n: int,
             route: Optional[str] = None) -> BwdPlan:
    """The backward's plan, from the inputs' dtype and shape alone, before
    any launch.  bf16 goes to ``mma``: one block of BWD_MMA_THREADS per head
    and batch row, in clusters of the largest of 8, 4, 2 and 1 heads that
    divides nh, whose dB, dC and dCB terms are summed through DSMEM into
    one partial set a cluster, batch row and chunk; a prologue forms C B^T
    and an epilogue dCB B and dCB^T C once a batch row and chunk.  fp32
    goes to ``simt`` (the first design: BWD_HEADS heads a block on the CUDA
    cores; an mma on fp32 data would be TF32).  ``route`` forces one (bf16
    may take ``simt``, which chip_smoke times beside ``mma``).  Raises a
    ``ValueError`` for a dtype, shape or forced route that no route
    takes."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"mamba2 scan backward: no route for {dtype}")
    if min(b, s, nh) < 1 or not (1 <= hd <= MAX_DIM and 1 <= n <= MAX_DIM):
        raise ValueError(f"mamba2 scan backward: no route for B {b}, S {s}, "
                         f"nh {nh}, hd {hd}, N {n} (hd and N in [1, "
                         f"{MAX_DIM}])")
    if route not in (None, *BWD_ROUTES):
        raise ValueError(f"mamba2 scan backward: no route {route!r}")
    route = route or ("mma" if dtype == torch.bfloat16 else "simt")
    if route == "simt":
        groups = -(-nh // BWD_HEADS)
        return BwdPlan("simt", (groups, b), 256, SIMT_SMEM, 1, groups,
                       2 * groups * b * s * n + 2 * b * nh)
    if dtype != torch.bfloat16 or hd % 8 or n % 8:
        raise ValueError(f"mamba2 scan backward: the mma route takes bf16 "
                         f"with hd and N multiples of 8, got {dtype}, hd "
                         f"{hd}, N {n}")
    cluster = next(c for c in (BWD_MMA_CLUSTER, 4, 2, 1) if nh % c == 0)
    groups = nh // cluster
    return BwdPlan("mma", (nh, b), BWD_MMA_THREADS, BWD_MMA_SMEM, cluster,
                   groups, b * chunks(s) * (BWD_TRI_FLOATS
                                            + groups * BWD_SLOT_FLOATS)
                   + 2 * b * nh)


def mamba2_scan_bwd_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                         B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                         states: torch.Tensor, dy: torch.Tensor, *,
                         plan: Optional[BwdPlan] = None
                         ) -> tuple[torch.Tensor, ...]:
    """The scan's backward on the card, from the forward's inputs and its
    saved chunk states (``mamba2_scan_cuda(..., save=True)``) and the
    upstream gradient ``dy`` on y (made contiguous here): (dx, ddt, dA, dB,
    dC, dD), dx, dB and dC in their inputs' dtypes, ddt, dA and dD in
    fp32, as ``ref.mamba2_scan_bwd_ref`` computes them, on the route
    :func:`plan_bwd` gives (or ``plan``'s, a route forced).  The mma route
    launches a prologue (C B^T), the main kernel and an epilogue (the
    clusters' partials summed, dCB B and dCB^T C, dA and dD); the simt
    route the first design's kernel and its merge.  Counted once in
    ``LAUNCHES["mamba2_scan_bwd"]``, and in ``"mamba2_scan_bwd_mma"`` on
    the mma route; two calls on the same inputs agree bit for bit."""
    p = _check_bwd(x, dt, A, B, C, D, states, dy, plan)
    out = _launch_bwd(_bwd_lib(), x, dt, A, B, C, D, states,
                      dy.contiguous(), p)
    LAUNCHES["mamba2_scan_bwd"] += 1
    if p.route == "mma":
        LAUNCHES["mamba2_scan_bwd_mma"] += 1
    return out


def _launch_bwd(lib: ctypes.CDLL, x, dt, A, B, C, D, states, dy,
                p: BwdPlan) -> tuple:
    b, s, nh, hd = x.shape
    n = B.shape[-1]
    dev = x.device
    dx = torch.empty(b, s, nh, hd, dtype=x.dtype, device=dev)
    ddt = torch.empty(b, s, nh, device=dev)
    dB = torch.empty(b, s, n, dtype=B.dtype, device=dev)
    dC = torch.empty(b, s, n, dtype=C.dtype, device=dev)
    dA = torch.empty(nh, device=dev)
    dD = torch.empty(nh, device=dev)
    scratch = torch.empty(p.scratch_floats, device=dev)
    part_ad = scratch[scratch.numel() - 2 * b * nh:]
    strides = _strides(x, dt, B, C)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = (x.data_ptr(), _ptr(strides[0]), dt.data_ptr(), _ptr(strides[1]),
            A.data_ptr(), B.data_ptr(), _ptr(strides[2]), C.data_ptr(),
            _ptr(strides[3]), D.data_ptr(), dy.data_ptr(), states.data_ptr(),
            dx.data_ptr(), ddt.data_ptr(), dB.data_ptr(), dC.data_ptr(),
            dA.data_ptr(), dD.data_ptr())
    if p.route == "mma":
        status = lib.mamba2_scan_bwd_mma(*ptrs, scratch.data_ptr(),
                                         part_ad.data_ptr(), b, s, nh, hd, n,
                                         p.cluster, stream)
    else:
        status = lib.mamba2_scan_bwd(
            int(x.dtype == torch.bfloat16), *ptrs, scratch.data_ptr(),
            part_ad.data_ptr(), b, s, nh, hd, n, stream)
    build.check(status, f"mamba2_scan backward launch ({p.route} route)")
    return dx, ddt, dA, dB, dC, dD


def bwd_profile(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                states: torch.Tensor, dy: torch.Tensor,
                plan: Optional[BwdPlan] = None) -> dict[str, float]:
    """One launch of the backward on ``plan``'s route (:func:`plan_bwd`'s
    by default) built with ``-DMAMBA2_BWD_PROFILE`` (a library of its own):
    the SM clocks of each phase of a chunk (``BWD_PHASES[route]``) in block
    (0, 0)'s thread 0, averaged over its chunks.  Not counted in
    ``LAUNCHES``: the main path never runs this build."""
    p = _check_bwd(x, dt, A, B, C, D, states, dy, plan)
    lib = _bind_bwd(build.load("mamba2_scan_bwd", ("MAMBA2_BWD_PROFILE",)))
    fn = getattr(lib, f"mamba2_scan_bwd_{p.route}_profile")
    fn.argtypes, fn.restype = [_P], _I
    phases = BWD_PHASES[p.route]
    clocks = (ctypes.c_longlong * len(phases))()
    build.check(fn(clocks), "mamba2_scan_bwd profile clear")
    _launch_bwd(lib, x, dt, A, B, C, D, states, dy.contiguous(), p)
    torch.cuda.synchronize(x.device)
    build.check(fn(clocks), "mamba2_scan_bwd profile read")
    return {k: clocks[i] / chunks(x.shape[1]) for i, k in enumerate(phases)}


class Mamba2Scan(torch.autograd.Function):
    """The differentiable scan on the card: the forward kernel's training
    variant, saving its inputs and the chunk states; the backward kernel
    for the gradients on x, dt, A, B, C and D.  The scan starts from the
    zero state and its final state carries no gradient (training drops
    it).  Under a layer recomputed in the backward pass
    (``torch.utils.checkpoint``), the tensors saved here come from the
    recompute."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, D):
        y, final, states = mamba2_scan_cuda(x, dt, A, B, C, D, save=True)
        ctx.mark_non_differentiable(final)
        ctx.save_for_backward(x, dt, A, B, C, D, states)
        return y, final

    @staticmethod
    def backward(ctx, dy, _):
        return mamba2_scan_bwd_cuda(*ctx.saved_tensors, dy)


def bwd_mma_residency() -> tuple[int, int]:
    """The mma route's main kernel on the current card: its blocks resident
    on one SM, and its clusters of BWD_MMA_CLUSTER blocks resident at once,
    as the occupancy calculator gives them."""
    blocks, clusters = ctypes.c_int(0), ctypes.c_int(0)
    fn = _bwd_lib().mamba2_scan_bwd_mma_occupancy
    fn.argtypes, fn.restype = [_I, _P, _P], _I
    build.check(fn(BWD_MMA_CLUSTER, ctypes.byref(blocks),
                   ctypes.byref(clusters)),
                "mamba2_scan backward occupancy query")
    return blocks.value, clusters.value


def mma_blocks_per_sm() -> int:
    """The bf16 kernel's blocks resident on one SM of the current card, as
    the occupancy calculator gives it for its 256 threads and shared
    memory."""
    blocks = ctypes.c_int(0)
    build.check(_lib().mamba2_scan_mma_occupancy(ctypes.byref(blocks)),
                "mamba2_scan occupancy query")
    return blocks.value


def chunk_profile(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  B: torch.Tensor, C: torch.Tensor, D: torch.Tensor
                  ) -> dict[str, list[float]]:
    """One launch of the bf16 kernel built with ``-DMAMBA2_PROFILE`` (a
    library of its own): for each phase of a chunk (``PROFILE_PHASES``),
    the SM clocks a chunk of each of block (0, 0)'s 8 warps, averaged over
    the chunks.  Not counted in ``LAUNCHES``: it is a diagnostic, not the
    path."""
    _check(x, dt, A, B, C, D)
    if x.dtype != torch.bfloat16:
        raise ValueError("mamba2 scan: the chunk profile is of the bf16 "
                         "kernel")
    lib = _bind(build.load("mamba2_scan", ("MAMBA2_PROFILE",)))
    lib.mamba2_scan_mma_profile.argtypes = [_P]
    lib.mamba2_scan_mma_profile.restype = _I
    n_ph = len(PROFILE_PHASES)
    clocks = (ctypes.c_ulonglong * (PROFILE_WARPS * n_ph))()
    build.check(lib.mamba2_scan_mma_profile(clocks), "mamba2_scan profile "
                "clear")
    _launch(lib, x, dt, A, B, C, D)
    torch.cuda.synchronize(x.device)
    build.check(lib.mamba2_scan_mma_profile(clocks), "mamba2_scan profile "
                "read")
    n_chunks = chunks(x.shape[1])
    return {k: [clocks[w * n_ph + i] / n_chunks
                for w in range(PROFILE_WARPS)]
            for i, k in enumerate(PROFILE_PHASES)}
