"""Amax-scaled int8/fp8 fake quantization on the card:
``csrc/quantize.cu`` bound with ctypes.

Counterpart of the JAX package's ``kernels/quantize.py``
(``quantize_dequantize_pallas``), in a batched form: one scale per leading
slice (per client), as the JAX engine's vmapped calls give.  Two routes,
chosen by :func:`plan` from the slice size before any launch:

- ``fused``: one launch, one thread block cluster of C blocks a slice,
  where C blocks' shared memory holds the slice (the training round's cut
  tensors).  The slice is read from device memory once.
- ``two_pass``: an amax pass that writes per-block partial maxima, then a
  quantize-dequantize pass that takes their max on the device, so nothing
  waits on the host between them (slices beyond a cluster: the VGG cuts).

A failed build, a refused launch or a cluster that the card cannot hold
raises; nothing gives way to the other route or to the plain version."""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import QMAX

LAUNCHES = {"quantize_fused": 0, "quantize_amax": 0, "quantize_qdq": 0}

# as csrc/quantize.cu: the two-pass kernels' threads a block and 16-byte
# loads in flight a thread; the fused kernel's threads a block, bytes a bulk
# copy, largest cluster and the static shared memory a block keeps besides
# its share
THREADS, UNROLL = 256, 4
FUSED_THREADS, CHUNK_BYTES, MAX_CLUSTER, SCRATCH_BYTES = 512, 32768, 8, 1024
CLUSTER_SIZES = (1, 2, 4, MAX_CLUSTER)

_FMT_CODE = {"int8": 0, "fp8": 1}

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_IP = ctypes.POINTER(ctypes.c_int)


@dataclass(frozen=True)
class Plan:
    """How one call spreads over the card."""
    route: str          # "fused" or "two_pass"
    slices: int         # S
    n: int              # floats a slice
    cluster: int        # fused: C blocks a slice; two-pass: 0
    share_bytes: int    # fused: a block's share of its slice, on chip
    smem_bytes: int     # fused: the share plus the block's own scratch
    parts: int          # two-pass: amax blocks (partials) a slice; fused: 0
    blocks: int         # blocks of the fused launch or of the amax pass


def fused_plan(s: int, n: int, smem_optin: int) -> Optional[Plan]:
    """The smallest cluster whose blocks each hold a share of a slice (n /
    C floats, rounded up to 16 bytes) in the shared memory a block may opt
    in to, less its scratch; None where no cluster size holds it."""
    for c in CLUSTER_SIZES:
        share = -(-n // c)                       # floats a block
        share = -(-share // 4) * 16              # bytes, to 16
        if share + SCRATCH_BYTES <= smem_optin:
            return Plan("fused", s, n, c, share, share + SCRATCH_BYTES, 0,
                        s * c)
    return None


def two_pass_plan(s: int, n: int, n_sm: int, amax_per_sm: int) -> Plan:
    """The amax pass's grid: blocks enough to fill the card once (its SMs
    times the blocks resident on each), shared among the slices, and no
    more than give each thread one round of UNROLL 16-byte loads."""
    per_block = THREADS * 4 * UNROLL
    parts = max(1, min(-(-n // per_block), n_sm * amax_per_sm // s))
    return Plan("two_pass", s, n, 0, 0, 0, parts, s * parts)


def plan(s: int, n: int, n_sm: int, smem_optin: int,
         amax_per_sm: int) -> Plan:
    """The fused route where a cluster holds a slice, else two passes."""
    if min(s, n, n_sm, smem_optin, amax_per_sm) < 1:
        raise ValueError(f"quantize: no plan for {s} slices of {n} on "
                         f"{n_sm} SMs")
    return (fused_plan(s, n, smem_optin)
            or two_pass_plan(s, n, n_sm, amax_per_sm))


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.quantize_limits.argtypes = [_IP, _IP, _IP]
    lib.quantize_limits.restype = _I
    lib.quantize_fused_clusters.argtypes = [_I, _I, _I, _IP]
    lib.quantize_fused_clusters.restype = _I
    lib.quantize_fused.argtypes = [_P, _I, _LL, _I, _I, _I, _P, _P, _P]
    lib.quantize_fused.restype = _I
    lib.quantize_amax.argtypes = [_P, _I, _LL, _I, _P, _P]
    lib.quantize_amax.restype = _I
    lib.quantize_qdq.argtypes = [_P, _I, _LL, _P, _I, _I, _P, _P, _P]
    lib.quantize_qdq.restype = _I
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    return _bind(build.load("quantize"))


@functools.cache
def card_limits(device_index: int) -> tuple[int, int, int]:
    """(SMs, shared memory a block may opt in to, amax-pass blocks resident
    on an SM) of a card."""
    vals = [ctypes.c_int(0) for _ in range(3)]
    with torch.cuda.device(device_index):
        build.check(_lib().quantize_limits(*map(ctypes.byref, vals)),
                    "quantize card limits")
    return tuple(v.value for v in vals)


@functools.cache
def resident_clusters(device_index: int, cluster: int, share_bytes: int,
                      fmt: str) -> int:
    """Clusters of the fused kernel that the card holds at once; raises
    where it holds none."""
    n = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        build.check(_lib().quantize_fused_clusters(
            cluster, share_bytes, _FMT_CODE[fmt], ctypes.byref(n)),
            "quantize_fused occupancy")
    if n.value < 1:
        raise RuntimeError(f"quantize_fused: the card holds no cluster of "
                           f"{cluster} blocks with {share_bytes} bytes of "
                           f"shared memory each")
    return n.value


def slices(x: torch.Tensor, per_slice: bool) -> tuple[int, int]:
    """(S, n): the call's slices and floats a slice."""
    s = x.shape[0] if per_slice else 1
    if x.numel() == 0 or s < 1:
        raise ValueError("quantize kernel takes a non-empty tensor")
    return s, x.numel() // s


def plan_for(x: torch.Tensor, per_slice: bool) -> Plan:
    """:func:`plan` for a tensor on a card, from that card's limits."""
    return plan(*slices(x, per_slice), *card_limits(x.device.index or 0))


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _launch_fused(lib: ctypes.CDLL, xf: torch.Tensor, fmt: str, p: Plan,
                  amax: Optional[torch.Tensor]) -> torch.Tensor:
    if p.route != "fused":
        raise ValueError(f"quantize_fused: plan is {p.route}")
    resident_clusters(xf.device.index or 0, p.cluster, p.share_bytes, fmt)
    out = torch.empty_like(xf)
    build.check(lib.quantize_fused(
        xf.data_ptr(), p.slices, p.n, p.cluster, p.share_bytes,
        _FMT_CODE[fmt], out.data_ptr(), _ptr(amax), _stream(xf)),
        "quantize_fused launch")
    return out


def quantize_fused(xf: torch.Tensor, fmt: str, p: Plan,
                   amax: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the one-pass kernel on a contiguous fp32 ``xf``; writes each
    slice's amax into ``amax`` (S,) where it is given."""
    out = _launch_fused(_lib(), xf, fmt, p, amax)
    LAUNCHES["quantize_fused"] += 1
    return out


# the moments each fused block stamps, after its start
PHASES = ("share landed, max taken", "cluster amax known", "stores issued")


def fused_profile(xf: torch.Tensor, fmt: str, p: Plan) -> dict:
    """One launch of a diagnostic build of the fused kernel
    (``-DQUANTIZE_PROFILE``, a library of its own): each block's start and
    the end of each of its :data:`PHASES`, in ns from the first block's
    start, as (blocks,) lists under "start" and each phase's name.  Not
    counted in ``LAUNCHES``: the main path never runs this build."""
    lib = _bind(build.load("quantize", ("QUANTIZE_PROFILE",)))
    lib.quantize_fused_stamps.argtypes = [_P, _I]
    lib.quantize_fused_stamps.restype = _I
    _launch_fused(lib, xf, fmt, p, None)
    torch.cuda.synchronize(xf.device)
    stamps = (ctypes.c_ulonglong * (4 * p.blocks))()
    build.check(lib.quantize_fused_stamps(stamps, p.blocks),
                "quantize_fused stamps read")
    t0 = min(stamps[4 * b] for b in range(p.blocks))
    return {name: [stamps[4 * b + k] - t0 for b in range(p.blocks)]
            for k, name in enumerate(("start",) + PHASES)}


def quantize_amax(xf: torch.Tensor, p: Plan) -> torch.Tensor:
    """Launch the amax pass: (S, parts) per-block maxima of |x|."""
    partial = torch.empty(p.slices, p.parts, device=xf.device,
                          dtype=torch.float32)
    build.check(_lib().quantize_amax(xf.data_ptr(), p.slices, p.n, p.parts,
                                     partial.data_ptr(), _stream(xf)),
                "quantize_amax launch")
    LAUNCHES["quantize_amax"] += 1
    return partial


def quantize_qdq(xf: torch.Tensor, partial: torch.Tensor, fmt: str,
                 p: Plan, amax: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """Launch the quantize-dequantize pass, each slice's scale taken from
    the max of its partials on the device; writes each slice's amax into
    ``amax`` (S,) where it is given."""
    out = torch.empty_like(xf)
    build.check(_lib().quantize_qdq(
        xf.data_ptr(), p.slices, p.n, partial.data_ptr(), p.parts,
        _FMT_CODE[fmt], out.data_ptr(), _ptr(amax), _stream(xf)),
        "quantize_qdq launch")
    LAUNCHES["quantize_qdq"] += 1
    return out


def run(xf: torch.Tensor, fmt: str, p: Plan,
        amax: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The round trip of a contiguous fp32 ``xf`` by the route of ``p``."""
    if p.route == "fused":
        return quantize_fused(xf, fmt, p, amax)
    return quantize_qdq(xf, quantize_amax(xf, p), fmt, p, amax)


def quantize_dequantize_cuda(x: torch.Tensor, fmt: str, *,
                             per_slice: bool = False) -> torch.Tensor:
    """Fake-quantize a CUDA tensor through ``fmt``, bit for bit as
    ``ref.quantize_dequantize_ref`` does, by the route :func:`plan`
    picks."""
    if fmt not in QMAX:
        raise ValueError(f"unknown wire format {fmt!r}; "
                         f"known: {', '.join(sorted(QMAX))}")
    if x.device.type != "cuda":
        raise ValueError("quantize kernel input must lie on a CUDA device")
    xf = x.to(torch.float32).contiguous()
    return run(xf, fmt, plan_for(xf, per_slice)).to(x.dtype)
