"""The Mamba2 (SSD) selective scan on the card: ``csrc/mamba2_scan.cu``
bound with ctypes.

Counterpart of the JAX package's ``kernels/mamba2_scan.py``
(``mamba2_scan``): x (B, S, nh, hd), dt (B, S, nh) fp32, A and D (nh,)
fp32, B and C (B, S, N) of one group shared by all heads, from a zero
state.  Returns y (B, S, nh, hd) in x's dtype and, where the TPU kernel
returns y only, the final state (B, nh, hd, N) in fp32, the layout of the
model's decode cache.  The kernel reads x, B, C and dt through their
strides, so the model's slices of its conv output go in as they are.  Any
S >= 1; hd and N at most 64.  One launch per call."""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

LAUNCHES = {"mamba2_scan": 0}

MAX_DIM = 64                           # hd and N, padded to 64 in the kernel
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("mamba2_scan")
    lib.mamba2_scan_fwd.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                    _P, _P, _I, _I, _I, _I, _I, _I, _P]
    lib.mamba2_scan_fwd.restype = _I
    return lib


def _check(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
           B: torch.Tensor, C: torch.Tensor, D: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"mamba2 scan: x must lie on a CUDA device, not "
                         f"{x.device}")
    if x.dim() != 4:
        raise ValueError(f"mamba2 scan: x must be (B, S, nh, hd), got "
                         f"{tuple(x.shape)}")
    b, s, nh, hd = x.shape
    if x.dtype not in _DTYPE_CODE:
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


def mamba2_scan_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                     B: torch.Tensor, C: torch.Tensor, D: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel: y (B, S, nh, hd) in x's dtype and the final state
    (B, nh, hd, N) in fp32, as ``ref.mamba2_scan_ref`` computes them."""
    _check(x, dt, A, B, C, D)
    b, s, nh, hd = x.shape
    n = B.shape[-1]
    y = torch.empty(b, s, nh, hd, dtype=x.dtype, device=x.device)
    state = torch.empty(b, nh, hd, n, device=x.device)
    strides = [(ctypes.c_longlong * 3)(*t.stride()[:3]) for t in (x, dt)]
    strides += [(ctypes.c_longlong * 2)(*t.stride()[:2]) for t in (B, C)]
    ptr = lambda a: ctypes.cast(a, ctypes.c_void_p)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    build.check(_lib().mamba2_scan_fwd(
        x.data_ptr(), ptr(strides[0]), dt.data_ptr(), ptr(strides[1]),
        A.data_ptr(), B.data_ptr(), ptr(strides[2]), C.data_ptr(),
        ptr(strides[3]), D.data_ptr(), y.data_ptr(), state.data_ptr(),
        _DTYPE_CODE[x.dtype], b, s, nh, hd, n, stream), "mamba2_scan launch")
    LAUNCHES["mamba2_scan"] += 1
    return y, state
