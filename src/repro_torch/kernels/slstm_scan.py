"""The sLSTM recurrence on the card: ``csrc/slstm_scan.cu`` bound with
ctypes.

Counterpart of the JAX package's ``kernels/slstm_scan.py``
(``slstm_scan``): wx (B, S, 4, nh, hd) gate inputs [z, i, f, o], r (nh,
hd, 4 hd) gate-major recurrent weights, fp32, plus an initial (h, c, n, m)
of (B, nh, hd) each, or none for zeros and m = -1e30.  Returns h (B, S, nh,
hd) and the final (h, c, n, m).  The kernel reads wx through its strides,
so a (B, S, 4, nh, hd) view of the model's contiguous (B, S, 4d)
projection goes in as it is.  One launch per call."""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build

LAUNCHES = {"slstm_scan": 0}

MAX_HEAD_DIM = 1024                    # one thread per unit of a head

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("slstm_scan")
    lib.slstm_scan_fwd.argtypes = [_P, _L, _L, _L, _L, _P, _P, _P, _P, _P,
                                   _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
    lib.slstm_scan_fwd.restype = _I
    return lib


def _check(wx: torch.Tensor, r: torch.Tensor,
           state: Optional[tuple]) -> None:
    if wx.device.type != "cuda":
        raise ValueError(f"slstm scan: wx must lie on a CUDA device, not "
                         f"{wx.device}")
    if wx.dim() != 5 or wx.shape[2] != 4:
        raise ValueError(f"slstm scan: wx must be (B, S, 4, nh, hd), got "
                         f"{tuple(wx.shape)}")
    b, s, _, nh, hd = wx.shape
    if s < 1 or not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"slstm scan needs S >= 1 and 1 <= hd <= "
                         f"{MAX_HEAD_DIM}, got S {s}, hd {hd}")
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


def slstm_scan_cuda(wx: torch.Tensor, r: torch.Tensor,
                    state: Optional[tuple] = None):
    """Launch the kernel: h (B, S, nh, hd) and the final (h, c, n, m), all
    fp32, as ``ref.slstm_scan_ref`` computes them."""
    _check(wx, r, state)
    b, s, _, nh, hd = wx.shape
    h_out = torch.empty(b, s, nh, hd, device=wx.device)
    final = tuple(torch.empty(b, nh, hd, device=wx.device) for _ in range(4))
    init = (0, 0, 0, 0) if state is None else tuple(
        t.data_ptr() for t in state)
    stream = torch.cuda.current_stream(wx.device).cuda_stream
    build.check(_lib().slstm_scan_fwd(
        wx.data_ptr(), *wx.stride()[:4], r.data_ptr(), *init,
        h_out.data_ptr(), *(t.data_ptr() for t in final), b, s, nh, hd,
        stream), "slstm_scan launch")
    LAUNCHES["slstm_scan"] += 1
    return h_out, final
