"""Forward GQA flash attention on the card: ``csrc/flash_attention.cu``
bound with ctypes.

Counterpart of the JAX package's ``kernels/flash_attention.py``
(``flash_attention``): q (B, H, Sq, hd), k and v (B, KVH, Skv, hd), causal
or not, an optional sliding window, fp32 or bf16.  The kernel reads every
tensor through its strides, so a (B, H, S, hd) view of a (B, S, H, hd)
tensor goes in as it is; the output is allocated with q's strides, so such
a caller gets it back in its own layout.  Any Sq and Skv: the ragged edges
are masked in the kernel.  One launch per call."""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

LAUNCHES = {"flash_attention": 0}

HEAD_DIMS = (32, 64, 80, 96, 112, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    lib.flash_attention_fwd.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                        _I, _I, _P, _I, _I, _P]
    lib.flash_attention_fwd.restype = _I
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: int) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"flash attention: {name} must lie on q's "
                             f"CUDA device, not {t.device}")
        if t.dim() != 4 or t.dtype != q.dtype:
            raise ValueError(f"flash attention: {name} must be 4-d "
                             f"{q.dtype}, got {t.dim()}-d {t.dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"flash attention: {name}'s head dim must be "
                             "contiguous")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"flash attention takes fp32 or bf16, not {q.dtype}")
    b, h, sq, hd = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"flash attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if h % k.shape[1]:
        raise ValueError(f"flash attention: {h} query heads are not a "
                         f"multiple of {k.shape[1]} kv heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash attention: head dim {hd} not in "
                         f"{HEAD_DIMS}")
    if sq < 1 or k.shape[2] < 1 or window < 0:
        raise ValueError("flash attention needs Sq, Skv >= 1 and a "
                         "window >= 0")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: int = 0) -> torch.Tensor:
    """Launch the kernel: (B, H, Sq, hd) x (B, KVH, Skv, hd) -> (B, H, Sq,
    hd) in q's dtype, as ``ref.flash_attention_ref`` computes it."""
    _check(q, k, v, window)
    out = torch.empty_like(q)          # q's strides, hence q's layout
    b, h, sq, hd = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    strides = (ctypes.c_longlong * 12)(*(
        s for t in (q, k, v, out) for s in t.stride()[:3]))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    build.check(_lib().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _DTYPE_CODE[q.dtype], b, h, kvh, sq, skv, hd,
        ctypes.cast(strides, ctypes.c_void_p), int(causal), int(window),
        stream), "flash_attention launch")
    LAUNCHES["flash_attention"] += 1
    return out
