"""Amax-scaled int8/fp8 fake quantization on the card:
``csrc/quantize.cu`` bound with ctypes.

Counterpart of the JAX package's ``kernels/quantize.py``
(``quantize_dequantize_pallas``), in a batched form: one scale per leading
slice (per client), as the JAX engine's vmapped calls give.  Two launches
per call: the amax pass writes one amax per slice into device memory, the
qdq pass reads it there, so nothing waits on the host between them."""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import QMAX

LAUNCHES = {"quantize_amax": 0, "quantize_qdq": 0}

_FMT_CODE = {"int8": 0, "fp8": 1}

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("quantize")
    lib.quantize_amax.argtypes = [_P, _I, _LL, _P, _P]
    lib.quantize_amax.restype = _I
    lib.quantize_qdq.argtypes = [_P, _I, _LL, _P, _I, _P, _P]
    lib.quantize_qdq.restype = _I
    return lib


def _slices(x: torch.Tensor, per_slice: bool) -> tuple[int, int]:
    s = x.shape[0] if per_slice else 1
    if x.numel() == 0 or s < 1:
        raise ValueError("quantize kernel takes a non-empty tensor")
    return s, x.numel() // s


def quantize_amax(x: torch.Tensor, per_slice: bool) -> torch.Tensor:
    """Launch the amax pass: (S,) fp32 amax(|x_s|) per slice."""
    s, n = _slices(x, per_slice)
    amax = torch.zeros(s, device=x.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    build.check(_lib().quantize_amax(x.data_ptr(), s, n, amax.data_ptr(),
                                     stream), "quantize_amax launch")
    LAUNCHES["quantize_amax"] += 1
    return amax


def quantize_qdq(x: torch.Tensor, amax: torch.Tensor, fmt: str,
                 per_slice: bool) -> torch.Tensor:
    """Launch the quantize-dequantize pass with each slice's scale taken
    from ``amax`` on the device."""
    s, n = _slices(x, per_slice)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    build.check(_lib().quantize_qdq(x.data_ptr(), s, n, amax.data_ptr(),
                                    _FMT_CODE[fmt], out.data_ptr(), stream),
                "quantize_qdq launch")
    LAUNCHES["quantize_qdq"] += 1
    return out


def quantize_dequantize_cuda(x: torch.Tensor, fmt: str, *,
                             per_slice: bool = False) -> torch.Tensor:
    """Fake-quantize a CUDA tensor through ``fmt``, bit for bit as
    ``ref.quantize_dequantize_ref`` does."""
    if fmt not in QMAX:
        raise ValueError(f"unknown wire format {fmt!r}; "
                         f"known: {', '.join(sorted(QMAX))}")
    if x.device.type != "cuda":
        raise ValueError("quantize kernel input must lie on a CUDA device")
    xf = x.to(torch.float32).contiguous()
    amax = quantize_amax(xf, per_slice)
    return quantize_qdq(xf, amax, fmt, per_slice).to(x.dtype)
