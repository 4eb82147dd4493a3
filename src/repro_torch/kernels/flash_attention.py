"""GQA flash attention on the card, forward (``csrc/flash_attention.cu``)
and backward (``csrc/flash_attention_bwd.cu``), bound with ctypes; both
include ``csrc/hopper.cuh`` (mbarriers, TMA, wgmma).

Counterpart of the JAX package's ``kernels/flash_attention.py``
(``flash_attention``): q (B, H, Sq, hd), k and v (B, KVH, Skv, hd), causal
or not, an optional sliding window, fp32 or bf16.  The dtype picks the
kernel: bf16 goes to ``flash_kernel_wgmma`` (both products on the tensor
cores, K/V staged by TMA), fp32 to the CUDA-core ``flash_kernel`` (a wgmma
on fp32 data would be TF32).  Neither stands in for the other: a bf16
tensor the wgmma kernel cannot read raises.  Both read every tensor
through its strides, so a (B, H, S, hd) view of a (B, S, H, hd) tensor
goes in as it is; the output is allocated with q's strides, so such a
caller gets it back in its own layout.  Any Sq and Skv: the ragged edges
are masked in the kernel.  One launch per call.

The forward can also write each row's log-sum-exp (fp32, (B, H, Sq)).
:class:`FlashAttention` saves it with q, k, v and the output, and its
backward launches D = rowsum(dO o), then dK and dV (one block per key tile
and KV head, the GQA group summed in the block, no atomics), then dQ, by
dtype again: bf16 to ``flash_attention_bwd_wgmma`` (wgmma on the tensor
cores, Q/dO or K/V streamed by TMA, P and dS as 3 bf16 terms for dK and
dV, dS as 2 for dQ;
the same layout rule as the forward, a ``do`` that breaks it copied
first), fp32 to ``flash_attention_bwd`` (the CUDA cores); gradients in the
inputs' dtype and layouts.  Its reference is JAX's VJP of
``_chunked_attend`` and, on the card, ``ref.flash_attention_bwd_ref``."""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build

# "flash_attention" counts every forward launch, "flash_attention_wgmma"
# those of the bf16 kernel, "flash_attention_bwd" every backward call (its
# three kernels), "flash_attention_bwd_wgmma" those of the bf16 ones
LAUNCHES = {"flash_attention": 0, "flash_attention_wgmma": 0,
            "flash_attention_bwd": 0, "flash_attention_bwd_wgmma": 0}

HEAD_DIMS = (32, 64, 80, 96, 112, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_AXES = ("batch", "head", "sequence")

# the backward's C entry point for each dtype: the tensor-core kernels for
# bf16, the CUDA-core ones for fp32
BWD_ENTRY = {torch.bfloat16: "flash_attention_bwd_wgmma",
             torch.float32: "flash_attention_bwd"}
# the bf16 backward's constants, as csrc/flash_attention_bwd.cu states them
# (kKvTerms, kDqTerms, kKvKeys, kKvRows, kDqRows, kDqKeys; a CPU test holds
# them to the source): the dK/dV kernel takes P and dS into its products as
# BWD_KV_TERMS bf16 terms, BWD_KV_KEYS keys a block, and streams query
# tiles of BWD_KV_ROWS rows; the dQ kernel takes dS as BWD_DQ_TERMS terms,
# BWD_DQ_ROWS rows a block, and streams key tiles of BWD_DQ_KEYS
BWD_KV_TERMS, BWD_DQ_TERMS = 3, 2
BWD_KV_KEYS, BWD_KV_ROWS = 128, 64
BWD_DQ_ROWS, BWD_DQ_KEYS = 128, 128

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    lib.flash_attention_fwd.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                        _I, _I, _I, _P, _I, _I, _P]
    lib.flash_attention_fwd.restype = _I
    return lib


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    lib = build.load("flash_attention_bwd")
    for entry in BWD_ENTRY.values():
        fn = getattr(lib, entry)
        fn.argtypes = [_P] * 10 + [_I] * 6 + [_P, _I, _I, _P]
        fn.restype = _I
    return lib


def _strides(t: torch.Tensor) -> tuple:
    """t's (batch, head, sequence) strides in elements, a dim of size 1
    given its contiguous stride: any stride addresses it, and the tensor
    map wants one it accepts."""
    _, h, s, hd = t.shape
    return tuple(c if n == 1 else st for n, st, c in zip(
        t.shape[:3], t.stride()[:3], (h * s * hd, s * hd, hd)))


def _tma_problem(name: str, t: torch.Tensor) -> Optional[str]:
    """Why a TMA tensor map of the bf16 kernels cannot read ``t``, (B,
    heads, S, hd), or None."""
    if t.dtype != torch.bfloat16:
        return f"{name} is {t.dtype}, not torch.bfloat16"
    if t.dim() != 4 or t.shape[3] not in HEAD_DIMS:
        return (f"{name}'s head dim of {tuple(t.shape)} is not in "
                f"{HEAD_DIMS}")
    if t.stride(3) != 1:
        return f"{name}'s head dim is not contiguous"
    if t.data_ptr() % 16:
        return (f"{name}'s base address is {t.data_ptr() % 16} bytes "
                "past a 16-byte boundary")
    for axis, n, s in zip(_AXES, t.shape, t.stride()):
        if n > 1 and (s <= 0 or s * t.element_size() % 16
                      or s * t.element_size() >= 1 << 40):
            return (f"{name}'s {axis} stride of {s} elements is not a "
                    "positive multiple of 16 bytes below 2^40")
    return None


def wgmma_layout_problem(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor) -> Optional[str]:
    """Why the bf16 kernels' TMA tensor maps cannot read q, k or v, each
    (B, heads, S, hd), or None: each must be bf16, its head dim one of
    ``HEAD_DIMS`` and contiguous, its base 16-byte aligned, and every
    stride of a dim longer than 1 a positive multiple of 16 bytes (the
    backward reads its ``do`` by the same rule).  It reads shapes,
    strides, addresses and dtypes only, so it runs on ``meta`` tensors
    without a card."""
    return next((p for p in (_tma_problem(n, t) for n, t in
                             (("q", q), ("k", k), ("v", v))) if p), None)


def _on_card(named: dict) -> None:
    """Raise unless every named tensor lies on q's CUDA device."""
    for name, t in named.items():
        if t.device.type != "cuda" or t.device != named["q"].device:
            raise ValueError(f"flash attention: {name} must lie on q's "
                             f"CUDA device, not {t.device}")


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: int, **more: torch.Tensor) -> None:
    """Raise on what neither kernel takes; ``more`` names tensors shaped
    like q (the output and its gradient, for the backward)."""
    _on_card({"q": q, "k": k, "v": v, **more})
    for name, t in (("q", q), ("k", k), ("v", v), *more.items()):
        if t.dim() != 4 or t.dtype != q.dtype:
            raise ValueError(f"flash attention: {name} must be 4-d "
                             f"{q.dtype}, got {t.dim()}-d {t.dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"flash attention: {name}'s head dim must be "
                             "contiguous")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"flash attention takes fp32 or bf16, not {q.dtype}")
    b, h, sq, hd = q.shape
    for name, t in more.items():
        if t.shape != q.shape:
            raise ValueError(f"flash attention: {name} {tuple(t.shape)} is "
                             f"not shaped like q {tuple(q.shape)}")
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
    if q.dtype == torch.bfloat16:
        problem = wgmma_layout_problem(q, k, v)
        if problem:
            raise ValueError(f"flash attention, bf16 (wgmma) kernel: "
                             f"{problem}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         with_lse: bool = False):
    """Launch the kernel of q's dtype: (B, H, Sq, hd) x (B, KVH, Skv, hd)
    -> (B, H, Sq, hd) in q's dtype, as ``ref.flash_attention_ref``
    computes it (the bf16 kernel rounds P to bf16 before P V, as the JAX
    model does).  With ``with_lse``, returns (out, lse): lse (B, H, Sq)
    fp32 is each row's log-sum-exp of its scaled scores (as
    ``ref.flash_attention_lse_ref``), -inf for a row that sees no key."""
    _check(q, k, v, window)
    out = torch.empty_like(q)          # q's strides, hence q's layout
    b, h, sq, hd = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    strides = (ctypes.c_longlong * 12)(*(
        s for t in (q, k, v, out) for s in _strides(t)))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = _lib().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        0 if lse is None else lse.data_ptr(), _DTYPE_CODE[q.dtype], b, h,
        kvh, sq, skv, hd, ctypes.cast(strides, ctypes.c_void_p), int(causal),
        int(window), stream)
    if status < 0:
        raise RuntimeError(f"flash attention: cuTensorMapEncodeTiled "
                           f"refused a TMA tensor map (CUresult {-status})")
    build.check(status, "flash_attention launch")
    LAUNCHES["flash_attention"] += 1
    if q.dtype == torch.bfloat16:
        LAUNCHES["flash_attention_wgmma"] += 1
    return (out, lse) if with_lse else out


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             lse: torch.Tensor, do: torch.Tensor, *,
                             causal: bool = True, window: int = 0
                             ) -> tuple[torch.Tensor, ...]:
    """(dq, dk, dv) of the forward that gave ``o`` and ``lse`` from q, k and
    v, for the output gradient ``do``, as ``ref.flash_attention_bwd_ref``
    computes them: each in its input's dtype and strides.  q, k, v, o and
    do may be any views with a contiguous head dim, in bf16 also meeting
    :func:`wgmma_layout_problem`'s rule (a q, k or v that does not raises;
    a ``do`` without a contiguous head dim, or in bf16 one the rule
    refuses, is copied first); lse is (B, H, Sq) fp32.  bf16 launches the
    tensor-core kernels, fp32 the CUDA-core ones (``BWD_ENTRY``)."""
    if do.dim() == 4 and (do.stride(-1) != 1 or (
            do.dtype == q.dtype == torch.bfloat16
            and _tma_problem("do", do))):
        do = do.contiguous()
    _check(q, k, v, window, o=o, do=do)
    b, h, sq, hd = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    if (lse.dtype != torch.float32 or lse.shape != (b, h, sq)
            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError(f"flash attention backward: lse must be a "
                         f"contiguous fp32 ({b}, {h}, {sq}) tensor on "
                         f"{q.device}, got {lse.dtype} {tuple(lse.shape)}")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 24)(*(
        s for t in (q, k, v, o, do, dq, dk, dv) for s in _strides(t)))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    entry = BWD_ENTRY[q.dtype]
    status = getattr(_bwd_lib(), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b, h, kvh, sq, skv, hd,
        ctypes.cast(strides, ctypes.c_void_p), int(causal), int(window),
        stream)
    if status < 0:
        raise RuntimeError(f"flash attention backward: "
                           f"cuTensorMapEncodeTiled refused a TMA tensor "
                           f"map (CUresult {-status})")
    build.check(status, f"{entry} launch")
    LAUNCHES["flash_attention_bwd"] += 1
    if q.dtype == torch.bfloat16:
        LAUNCHES["flash_attention_bwd_wgmma"] += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention on the card: the forward kernel with
    its lse, the backward kernels for dq, dk and dv.  Under a layer that is
    recomputed in the backward pass (``torch.utils.checkpoint``), the
    tensors saved here come from the recompute."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        out, lse = flash_attention_cuda(q, k, v, causal=causal,
                                        window=window, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_cuda(q, k, v, out, lse, do,
                                              causal=ctx.causal,
                                              window=ctx.window)
        return dq, dk, dv, None, None
