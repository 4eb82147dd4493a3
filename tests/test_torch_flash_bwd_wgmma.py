"""The bf16 flash-attention backward's design, on the CPU, before the card.

``csrc/flash_attention_bwd.cu`` runs the bf16 backward on the tensor cores
(``flash_bwd_dkdv_wgmma``, ``flash_bwd_dq_wgmma``): S = Q K^T and dP =
dO V^T are exact bf16 products summed in fp32, P and dS are formed in
fp32 and each goes into the products that read it as bf16 terms (hi =
bf16(x), lo = bf16(x - hi), then bf16 of what is left): ``BWD_KV_TERMS``
for dK and dV, ``BWD_DQ_TERMS`` for dQ; dK/dV are summed over query tiles
of ``BWD_KV_ROWS`` rows (the group's heads in order) and dQ over key tiles
of ``BWD_DQ_KEYS``, every sum in fp32, and each gradient is rounded once to
bf16.  :func:`_bwd_arithmetic` is that arithmetic in plain PyTorch.  It is
held, at chip_smoke's bf16 tolerance (atol 1e-5, rtol 2^-7: both sides
round each gradient once to bf16, so one bf16 ulp is at most 2^-7 |x|, and
the fp32 gap must stay below 1e-5), to

- ``ref.flash_attention_bwd_ref``, the plain backward the kernels are held
  to on the card, on the same bf16 inputs, forward output and lse; and
- JAX's VJP of ``repro.models.attention._chunked_attend`` (the model's
  attention, whose VJP the JAX package trains through) on the same
  bf16-valued inputs in fp32, its gradients rounded to bf16; here the
  emulation reads the forward's output in fp32, as JAX's VJP does.

Cases: ``test_torch_flash_grad.py``'s CASES (head dims 64, 80, 128, groups
1 and 4, S 100, 300, 512, windows), ragged and non-causal shapes, windows
across tile edges, rows that see no key, and H2O-Danube-1.8B's group 4 and
hd 80 at S 2048.  Then: the term count (here, with every sum rounded to
nearest, one term misses the tolerance and two and three meet it; on the
card two terms for dK and dV left 1 of scripts/flash_bwd_study.py's 24
danube-shape checks just over it, where the tensor cores' truncating sums
and the fp32 reference's own error add up, so the kernel takes three there),
the wrapper's constants against the .cu, the
layout rule on danube's training views, and the wrapper's routing by
dtype with its C library swapped for a recorder."""
import ctypes
import functools
import importlib
import math
import re
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import _chunked_attend
from repro_torch.kernels import ref
from _torch_threads import one_torch_thread  # noqa: F401

fa = importlib.import_module("repro_torch.kernels.flash_attention")

ATOL, RTOL = 1e-5, 2.0 ** -7
LOG2E = 1.4426950408889634
BF = torch.bfloat16

# (batch, query heads, kv heads, Sq, Skv, hd, causal, window)
FLASH_GRAD_CASES = [(2, 2 * g, 2, s, s, hd, True, w)
                    for hd, g, s, w in [(64, 1, 100, 0), (64, 4, 300, 0),
                                        (64, 4, 512, 100), (80, 4, 100, 0),
                                        (80, 4, 300, 64), (80, 1, 512, 0),
                                        (80, 1, 100, 16), (128, 1, 300, 0),
                                        (128, 4, 100, 32), (128, 4, 512, 0)]]
EDGE_CASES = [(1, 5, 1, 77, 300, 96, False, 0),     # ragged, Skv > Sq
              (2, 2, 2, 128, 256, 64, False, 0),
              (1, 4, 2, 33, 33, 32, True, 16),      # one ragged tile
              (1, 4, 1, 300, 300, 112, True, 100),  # window across tiles
              (1, 10, 2, 200, 200, 128, True, 0),   # group 5
              (1, 2, 1, 64, 16, 32, True, 8)]       # rows 23 on see no key
DANUBE_CASE = (1, 8, 2, 2048, 2048, 80, True, 0)    # danube's group and hd


def _bf16_terms(x: torch.Tensor, terms: int) -> list:
    """x (fp32) as ``terms`` bf16-valued fp32 tensors: hi = bf16(x), then
    bf16 of what is left, as the kernel's split() does."""
    out = []
    for _ in range(terms):
        t = x.to(BF).float()
        out.append(t)
        x = x - t
    return out


def _bwd_arithmetic(q, k, v, o, lse, do, *, causal=True, window=0,
                    terms=None):
    """The bf16 kernels' arithmetic in plain PyTorch: (dq, dk, dv) in bf16
    from bf16 q, k, v, do, the forward's o (any dtype: D = rowsum(dO o) in
    fp32) and lse.  P = exp(s q.k - lse) is taken in base 2, as
    exp2(fp32(s log2 e) q.k - fp32(lse log2 e)); lse = -inf (a row that
    sees no key) reads as +inf, so P is 0 there; masked keys give P = 0;
    each tile's products are summed, then added to the gradient.  dK and dV
    add each query tile of ``BWD_KV_ROWS`` rows in order, head by head
    of the group; dQ adds each key tile of ``BWD_DQ_KEYS``; P and dS go
    into those products as ``BWD_KV_TERMS`` and ``BWD_DQ_TERMS`` bf16
    terms, or ``terms`` in both; fp32 sums; s dK, dV and s dQ rounded once
    to bf16."""
    kv_terms, dq_terms = ((terms, terms) if terms
                          else (fa.BWD_KV_TERMS, fa.BWD_DQ_TERMS))
    b, h, sq, hd = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    g = h // kvh
    scale = 1.0 / math.sqrt(hd)
    scale_log2 = torch.tensor(scale * LOG2E, dtype=torch.float32)
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    dd = (dof * o.float()).sum(-1)
    lse2 = torch.where(torch.isneginf(lse), math.inf,
                       (lse.double() * LOG2E).float())
    mask = ref._attn_mask(sq, skv, causal, window, q.device)

    def p_ds(hq, rows, keys):
        kv = hq // g
        s = qf[:, hq, rows] @ kf[:, kv, keys].transpose(-1, -2)
        p = torch.where(mask[rows, keys], torch.exp2(
            s * scale_log2 - lse2[:, hq, rows, None]), 0.0)
        dp = dof[:, hq, rows] @ vf[:, kv, keys].transpose(-1, -2)
        return p, p * (dp - dd[:, hq, rows, None])

    dq = torch.zeros(b, h, sq, hd)
    dk, dv = torch.zeros(b, kvh, skv, hd), torch.zeros(b, kvh, skv, hd)
    for hq in range(h):
        kv = hq // g
        for r0 in range(0, sq, fa.BWD_KV_ROWS):
            rows = slice(r0, r0 + fa.BWD_KV_ROWS)
            p, ds = p_ds(hq, rows, slice(None))
            for t in _bf16_terms(p, kv_terms):
                dv[:, kv] += t.transpose(-1, -2) @ dof[:, hq, rows]
            for t in _bf16_terms(ds, kv_terms):
                dk[:, kv] += t.transpose(-1, -2) @ qf[:, hq, rows]
        for k0 in range(0, skv, fa.BWD_DQ_KEYS):
            keys = slice(k0, k0 + fa.BWD_DQ_KEYS)
            _, ds = p_ds(hq, slice(None), keys)
            for t in _bf16_terms(ds, dq_terms):
                dq[:, hq] += t @ kf[:, kv, keys]
    return (dq * scale).to(BF), (dk * scale).to(BF), dv.to(BF)


def _inputs(b, h, kvh, sq, skv, hd, seed):
    """bf16 q, k, v, do (B, heads, S, hd) from numpy's seed."""
    rng = np.random.RandomState(seed)
    t = lambda *shape: torch.from_numpy(
        rng.randn(*shape).astype(np.float32)).to(BF)
    return t(b, h, sq, hd), t(b, kvh, skv, hd), t(b, kvh, skv, hd), \
        t(b, h, sq, hd)


def _worst(got, want) -> float:
    """Each gradient's worst |err| / (atol + rtol |want|): 1 is the limit."""
    return max(float(((a.float() - w.float()).abs()
                      / (ATOL + RTOL * w.float().abs())).max())
               for a, w in zip(got, want))


def _against_plain(case, terms=None, seed=0):
    """The emulation and the plain backward on one bf16 forward's o, lse."""
    b, h, kvh, sq, skv, hd, causal, window = case
    q, k, v, do = _inputs(b, h, kvh, sq, skv, hd, seed)
    o = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    lse = ref.flash_attention_lse_ref(q, k, causal=causal, window=window)
    got = _bwd_arithmetic(q, k, v, o, lse, do, causal=causal, window=window,
                          terms=terms)
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                       window=window)
    return got, want, lse


@pytest.mark.parametrize("case", FLASH_GRAD_CASES + EDGE_CASES
                         + [DANUBE_CASE])
def test_bwd_arithmetic_matches_the_plain_backward(case):
    got, want, lse = _against_plain(case)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == BF and a.shape == w.shape, name
        np.testing.assert_allclose(a.float().numpy(), w.float().numpy(),
                                   atol=ATOL, rtol=RTOL, err_msg=name)
    seen = torch.isfinite(lse)
    if not bool(seen.all()):                 # rows that see no key
        assert all(bool(torch.isfinite(t.float()).all()) for t in got)
        assert float(got[0].float()[~seen].abs().max()) == 0.0


@functools.partial(jax.jit, static_argnums=(4, 5))
def _jax_vjp(q, k, v, g, causal, window):
    fn = lambda q_, k_, v_: _chunked_attend(q_, k_, v_, causal=causal,
                                            window=window)
    _, vjp = jax.vjp(fn, q, k, v)
    return vjp(g)


# JAX's VJP gives NaN where a row sees no key (its softmax's VJP of the
# rows it zeroes), so the no-key case is held to the plain backward only
@pytest.mark.parametrize("case", FLASH_GRAD_CASES + EDGE_CASES[:-1]
                         + [DANUBE_CASE])
def test_bwd_arithmetic_matches_jax_vjp(case):
    b, h, kvh, sq, skv, hd, causal, window = case
    q, k, v, do = _inputs(b, h, kvh, sq, skv, hd, seed=1)
    qf, kf, vf = (t.float() for t in (q, k, v))
    o = ref.flash_attention_ref(qf, kf, vf, causal=causal, window=window)
    lse = ref.flash_attention_lse_ref(qf, kf, causal=causal, window=window)
    got = _bwd_arithmetic(q, k, v, o, lse, do, causal=causal, window=window)
    # JAX's (B, S, heads, hd) layout, fp32 values of the bf16 inputs
    jx = lambda t: jnp.asarray(t.float().transpose(1, 2).numpy())
    want = _jax_vjp(jx(q), jx(k), jx(v), jx(do), causal, window)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        w = torch.from_numpy(np.array(w)).transpose(1, 2).to(BF)
        np.testing.assert_allclose(a.float().numpy(), w.float().numpy(),
                                   atol=ATOL, rtol=RTOL, err_msg=name)


@pytest.mark.parametrize("terms", [1, 2, 3])
@pytest.mark.parametrize("sq", [512, 2048])
def test_bwd_term_count(sq, terms):
    """Why P and dS go in as more than one bf16 term: one (P and dS rounded
    to bf16, as FA2/FA3 do) misses the tolerance many times over; two and
    three meet it, at danube's group 4 and hd 80, with every sum rounded
    to nearest (the card needs three for dK and dV: see the module's
    docstring).  Prints the worst error over its limit (run with -s)."""
    got, want, _ = _against_plain((1, 8, 2, sq, sq, 80, True, 0), terms,
                                  seed=2)
    worst = _worst(got, want)
    print(f"S {sq}, {terms} term(s): worst err / (atol + rtol |x|) "
          f"{worst:.4g}")
    assert (worst <= 1.0) == (terms >= 2), worst


def test_bwd_constants_match_the_kernel_source():
    """The wrapper's term counts and tile sizes, which the emulation above
    uses, are the .cu's kKvTerms, kDqTerms, kKvKeys, kKvRows, kDqRows and
    kDqKeys."""
    src = (Path(fa.__file__).parents[1] / "csrc" / "flash_attention_bwd.cu"
           ).read_text()
    for const, value in (("kKvTerms", fa.BWD_KV_TERMS),
                         ("kDqTerms", fa.BWD_DQ_TERMS),
                         ("kKvKeys", fa.BWD_KV_KEYS),
                         ("kKvRows", fa.BWD_KV_ROWS),
                         ("kDqRows", fa.BWD_DQ_ROWS),
                         ("kDqKeys", fa.BWD_DQ_KEYS)):
        assert re.search(rf"constexpr int {const} = {value};", src), const


def _danube_views(batch=4, seq=4096):
    """q, k, v and the output's gradient do as the danube train step hands
    them to the backward, on the meta device: (B, S, heads, hd)
    projections viewed as (B, heads, S, hd); do the same view of the (B,
    S, H hd) gradient of the attention output's reshape."""
    from repro_torch.configs import get_config
    cfg = get_config("h2o-danube-1.8b")
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    proj = lambda n: torch.empty(batch, seq, n, hd, dtype=BF,
                                 device="meta").transpose(1, 2)
    do = torch.empty(batch, seq, h * hd, dtype=BF, device="meta").view(
        batch, seq, h, hd).transpose(1, 2)
    return proj(h), proj(kvh), proj(kvh), do


@pytest.mark.parametrize("batch", [4, 1])
def test_danube_training_views_fit_the_wgmma_backward(batch):
    """The top's (batch 4) and a bottom's (batch 1) views meet the bf16
    kernels' layout rule, so the training path never copies do or raises."""
    q, k, v, do = _danube_views(batch)
    assert q.shape[-1] == 80 and do.stride() == (4096 * 2560, 80, 2560, 1)
    assert fa.wgmma_layout_problem(q, k, v) is None
    assert fa._tma_problem("do", do) is None


class _Recorder:
    """Stands in for the backward's C library: each entry point records
    its name, its strides and the do pointer it got, and returns 0."""

    def __init__(self):
        self.calls = []
        for entry in fa.BWD_ENTRY.values():
            setattr(self, entry, functools.partial(self._call, entry))

    def _call(self, entry, *args):
        # (ten pointers, B, H, KVH, Sq, Skv, hd, hd_v, strides, ...)
        strides = ctypes.cast(args[17], ctypes.POINTER(ctypes.c_longlong * 24)
                              ).contents
        self.calls.append((entry, args[4], tuple(strides)))
        return 0


@pytest.fixture
def recorder(monkeypatch):
    """The wrapper with its device check and C library swapped, so that
    CPU tensors go through its routing, layout checks and counts."""
    rec = _Recorder()
    monkeypatch.setattr(fa, "_on_card", lambda named: None)
    monkeypatch.setattr(fa, "_bwd_lib", lambda: rec)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=0))
    for key in fa.LAUNCHES:
        monkeypatch.setitem(fa.LAUNCHES, key, 0)
    return rec


def _model_views(dtype, b=2, s=64, h=4, kvh=2, hd=64):
    view = lambda n: torch.zeros(b, s, n, hd, dtype=dtype).transpose(1, 2)
    return view(h), view(kvh), view(kvh), view(h), view(h)


def test_bwd_routes_bf16_to_the_tensor_cores(recorder):
    """bf16 launches the wgmma entry point and counts it in both counts;
    fp32 launches the CUDA-core entry point and counts only the first."""
    for dtype, entry in ((BF, "flash_attention_bwd_wgmma"),
                         (torch.float32, "flash_attention_bwd")):
        q, k, v, o, do = _model_views(dtype)
        lse = torch.zeros(2, 4, 64)
        dq, dk, dv = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do)
        assert recorder.calls[-1][0] == entry
        assert dq.stride() == q.stride() and dk.stride() == k.stride()
    assert [c[0] for c in recorder.calls] == ["flash_attention_bwd_wgmma",
                                              "flash_attention_bwd"]
    assert fa.LAUNCHES["flash_attention_bwd"] == 2
    assert fa.LAUNCHES["flash_attention_bwd_wgmma"] == 1


def test_bwd_bf16_refuses_what_tma_cannot_read(recorder):
    """A bf16 q, k or v the tensor maps cannot read raises and launches
    nothing (no CUDA-core stand-in); a do they cannot read is copied."""
    q, k, v, o, do = _model_views(BF, hd=128)
    lse = torch.zeros(2, 4, 64)
    rows = torch.zeros(2, 64, 4, 129, dtype=BF)[..., 1:].transpose(1, 2)
    for bad in ({"q": rows}, {"k": rows[:, :2]}, {"v": rows[:, :2]}):
        args = {"q": q, "k": k, "v": v, **bad}
        with pytest.raises(ValueError, match="wgmma"):
            fa.flash_attention_bwd_cuda(args["q"], args["k"], args["v"], o,
                                        lse, do)
    assert recorder.calls == []
    fa.flash_attention_bwd_cuda(q, k, v, o, lse, rows)
    entry, do_ptr, strides = recorder.calls[-1]
    assert entry == "flash_attention_bwd_wgmma" and do_ptr != rows.data_ptr()
    assert strides[12:15] == (4 * 64 * 128, 64 * 128, 128)


def test_build_digest_covers_included_headers(tmp_path, monkeypatch):
    """A library is named by its source and every header the source
    includes with quotes, so an edit to a shared header (``hopper.cuh``)
    builds anew instead of loading a stale library."""
    from repro_torch.kernels import build
    for name in ("flash_attention", "flash_attention_bwd"):
        assert [p.name for p in build._sources(build.CSRC / f"{name}.cu")
                ] == [f"{name}.cu", "hopper.cuh"]
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n#include <stdint.h>\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("#pragma once\n#include \"a.cuh\"\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    first = build._target("k")
    assert build._target("k") == first
    (tmp_path / "b.cuh").write_text("#pragma once\n// edited\n")
    assert build._target("k") != first
