"""The PyTorch port's attention gradient against the JAX package, on the CPU.

The JAX model trains through ``repro.models.attention._chunked_attend``
(the Pallas flash kernel defines no backward), so its gradient is
``jax.vjp`` of that function.  On the CPU the port's
``kernels.flash_attention`` is the plain version under autograd, and
``ref.flash_attention_bwd_ref`` is the plain backward written out (from the
forward's output and lse), which ``chip_smoke.py`` holds the CUDA backward
kernels to on the card.  The same
numpy inputs and output cotangent go to both sides, in their layouts (JAX
(B, S, heads, hd), the port (B, heads, S, hd)).

Cases: fp32, causal, window 0 and windows shorter than S, GQA groups 1 and
4, head dims 64, 80 and 128, Sq 100 and 300 (one q-chunk of JAX's Q_CHUNK
256: ``_chunked_attend`` takes max(1, Sq // 256) chunks, so 300 is one
chunk of 300) and 512 (two chunks).  Tolerance atol 1e-5 / rtol 1e-4: the
sides sum the same products in other orders (measured gap below 2e-6).

The autograd plumbing the card runs (``FlashAttention``: forward kernel
with its lse, backward kernels, under the layer recompute of
``torch.utils.checkpoint``) is driven here with the two launchers replaced
by their plain versions; the backward wrapper's argument check runs before
any build, so its refusal of a CPU tensor is tested here too."""
import functools
import importlib

import jax
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from repro.models.attention import _chunked_attend
from repro_torch import kernels
from repro_torch.kernels import ref
from _torch_threads import one_torch_thread  # noqa: F401

fa = importlib.import_module("repro_torch.kernels.flash_attention")

TOL = dict(atol=1e-5, rtol=1e-4)

# (head dim, query heads per KV head, Sq, window); 2 KV heads, batch 2
CASES = [(64, 1, 100, 0), (64, 4, 300, 0), (64, 4, 512, 100),
         (80, 4, 100, 0), (80, 4, 300, 64), (80, 1, 512, 0),
         (80, 1, 100, 16), (128, 1, 300, 0), (128, 4, 100, 32),
         (128, 4, 512, 0)]
KVH, BATCH = 2, 2


def _inputs(hd, group, sq, seed=0):
    rng = np.random.RandomState(seed)
    h = KVH * group
    return (rng.randn(BATCH, sq, h, hd).astype(np.float32),
            rng.randn(BATCH, sq, KVH, hd).astype(np.float32),
            rng.randn(BATCH, sq, KVH, hd).astype(np.float32),
            rng.randn(BATCH, sq, h, hd).astype(np.float32))


def _port_view(a: np.ndarray) -> torch.Tensor:
    """A (B, S, heads, hd) array as the port's (B, heads, S, hd) view, the
    model's layout."""
    return torch.from_numpy(a).transpose(1, 2)


@functools.partial(jax.jit, static_argnums=4)
def _jax_vjp(q, k, v, g, window):
    fn = lambda q_, k_, v_: _chunked_attend(q_, k_, v_, causal=True,
                                            window=window)
    out, vjp = jax.vjp(fn, q, k, v)
    return (out, *vjp(g))


def _jax_grads(q, k, v, g, window):
    return [np.asarray(t) for t in _jax_vjp(q, k, v, g, window)]


def _port_grads(q, k, v, g, window):
    tq, tk, tv = (_port_view(a).requires_grad_(True) for a in (q, k, v))
    out = kernels.flash_attention(tq, tk, tv, causal=True, window=window)
    grads = torch.autograd.grad(out, (tq, tk, tv), _port_view(g))
    # back to JAX's (B, S, heads, hd)
    return [t.detach().transpose(1, 2).numpy() for t in (out, *grads)]


@pytest.mark.parametrize("hd,group,sq,window", CASES)
def test_attention_gradient_matches_jax_vjp(hd, group, sq, window):
    q, k, v, g = _inputs(hd, group, sq)
    want = _jax_grads(q, k, v, g, window)
    got = _port_grads(q, k, v, g, window)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, err_msg=name, **TOL)


@pytest.mark.parametrize("hd,group,sq,window", CASES)
def test_plain_backward_matches_autograd(hd, group, sq, window):
    """``flash_attention_bwd_ref`` from the forward's output and lse gives
    what autograd gives through ``flash_attention_ref``."""
    q, k, v, g = _inputs(hd, group, sq, seed=1)
    tq, tk, tv = (_port_view(a).requires_grad_(True) for a in (q, k, v))
    out = ref.flash_attention_ref(tq, tk, tv, causal=True, window=window)
    want = torch.autograd.grad(out, (tq, tk, tv), _port_view(g))
    lse = ref.flash_attention_lse_ref(tq.detach(), tk.detach(),
                                      window=window)
    got = ref.flash_attention_bwd_ref(tq.detach(), tk.detach(), tv.detach(),
                                      out.detach(), lse, _port_view(g),
                                      window=window)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=name,
                                   **TOL)


def test_lse_is_the_log_of_the_softmax_normaliser():
    """lse is logsumexp of the scaled scores, so exp(s - lse) sums to 1 over
    a row's keys; a row that sees no key gets -inf."""
    rng = np.random.RandomState(2)
    q = torch.from_numpy(rng.randn(1, 4, 40, 32).astype(np.float32))
    k = torch.from_numpy(rng.randn(1, 2, 16, 32).astype(np.float32))
    lse = ref.flash_attention_lse_ref(q, k, window=8)
    s = torch.einsum("bhqd,bhsd->bhqs", q,
                     k.repeat_interleave(2, dim=1)) / np.sqrt(32)
    q_pos, kv_pos = torch.arange(40)[:, None], torch.arange(16)[None]
    mask = (kv_pos <= q_pos) & (kv_pos > q_pos - 8)
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    seen = mask.any(-1)
    np.testing.assert_allclose(p.sum(-1)[..., seen].numpy(), 1.0,
                               rtol=1e-6)
    assert bool(torch.isneginf(lse[..., ~seen]).all())


def test_plain_backward_gives_zero_for_rows_that_see_no_key():
    """Causal over 16 keys with a window of 8: rows 23 on see no key; their
    dq is 0, and nothing is NaN."""
    rng = np.random.RandomState(3)
    q, k, v, g = (torch.from_numpy(rng.randn(*s).astype(np.float32))
                  for s in ((1, 2, 64, 32), (1, 1, 16, 32), (1, 1, 16, 32),
                            (1, 2, 64, 32)))
    out = ref.flash_attention_ref(q, k, v, window=8)
    lse = ref.flash_attention_lse_ref(q, k, window=8)
    dq, dk, dv = ref.flash_attention_bwd_ref(q, k, v, out, lse, g, window=8)
    assert all(bool(torch.isfinite(t).all()) for t in (dq, dk, dv))
    assert float(dq[:, :, 23:].abs().max()) == 0.0


def test_flash_attention_function_under_layer_recompute(monkeypatch):
    """``FlashAttention`` inside ``torch.utils.checkpoint``, with its two
    launchers replaced by their plain versions: the forward runs once and
    again in the backward pass, the backward runs once on what the
    recompute saved, and the gradients are autograd's through the plain
    version."""
    calls = {"fwd": 0, "bwd": 0}

    def fwd(q, k, v, *, causal, window, with_lse):
        assert with_lse
        calls["fwd"] += 1
        return (ref.flash_attention_ref(q, k, v, causal=causal,
                                        window=window),
                ref.flash_attention_lse_ref(q, k, causal=causal,
                                            window=window))

    def bwd(*args, **kw):
        calls["bwd"] += 1
        return ref.flash_attention_bwd_ref(*args, **kw)

    monkeypatch.setattr(fa, "flash_attention_cuda", fwd)
    monkeypatch.setattr(fa, "flash_attention_bwd_cuda", bwd)
    q, k, v, g = _inputs(80, 4, 100, seed=4)
    w = torch.from_numpy(np.random.RandomState(5).randn(80, 80).astype(
        np.float32))

    def layer(attend, q_, k_, v_):
        return attend(q_ @ w, k_, v_).tanh()

    plain = lambda a, b, c: ref.flash_attention_ref(a, b, c, window=16)
    func = lambda a, b, c: fa.FlashAttention.apply(a, b, c, True, 16)
    grads = []
    for attend, recompute in ((plain, False), (func, True)):
        ts = [_port_view(a).requires_grad_(True) for a in (q, k, v)]
        out = (checkpoint(layer, attend, *ts, use_reentrant=False)
               if recompute else layer(attend, *ts))
        grads.append(torch.autograd.grad(out, ts, _port_view(g)))
    assert calls == {"fwd": 2, "bwd": 1}
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


def test_the_routes_on_the_cpu_never_reach_the_kernels(monkeypatch):
    """CPU tensors take the plain versions, with or without a gradient."""
    def boom(*args, **kw):
        raise AssertionError("a CPU tensor reached a CUDA launcher")
    for name in ("flash_attention_cuda", "flash_attention_bwd_cuda"):
        monkeypatch.setattr(fa, name, boom)
    monkeypatch.setattr(fa.FlashAttention, "apply", boom)
    q, k, v, g = (_port_view(a) for a in _inputs(64, 1, 100))
    kernels.flash_attention(q.requires_grad_(True), k, v).sum().backward()
    kernels.flash_attention(q.detach(), k, v)


def test_backward_wrapper_refuses_cpu_tensors():
    """The CUDA backward wrapper checks before it builds or launches
    anything: a CPU tensor raises, it is never computed by the plain
    version."""
    q, k, v, g = (_port_view(a) for a in _inputs(64, 1, 100))
    with pytest.raises(ValueError, match="CUDA device"):
        fa.flash_attention_bwd_cuda(q, k, v, q, torch.zeros(2, 2, 100), g)
