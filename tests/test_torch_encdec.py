"""The port's encoder-decoder model (SeamlessM4T: a non-causal encoder
over frame embeddings, split inside it, and a causal decoder that
cross-attends to it) against the JAX package, on the CPU at smoke size.

The smoke ``seamless-m4t-medium`` (2 encoder layers split 1 + 1, 2
decoder layers, d_model 256, 4 heads of 64, LayerNorm, ReLU MLP), its
weights the JAX init's (or numpy draws in the JAX ``input_specs``
shapes), converted by ``convert``:

  * ``apply_attention`` with ``kv_override`` (cross-attention) against
    JAX's, causal and not, and in decode (one query row over all the given
    K/V), with QKV bias and qk-norm switched on so that the q-only norm
    and bias are live;
  * one prefill (S frames, 8 decoder tokens) and 4 greedy decode steps
    against the JAX steps, fp32 and bf16, the cross cache longer than S;
  * the reference's fault that both keep: the decoder cross-attends to the
    whole ``max_len`` cross cache, its rows past S zeros, so the prefill's
    logits move with ``max_len`` (in JAX and in the port alike), while at
    ``max_len`` = S they are train mode's;
  * one train step against JAX's ``make_train_step`` (2 clients x 2
    sequences x 64 frames, 24 decoder tokens: cross-attention with Sq !=
    Skv), no wire and ``int8`` (JAX's wire roundings replayed), tau 0 and
    0.95; two steps of ``make_scanned_train_phase`` against JAX's and the
    port's eager loop; the host-read guard over one bf16 step;
  * the converters' round trips (train state, serving cache), the shapes
    against JAX's ``input_specs`` (smoke and full), the model's extras;
  * ``serve_config`` against JAX's ``serve`` driver (fp32).

Tolerances as ``tests/test_torch_vlm.py`` (the dense tests')."""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_lm as serving
import test_torch_vlm as vlm
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.launch import serve as jserve
from repro.models import attention as jattn
from repro.models import build_model as jax_build_model
from repro_torch.configs import get_config, smoke_config
from repro_torch.convert import (lm_cache_from_numpy, lm_cache_to_numpy,
                                 lm_params_from_numpy)
from repro_torch.launch import steps
from repro_torch.models import attention as tattn
from repro_torch.models.transformer import EncDecModel, build_model
from _torch_threads import one_torch_thread  # noqa: F401

ARCH = "seamless-m4t-medium"
BATCH, N_DECODE, DEC = 2, 4, 8
TRAIN_DEC = 24          # decoder tokens a train sequence (Sq != Skv)


def _cfgs(dtype: str = "float32", tau=None):
    out = []
    for cfg in (jax_smoke_config(ARCH), smoke_config(ARCH)):
        cfg = replace(cfg, dtype=dtype)
        if tau is not None:
            cfg = replace(cfg, semisfl=replace(cfg.semisfl,
                                               confidence_threshold=tau))
        out.append(cfg)
    return out


# ---------------------------------------------------------------------------
# cross-attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,causal", [("train", True), ("train", False),
                                         ("decode", False)])
def test_cross_attention_matches_jax(mode, causal):
    jcfg, tcfg = (replace(c, qk_norm=True, attn_bias=True)
                  for c in _cfgs())
    rng = np.random.RandomState(1)
    p = jax.tree.map(lambda a: (rng.randn(*a.shape) * (
        0.02 if a.ndim == 1 else 1.0 / np.sqrt(a.shape[0])) + (
        1.0 if a.ndim == 1 and a.shape[0] == 64 else 0.0)).astype(np.float32),
        jax.device_get(jattn.init_attention(jax.random.PRNGKey(0), jcfg,
                                            jnp.float32)))
    sq = 1 if mode == "decode" else 12
    x = rng.randn(BATCH, sq, jcfg.d_model).astype(np.float32)
    k, v = (rng.randn(BATCH, 40, jcfg.num_kv_heads, 64).astype(np.float32)
            for _ in range(2))
    pos = np.broadcast_to(np.arange(sq) + 7, (BATCH, sq)).astype(np.int32)
    want, _ = jattn.apply_attention(
        jax.tree.map(jnp.asarray, p), jcfg, jnp.asarray(x),
        positions=jnp.asarray(pos), mode=mode, causal=causal,
        kv_override=(jnp.asarray(k), jnp.asarray(v)))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    got, cache = tattn.apply_attention(
        {n: t(a) for n, a in p.items()}, tcfg, t(x),
        positions=t(pos.astype(np.int64)), mode=mode, causal=causal,
        kv_override=(t(k), t(v)))
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _prefill_batch(cfg, s: int, seed: int = 0) -> dict:
    rng = np.random.RandomState(seed)
    return {"frames": rng.randn(BATCH, s, cfg.d_model).astype(np.float32),
            "dec_tokens": rng.randint(0, cfg.vocab_size,
                                      (BATCH, DEC)).astype(np.int32)}


def _jax_prefill(jcfg, s: int, max_len: int):
    """JAX's prefill of :func:`_prefill_batch` with a cache of
    ``max_len``: (params, logits, cache)."""
    jprefill, _ = serving._jax_steps(jcfg)
    model = jax_build_model(jcfg)
    params = model.init(jax.random.PRNGKey(0))
    cache = model.init_cache(BATCH, max_len)
    logits, cache = jprefill(params, jax.tree.map(
        jnp.asarray, _prefill_batch(jcfg, s)), cache)
    return params, logits, cache


def _assert_encdec_cache_close(jcache, tcache, tol: float) -> None:
    got = lm_cache_to_numpy(tcache)
    want = jcache["top"]
    assert got["bottom"] is None and jcache["bottom"] is None
    for i, name in enumerate(("k", "v")):
        np.testing.assert_allclose(got["top"]["dec_self"][i], serving._f32(
            getattr(want["dec_self"], name)), atol=tol, rtol=0)
    np.testing.assert_array_equal(got["top"]["dec_self"][2],
                                  np.asarray(want["dec_self"].pos))
    for name in ("cross_k", "cross_v"):
        np.testing.assert_allclose(got["top"][name],
                                   serving._f32(want[name]), atol=tol,
                                   rtol=0)


@pytest.mark.parametrize("s", [32, 300, 512])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(dtype, s):
    jcfg, tcfg = _cfgs(dtype)
    tol = serving.TOLS[dtype]
    _, jdecode = serving._jax_steps(jcfg)
    max_len = s + N_DECODE + 1
    jparams, jlogits, jcache = _jax_prefill(jcfg, s, max_len)
    tparams = lm_params_from_numpy(jax.device_get(jparams))
    tcache = lm_cache_from_numpy(jax.device_get(
        jax_build_model(jcfg).init_cache(BATCH, max_len)))
    tlogits, tcache = steps.make_prefill_step(tcfg)(
        tparams, vlm.torch_batch(_prefill_batch(jcfg, s)), tcache)
    np.testing.assert_allclose(tlogits.float().numpy(),
                               serving._f32(jlogits), atol=tol, rtol=0)
    _assert_encdec_cache_close(jax.device_get(jcache), tcache, tol)

    tdecode = steps.make_decode_step(tcfg)
    jtok = jnp.argmax(jlogits, -1).astype(jnp.int32)
    ttok = tlogits.argmax(-1)
    jtoks, ttoks = [np.asarray(jtok)], [ttok.numpy()]
    for i in range(N_DECODE):
        pos = np.full((BATCH,), DEC + i, np.int32)
        if dtype == "bfloat16":      # teacher-forced, as test_torch_lm
            ttok = torch.from_numpy(np.asarray(jtok, np.int64))
        jtok, jcache = jdecode(jparams, {"tokens": jtok[:, None],
                                         "pos": jnp.asarray(pos)}, jcache)
        ttok, tcache = tdecode(tparams, vlm.torch_batch(
            {"tokens": ttok[:, None].numpy(), "pos": pos}), tcache)
        jtoks.append(np.asarray(jtok))
        ttoks.append(ttok.numpy())
    _assert_encdec_cache_close(jax.device_get(jcache), tcache, tol)
    if dtype == "float32":
        np.testing.assert_array_equal(np.stack(ttoks), np.stack(jtoks))


def test_the_prefill_logits_move_with_max_len_in_both():
    """The reference's fault, kept: the decoder cross-attends to every row
    of the ``max_len`` cross cache, the zero rows past the S frames
    written included, so one prefill's last-position logits at ``max_len``
    S and S + 32 differ (by far more than the tolerance), in JAX and in
    the port alike, the two packages agreeing at each ``max_len``; at
    ``max_len`` S the prefill's logits are train mode's."""
    jcfg, tcfg = _cfgs()
    s = 16
    got, want = {}, {}
    for max_len in (s, s + 32):
        jparams, jlogits, _ = _jax_prefill(jcfg, s, max_len)
        tparams = lm_params_from_numpy(jax.device_get(jparams))
        cache = build_model(tcfg).init_cache(BATCH, max_len, "cpu")
        tlogits, _ = steps.make_prefill_step(tcfg)(
            tparams, vlm.torch_batch(_prefill_batch(jcfg, s)), cache)
        got[max_len], want[max_len] = tlogits.numpy(), np.asarray(jlogits)
        np.testing.assert_allclose(got[max_len], want[max_len], atol=1e-4,
                                   rtol=0)
    moved_jax = np.abs(want[s + 32] - want[s]).max()
    moved_port = np.abs(got[s + 32] - got[s]).max()
    assert moved_jax > 0.1 and moved_port > 0.1
    np.testing.assert_allclose(moved_port, moved_jax, rtol=1e-3)
    # train mode (the cross K/V of the S frames alone) is max_len S's
    model, b = build_model(tcfg), vlm.torch_batch(_prefill_batch(jcfg, s))
    with torch.no_grad():
        feats, _, extras = model.bottom_apply(tparams["bottom"], b)
        out, _ = model.top_apply(tparams["top"], feats,
                                 extras=dict(extras,
                                             dec_tokens=b["dec_tokens"]))
    np.testing.assert_allclose(out["logits"][:, -1].numpy(), got[s],
                               atol=1e-6, rtol=0)


def test_serve_config_matches_the_jax_serve_driver(monkeypatch):
    """The JAX driver's inputs (seeded frames, 8 zero decoder tokens) and
    decode positions (from 8), from the JAX init's weights, fp32: the same
    greedy tokens."""
    jcfg, tcfg = _cfgs()
    gen = N_DECODE + 2
    monkeypatch.setattr(vlm, "ARCH", ARCH)
    want = vlm._jax_serve(jcfg, monkeypatch, gen, [])
    params = lm_params_from_numpy(jax.device_get(
        jax_build_model(jcfg).init(jax.random.PRNGKey(0))))
    got = vlm.serve_config_cpu(tcfg, params, gen)
    np.testing.assert_array_equal(got.tokens, want)
    assert jserve.smoke_config(ARCH) is jcfg


def test_the_serving_cache_round_trips():
    jcfg, _ = _cfgs("bfloat16")
    cache = jax.device_get(jax_build_model(jcfg).init_cache(BATCH, 16))
    cache = jax.tree.map(lambda a: (a + (3 if a.dtype.kind == "i" else 1))
                         .astype(a.dtype), cache)
    port = lm_cache_from_numpy(cache)
    assert len(port["top"]["dec_self"]) == jcfg.num_layers
    assert port["top"]["cross_k"].dtype == torch.bfloat16
    back = lm_cache_to_numpy(port)
    assert back["bottom"] is None
    want = cache["top"]
    for got, w in zip(back["top"]["dec_self"], want["dec_self"]):
        np.testing.assert_array_equal(got, np.asarray(w, got.dtype))
    for name in ("cross_k", "cross_v"):
        np.testing.assert_array_equal(back["top"][name],
                                      np.asarray(want[name], np.float32))


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def batch(cfg, seed: int) -> dict:
    """A train batch of numpy draws: both views' frames (N, b, S, d_model)
    and TRAIN_DEC decoder tokens a sequence."""
    rng = np.random.RandomState(seed)
    n, b, s = vlm.dense.N_CLIENTS, vlm.dense.PER_CLIENT, vlm.dense.SEQ
    out = {k: rng.randn(n, b, s, cfg.d_model).astype(np.float32)
           for k in ("frames_weak", "frames_strong")}
    out["dec_tokens"] = rng.randint(0, cfg.vocab_size,
                                    (n, b, TRAIN_DEC)).astype(np.int32)
    return out


@pytest.mark.parametrize("wire,tau", vlm.STEP_CASES,
                         ids=[f"{w}-tau{t}" for w, t in vlm.STEP_CASES])
def test_train_step_matches_jax(wire, tau, monkeypatch):
    jcfg, tcfg = _cfgs(tau=tau)
    vlm.check_train_step(jcfg, tcfg, batch, wire, tau, monkeypatch)


def test_scanned_phase_matches_jax_and_the_eager_loop():
    jcfg, tcfg = _cfgs(tau=0.0)
    vlm.check_scanned_phase(jcfg, tcfg, batch)


def test_the_encdec_step_reads_no_host_value():
    vlm.check_no_host_read(smoke_config(ARCH), batch)


@pytest.mark.parametrize("which", ["smoke", "full"])
def test_the_encdec_shapes_are_the_jax_input_specs(which):
    """Full: 12 + 12 layers, the encoder split 6 + 6 (nothing allocated)."""
    cfgs = (_cfgs("bfloat16") if which == "smoke" else
            (jax_get_config(ARCH), get_config(ARCH)))
    vlm.check_shapes(*cfgs)
    assert EncDecModel(cfgs[1]).split == \
        jax_build_model(cfgs[0]).split == (1 if which == "smoke" else 6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_encdec_train_state_round_trips_bit_for_bit(dtype):
    vlm.check_state_round_trip(_cfgs(dtype)[0])


def test_the_encdec_extras_are_the_jax_models():
    """``bottom_apply`` hands the top positions 0 .. S - 1 and a zero aux
    loss; in decode the client is idle (no features) and hands on the
    step's positions; ``top_apply``'s aux loss is a zero fp32 scalar."""
    jcfg, tcfg = _cfgs()
    b = _prefill_batch(jcfg, 16)
    jmodel, tmodel = jax_build_model(jcfg), build_model(tcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    _, _, jex = jmodel.bottom_apply(jparams["bottom"],
                                    {"frames": jnp.asarray(b["frames"])})
    port = lm_params_from_numpy(jax.device_get(jparams))
    tb = vlm.torch_batch(b)
    with torch.no_grad():
        feats, cache, tex = tmodel.bottom_apply(port["bottom"],
                                                {"frames": tb["frames"]})
        out, new = tmodel.top_apply(port["top"], feats, extras=dict(
            tex, dec_tokens=tb["dec_tokens"]))
    assert cache is None and new is None
    assert set(tex) == set(jex) == {"aux_loss", "positions"}
    np.testing.assert_array_equal(tex["positions"].numpy(),
                                  np.asarray(jex["positions"]))
    assert float(tex["aux_loss"]) == float(jex["aux_loss"]) == 0.0
    assert out["aux_loss"].dtype == torch.float32
    assert float(out["aux_loss"]) == 0.0
    pos = torch.full((BATCH, 1), 9)
    feats, cache, ex = tmodel.bottom_apply(
        port["bottom"], {"tokens": torch.zeros(BATCH, 1, dtype=torch.long),
                         "positions": pos}, mode="decode")
    assert feats is None and cache is None and ex["positions"] is pos
