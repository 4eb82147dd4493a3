"""The PyTorch port's Multi-head Latent Attention (``models/mla.py``), the
flash wrapper's (192, 128) head-dim pair that its prefill runs on, and the
DeepSeek-V2 serving path, against the JAX package on the CPU at smoke
size.

MLA: the smoke ``deepseek-v2-236b``'s layer (4 heads, kv_lora 32, q_lora
48, nope 32 + rope 16 for q and k, v 32), its JAX parameters converted by
``convert.lm_params_from_numpy``, a prefill of S 32, 256 and 512 tokens
(one and two q-chunks of JAX's chunked softmax, which needs S divisible by
S // 256) into a cache of S + 5, then 4 absorbed decode steps from the
JAX prefill's cache converted by ``convert.lm_cache_from_numpy``; inputs
from a numpy seed.  On the CPU the prefill's attention takes the flash
kernel's plain version.

The whole model: the smoke DeepSeek-V2 (layer 0 a dense prefix layer in
the bottom, layer 1 MLA + MoE in the top) and the smoke Arctic (MoE with a
dense residual on both sides) through the JAX ``make_prefill_step`` /
``make_decode_step`` and the port's, one prefill and 4 greedy decode
steps, and ``serve_config`` against the JAX steps.

Tolerances.  fp32: outputs, logits and caches to 1e-4 (``test_torch_lm``'s
TOLS: the two sides sum in other orders; measured at most 1.6e-6 on the
layer's outputs and 6.0e-6 on the logits), greedy tokens equal.  bf16: to
0.1 (``test_torch_lm``'s TOLS: both sides round to bf16 after their
operations but in other places, and JAX rounds the softmax weights to bf16
before the product with V where the plain flash version keeps them in
fp32; measured at most 0.0156 on the layer's outputs, one ulp of values in
[2, 4), and 0.047 on the logits, three ulps of values in [2, 4)); in bf16
the decode steps are fed the JAX tokens, as in ``test_torch_lm``.  The
plain flash version with v's head dim apart from q's: to 1e-5 of an fp64
numpy softmax (fp32 scores and sums)."""
from dataclasses import fields, replace
from importlib import import_module
import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import INPUT_SHAPES
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.launch.steps import StepPlan
from repro.launch.steps import make_decode_step as jax_decode_step
from repro.launch.steps import make_prefill_step as jax_prefill_step
from repro.models import DistContext
from repro.models import build_model as jax_build_model
from repro.models import mla as jmla
from repro_torch.configs import get_config, smoke_config
from repro_torch.convert import (lm_cache_from_numpy, lm_cache_to_numpy,
                                 lm_params_from_numpy)
from repro_torch.kernels import ref
from repro_torch.launch import steps
from repro_torch.launch.serve import serve_config
from repro_torch.models import mla
from repro_torch.models.transformer import DecoderLM
from _torch_threads import one_torch_thread  # noqa: F401

fa = import_module("repro_torch.kernels.flash_attention")

BATCH, N_DECODE = 2, 4
TOLS = {"float32": 1e-4, "bfloat16": 0.1}
DS = "deepseek-v2-236b"


def _f32(a) -> np.ndarray:
    return np.asarray(a, np.float32)


def _both(x: np.ndarray, dtype: str):
    """The same values on both sides: JAX's array and the port's tensor
    from its bits."""
    jx = jnp.asarray(x, getattr(jnp, dtype))
    return jx, torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))


@functools.cache
def _jax_model(arch: str, dtype: str):
    jcfg = replace(jax_smoke_config(arch), dtype=dtype)
    params = jax.device_get(jax_build_model(jcfg).init(
        jax.random.PRNGKey(0)))
    return jcfg, params


# ---------------------------------------------------------------------------
# the MLA layer
# ---------------------------------------------------------------------------

@functools.cache
def _jax_mla(dtype: str):
    jcfg, params = _jax_model(DS, dtype)
    p = jax.tree.map(lambda a: a[0], params["top"]["stack"]["attn"])
    run = lambda mode: jax.jit(lambda p, x, pos, c: jmla.apply_mla(
        p, jcfg, x, positions=pos, mode=mode, cache=c))
    return jcfg, p, run("prefill"), run("decode")


def _segment(cache) -> dict:
    """One layer's JAX cache as a one-layer JAX model cache."""
    one = jax.tree.map(lambda a: np.asarray(a)[None], cache)
    return {"bottom": {"stack": one}, "top": {"stack": one}}


def _assert_mla_cache_close(jcache, tcache: mla.MLACache, tol: float):
    got = lm_cache_to_numpy({"bottom": {"stack": [tcache]},
                             "top": {"stack": [tcache]}})["top"]
    np.testing.assert_allclose(got[0][0], _f32(jcache.latent), atol=tol,
                               rtol=0)
    np.testing.assert_allclose(got[1][0], _f32(jcache.k_rope), atol=tol,
                               rtol=0)
    np.testing.assert_array_equal(got[2][0], np.asarray(jcache.length))


@pytest.mark.parametrize("s", [32, 256, 512])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_mla_prefill_and_decode_match_jax(dtype, s):
    jcfg, jp, jprefill, jdecode = _jax_mla(dtype)
    tcfg = replace(smoke_config(DS), dtype=dtype)
    tp = lm_params_from_numpy(_jax_model(DS, dtype)[1])["top"]["stack"][0][
        "attn"]
    tol = TOLS[dtype]
    rng = np.random.RandomState(s)
    jx, tx = _both(rng.randn(BATCH, s, jcfg.d_model), dtype)
    pos = np.broadcast_to(np.arange(s), (BATCH, s))
    jcache = jmla.init_mla_cache(BATCH, s + N_DECODE + 1, jcfg,
                                 getattr(jnp, dtype))
    jy, jcache = jprefill(jp, jx, jnp.asarray(pos, jnp.int32), jcache)
    tcache = mla.init_mla_cache(BATCH, s + N_DECODE + 1, tcfg,
                                getattr(torch, dtype), "cpu")
    with torch.inference_mode():
        ty, tcache = mla.apply_mla(tp, tcfg, tx,
                                   positions=torch.from_numpy(pos.copy()),
                                   mode="prefill", cache=tcache)
    np.testing.assert_allclose(ty.float().numpy(), _f32(jy), atol=tol,
                               rtol=0)
    _assert_mla_cache_close(jcache, tcache, tol)

    # decode from the JAX prefill's cache, converted
    tcache = lm_cache_from_numpy(_segment(jax.device_get(jcache)))["top"][
        "stack"][0]
    for i in range(N_DECODE):
        jx, tx = _both(rng.randn(BATCH, 1, jcfg.d_model), dtype)
        p = np.full((BATCH, 1), s + i)
        jy, jcache = jdecode(jp, jx, jnp.asarray(p, jnp.int32), jcache)
        with torch.inference_mode():
            ty, tcache = mla.apply_mla(tp, tcfg, tx,
                                       positions=torch.from_numpy(p),
                                       mode="decode", cache=tcache)
        np.testing.assert_allclose(ty.float().numpy(), _f32(jy), atol=tol,
                                   rtol=0)
    _assert_mla_cache_close(jcache, tcache, tol)


# ---------------------------------------------------------------------------
# the flash wrapper at unequal head dims
# ---------------------------------------------------------------------------

def _softmax_attention_f64(q, k, v, causal, window):
    """The plain definition in fp64 numpy: q (B, H, Sq, d), k (B, KVH, Skv,
    d), v (B, KVH, Skv, dv); a row that sees no key gives 0."""
    b, h, sq, d = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    k = np.repeat(k, h // kvh, axis=1).astype(np.float64)
    v = np.repeat(v, h // kvh, axis=1).astype(np.float64)
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), k) / np.sqrt(d)
    i, j = np.arange(sq)[:, None], np.arange(skv)[None, :]
    mask = np.ones((sq, skv), bool)
    if causal:
        mask &= j <= i
    if window:
        mask &= j > i - window
    s = np.where(mask, s, -np.inf)
    m = s.max(-1, keepdims=True)
    e = np.where(mask, np.exp(s - np.where(np.isfinite(m), m, 0.0)), 0.0)
    w = e / np.where(e.sum(-1, keepdims=True) > 0, e.sum(-1, keepdims=True),
                     1.0)
    return np.einsum("bhqk,bhkd->bhqd", w, v)


@pytest.mark.parametrize("b,h,kvh,sq,skv,d,dv,causal,window", [
    (2, 4, 4, 40, 40, 24, 16, True, 0),
    (1, 4, 2, 33, 70, 48, 32, False, 0),
    (1, 2, 1, 64, 16, 40, 8, True, 8),          # rows 23 on see no key
    (1, 2, 2, 20, 20, 192, 128, True, 0)])
def test_plain_flash_with_its_own_v_head_dim(b, h, kvh, sq, skv, d, dv,
                                             causal, window):
    rng = np.random.RandomState(d + dv)
    q = rng.randn(b, h, sq, d).astype(np.float32)
    k = rng.randn(b, kvh, skv, d).astype(np.float32)
    v = rng.randn(b, kvh, skv, dv).astype(np.float32)
    got = ref.flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal=causal,
                                  window=window)
    assert got.shape == (b, h, sq, dv)
    np.testing.assert_allclose(got.numpy(),
                               _softmax_attention_f64(q, k, v, causal,
                                                      window),
                               atol=1e-5, rtol=0)


def _meta(shape, dtype=torch.bfloat16):
    return torch.empty(*shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wrapper_accepts_the_mla_pair(dtype, monkeypatch):
    """(192, 128) passes the wrapper's checks in both dtypes (the device
    check aside: these are ``meta`` tensors), and the bf16 views the MLA
    prefill hands over meet the wgmma kernel's layout rule."""
    dt = getattr(torch, dtype)
    q = _meta((2, 64, 4, 192), dt).transpose(1, 2)
    k = _meta((2, 64, 4, 192), dt).transpose(1, 2)
    v = _meta((2, 64, 4 * 128), dt).view(2, 64, 4, 128).transpose(1, 2)
    assert fa.head_dims_problem(192, 128) is None
    monkeypatch.setattr(fa, "_on_card", lambda named: None)
    fa._check(q, k, v, 0)
    if dt == torch.bfloat16:
        assert fa.wgmma_layout_problem(q, k, v) is None


@pytest.mark.parametrize("d,dv", [(128, 192), (192, 192), (128, 64),
                                  (192, 64), (96, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wrapper_refuses_pairs_not_built(d, dv, dtype, monkeypatch):
    """A pair the .cu does not instantiate raises (Dv > D among them), in
    both dtypes, before any launch."""
    dt = getattr(torch, dtype)
    q, k = _meta((1, 2, 64, d), dt), _meta((1, 2, 64, d), dt)
    v = _meta((1, 2, 64, dv), dt)
    assert "head dims" in fa.head_dims_problem(d, dv)
    monkeypatch.setattr(fa, "_on_card", lambda named: None)
    with pytest.raises(ValueError, match="head dims|head dim of"):
        fa._check(q, k, v, 0)
    if dt == torch.bfloat16:
        assert fa.wgmma_layout_problem(q, k, v) is not None


def test_head_dims_match_the_kernel_source():
    """The wrapper's ``HEAD_DIMS`` are the .cu switch's cases and its
    ``HEAD_DIM_PAIRS`` the unequal pair the entry point instantiates."""
    src = (Path(fa.__file__).parents[1] / "csrc" / "flash_attention.cu"
           ).read_text()
    entry = src[src.index('extern "C" int flash_attention_fwd'):]
    cases = tuple(int(c) for c in re.findall(
        r"case (\d+): fn = pick<\1>\(bf16\)", entry))
    assert cases == fa.HEAD_DIMS
    pairs = tuple((int(a), int(b)) for a, b in re.findall(
        r"fn = pick<(\d+), (\d+)>\(bf16\)", entry))
    assert pairs == fa.HEAD_DIM_PAIRS
    for d, dv in pairs:
        assert f"hd != {d} || hd_v != {dv}" in entry


def test_output_keeps_q_layout_with_v_head_dim():
    """The output of a (B, S, H, 192) projection's view has v's head dim in
    the same (B, S, H, .) layout, so the model's reshape needs no copy."""
    q = _meta((4, 2048, 128, 192)).transpose(1, 2)
    out = fa.output_like(q, 128)
    assert out.shape == (4, 128, 2048, 128)
    assert out.stride() == (2048 * 128 * 128, 128, 128 * 128, 1)
    assert fa.output_like(q, 192).stride() == q.stride()


def _bwd_args(d: int, dv: int, dt):
    """q, k (1, 2, 64, d), v, o and dO (1, 2, 64, dv) and the lse, on
    ``meta``: what the backward wrapper checks before any launch."""
    q, k = _meta((1, 2, 64, d), dt), _meta((1, 2, 64, d), dt)
    v, o, do = (_meta((1, 2, 64, dv), dt) for _ in range(3))
    return q, k, v, o, _meta((1, 2, 64), torch.float32), do


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_accepts_the_mla_pair(dtype, monkeypatch):
    """(192, 128) passes the backward's checks in both dtypes: o and dO
    have v's head dim, the gradients each their input's."""
    q, k, v, o, lse, do = _bwd_args(192, 128, getattr(torch, dtype))
    monkeypatch.setattr(fa, "_on_card", lambda named: None)
    fa._check(q, k, v, 0, o=o, do=do)
    with pytest.raises(ValueError, match="not shaped like q"):
        fa._check(q, k, v, 0, o=_meta((1, 2, 64, 192), q.dtype), do=do)


@pytest.mark.parametrize("d,dv", [(128, 192), (192, 192), (128, 64),
                                  (192, 64), (96, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_refuses_pairs_not_built(d, dv, dtype, monkeypatch):
    """A pair the backward .cu does not instantiate raises, in both dtypes,
    before any launch, as the forward's wrapper does."""
    q, k, v, o, lse, do = _bwd_args(d, dv, getattr(torch, dtype))
    monkeypatch.setattr(fa, "_on_card", lambda named: None)
    with pytest.raises(ValueError, match="head dims|head dim of"):
        fa.flash_attention_bwd_cuda(q, k, v, o, lse, do)


def test_deepseek_prefill_views_fit_the_wgmma_kernel(monkeypatch):
    """The full DeepSeek-V2's MLA prefill (batch 4, S 2048, bf16, on
    ``meta``) hands the flash wrapper q, k (192) and v (128) views that
    the wgmma kernel takes, so the serving path never hits its raise."""
    cfg = get_config(DS)
    p = mla.init_mla(cfg, None, "meta", torch.bfloat16)
    seen = []

    def flash(q, k, v, causal):
        seen.append((q, k, v, causal))
        return fa.output_like(q, v.shape[-1])
    monkeypatch.setattr(mla.kernels, "flash_attention", flash)
    x = _meta((4, 2048, cfg.d_model))
    pos = torch.empty(4, 2048, dtype=torch.int64, device="meta")
    y, _ = mla.apply_mla(p, cfg, x, positions=pos, mode="prefill")
    (q, k, v, causal), = seen
    assert causal and y.shape == x.shape
    assert q.shape == k.shape == (4, 128, 2048, 192)
    assert v.shape == (4, 128, 2048, 128)
    assert fa.wgmma_layout_problem(q, k, v) is None


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

@functools.cache
def _jax_steps(arch: str, dtype: str):
    jcfg, _ = _jax_model(arch, dtype)
    plan = StepPlan(cfg=jcfg, shape=INPUT_SHAPES["decode_32k"],
                    kind="decode", n_clients=1, per_client_batch=BATCH,
                    long_context=False)
    return (jax.jit(jax_prefill_step(plan, DistContext())),
            jax.jit(jax_decode_step(plan, DistContext())))


def _assert_cache_close(jcache, tcache, tol: float) -> None:
    got = lm_cache_to_numpy(tcache)
    want = jax.device_get(jcache)
    pairs = [(got["top"], want["top"]["stack"])]
    if "prefix" in tcache["bottom"]:
        assert want["bottom"]["stack"] is None
        assert got["bottom"]["stack"] is None
        pairs.append((got["bottom"]["prefix"], want["bottom"]["prefix"]))
    else:
        pairs.append((got["bottom"], want["bottom"]["stack"]))
    for g, w in pairs:
        for gi, wi in zip(g, w):
            if wi.dtype.kind in "iu":
                np.testing.assert_array_equal(gi, wi)
            else:
                np.testing.assert_allclose(gi, _f32(wi), atol=tol, rtol=0)


@pytest.mark.parametrize("arch,dtype,prompt_len", [
    (DS, "float32", 32), (DS, "float32", 300), (DS, "bfloat16", 32),
    (DS, "bfloat16", 300), ("arctic-480b", "float32", 32)])
def test_prefill_and_decode_match_jax(arch, dtype, prompt_len):
    jcfg, jparams = _jax_model(arch, dtype)
    tcfg = replace(smoke_config(arch), dtype=dtype)
    tol = TOLS[dtype]
    jprefill, jdecode = _jax_steps(arch, dtype)
    jcache = jax_build_model(jcfg).init_cache(BATCH,
                                              prompt_len + N_DECODE + 1)
    tparams = lm_params_from_numpy(jparams)
    tcache = lm_cache_from_numpy(jax.device_get(jcache))
    prompt = np.random.RandomState(0).randint(0, jcfg.vocab_size,
                                              (BATCH, prompt_len))
    jlogits, jcache = jprefill(jparams, {"tokens": jnp.asarray(
        prompt, jnp.int32)}, jcache)
    tlogits, tcache = steps.make_prefill_step(tcfg)(
        tparams, {"tokens": torch.from_numpy(prompt)}, tcache)
    np.testing.assert_allclose(tlogits.float().numpy(), _f32(jlogits),
                               atol=tol, rtol=0)
    _assert_cache_close(jcache, tcache, tol)

    tdecode = steps.make_decode_step(tcfg)
    jtok = jnp.argmax(jlogits, -1).astype(jnp.int32)
    ttok = tlogits.argmax(-1)
    jtoks, ttoks = [np.asarray(jtok)], [ttok.numpy()]
    for i in range(N_DECODE):
        pos = prompt_len + i
        if dtype == "bfloat16":      # teacher-forced, as in test_torch_lm
            ttok = torch.from_numpy(np.asarray(jtok, np.int64))
        jtok, jcache = jdecode(jparams, {"tokens": jtok[:, None],
                                         "pos": jnp.full((BATCH,), pos,
                                                         jnp.int32)}, jcache)
        ttok, tcache = tdecode(tparams, {"tokens": ttok[:, None],
                                         "pos": torch.full((BATCH,), pos)},
                               tcache)
        jtoks.append(np.asarray(jtok))
        ttoks.append(ttok.numpy())
    _assert_cache_close(jcache, tcache, tol)
    if dtype == "float32":
        np.testing.assert_array_equal(np.stack(ttoks), np.stack(jtoks))


def test_serve_config_matches_the_jax_steps():
    """The port's serve entry point generates the JAX steps' greedy tokens
    from the same DeepSeek-V2 weights (fp32)."""
    jcfg, jparams = _jax_model(DS, "float32")
    prompt_len, gen = 32, N_DECODE + 1
    jprefill, jdecode = _jax_steps(DS, "float32")
    jcache = jax_build_model(jcfg).init_cache(BATCH, prompt_len + gen)
    rng = np.random.RandomState(0)
    prompt = jnp.asarray(rng.randint(0, jcfg.vocab_size,
                                     (BATCH, prompt_len)), jnp.int32)
    jlogits, jcache = jprefill(jparams, {"tokens": prompt}, jcache)
    tok = jnp.argmax(jlogits, -1).astype(jnp.int32)
    want = [np.asarray(tok)]
    for i in range(gen - 1):
        tok, jcache = jdecode(jparams, {"tokens": tok[:, None],
                                        "pos": jnp.full((BATCH,),
                                                        prompt_len + i,
                                                        jnp.int32)}, jcache)
        want.append(np.asarray(tok))
    got = serve_config(replace(smoke_config(DS), dtype="float32"), BATCH,
                       prompt_len, gen, seed=0,
                       params=lm_params_from_numpy(jparams), device="cpu",
                       log=lambda _: None)
    np.testing.assert_allclose(got.logits.numpy(), _f32(jlogits),
                               atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got.tokens, np.stack(want, 1))


@pytest.mark.parametrize("arch", [DS, "arctic-480b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_tree_matches_the_converted_jax_tree(arch, dtype):
    """The port's own init gives the converted JAX tree's structure,
    shapes and dtypes (the prefix segment, the (E, d, f) experts, the fp32
    router, the MLA weights), so weights drawn on the card have the JAX
    layout."""
    want = lm_params_from_numpy(_jax_model(arch, dtype)[1])
    got = DecoderLM(replace(smoke_config(arch), dtype=dtype)).init(
        torch.Generator().manual_seed(0), "cpu")
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert g.shape == w.shape and g.dtype == w.dtype


def test_deepseek_split_and_prefix():
    """The full DeepSeek-V2 keeps layer 0 as its bottom's dense prefix;
    chip_smoke's 9- and 2-layer cuts split 2 + 7 and 1 + 1, as JAX's
    DecoderLM splits them."""
    for layers, split in ((60, 15), (9, 2), (2, 1)):
        tcfg = replace(get_config(DS), num_layers=layers)
        jm = jax_build_model(replace(jax_get_config(DS), num_layers=layers))
        tm = DecoderLM(tcfg)
        assert (tm.prefix_n, tm.split) == (jm.prefix_n, jm.split) == \
            (1, split)
    cfg = get_config(DS)
    assert {f.name for f in fields(cfg.moe)} >= {"num_experts", "top_k"}
    assert cfg.resolved_head_dim == 192 and cfg.v_head_dim == 128
