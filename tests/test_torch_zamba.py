"""The PyTorch port's Zamba2 serving path against the JAX package's, on the
CPU at smoke size.

The JAX ``HybridMamba.init`` parameters of ``smoke_config("zamba2-7b")``
(4 Mamba2 layers with the weight-shared attention + MLP block after every
2, split 2 + 2, so one application of the block on each side; d_model 256,
SSM state 16, 16 heads of 32, chunk 8; attention 4 heads of 64), converted
by ``lm_params_from_numpy``, go through the JAX ``make_prefill_step`` /
``make_decode_step`` and the port's: the same prompt (numpy seed), prompt
lengths 32, 256 and 300 (the JAX model's chunk of 8 halves to 4 at 300),
one prefill and 4 greedy decode steps.  On the CPU the port's prefill scan
takes the Mamba2 kernel's plain version, where the JAX model runs
``ssd_chunked`` and ``_final_state``.

The first 3 decode steps (conv width - 1) are where the reference's conv
cache shows its mixed contents: prefill stores the post-SiLU conv output
and decode appends the raw projection (``models/ssm.py:171`` against
``:143``).  The port mirrors this, so every cache leaf after each of those
steps must agree too.

Tolerances.  fp32: the last-position logits and every cache leaf (conv
window, SSM state, shared-block k and v) to 1e-4 (the two sides sum in
other orders: the sequential scan against the chunked one), and the greedy
tokens equal (measured: logits within 7.7e-6 at |logit| < 3.5, leaves
within 2.6e-5).  bf16: logits to 0.2 and cache leaves to 0.15 (measured:
logits 0.089, the SSM state 0.0075, the conv window 0.066, the shared k
and v 0.098, three bf16 ulps at their size; PyTorch's CPU matmuls may block
their sums differently with another thread count).  Both sides
round to bf16 after their operations, but in other places (XLA fuses
elementwise chains and rounds once at the end, PyTorch rounds after each
operation; the JAX prefill scan rounds y per chunk where the port's rounds
it once), so a layer's bf16 output differs by an ulp here and there, and
the recurrent state carries such a difference on through time.  Greedy
argmax over logits that agree only to 0.2 may flip on a near tie, so in
bf16 the decode steps are fed the JAX tokens and held to the cache, and
the tokens are compared in fp32 only."""
from dataclasses import asdict, fields, replace
import functools

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
from repro.models import ssm as jssm
from repro_torch.configs import get_config, smoke_config
from repro_torch.convert import (lm_cache_from_numpy, lm_cache_to_numpy,
                                 lm_params_from_numpy)
from repro_torch.launch import steps
from repro_torch.launch.serve import serve_config
from repro_torch.models import ssm as tssm
from repro_torch.models.transformer import HybridMamba, build_model
from _torch_threads import one_torch_thread  # noqa: F401

BATCH, N_DECODE = 2, 4
TOLS = {"float32": 1e-4, "bfloat16": 0.15}
LOGIT_TOLS = {"float32": 1e-4, "bfloat16": 0.2}


def _configs(dtype: str):
    return (replace(jax_smoke_config("zamba2-7b"), dtype=dtype),
            replace(smoke_config("zamba2-7b"), dtype=dtype))


@functools.cache
def _jax_steps(jcfg):
    plan = StepPlan(cfg=jcfg, shape=INPUT_SHAPES["decode_32k"],
                    kind="decode", n_clients=1, per_client_batch=BATCH,
                    long_context=False)
    return (jax.jit(jax_prefill_step(plan, DistContext())),
            jax.jit(jax_decode_step(plan, DistContext())))


def _jax_state(jcfg, prompt_len: int, seed: int = 0):
    model = jax_build_model(jcfg)
    params = model.init(jax.random.PRNGKey(seed))
    cache = model.init_cache(BATCH, prompt_len + N_DECODE + 1)
    return params, cache


def _prompt(vocab: int, prompt_len: int, seed: int = 0) -> np.ndarray:
    return np.random.RandomState(seed).randint(0, vocab, (BATCH, prompt_len))


def _assert_cache_close(jcache, tcache, dtype: str, what: str) -> None:
    got = lm_cache_to_numpy(tcache)
    for seg in ("bottom", "top"):
        for kind in ("ssm", "shared_kv"):
            want = jcache[seg][kind]
            for name, g, w in zip(want._fields, got[seg][kind], want):
                assert g.shape == w.shape, (seg, kind, name)
                np.testing.assert_allclose(
                    g, np.asarray(w, g.dtype), atol=TOLS[dtype], rtol=0,
                    err_msg=f"{what}: {seg} {kind} {name}")


@pytest.mark.parametrize("prompt_len", [32, 256, 300])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(dtype, prompt_len):
    jcfg, tcfg = _configs(dtype)
    jprefill, jdecode = _jax_steps(jcfg)
    jparams, jcache = _jax_state(jcfg, prompt_len)
    tparams = lm_params_from_numpy(jax.device_get(jparams))
    tcache = lm_cache_from_numpy(jax.device_get(jcache))
    prompt = _prompt(jcfg.vocab_size, prompt_len)

    jlogits, jcache = jprefill(jparams, {"tokens": jnp.asarray(prompt,
                                                               jnp.int32)},
                               jcache)
    tlogits, tcache = steps.make_prefill_step(tcfg)(
        tparams, {"tokens": torch.from_numpy(prompt)}, tcache)
    np.testing.assert_allclose(tlogits.float().numpy(),
                               np.asarray(jlogits, np.float32),
                               atol=LOGIT_TOLS[dtype], rtol=0)
    _assert_cache_close(jax.device_get(jcache), tcache, dtype, "prefill")

    tdecode = steps.make_decode_step(tcfg)
    jtok = jnp.argmax(jlogits, -1).astype(jnp.int32)
    ttok = tlogits.argmax(-1)
    jtoks, ttoks = [np.asarray(jtok)], [ttok.numpy()]
    for i in range(N_DECODE):
        pos = prompt_len + i
        if dtype == "bfloat16":      # teacher-forced: see the module note
            ttok = torch.from_numpy(np.asarray(jtok, np.int64))
        jtok, jcache = jdecode(jparams, {"tokens": jtok[:, None],
                                         "pos": jnp.full((BATCH,), pos,
                                                         jnp.int32)}, jcache)
        ttok, tcache = tdecode(tparams, {"tokens": ttok[:, None],
                                         "pos": torch.full((BATCH,), pos)},
                               tcache)
        jtoks.append(np.asarray(jtok))
        ttoks.append(ttok.numpy())
        _assert_cache_close(jax.device_get(jcache), tcache, dtype,
                            f"decode step {i}")
    if dtype == "float32":
        np.testing.assert_array_equal(np.stack(ttoks), np.stack(jtoks))


def test_ssm_layer_matches_jax_through_the_mixed_conv_window():
    """One Mamba2 layer, fp32: prefill of 13 tokens and 4 decode steps
    against the JAX ``apply_ssm``, output and cache after each call.  The
    prefill's conv window holds the post-SiLU conv output, not the raw
    projection, as in the reference (so the two differ), and the first 3
    decode steps convolve that window with raw inputs."""
    jcfg, tcfg = _configs("float32")
    b, s = BATCH, 13
    jp = jssm.init_ssm(jax.random.PRNGKey(3), jcfg, jnp.float32)
    # a non-zero A_log and dt_bias, so that every head decays at its own rate
    jp = dict(jp, A_log=jnp.linspace(-1.0, 1.0, jp["A_log"].shape[0]),
              dt_bias=jnp.linspace(-0.5, 0.5, jp["dt_bias"].shape[0]))
    tp = lm_params_from_numpy({"bottom": {"p": jax.device_get(jp)},
                               "top": {}})["bottom"]["p"]
    rng = np.random.RandomState(4)
    x = rng.randn(b, s + N_DECODE, jcfg.d_model).astype(np.float32)
    jc = jssm.init_ssm_cache(b, jcfg, jnp.float32)
    tc = tssm.init_ssm_cache(b, tcfg, torch.float32, "cpu")
    jy, jc = jssm.apply_ssm(jp, jcfg, jnp.asarray(x[:, :s]), mode="prefill",
                            cache=jc)
    ty, tc = tssm.apply_ssm(tp, tcfg, torch.from_numpy(x[:, :s]),
                            mode="prefill", cache=tc)
    raw_tail = np.asarray(jssm._split_proj(jnp.asarray(x[:, s - 3:s])
                                           @ jp["in_proj"], jcfg)[1])
    assert np.abs(tc.conv.numpy() - raw_tail).max() > 0.1
    for i in range(N_DECODE + 1):
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-4,
                                   rtol=0, err_msg=f"call {i}: y")
        for name, g, w in zip(tc._fields, tc, jc):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                       rtol=0, err_msg=f"call {i}: {name}")
        if i == N_DECODE:
            break
        xt = x[:, s + i: s + i + 1]
        jy, jc = jssm.apply_ssm(jp, jcfg, jnp.asarray(xt), mode="decode",
                                cache=jc)
        ty, tc = tssm.apply_ssm(tp, tcfg, torch.from_numpy(xt),
                                mode="decode", cache=tc)


def test_serve_config_matches_the_jax_steps():
    """The port's serve entry point draws the prompt as the JAX launcher
    does and generates the JAX steps' greedy tokens from the same weights
    (fp32)."""
    jcfg, tcfg = _configs("float32")
    prompt_len, gen = 32, N_DECODE + 1
    jprefill, jdecode = _jax_steps(jcfg)
    jparams, jcache = _jax_state(jcfg, prompt_len)
    prompt = jnp.asarray(_prompt(jcfg.vocab_size, prompt_len), jnp.int32)
    jlogits, jcache = jprefill(jparams, {"tokens": prompt}, jcache)
    tok = jnp.argmax(jlogits, -1).astype(jnp.int32)
    want = [np.asarray(tok)]
    for i in range(gen - 1):
        tok, jcache = jdecode(jparams, {"tokens": tok[:, None],
                                        "pos": jnp.full((BATCH,),
                                                        prompt_len + i,
                                                        jnp.int32)}, jcache)
        want.append(np.asarray(tok))
    got = serve_config(tcfg, BATCH, prompt_len, gen, seed=0,
                       params=lm_params_from_numpy(jax.device_get(jparams)),
                       device="cpu", log=lambda _: None)
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(jlogits),
                               atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got.tokens, np.stack(want, 1))


@pytest.mark.parametrize("which", ["full", "smoke"])
def test_config_fields_match_jax(which):
    """Every field the port's ArchConfig keeps has the JAX value, for the
    full zamba2-7b config and its smoke variant, and the model splits at
    the same layer (the full config's 20 snapped to the period: 18 + 63)."""
    if which == "full":
        jcfg, tcfg = jax_get_config("zamba2-7b"), get_config("zamba2-7b")
    else:
        jcfg, tcfg = jax_smoke_config("zamba2-7b"), smoke_config("zamba2-7b")
    for f in fields(tcfg):
        if f.name == "ssm":
            for k, v in asdict(tcfg.ssm).items():
                assert v == getattr(jcfg.ssm, k), k
        elif f.name != "semisfl":
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    assert tcfg.split_layer == jcfg.split_layer
    jm, tm = jax_build_model(jcfg), build_model(tcfg)
    assert isinstance(tm, HybridMamba)
    assert tm.split == jm.split == (18 if which == "full" else 2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_tree_matches_the_converted_jax_tree(dtype):
    """The port's own init gives the converted JAX tree's structure, shapes
    and dtypes (fp32 A_log, D and dt_bias included), and its cache the
    converted JAX cache's: one SSM cache per layer, one KV cache per
    application of the shared block."""
    jcfg, tcfg = _configs(dtype)
    jmodel, tmodel = jax_build_model(jcfg), HybridMamba(tcfg)
    pairs = [
        (tmodel.init(torch.Generator().manual_seed(0), "cpu"),
         lm_params_from_numpy(jax.device_get(
             jmodel.init(jax.random.PRNGKey(0))))),
        (tmodel.init_cache(BATCH, 8, "cpu"),
         lm_cache_from_numpy(jax.device_get(jmodel.init_cache(BATCH, 8))))]
    for got, want in pairs:
        assert jax.tree_util.tree_structure(got) == \
            jax.tree_util.tree_structure(want)
        # jax.tree_util orders dict keys, so the leaves pair up whatever the
        # insertion order of either tree
        for g, w in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(want)):
            assert g.shape == w.shape and g.dtype == w.dtype
    cache = pairs[1][0]
    assert [len(cache[seg]["ssm"]) for seg in ("bottom", "top")] == [2, 2]
    assert [len(cache[seg]["shared_kv"]) for seg in ("bottom", "top")] == \
        [1, 1]


def test_converted_params_unstack_the_layers_and_keep_the_shared_block():
    """``lm_params_from_numpy`` turns each side's ``stack`` into one tree
    per layer and copies each side's ``shared_attn`` block as a tree, bit
    for bit, in bf16."""
    jcfg, _ = _configs("bfloat16")
    jparams = jax.device_get(jax_build_model(jcfg).init(
        jax.random.PRNGKey(1)))
    tparams = lm_params_from_numpy(jparams)
    for seg in ("bottom", "top"):
        stack = tparams[seg]["stack"]
        assert len(stack) == 2 and set(stack[0]) == {"norm", "ssm"}
        w = np.asarray(jparams[seg]["stack"]["ssm"]["in_proj"][1],
                       np.float32)
        assert np.array_equal(stack[1]["ssm"]["in_proj"].float().numpy(), w)
        shared = tparams[seg]["shared_attn"]
        assert set(shared) == {"attn_norm", "attn", "mlp_norm", "mlp"}
        assert shared["attn"]["wq"].dtype == torch.bfloat16
        assert np.array_equal(
            shared["mlp"]["gate"].float().numpy(),
            np.asarray(jparams[seg]["shared_attn"]["mlp"]["gate"],
                       np.float32))
    assert not np.array_equal(
        tparams["bottom"]["shared_attn"]["attn"]["wq"].float().numpy(),
        tparams["top"]["shared_attn"]["attn"]["wq"].float().numpy())


def test_cache_converter_round_trips():
    """A JAX cache after a prefill -> the port's cache -> numpy again gives
    the same arrays (fp32 and positions exactly)."""
    jcfg, _ = _configs("float32")
    jprefill, _ = _jax_steps(jcfg)
    jparams, jcache = _jax_state(jcfg, 32)
    _, jcache = jprefill(jparams, {"tokens": jnp.asarray(
        _prompt(jcfg.vocab_size, 32), jnp.int32)}, jcache)
    want = jax.device_get(jcache)
    got = lm_cache_to_numpy(lm_cache_from_numpy(want))
    for seg in ("bottom", "top"):
        for kind in ("ssm", "shared_kv"):
            for g, w in zip(got[seg][kind], want[seg][kind]):
                assert np.array_equal(g, np.asarray(w))
