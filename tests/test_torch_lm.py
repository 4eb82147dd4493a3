"""The PyTorch port's dense decoder-LM serving path against the JAX
package's, on the CPU at smoke size.

The JAX ``DecoderLM.init`` parameters of ``smoke_config("qwen3-14b")`` (4
query heads over 4 KV heads, head dim 64, 2 layers split 1 + 1) and of its
GQA variant (2 KV heads), converted by ``lm_params_from_numpy``, go through
the JAX ``make_prefill_step`` / ``make_decode_step`` and the port's: the
same prompt (numpy seed), prompt lengths 32, 300 and 512 (one and two
q-chunks of the JAX stand-in ``_chunked_attend``, Q_CHUNK 256), one
prefill and 4 greedy decode steps.  On the CPU the port's attention takes
the flash kernel's plain version.

Tolerances.  fp32: the last-position logits and the KV cache to 1e-4 (the
two sides sum in other orders; the measured gap is below 2e-5), and the
greedy tokens equal.  bf16: logits and cache to 0.1.  Both sides round to
bf16 after their operations, but in other places: XLA fuses chains of
elementwise operations and rounds once at the end of the fusion, PyTorch
rounds after every operation, and ``_chunked_attend`` rounds the softmax
weights to bf16 before the product with V while the port, like the Pallas
kernel, keeps them in fp32.  Each rounding moves a value by up to half a
bf16 ulp (2^-9 relative); the logits (|logit| < 4, where one ulp is 2^-6 to
2^-5) and the cache entries (|k|, |v| < 8) then agree to about two ulps of
their largest values (measured: 0.05), which 0.1 bounds.  Greedy argmax
over logits that agree only to 0.1 may flip on a near tie, so in bf16 the
decode steps are fed the JAX tokens and held to the cache, and the tokens
are compared in fp32 only."""
from dataclasses import fields, is_dataclass, replace
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
from repro_torch.configs import get_config, smoke_config
from repro_torch.convert import (lm_cache_from_numpy, lm_cache_to_numpy,
                                 lm_params_from_numpy)
from repro_torch.launch import steps
from repro_torch.launch.serve import serve_config
from repro_torch.models.transformer import DecoderLM
from _torch_threads import one_torch_thread  # noqa: F401

BATCH, N_DECODE = 2, 4
TOLS = {"float32": 1e-4, "bfloat16": 0.1}


def _configs(dtype: str, kv_heads: int):
    return (replace(jax_smoke_config("qwen3-14b"), dtype=dtype,
                    num_kv_heads=kv_heads),
            replace(smoke_config("qwen3-14b"), dtype=dtype,
                    num_kv_heads=kv_heads))


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


def _f32(a) -> np.ndarray:
    return np.asarray(a, np.float32)


def _assert_cache_close(jcache, tcache, tol: float) -> None:
    got = lm_cache_to_numpy(tcache)
    for seg in ("bottom", "top"):
        want = jcache[seg]["stack"]
        np.testing.assert_allclose(got[seg][0], _f32(want.k), atol=tol,
                                   rtol=0)
        np.testing.assert_allclose(got[seg][1], _f32(want.v), atol=tol,
                                   rtol=0)
        np.testing.assert_array_equal(got[seg][2], np.asarray(want.pos))


@pytest.mark.parametrize("prompt_len", [32, 300, 512])
@pytest.mark.parametrize("kv_heads", [4, 2], ids=["mha", "gqa"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(dtype, kv_heads, prompt_len):
    jcfg, tcfg = _configs(dtype, kv_heads)
    tol = TOLS[dtype]
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
    np.testing.assert_allclose(tlogits.float().numpy(), _f32(jlogits),
                               atol=tol, rtol=0)
    _assert_cache_close(jax.device_get(jcache), tcache, tol)

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
    _assert_cache_close(jax.device_get(jcache), tcache, tol)
    if dtype == "float32":
        np.testing.assert_array_equal(np.stack(ttoks), np.stack(jtoks))


def test_serve_config_matches_the_jax_steps():
    """The port's serve entry point draws the prompt as the JAX launcher
    does and generates the JAX steps' greedy tokens from the same
    weights (fp32, GQA)."""
    jcfg, tcfg = _configs("float32", 2)
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
    np.testing.assert_allclose(got.logits.numpy(), _f32(jlogits), atol=1e-4,
                               rtol=0)
    np.testing.assert_array_equal(got.tokens, np.stack(want, 1))


@pytest.mark.parametrize("which,arch", [
    pytest.param("full", "qwen3-14b", id="full"),
    pytest.param("smoke", "qwen3-14b", id="smoke"),
    pytest.param("full", "deepseek-v2-236b", id="deepseek-v2-236b-full"),
    pytest.param("smoke", "deepseek-v2-236b", id="deepseek-v2-236b-smoke"),
    pytest.param("full", "arctic-480b", id="arctic-480b-full"),
    pytest.param("smoke", "arctic-480b", id="arctic-480b-smoke")])
def test_config_fields_match_jax(which, arch):
    """Every field the port's ArchConfig keeps has the JAX value (a
    sub-config's, such as ``moe``, field by field), for the full qwen3-14b,
    deepseek-v2-236b and arctic-480b configs and their smoke variants."""
    if which == "full":
        jcfg, tcfg = jax_get_config(arch), get_config(arch)
    else:
        jcfg, tcfg = jax_smoke_config(arch), smoke_config(arch)
    for f in fields(tcfg):
        if f.name == "semisfl":
            continue
        got, want = getattr(tcfg, f.name), getattr(jcfg, f.name)
        if is_dataclass(got):
            for g in fields(got):
                assert getattr(got, g.name) == getattr(want, g.name), \
                    (f.name, g.name)
        else:
            assert got == want, f.name
    assert tcfg.split_layer == jcfg.split_layer
    assert tcfg.resolved_head_dim == jcfg.resolved_head_dim


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_tree_matches_the_converted_jax_tree(dtype):
    """The port's own init gives the converted JAX tree's structure,
    shapes and dtypes, so weights drawn on the card have the JAX layout."""
    jcfg, tcfg = _configs(dtype, 2)
    want = lm_params_from_numpy(jax.device_get(
        jax_build_model(jcfg).init(jax.random.PRNGKey(0))))
    got = DecoderLM(tcfg).init(torch.Generator().manual_seed(0), "cpu")
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    # jax.tree_util orders dict keys, so the leaves pair up whatever the
    # insertion order of either tree
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert g.shape == w.shape and g.dtype == w.dtype


def test_decoder_refuses_families_not_ported():
    """Vision and encoder-decoder models are not ported (MoE is)."""
    for kw in (dict(arch_type="vlm", modality="vision"),
               dict(is_encoder_decoder=True)):
        with pytest.raises(NotImplementedError, match="no vision or "
                           "encoder-decoder"):
            DecoderLM(replace(smoke_config("qwen3-14b"), **kw))
