"""The PyTorch port's xLSTM serving path against the JAX package's, on the
CPU at smoke size.

The JAX ``XLSTMModel.init`` parameters of ``smoke_config("xlstm-1.3b")``
(4 blocks in 2 groups of one mLSTM and one sLSTM block, split 1 + 1 group;
d_model 256, sLSTM 4 heads of 64, mLSTM 8 heads of 64), converted by
``lm_params_from_numpy``, go through the JAX ``make_prefill_step`` /
``make_decode_step`` and the port's: the same prompt (numpy seed), prompt
lengths 32, 256 and 300 (the mLSTM chunk is 32, 128 and, halved until it
divides 300, 4: 75 chunks), one prefill and 4 greedy decode steps.  On the
CPU the port's sLSTM prefill takes the scan kernel's plain version.

Tolerances.  fp32: the last-position logits and every cache leaf (mLSTM C,
n, m; sLSTM h, c, n, m) to 1e-4 (the two sides sum in other orders;
measured below 2e-5), and the greedy tokens equal.  The sLSTM stabilizer m
is a running sum of the forget pre-activation (bias 3), about 1300 after
300 tokens, where one fp32 ulp is 1.2e-4: it is held to 1e-4 plus 1e-5 of
its size (measured 1e-3, 8e-7 of its size).  bf16: logits to 0.2, cache
leaves to 0.1, the sLSTM m to 0.1 plus 1 % of its size.  Both sides round
to bf16 after their operations, but in other places (XLA fuses elementwise
chains and rounds once at the end, PyTorch rounds after each operation), so
a block's bf16 output differs by an ulp here and there; unlike attention's,
the recurrences carry such a difference on through time: the sLSTM c and n
are running sums of gated inputs, m a running sum of the forget
pre-activation, so its difference grows with the prompt (measured: logits
0.13 at |logit| < 4.1, i.e. 8 ulps; leaves 0.08; m 5.9 at 1300, 0.7 %).
Greedy argmax over logits that agree only to 0.2 may flip on a near tie, so
in bf16 the decode steps are fed the JAX tokens and held to the cache, and
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
from repro_torch.configs import get_config, smoke_config
from repro_torch.convert import (lm_cache_from_numpy, lm_cache_to_numpy,
                                 lm_params_from_numpy)
from repro_torch.launch import steps
from repro_torch.launch.serve import serve_config
from repro_torch.models.transformer import XLSTMModel, build_model
from _torch_threads import one_torch_thread  # noqa: F401

BATCH, N_DECODE = 2, 4
# (logits and leaves, relative term for the sLSTM m)
TOLS = {"float32": (1e-4, 1e-5), "bfloat16": (0.1, 1e-2)}
LOGIT_TOLS = {"float32": 1e-4, "bfloat16": 0.2}


def _configs(dtype: str):
    return (replace(jax_smoke_config("xlstm-1.3b"), dtype=dtype),
            replace(smoke_config("xlstm-1.3b"), dtype=dtype))


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


def _assert_cache_close(jcache, tcache, dtype: str) -> None:
    atol, m_rtol = TOLS[dtype]
    got = lm_cache_to_numpy(tcache)
    for seg in ("bottom", "top"):
        for kind in ("mlstm", "slstm"):
            want = jcache[seg][kind]
            assert len(got[seg][kind]) == len(want)
            for name, g, w in zip(want._fields, got[seg][kind], want):
                rtol = m_rtol if (kind, name) == ("slstm", "m") else 0.0
                np.testing.assert_allclose(
                    g, np.asarray(w, np.float32), atol=atol, rtol=rtol,
                    err_msg=f"{seg} {kind} {name}")


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
    _assert_cache_close(jax.device_get(jcache), tcache, dtype)

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
    _assert_cache_close(jax.device_get(jcache), tcache, dtype)
    if dtype == "float32":
        np.testing.assert_array_equal(np.stack(ttoks), np.stack(jtoks))


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
    full xlstm-1.3b config and its smoke variant, and the model splits at
    the same group."""
    if which == "full":
        jcfg, tcfg = jax_get_config("xlstm-1.3b"), get_config("xlstm-1.3b")
    else:
        jcfg, tcfg = (jax_smoke_config("xlstm-1.3b"),
                      smoke_config("xlstm-1.3b"))
    for f in fields(tcfg):
        if f.name == "xlstm":
            assert asdict(tcfg.xlstm) == asdict(jcfg.xlstm)
        elif f.name != "semisfl":
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    assert tcfg.split_layer == jcfg.split_layer
    jm, tm = jax_build_model(jcfg), build_model(tcfg)
    assert isinstance(tm, XLSTMModel)
    assert (tm.n_groups, tm.split_groups, tm.split) == \
        (jm.n_groups, jm.split_groups, jm.split)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_tree_matches_the_converted_jax_tree(dtype):
    """The port's own init gives the converted JAX tree's structure,
    shapes and dtypes (fp32 sLSTM w, r, b and mLSTM w_if, b_if included),
    and its cache the converted JAX cache's."""
    jcfg, tcfg = _configs(dtype)
    jmodel, tmodel = jax_build_model(jcfg), XLSTMModel(tcfg)
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
