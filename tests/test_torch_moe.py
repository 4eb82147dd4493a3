"""The PyTorch port's MoE layer (``repro_torch/models/moe.py``) against the
JAX package's dense-mixture path (``apply_moe_dense``), on the CPU at smoke
size.

The JAX ``DecoderLM.init`` parameters of the smoke ``deepseek-v2-236b``
(4 experts, top 2, one shared expert) and ``arctic-480b`` (4 experts, top
2, a dense residual MLP) go through ``convert.lm_params_from_numpy``; the
top segment's MoE layer then takes the same inputs (numpy seed) on both
sides, at 4 tokens (a decode step's batch) and at 2 x 64 (a prefill).

Tolerances.  The routing indices are equal and the routing weights and
probabilities agree to 1e-6 (fp32 softmax on both sides).  The aux loss
agrees to 1e-6 (fp32 means and sums in other orders; measured equal).  The
layer's output: fp32 to 1e-5 (the port runs only the selected experts and
sums a token's k terms in its own order; measured at most 9e-7 on outputs
up to 4.6); bf16 to 0.1, ``test_torch_lm.py``'s bf16 tolerance: both sides
round the expert products and the SiLU to bf16, but XLA may keep a fused
chain in fp32 where PyTorch rounds after each op, so an output can land
on a neighbouring bf16 value; measured at most 0.03125, one ulp of outputs
in [4, 8)."""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import moe as jmoe
from repro_torch.configs import get_config, smoke_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import moe
from _torch_threads import one_torch_thread  # noqa: F401

ARCHS = ["deepseek-v2-236b", "arctic-480b"]
OUT_TOLS = {"float32": 1e-5, "bfloat16": 0.1}


def _layers(arch: str, dtype: str):
    """(JAX, port) parameters of the smoke model's first top-segment MoE
    layer, the port's converted from the JAX model's init."""
    jcfg = replace(jax_smoke_config(arch), dtype=dtype)
    tcfg = replace(smoke_config(arch), dtype=dtype)
    jparams = jax.device_get(jax_build_model(jcfg).init(
        jax.random.PRNGKey(0)))
    tparams = lm_params_from_numpy(jparams)
    jlayer = jax.tree.map(lambda a: a[0], jparams["top"]["stack"]["moe"])
    return jcfg, tcfg, jlayer, tparams["top"]["stack"][0]["moe"]


def _x(shape, d: int, dtype: str, seed: int = 0):
    """The same input on both sides: JAX's array and the port's tensor
    from its bits."""
    x = np.random.RandomState(seed).randn(*shape, d).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    return jx, torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))


@pytest.mark.parametrize("shape", [(1, 4), (2, 64)], ids=["t4", "2x64"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_matches_apply_moe_dense(arch, dtype, shape):
    jcfg, tcfg, jp, tp = _layers(arch, dtype)
    jx, tx = _x(shape, jcfg.d_model, dtype)
    jout, jaux = jmoe.apply_moe_dense(jp, jcfg, jx)
    tout, taux = moe.apply_moe(tp, tcfg, tx)
    assert tout.dtype == tx.dtype and tout.shape == tx.shape
    np.testing.assert_allclose(tout.float().numpy(),
                               np.asarray(jout, np.float32),
                               atol=OUT_TOLS[dtype], rtol=0)
    np.testing.assert_allclose(float(taux), float(jaux), atol=1e-6, rtol=0)

    # the routing itself: the same experts, the same weights
    jw, jidx, jprobs = jmoe._routing(jp["router"],
                                     jx.reshape(-1, jcfg.d_model), jcfg.moe)
    tw, tidx, tprobs = moe._routing(tp["router"],
                                    tx.reshape(-1, tcfg.d_model), tcfg.moe)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tprobs.numpy(), np.asarray(jprobs),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_aux_loss_matches_jax(arch):
    """The Switch load-balance loss from the same probabilities and
    indices, including an expert that takes no token."""
    rng = np.random.RandomState(3)
    probs = rng.dirichlet(np.ones(4), 16).astype(np.float32)
    idx = rng.randint(0, 3, (16, 2)).astype(np.int32)   # expert 3 unused
    want = jmoe.aux_load_balance_loss(jnp.asarray(probs), jnp.asarray(idx),
                                      4)
    got = moe.aux_load_balance_loss(torch.from_numpy(probs),
                                    torch.from_numpy(idx.astype(np.int64)),
                                    4)
    np.testing.assert_allclose(float(got), float(want), atol=1e-6, rtol=0)


def test_routing_record():
    """``ROUTING`` receives each call's tokens per expert (a tensor on x's
    device summing to T k, bincount's counts) and its smallest gap between
    the k-th and (k+1)-th probability."""
    _, tcfg, _, tp = _layers("deepseek-v2-236b", "float32")
    _, tx = _x((2, 64), tcfg.d_model, "float32", seed=5)
    moe.ROUTING = []
    try:
        moe.apply_moe(tp, tcfg, tx)
        (rec,) = moe.ROUTING
    finally:
        moe.ROUTING = None
    k = tcfg.moe.top_k
    assert int(rec["counts"].sum()) == 128 * k
    _, idx, probs = moe._routing(tp["router"], tx.reshape(-1, tcfg.d_model),
                                 tcfg.moe)
    assert torch.equal(rec["counts"], torch.bincount(
        idx.reshape(-1), minlength=tcfg.moe.num_experts))
    top = probs.sort(-1, descending=True).values
    assert float(rec["gap"]) == pytest.approx(
        float((top[:, k - 1] - top[:, k]).min()))


@pytest.mark.parametrize("which", ["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_param_count_matches_jax(arch, which):
    """``param_count`` reckons as JAX's does, MoE and MLA layers included
    (over-count and all)."""
    if which == "full":
        jcfg, tcfg = jax_get_config(arch), get_config(arch)
    else:
        jcfg, tcfg = jax_smoke_config(arch), smoke_config(arch)
    assert tcfg.param_count() == jcfg.param_count()

