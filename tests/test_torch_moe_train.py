"""The port's MoE and MLA training (DeepSeek-V2, Arctic) against the JAX
package, on the CPU at smoke size.

  * one SemiSFL train step of the smoke ``deepseek-v2-236b`` (a dense MLA
    prefix layer in the bottom, an MLA + MoE layer with a shared expert in
    the top) and ``arctic-480b`` (MoE with a dense residual on both
    sides), with the ``int8`` wire and with none, against JAX's
    ``make_train_step`` (its MoE on the dense path, ``apply_moe_dense``)
    from one converted JAX state, as ``tests/test_torch_lm_train.py`` holds
    the dense configs (tau 0, 2 clients x 2 x 64 tokens, fp32, TOL); in
    the int8 case JAX's wire roundings are replayed into the port and the
    port's own held to them within single-code flips, as the xLSTM and
    Zamba2 tests do (``test_torch_xlstm_train._replay_wire``: a one-code
    flip of the cut's cotangent moved the smoke DeepSeek-V2's client
    embeddings by 2.3e-5, past TOL).  Routing is equal on the two sides:
    a token sent to another expert moves its MoE output by the size of an
    expert's output, and the top's expert weights by about rate / tokens
    (8e-5 here), past TOL, where the states agree;
  * the scanned K=3 phase against JAX's scanned phase (PHASE_TOL);
  * the host-read guard of ``tests/test_torch_lm_scan.py`` over one smoke
    step of each (what a CUDA graph's capture refuses);
  * the MoE layer's expert route (grouped products over the
    expert-sorted rows, counts summed on the device) against its plain
    per-expert loop and against JAX's ``apply_moe_dense``: the output, the
    aux loss and the gradients of x, the router and the experts, in fp32
    and bf16, with an expert that takes no token;
  * the flash attention backward at unequal head dims: the plain backward
    (``ref.flash_attention_bwd_ref``, what the card's kernels are held to)
    and autograd through the plain forward against ``jax.vjp`` of the
    chunked causal softmax of JAX's MLA train branch
    (``src/repro/models/mla.py``) at the smoke MLA's q/k 48 over v 32 and at
    DeepSeek-V2's 192 over 128, and the whole ``apply_mla`` train branch
    (the q/k concatenation and the rope key broadcast over the heads carry
    gradients) against ``jax.vjp`` of JAX's;
  * the backward .cu's head-dim switch against the wrapper's
    ``HEAD_DIMS`` and ``HEAD_DIM_PAIRS``;
  * the train state's shapes against JAX's ``input_specs`` and its round
    trip through the converters, bit for bit.

Tolerances.  The step at ``TOL`` (atol 1e-5, rtol 1e-4) and the phase at
``PHASE_TOL`` (1e-4), as the dense configs'.  The route against the loop:
fp32 to 1e-6 (the same products, grouped; measured equal), bf16 equal
after the products' rounding to bf16 within one bf16 ulp (2^-7 relative)
of the larger.  Against JAX: fp32 outputs to TOL and gradients to its rtol
with its atol times the leaf's largest gradient (the sides sum in other
orders, and a gradient entry is a sum over the tokens whose terms can
cancel far below their size; JAX's dense path also adds the unselected
experts' zero-weighted outputs); bf16 outputs to ``test_torch_moe``'s 0.1
and gradients to 2^-5 of the largest gradient of the leaf (XLA may keep a
fused chain in fp32 where PyTorch rounds each op to bf16); the aux loss to
1e-6.  The flash backward to TOL (both fp32); the MLA layer's output to
TOL and its gradients as the route's fp32 ones."""
import functools
import importlib
import re
from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_lm_scan as scan
import test_torch_lm_train as dense
import test_torch_moe as tmoe
import test_torch_xlstm_train as xlt
from repro.launch import steps as jsteps
from repro.models import DistContext
from repro.models import build_model as jax_build_model
from repro.models import mla as jmla
from repro.models import moe as jmoe
from repro.models.attention import Q_CHUNK
from repro_torch import kernels
from repro_torch.convert import (lm_params_from_numpy,
                                 lm_train_state_from_numpy,
                                 lm_train_state_to_numpy)
from repro_torch.kernels import ref
from repro_torch.launch import steps
from repro_torch.models import mla, moe
from test_torch_lm_train import PHASE_TOL, TOL, _assert_state_close
from test_torch_lm_train import _torch_batch
from _torch_threads import one_torch_thread  # noqa: F401

fa = importlib.import_module("repro_torch.kernels.flash_attention")

ARCHS = ["deepseek-v2-236b", "arctic-480b"]
STEP_CASES = [(a, w) for a in ARCHS for w in (None, "int8")]


def _cfgs(arch: str, dtype: str = "float32"):
    return dense._cfgs(arch, {}, 0.0, dtype)


def _assert_grad_close(got: np.ndarray, want: np.ndarray, what: str):
    """fp32 gradients: TOL's rtol, and its atol times the largest entry of
    ``want`` (an entry is a sum over tokens or positions whose terms may
    cancel far below their size, and the sides sum in other orders)."""
    np.testing.assert_allclose(got, want, err_msg=what, rtol=TOL["rtol"],
                               atol=TOL["atol"] * max(1.0,
                                                      np.abs(want).max()))


# ---------------------------------------------------------------------------
# the train step and the scanned phase
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,wire", STEP_CASES,
                         ids=[f"{a}-{w}" for a, w in STEP_CASES])
def test_moe_train_step_matches_jax(arch, wire, monkeypatch):
    jcfg, tcfg = _cfgs(arch)
    batch = dense._batch(jcfg, 1)
    state = dense._jax_state(jcfg, wire, batch)
    jnew, jm = dense._jax_step(jcfg, wire)(state, batch)
    jnew = jax.device_get(jnew)
    if wire:
        want = xlt._jax_wire(jcfg, state, batch, wire)
        seen = xlt._replay_wire(monkeypatch, want, wire)
    tnew, tm = steps.make_train_step(dense._plans(jcfg, tcfg)[1],
                                     wire=wire)(
        lm_train_state_from_numpy(state), _torch_batch(batch))
    if wire:
        xlt._assert_single_code_flips(seen, want)
    for k in ("loss", "consistency", "clustering", "mask_rate"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), err_msg=k,
                                   **TOL)
    assert float(tm["mask_rate"]) == 0.0 and float(tm["clustering"]) > 0.0
    _assert_state_close(tnew, jnew, TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_scanned_phase_matches_the_scanned_jax_phase(arch):
    jcfg, tcfg = _cfgs(arch)
    batches = [dense._batch(jcfg, 3 + i) for i in range(3)]
    state = dense._jax_state(jcfg, None, batches[0], seed=2)
    jplan, tplan = dense._plans(jcfg, tcfg)
    stacked = scan._stack(batches)
    jphase = jsteps.make_scanned_train_phase(jplan, DistContext(),
                                             donate_carry=False)
    jnew, jm = jax.device_get(jphase(state, stacked))
    tnew, tm = steps.make_scanned_train_phase(tplan)(
        lm_train_state_from_numpy(state), _torch_batch(stacked))
    scan._assert_metrics_close(tm, jm, 3)
    assert float(tm["clustering"][0]) > 0.0
    _assert_state_close(tnew, jnew, PHASE_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_the_moe_step_reads_no_host_value(arch):
    """One smoke step (bf16 as the config has it, int8 wire, tau 0) under
    the host-read guard, on the CPU: the routing, the counts and the
    expert products read nothing on the host."""
    from repro_torch.configs import smoke_config
    cfg = smoke_config(arch)
    cfg = replace(cfg, semisfl=replace(cfg.semisfl,
                                       confidence_threshold=0.0))
    plan = dense._plans(_cfgs(arch)[0], cfg)[1]
    state = steps.init_train_state(plan, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(0)
    n, b, s = plan.n_clients, plan.per_client_batch, plan.shape.seq_len
    batch = {k: torch.randint(0, cfg.vocab_size, (n, b, s), generator=gen)
             for k in ("tokens_weak", "tokens_strong")}
    step = steps.make_train_step(plan, wire="int8")
    with scan.HostReads() as guard:
        _, metrics = step(state, batch)
    assert guard.seen == [], guard.seen
    assert float(metrics["mask_rate"]) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_state_shapes_are_the_jax_input_specs(arch):
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    jplan, tplan = dense._plans(jcfg, tcfg)
    want = jsteps.input_specs(jplan)["state"]
    state = lm_train_state_to_numpy(steps.init_train_state(tplan, 0, "cpu"))
    for key in ("client_bottoms", "teacher_bottoms", "top", "t_top", "proj",
                "t_proj"):
        g = jax.tree.map(lambda a: (a.shape, a.dtype.name), state[key])
        w = jax.tree.map(lambda a: (a.shape, a.dtype.name), want[key])
        assert g == w, key
    # the full configs' state on meta: nothing allocated
    from repro_torch.configs import get_config
    full = steps.train_state_shapes(dense._plans(jcfg, get_config(arch))[1])
    assert full["state"]["top"]["stack"][0]["moe"]["experts"]["up"][0] == (
        get_config(arch).moe.num_experts, get_config(arch).d_model,
        get_config(arch).moe.d_ff_expert)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_train_state_round_trips_bit_for_bit(arch):
    jcfg, _ = _cfgs(arch)
    state = dense._jax_state(jcfg, None, dense._batch(jcfg, 1))
    back = lm_train_state_to_numpy(lm_train_state_from_numpy(state))
    want = dict(state, queue=state["queue"]._asdict())
    want["queue"]["ptr"] = int(state["queue"].ptr)
    g_leaves = jax.tree_util.tree_leaves_with_path(back)
    w_leaves = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in g_leaves] == [p for p, _ in w_leaves]
    for (path, g), (_, w) in zip(g_leaves, w_leaves):
        g, w = np.asarray(g), np.asarray(w)
        assert g.tobytes() == w.astype(g.dtype).tobytes(), \
            jax.tree_util.keystr(path)


# ---------------------------------------------------------------------------
# the expert route
# ---------------------------------------------------------------------------

UNUSED = 3          # the expert the inputs below never route to


def _route_inputs(arch: str, dtype: str, shape=(2, 24)):
    """(JAX, port) layer parameters with expert UNUSED's router column
    moved away from every input, the same input x on both sides and an
    output cotangent, from numpy: every entry of x is offset by 0.5, so
    that x . 1 is about d / 2 (8 standard deviations above 0 at d 256),
    and expert UNUSED's column is expert 0's less 1 / sqrt(d) in every
    entry, which puts its logit about 8 below expert 0's."""
    jcfg, tcfg, jp, tp = tmoe._layers(arch, dtype)
    d = jcfg.d_model
    router = np.array(jp["router"], np.float32)
    router[:, UNUSED] = router[:, 0] - 1.0 / np.sqrt(d)
    jp = dict(jp, router=jnp.asarray(router))
    tp = dict(tp, router=torch.from_numpy(router))
    rng = np.random.RandomState(11)
    x = rng.randn(*shape, d).astype(np.float32) + 0.5
    g = rng.randn(*shape, d).astype(np.float32)
    tdt = getattr(torch, dtype)
    jx, jg = (jnp.asarray(a, getattr(jnp, dtype)) for a in (x, g))
    tx, tg = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt)
              for a in (jx, jg))
    return jcfg, tcfg, jp, tp, jx, tx, jg, tg


AUX_W = 0.37        # the aux loss's weight in the differentiated sum


def _port_grads(tp, tcfg, tx, tg, route):
    """out, aux and the gradients of sum(out g) + AUX_W aux with respect
    to x, the router and the experts, through the port's layer."""
    leaves = {"x": tx.clone().requires_grad_(True),
              "router": tp["router"].clone().requires_grad_(True),
              **{f"experts.{k}": v.clone().requires_grad_(True)
                 for k, v in tp["experts"].items()}}
    p = dict(tp, router=leaves["router"],
             experts={k: leaves[f"experts.{k}"] for k in tp["experts"]})
    out, aux = moe.apply_moe(p, tcfg, leaves["x"], route=route)
    loss = (out.float() * tg.float()).sum() + AUX_W * aux
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return out.detach(), aux.detach(), dict(zip(leaves, grads))


@functools.cache
def _jax_grad_fn(jcfg):
    def loss(jp, x, g):
        out, aux = jmoe.apply_moe_dense(jp, jcfg, x)
        return (out.astype(jnp.float32) * g.astype(jnp.float32)).sum() \
            + AUX_W * aux, (out, aux)
    return jax.jit(jax.grad(loss, argnums=(0, 1), has_aux=True))


def _jax_grads(jcfg, jp, jx, jg):
    (gp, gx), (out, aux) = _jax_grad_fn(jcfg)(jp, jx, jg)
    grads = {"x": gx, "router": gp["router"],
             **{f"experts.{k}": v for k, v in gp["experts"].items()}}
    return out, aux, {k: np.asarray(v, np.float32) for k, v in grads.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_expert_route_matches_the_loop_and_jax(arch, dtype):
    jcfg, tcfg, jp, tp, jx, tx, jg, tg = _route_inputs(arch, dtype)
    counts = moe.expert_counts(moe._routing(
        tp["router"], tx.reshape(-1, tcfg.d_model), tcfg.moe)[1],
        tcfg.moe.num_experts)
    assert int(counts[UNUSED]) == 0 and int(counts.sum()) == \
        tx.shape[0] * tx.shape[1] * tcfg.moe.top_k
    assert moe.expert_route(getattr(torch, dtype), "cpu") == "grouped"
    got = _port_grads(tp, tcfg, tx, tg, "grouped")
    loop = _port_grads(tp, tcfg, tx, tg, "loop")
    want = _jax_grads(jcfg, jp, jx, jg)

    # the route against the loop
    loop_tol = (dict(atol=1e-6, rtol=0) if dtype == "float32"
                else dict(atol=0, rtol=2.0 ** -7))
    torch.testing.assert_close(got[0].float(), loop[0].float(), **loop_tol)
    assert float(got[1]) == float(loop[1])
    for k in got[2]:
        torch.testing.assert_close(got[2][k].float(), loop[2][k].float(),
                                   msg=k, **loop_tol)
    assert float(got[2]["experts.up"][UNUSED].abs().max()) == 0.0

    # the route against JAX's dense path
    out_tol = (TOL if dtype == "float32"
               else dict(atol=tmoe.OUT_TOLS[dtype], rtol=0))
    np.testing.assert_allclose(got[0].float().numpy(),
                               np.asarray(want[0], np.float32), **out_tol)
    np.testing.assert_allclose(float(got[1]), float(want[1]), atol=1e-6,
                               rtol=0)
    for k, w in want[2].items():
        g = got[2][k].float().numpy()
        assert g.shape == w.shape, k
        if dtype == "float32":
            _assert_grad_close(g, w, k)
        else:
            np.testing.assert_allclose(g, w, err_msg=k, rtol=0,
                                       atol=2.0 ** -5 * np.abs(w).max())


def test_routing_counts_are_summed_on_the_device():
    """``expert_counts`` is ``bincount`` without its host read, an unused
    expert included; the aux loss reads it."""
    rng = np.random.RandomState(5)
    idx = torch.from_numpy(rng.randint(0, 5, (40, 3)))
    want = torch.bincount(idx.reshape(-1), minlength=6)
    assert torch.equal(moe.expert_counts(idx, 6), want)
    with scan.HostReads() as guard:
        moe.expert_counts(idx, 6)
    assert guard.seen == []


# ---------------------------------------------------------------------------
# MLA's attention backward at unequal head dims
# ---------------------------------------------------------------------------

def _jax_mla_core(q, k, v):
    """The chunked causal softmax of JAX's MLA train branch
    (``src/repro/models/mla.py``'s ``apply_mla``, train / prefill), fp32:
    q, k (B, S, H, dq), v (B, S, H, dv) -> (B, S, H, dv), the scale
    1 / sqrt(dq)."""
    b, s, h, dq = q.shape
    scale = 1.0 / np.sqrt(dq)
    n_chunks = max(1, s // Q_CHUNK)
    chunk = s // n_chunks
    qc = q.reshape(b, n_chunks, chunk, h, dq).swapaxes(0, 1)
    kv_pos = jnp.arange(s, dtype=jnp.int32)

    def one_chunk(args):
        ci, qx = args
        q_pos = ci * chunk + jnp.arange(chunk, dtype=jnp.int32)
        logits = jnp.einsum("bqhd,bshd->bhqs", qx, k,
                            preferred_element_type=jnp.float32) * scale
        mask = kv_pos[None, :] <= q_pos[:, None]
        logits = jnp.where(mask[None, None], logits, -jnp.inf)
        w = jax.nn.softmax(logits, axis=-1).astype(v.dtype)
        return jnp.einsum("bhqs,bshd->bqhd", w, v)

    out = jax.lax.map(one_chunk, (jnp.arange(n_chunks), qc))
    return out.swapaxes(0, 1).reshape(b, s, h, v.shape[-1])


@jax.jit
def _jax_core_vjp(q, k, v, g):
    out, vjp = jax.vjp(_jax_mla_core, q, k, v)
    return (out, *vjp(g))


# (q/k head dim, v head dim, heads, S): the smoke MLA's pair at one and two
# of JAX's q-chunks, DeepSeek-V2's at a short sequence
MLA_CASES = [(48, 32, 4, 64), (48, 32, 4, 512), (192, 128, 2, 128)]


@pytest.mark.parametrize("dq,dv,h,s", MLA_CASES,
                         ids=[f"{a}-{b}-S{s}" for a, b, _, s in MLA_CASES])
def test_plain_flash_backward_at_unequal_head_dims_matches_jax(dq, dv, h, s):
    rng = np.random.RandomState(dq + s)
    q, k = (rng.randn(2, s, h, dq).astype(np.float32) for _ in range(2))
    v, g = (rng.randn(2, s, h, dv).astype(np.float32) for _ in range(2))
    want = [np.asarray(t) for t in _jax_core_vjp(q, k, v, g)]
    view = lambda a: torch.from_numpy(a).transpose(1, 2)
    tq, tk, tv, tg = map(view, (q, k, v, g))
    o = ref.flash_attention_ref(tq, tk, tv)
    lse = ref.flash_attention_lse_ref(tq, tk)
    plain = ref.flash_attention_bwd_ref(tq, tk, tv, o, lse, tg)
    lq, lk, lv = (t.clone().requires_grad_(True) for t in (tq, tk, tv))
    out = kernels.flash_attention(lq, lk, lv, causal=True)
    auto = torch.autograd.grad(out, (lq, lk, lv), tg)
    back = lambda t: t.transpose(1, 2).detach().numpy()
    np.testing.assert_allclose(back(o), want[0], **TOL)
    for name, p, a, w in zip(("dq", "dk", "dv"), plain, auto, want[1:]):
        assert p.shape == a.shape and p.shape[-1] == w.shape[-1], name
        np.testing.assert_allclose(back(p), w, err_msg=f"plain {name}",
                                   **TOL)
        np.testing.assert_allclose(back(a), w, err_msg=f"autograd {name}",
                                   **TOL)


@pytest.mark.parametrize("s", [64, 512])
def test_apply_mla_train_branch_gradient_matches_jax(s):
    """The smoke DeepSeek-V2's MLA layer (fp32) in train mode: the output
    and the gradients of every weight and of x, for one output cotangent,
    against ``jax.vjp`` of JAX's ``apply_mla``."""
    from repro.configs import smoke_config as jax_smoke_config
    from repro_torch.configs import smoke_config
    jcfg = replace(jax_smoke_config("deepseek-v2-236b"), dtype="float32")
    tcfg = replace(smoke_config("deepseek-v2-236b"), dtype="float32")
    jparams = dense._realize(jax.eval_shape(
        jax_build_model(jcfg).init, jax.random.PRNGKey(0)),
        np.random.RandomState(9))
    jp = jax.tree.map(lambda a: a[0], jparams["top"]["stack"]["attn"])
    tp = lm_params_from_numpy(jparams)["top"]["stack"][0]["attn"]
    rng = np.random.RandomState(10)
    x = rng.randn(2, s, jcfg.d_model).astype(np.float32)
    g = rng.randn(2, s, jcfg.d_model).astype(np.float32)
    pos = np.broadcast_to(np.arange(s), (2, s))

    def fn(p, x_):
        return jmla.apply_mla(p, jcfg, x_, positions=jnp.asarray(pos),
                              mode="train")[0]
    out, vjp = jax.vjp(fn, jp, jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(g))

    flat = {jax.tree_util.keystr(path): t for path, t in
            jax.tree_util.tree_flatten_with_path(tp)[0]}
    live = {k: t.clone().requires_grad_(True) for k, t in flat.items()}
    treedef = jax.tree_util.tree_structure(tp)
    tp_live = jax.tree_util.tree_unflatten(treedef, list(live.values()))
    tx = torch.from_numpy(x).requires_grad_(True)
    y, _ = mla.apply_mla(tp_live, tcfg, tx,
                         positions=torch.from_numpy(pos.copy()),
                         mode="train")
    grads = torch.autograd.grad(y, [tx, *live.values()],
                                torch.from_numpy(g))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(out), **TOL)
    _assert_grad_close(grads[0].numpy(), np.asarray(gx), "x")
    want = {jax.tree_util.keystr(path): np.asarray(a) for path, a in
            jax.tree_util.tree_flatten_with_path(gp)[0]}
    assert set(want) == set(live)
    for (k, _), gr in zip(live.items(), grads[1:]):
        _assert_grad_close(gr.numpy(), want[k], k)


# ---------------------------------------------------------------------------
# the backward's head dims, as the .cu builds them
# ---------------------------------------------------------------------------

def test_backward_head_dims_match_the_kernel_source():
    """The backward .cu's switch instantiates exactly the wrapper's
    ``HEAD_DIMS`` and ``HEAD_DIM_PAIRS``, as the forward's does."""
    src = (Path(fa.__file__).parents[1] / "csrc" / "flash_attention_bwd.cu"
           ).read_text()
    body = src[src.index("int run(bool bf16"):src.index(
        'extern "C" int flash_attention_bwd(')]
    cases = tuple(int(c) for c in re.findall(
        r"case (\d+): fn = pick<\1>\(bf16\)", body))
    assert cases == fa.HEAD_DIMS
    pairs = tuple((int(a), int(b)) for a, b in re.findall(
        r"fn = pick<(\d+), (\d+)>\(bf16\)", body))
    assert pairs == fa.HEAD_DIM_PAIRS
    for d, dv in pairs:
        assert f"hd != {d} || hd_v != {dv}" in body
    # the C entry points take v's head dim after q's
    assert src.count("int Skv, int hd, int hd_v,") == 2
