"""The PyTorch port's LM training step against the JAX package's, on the CPU.

``repro_torch.launch.steps.make_train_step`` (and ``make_train_phase``)
against ``repro.launch.steps.make_train_step(plan, DistContext(), lr,
wire=...)`` with no mesh (and ``make_scanned_train_phase``): the same JAX
train state, converted by ``convert.lm_train_state_from_numpy``, and the same
numpy token batch go through both, and every metric and every leaf of the
new state is compared: the client bottoms, the top, the projection head,
the teacher bottoms (EMA), the teacher top and head (unchanged), and the
queue's z, label, conf, valid and ptr.

Configs: the smoke variants of ``h2o-danube-1.8b`` (with ``head_dim=80``
and ``sliding_window=16`` set on both sides, so that the window bites at S
64; the smoke config keeps 4096), ``stablelm-1.6b`` (LayerNorm, rotary on a
quarter of the head dim) and ``qwen2.5-14b`` (QKV bias), in fp32: 2 clients
x 2 sequences x 64 tokens.  The weights are numpy draws in the shapes of the
JAX ``input_specs`` (biases nonzero, so the QKV bias is live), each client
and each teacher its own; the queue is warmed by one JAX step from the same
state, so that Eq. (5) has positives.  tau is 0, as the JAX smoke test
sets it, so that every pseudo-label is confident and every gradient flows;
the default tau (0.95) reads the masked case, where no token of the random
teacher clears it.  Wires: none and ``int8`` (features quantized up,
cotangents down, one scale per client).  The JAX program of each case is
built once per module.

Tolerance atol 1e-5 / rtol 1e-4 for one step (the sums run in other
orders), 1e-4 for two steps through the phase; the queue's labels, flags and
pointer exactly.  Also: the train state round-trips through the converters
bit for bit, in fp32 and bf16; the dense configs' fields equal JAX's; and
one prefill + 4 decode steps of stablelm-1.6b and qwen2.5-14b (and danube)
against the JAX serving steps: logits within 8e-6, tokens equal."""
from dataclasses import fields, replace
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import INPUT_SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.core.queue import init_queue as jax_init_queue
from repro.core.split import init_projection_head as jax_init_proj
from repro.launch import steps as jsteps
from repro.models import DistContext
from repro.models import build_model as jax_build_model
from repro_torch.configs import INPUT_SHAPES, get_config, smoke_config
from repro_torch.convert import (lm_params_from_numpy,
                                 lm_train_state_from_numpy,
                                 lm_train_state_to_numpy)
from repro_torch.core.split import feature_dim, feature_shape, proj_dim
from repro_torch.launch import steps
from _torch_threads import one_torch_thread  # noqa: F401

N_CLIENTS, PER_CLIENT, SEQ = 2, 2, 64
TOL = dict(atol=1e-5, rtol=1e-4)
PHASE_TOL = dict(atol=1e-4, rtol=1e-4)
DANUBE = dict(head_dim=80, sliding_window=16)
# (arch, config overrides, wire, tau)
CASES = [("h2o-danube-1.8b", DANUBE, None, 0.0),
         ("h2o-danube-1.8b", DANUBE, "int8", 0.0),
         ("h2o-danube-1.8b", DANUBE, None, None),
         ("stablelm-1.6b", {}, None, 0.0),
         ("qwen2.5-14b", {}, None, 0.0)]
DENSE = ("h2o-danube-1.8b", "stablelm-1.6b", "qwen2.5-14b")


def _cfgs(arch: str, over: dict, tau, dtype: str = "float32"):
    out = []
    for cfg in (jax_smoke_config(arch), smoke_config(arch)):
        cfg = replace(cfg, dtype=dtype, **over)
        if tau is not None:
            cfg = replace(cfg, semisfl=replace(cfg.semisfl,
                                               confidence_threshold=tau))
        out.append(cfg)
    return out


def _plans(jcfg, tcfg):
    shape = lambda shapes: replace(shapes["train_4k"], seq_len=SEQ,
                                   global_batch=N_CLIENTS * PER_CLIENT)
    return (jsteps.make_plan(jcfg, shape(JAX_SHAPES), n_clients=N_CLIENTS),
            tcfg and steps.make_plan(tcfg, shape(INPUT_SHAPES),
                                     n_clients=N_CLIENTS))


@functools.cache
def _jax_step(jcfg, wire):
    plan = _plans(jcfg, None)[0]
    return jax.jit(jsteps.make_train_step(plan, DistContext(), wire=wire))


def _realize(specs, rng):
    """Numpy draws for a tree of ShapeDtypeStructs of model weights: norm
    scales 1 + 0.02 N, biases 0.02 N (so the zero-initialised ones are
    live), the embedding 0.02 N, matrices N / sqrt(d_in)."""
    def one(path, leaf):
        name = path[-1].key
        x = rng.randn(*leaf.shape)
        if name in ("scale", "q_norm", "k_norm"):
            x = 1.0 + 0.02 * x
        elif name == "embed" or len(leaf.shape) < 2 or name.startswith("b"):
            x = 0.02 * x
        else:
            x = x / np.sqrt(leaf.shape[-2])
        return x.astype(leaf.dtype)
    return jax.tree_util.tree_map_with_path(one, specs)


def _jax_state(jcfg, wire, batch, seed=0):
    """A JAX train state of numpy arrays drawn with the shapes of the JAX
    ``input_specs`` (each client and each teacher its own weights), the
    JAX projection heads, and a queue warmed by one JAX step from it on
    ``batch`` (whose sequence pseudo-labels the compared step then finds
    there)."""
    rng = np.random.RandomState(seed)
    specs = jsteps.input_specs(_plans(jcfg, None)[0])["state"]
    state = {k: _realize(specs[k], rng) for k in
             ("client_bottoms", "teacher_bottoms", "top", "t_top")}
    proj = lambda k: jax.device_get(jax_init_proj(jax.random.PRNGKey(k),
                                                  jcfg))
    state.update(proj=proj(30), t_proj=proj(31))
    q = jax_init_queue(jcfg.semisfl.queue_len, jsteps._proj_dim(jcfg))
    state["queue"] = jax.device_get(q._replace(ptr=jnp.int32(5)))
    warm, _ = _jax_step(jcfg, wire)(state, batch)
    state["queue"] = jax.device_get(warm["queue"])
    return state


def _batch(cfg, seed):
    rng = np.random.RandomState(seed)
    shape = (N_CLIENTS, PER_CLIENT, SEQ)
    return {k: rng.randint(0, cfg.vocab_size, shape).astype(np.int32)
            for k in ("tokens_weak", "tokens_strong")}


def _torch_batch(batch):
    return {k: torch.from_numpy(v.astype(np.int64)) for k, v in batch.items()}


def _to_port(state):
    return lm_train_state_from_numpy(state)


def _assert_state_close(got: dict, want: dict, tol: dict,
                        z_slack=None) -> None:
    """Every leaf of the port's state (as numpy, JAX layout) against the
    JAX state; each queue row's z with ``z_slack[row]`` added to the atol
    where given."""
    got = lm_train_state_to_numpy(got)
    wq, gq = want.pop("queue"), got.pop("queue")
    g_leaves = jax.tree_util.tree_leaves_with_path(got)
    w_leaves = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in g_leaves] == [p for p, _ in w_leaves]
    for (path, g), (_, w) in zip(g_leaves, w_leaves):
        assert g.shape == w.shape, path
        np.testing.assert_allclose(g, np.asarray(w, np.float32),
                                   err_msg=jax.tree_util.keystr(path), **tol)
    wz = np.asarray(wq.z)
    slack = np.zeros(len(wz)) if z_slack is None else z_slack
    over = np.abs(gq["z"] - wz) - (tol["atol"] + slack[:, None]
                                   + tol["rtol"] * np.abs(wz))
    assert over.max() <= 0.0, (
        f"queue.z rows {np.unique(np.nonzero(over > 0)[0])} past their "
        f"bound by up to {over.max():.3g}")
    for f in ("label", "conf", "valid"):
        np.testing.assert_array_equal(gq[f], np.asarray(getattr(wq, f)),
                                      err_msg=f"queue.{f}")
    assert gq["ptr"] == int(wq.ptr)


def _wire_flip_slack(jcfg, tcfg, state, batch, wire):
    """(Q,) how far each queue row's z may stray from JAX's because of
    int8 rounding flips: 0 for every row but the step's new ones, and for
    those a bound from the flips measured in their sequence.

    The port's wire-quantized teacher features are checked against JAX's:
    equal to about 1e-6, except where a feature lies that close to a
    rounding boundary of the int8 grid, and the sides round it to
    neighbouring codes (about 4 of the 65,536 here), one step amax / 127
    apart (at most 1e-3 of the elements).  A sequence with c flips of step
    h moves its pooled features by at most c h / S in L2; the projection
    head (linear maps and a ReLU) by at most ||W1||_2 ||W2||_2 times that;
    and the l2 normalization by at most 2 / |x| times the shift of the
    unnormalized projection x, with |x| JAX's own.  That sum is the row's
    slack; a row whose sequence has no flip keeps none."""
    from repro.core.wire import fake_quantize
    from repro_torch.kernels import quantize_dequantize
    from repro_torch.models.transformer import build_model
    jmodel, tmodel = jax_build_model(jcfg), build_model(tcfg)
    tokens = batch["tokens_weak"]
    jf = jax.vmap(lambda p, t: jmodel.bottom_apply(
        p, {"tokens": t}, mode="train")[0])(state["teacher_bottoms"], tokens)
    jq = np.asarray(jax.vmap(lambda t: fake_quantize(t, wire))(jf))
    port = _to_port(state)
    with torch.no_grad():
        tf = torch.stack([tmodel.bottom_apply(
            port["teacher_bottoms"][i],
            {"tokens": torch.from_numpy(tokens[i].astype(np.int64))},
            mode="train")[0] for i in range(len(tokens))])
        tq = quantize_dequantize(tf, wire, per_slice=True).numpy()
    step = np.abs(np.asarray(jf)).reshape(len(tokens), -1).max(1) / 127.0
    step = step.reshape(-1, 1, 1, 1)
    diff = np.abs(tq - jq)
    flip = diff > 1e-3
    np.testing.assert_allclose(diff[flip] / np.broadcast_to(step, diff.shape)
                               [flip], 1.0, rtol=1e-3)
    assert diff[~flip].max() < 1e-4
    assert flip.sum() <= 1e-3 * flip.size
    # per (client, sequence) row, in the queue's order
    shift = (flip.sum(axis=(2, 3)) * step.reshape(-1, 1) / SEQ).reshape(-1)
    w = [np.asarray(state["t_proj"][k], np.float64)
         for k in ("w1", "w2") if k in state["t_proj"]]
    lip = np.prod([np.linalg.norm(m, 2) for m in w])
    x = jq.reshape((-1,) + jq.shape[2:]).mean(axis=1).astype(np.float64)
    for i, m in enumerate(w):
        x = (np.maximum(x, 0.0) if i else x) @ m
    bound = 2.0 * lip * shift / np.linalg.norm(x, axis=-1)
    slack = np.zeros(len(state["queue"].z))
    slots = (int(state["queue"].ptr) + np.arange(len(bound))) % len(slack)
    slack[slots] = bound
    return slack


@pytest.mark.parametrize("arch,over,wire,tau", CASES,
                         ids=[f"{a}-{w}-tau{t}" for a, _, w, t in CASES])
def test_train_step_matches_jax(arch, over, wire, tau):
    jcfg, tcfg = _cfgs(arch, over, tau)
    batch = _batch(jcfg, 1)
    state = _jax_state(jcfg, wire, batch)
    jnew, jm = _jax_step(jcfg, wire)(state, batch)
    jnew = jax.device_get(jnew)
    tnew, tm = steps.make_train_step(_plans(jcfg, tcfg)[1], wire=wire)(
        _to_port(state), _torch_batch(batch))
    for k in ("loss", "consistency", "clustering", "mask_rate"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), err_msg=k,
                                   **TOL)
    if tau == 0.0:
        # the live case: everything confident, Eq. (5) has positives
        assert float(tm["mask_rate"]) == 0.0
        assert float(tm["clustering"]) > 0.0
    else:
        assert float(tm["mask_rate"]) == 1.0
    slack = (_wire_flip_slack(jcfg, tcfg, state, batch, wire)
             if wire else None)
    _assert_state_close(tnew, jnew, TOL, slack)
    # the teacher top and head do not move in a step
    for key in ("t_top", "t_proj"):
        for a, b in zip(jax.tree_util.tree_leaves(
                lm_train_state_to_numpy(tnew)[key]),
                jax.tree_util.tree_leaves(state[key])):
            np.testing.assert_array_equal(a, b)


def test_two_steps_of_the_phase_match_the_scanned_jax_phase():
    """No wire: a rounding flip of the int8 wire in step 1 (see
    :func:`_wire_flip_slack`) would move step 2's clustering
    term by about 1e-3."""
    jcfg, tcfg = _cfgs("h2o-danube-1.8b", DANUBE, 0.0)
    b0, b1 = _batch(jcfg, 3), _batch(jcfg, 4)
    state = _jax_state(jcfg, None, b0, seed=2)
    batches = {k: np.stack([b0[k], b1[k]]) for k in b0}
    jplan, tplan = _plans(jcfg, tcfg)
    jphase = jsteps.make_scanned_train_phase(jplan, DistContext(),
                                             donate_carry=False)
    jnew, jm = jax.device_get(jphase(state, batches))
    tnew, tm = steps.make_train_phase(tplan)(
        _to_port(state), _torch_batch(batches))
    for k in jm:
        assert tm[k].shape == (2,)
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                   err_msg=k, **PHASE_TOL)
    _assert_state_close(tnew, jnew, PHASE_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_state_round_trips_bit_for_bit(dtype):
    jcfg, _ = _cfgs("h2o-danube-1.8b", DANUBE, 0.0, dtype)
    rng = np.random.RandomState(6)
    model = jax_build_model(jcfg)
    params = _realize(jax.eval_shape(model.init, jax.random.PRNGKey(0)), rng)
    stack = lambda t: jax.tree.map(lambda a: np.stack([a, -a]), t)
    q = jax.device_get(jax_init_queue(16, 8))
    q = q._replace(z=rng.randn(16, 8).astype(np.float32),
                   label=rng.randint(0, 9, 16).astype(np.int32),
                   conf=rng.rand(16) > 0.5, valid=rng.rand(16) > 0.3,
                   ptr=np.int32(7))
    proj = jax.device_get(jax_init_proj(jax.random.PRNGKey(1), jcfg))
    state = {"client_bottoms": stack(params["bottom"]),
             "teacher_bottoms": stack(params["bottom"]),
             "top": params["top"], "t_top": params["top"], "proj": proj,
             "t_proj": proj, "queue": q}
    port = lm_train_state_from_numpy(state)
    assert port["client_bottoms"][1]["embed"].dtype == getattr(torch, dtype)
    back = lm_train_state_to_numpy(port)
    want = dict(state, queue=q._asdict())
    want["queue"]["ptr"] = int(q.ptr)
    g_leaves = jax.tree_util.tree_leaves_with_path(back)
    w_leaves = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in g_leaves] == [p for p, _ in w_leaves]
    for (path, g), (_, w) in zip(g_leaves, w_leaves):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype or g.shape == (), path
        assert g.tobytes() == w.astype(g.dtype).tobytes(), \
            jax.tree_util.keystr(path)
    # and the port's tree again from the numpy it gave
    again = lm_train_state_from_numpy(dict(back, queue=tuple(
        back["queue"].values())))
    for a, b in zip(jax.tree_util.tree_leaves(again),
                    jax.tree_util.tree_leaves(port)):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b


def test_the_state_shapes_are_the_jax_input_specs():
    jcfg, tcfg = _cfgs("h2o-danube-1.8b", DANUBE, 0.0, "bfloat16")
    jplan, tplan = _plans(jcfg, tcfg)
    want = jsteps.input_specs(jplan)
    got = steps.train_state_shapes(tplan)
    n = tplan.n_clients
    for key in ("client_bottoms", "teacher_bottoms"):
        assert len(got["state"][key]) == n
    state = lm_train_state_to_numpy(steps.init_train_state(tplan, 0, "cpu"))
    for key in ("client_bottoms", "teacher_bottoms", "top", "t_top", "proj",
                "t_proj"):
        g = jax.tree.map(lambda a: (a.shape, a.dtype.name), state[key])
        w = jax.tree.map(lambda a: (a.shape, a.dtype.name),
                         want["state"][key])
        assert g == w, key
    for f in ("z", "label", "conf", "valid"):
        assert got["state"]["queue"]._asdict()[f][0] == \
            getattr(want["state"]["queue"], f).shape
    for k, spec in want["batch"].items():
        assert got["batch"][k][0] == spec.shape


@pytest.mark.parametrize("arch", DENSE)
def test_split_shapes_match_jax(arch):
    from repro.core import split as jsplit
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    assert feature_dim(tcfg) == jsplit.feature_dim(jcfg) == tcfg.d_model
    assert feature_shape(tcfg, 4, 4096) == jsplit.feature_shape(jcfg, 4,
                                                                4096)
    assert proj_dim(tcfg) == jsteps._proj_dim(jcfg)
    with pytest.raises(ValueError, match="seq_len"):
        feature_shape(tcfg, 4)


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("which", ["full", "smoke"])
def test_dense_config_fields_match_jax(arch, which):
    get = {"full": (jax_get_config, get_config),
           "smoke": (jax_smoke_config, smoke_config)}[which]
    jcfg, tcfg = get[0](arch), get[1](arch)
    for f in fields(tcfg):
        if f.name != "semisfl":
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    assert tcfg.split_layer == jcfg.split_layer
    assert tcfg.resolved_head_dim == jcfg.resolved_head_dim


@pytest.mark.parametrize("arch", DENSE)
def test_dense_config_serves_as_the_jax_steps(arch):
    """One prefill of 40 tokens (longer than danube's window of 16 here)
    and 4 greedy decode steps of each dense config's smoke variant, fp32,
    against the JAX steps from the same perturbed weights: logits within
    8e-6, tokens equal."""
    jcfg, tcfg = _cfgs(arch, DANUBE if arch == "h2o-danube-1.8b" else {},
                       None)
    prompt_len, batch = 40, 2
    plan = jsteps.StepPlan(cfg=jcfg, shape=JAX_SHAPES["decode_32k"],
                           kind="decode", n_clients=1,
                           per_client_batch=batch, long_context=False)
    model = jax_build_model(jcfg)
    params = _realize(jax.eval_shape(model.init, jax.random.PRNGKey(0)),
                      np.random.RandomState(7))
    prompt = np.random.RandomState(8).randint(0, jcfg.vocab_size,
                                              (batch, prompt_len))
    from repro_torch.convert import lm_cache_from_numpy
    jcache = model.init_cache(batch, prompt_len + 5)
    tcache = lm_cache_from_numpy(jax.device_get(jcache))
    tparams = lm_params_from_numpy(params)
    jlogits, jcache = jsteps.make_prefill_step(plan, DistContext())(
        params, {"tokens": jnp.asarray(prompt, jnp.int32)}, jcache)
    tlogits, tcache = steps.make_prefill_step(tcfg)(
        tparams, {"tokens": torch.from_numpy(prompt)}, tcache)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               atol=8e-6, rtol=0)
    jdecode = jax.jit(jsteps.make_decode_step(plan, DistContext()))
    tdecode = steps.make_decode_step(tcfg)
    jtok = jnp.argmax(jlogits, -1).astype(jnp.int32)
    ttok = tlogits.argmax(-1)
    for i in range(4):
        pos = prompt_len + i
        jtok, jcache = jdecode(params, {"tokens": jtok[:, None],
                                        "pos": jnp.full((batch,), pos,
                                                        jnp.int32)}, jcache)
        ttok, tcache = tdecode(tparams, {"tokens": ttok[:, None],
                                         "pos": torch.full((batch,), pos)},
                               tcache)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
