"""The port's vision decoder (Qwen2-VL: M-RoPE, patch embeddings ahead of
the text) against the JAX package, on the CPU at smoke size.

The smoke ``qwen2-vl-7b`` (2 layers split 1 + 1, d_model 256, 4 query heads
over 4 KV heads of 64, QKV bias, M-RoPE sections (16, 8, 8), 8 patch
embeddings), its weights the JAX init's (or numpy draws in the JAX
``input_specs`` shapes, biases live), converted by ``convert``:

  * ``apply_mrope`` against JAX's, with position planes that differ and
    with equal planes, where both equal ``apply_rope``;
  * one prefill (the patch embeddings ahead of 32, 300 or 512 text tokens)
    and 4 greedy decode steps against the JAX steps, fp32 and bf16, with
    M-RoPE positions whose planes differ: one image grid of 2 x 4 patches
    (temporal 0, height the patch's row, width its column), then the text
    counting on from the grid's largest position + 1 on all three planes,
    the decode steps going on from there (a decode step's cache slot is
    its width-plane position, JAX's ``positions[-1]``, so these steps
    write over prompt slots in both packages);
  * one train step against JAX's ``make_train_step`` (2 clients x 2
    sequences x 64 positions: 8 patch embeddings + 56 tokens), no wire and
    ``int8`` (JAX's wire roundings replayed into the port, as the Zamba2
    and xLSTM tests do), at tau 0 and 0.95: every metric and state leaf;
  * two steps of ``make_scanned_train_phase`` against JAX's scanned phase
    and the port's eager loop (``make_train_phase``, bit for bit on the
    CPU, where the scanned phase is that loop); the host-read guard over
    one bf16 step;
  * the converters' round trips (train state, serving cache), the batch's
    and state's shapes against JAX's ``input_specs``;
  * ``serve_config`` against JAX's ``serve`` driver (fp32), and the
    driver's fault that both keep: its decode positions start at
    ``prompt_len``, not ``prompt_len`` + 8, so the first decode steps
    take the positions and cache slots of the last prompt tokens.

Tolerances are the dense tests': serving logits and caches 1e-4 in fp32
and 0.1 in bf16 (``test_torch_lm.py``'s module note: the two sides round
to bf16 in other places), greedy tokens equal in fp32 (bf16 decode steps
are fed JAX's tokens); a train step at TOL (atol 1e-5, rtol 1e-4), a
phase at PHASE_TOL (1e-4)."""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_lm as serving
import test_torch_lm_scan as scan
import test_torch_lm_train as dense
import test_torch_xlstm_train as xlt
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.core.queue import init_queue as jax_init_queue
from repro.core.split import init_projection_head as jax_init_proj
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.models import DistContext
from repro.models import build_model as jax_build_model
from repro.models import rope as jrope
from repro_torch.configs import get_config, smoke_config
from repro_torch.convert import (lm_cache_from_numpy, lm_cache_to_numpy,
                                 lm_params_from_numpy,
                                 lm_train_state_from_numpy,
                                 lm_train_state_to_numpy)
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps
from repro_torch.models import rope
from repro_torch.tree import tree_leaves
from test_torch_lm_train import PHASE_TOL, TOL, _assert_state_close
from _torch_threads import one_torch_thread  # noqa: F401

ARCH = "qwen2-vl-7b"
BATCH, N_DECODE = 2, 4
GRID = (2, 4)           # the smoke image's patches, rows x columns
STEP_CASES = [(w, t) for w in (None, "int8") for t in (0.0, 0.95)]


def _cfgs(dtype: str = "float32", tau=None):
    out = []
    for cfg in (jax_smoke_config(ARCH), smoke_config(ARCH)):
        cfg = replace(cfg, dtype=dtype)
        if tau is not None:
            cfg = replace(cfg, semisfl=replace(cfg.semisfl,
                                               confidence_threshold=tau))
        out.append(cfg)
    return out


def mrope_positions(batch: int, s_text: int, grid=GRID) -> np.ndarray:
    """(3, B, P + S) M-RoPE positions of one image of ``grid`` patches
    ahead of ``s_text`` text tokens: the patches at (0, row, column), the
    text at the grid's largest position + 1 on, equal on all planes."""
    rows, cols = grid
    r, c = np.divmod(np.arange(rows * cols), cols)
    img = np.stack([np.zeros_like(r), r, c])
    start = img.max() + 1
    text = np.broadcast_to(np.arange(start, start + s_text), (3, s_text))
    pos = np.concatenate([img, text], axis=1).astype(np.int32)
    return np.ascontiguousarray(np.broadcast_to(pos[:, None],
                                                (3, batch, pos.shape[1])))


def torch_batch(batch: dict) -> dict:
    """A numpy batch as tensors: ids as int64, floats as they are."""
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype.kind == "i"
                                else v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# M-RoPE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("planes", ["distinct", "equal"])
def test_apply_mrope_matches_jax(planes):
    """Distinct planes: the port against JAX at 1e-6.  Equal planes: both
    reduce to RoPE, so each equals its own package's ``apply_rope``."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 40, 3, 64).astype(np.float32)
    pos = mrope_positions(2, 32)
    if planes == "equal":
        pos = np.ascontiguousarray(np.broadcast_to(pos[-1], pos.shape))
    sections, theta = (16, 8, 8), 1e6
    want = np.asarray(jrope.apply_mrope(jnp.asarray(x), jnp.asarray(pos),
                                        theta, sections))
    got = rope.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos),
                           theta, sections).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    if planes == "equal":
        r = rope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos[0]),
                            theta).numpy()
        np.testing.assert_array_equal(got, r)
        jr = np.asarray(jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos[0]),
                                         theta))
        np.testing.assert_allclose(want, jr, atol=1e-6, rtol=0)
    else:
        # each section follows its own plane: against RoPE at the width
        # plane's positions, the temporal section (the fastest slots,
        # where the patches' positions are 0, not their columns) differs
        r = rope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos[2]),
                            theta).numpy()
        assert np.abs(got - r).max() > 0.1
    d = rope.default_mrope_positions(2, 5, 3).numpy()
    np.testing.assert_array_equal(d, np.asarray(
        jrope.default_mrope_positions(2, 5, 3)))


def test_apply_mrope_refuses_sections_that_miss_the_head_dim():
    with pytest.raises(ValueError, match="do not sum"):
        rope.apply_mrope(torch.zeros(1, 2, 1, 64), torch.zeros(
            3, 1, 2, dtype=torch.long), 1e4, (16, 8, 4))


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _prefill_batch(cfg, prompt_len: int, seed: int = 0) -> dict:
    rng = np.random.RandomState(seed)
    p = cfg.frontend_tokens
    return {"tokens": rng.randint(0, cfg.vocab_size,
                                  (BATCH, prompt_len)).astype(np.int32),
            "patch_embeds": rng.randn(BATCH, p, cfg.d_model).astype(
                np.float32),
            "mrope_positions": mrope_positions(BATCH, prompt_len)}


@pytest.mark.parametrize("prompt_len", [32, 300, 512])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(dtype, prompt_len):
    jcfg, tcfg = _cfgs(dtype)
    tol = serving.TOLS[dtype]
    jprefill, jdecode = serving._jax_steps(jcfg)
    model = jax_build_model(jcfg)
    jparams = model.init(jax.random.PRNGKey(0))
    s = jcfg.frontend_tokens + prompt_len
    jcache = model.init_cache(BATCH, s + N_DECODE + 1)
    tparams = lm_params_from_numpy(jax.device_get(jparams))
    tcache = lm_cache_from_numpy(jax.device_get(jcache))
    batch = _prefill_batch(jcfg, prompt_len)
    jlogits, jcache = jprefill(jparams, jax.tree.map(jnp.asarray, batch),
                               jcache)
    tlogits, tcache = steps.make_prefill_step(tcfg)(
        tparams, torch_batch(batch), tcache)
    np.testing.assert_allclose(tlogits.float().numpy(),
                               serving._f32(jlogits), atol=tol, rtol=0)
    serving._assert_cache_close(jax.device_get(jcache), tcache, tol)

    tdecode = steps.make_decode_step(tcfg)
    jtok = jnp.argmax(jlogits, -1).astype(jnp.int32)
    ttok = tlogits.argmax(-1)
    jtoks, ttoks = [np.asarray(jtok)], [ttok.numpy()]
    p0 = int(batch["mrope_positions"].max()) + 1
    for i in range(N_DECODE):
        pos = np.full((BATCH,), p0 + i, np.int32)
        p3 = np.full((3, BATCH, 1), p0 + i, np.int32)
        if dtype == "bfloat16":      # teacher-forced, as test_torch_lm
            ttok = torch.from_numpy(np.asarray(jtok, np.int64))
        jtok, jcache = jdecode(jparams, {"tokens": jtok[:, None],
                                         "pos": jnp.asarray(pos),
                                         "mrope_positions": jnp.asarray(p3)},
                               jcache)
        ttok, tcache = tdecode(tparams, torch_batch(
            {"tokens": ttok[:, None].numpy(), "pos": pos,
             "mrope_positions": p3}), tcache)
        jtoks.append(np.asarray(jtok))
        ttoks.append(ttok.numpy())
    serving._assert_cache_close(jax.device_get(jcache), tcache, tol)
    if dtype == "float32":
        np.testing.assert_array_equal(np.stack(ttoks), np.stack(jtoks))


def _jax_serve(jcfg, monkeypatch, gen: int, seen: list):
    """JAX's ``serve`` driver on ``jcfg`` (its smoke config swapped for
    it), each decode step's batch recorded in ``seen`` as the driver hands
    it to the jitted step."""
    import types
    monkeypatch.setattr(jserve, "smoke_config", lambda arch: jcfg)
    decode = jserve.make_decode_step(
        jsteps.StepPlan(cfg=jcfg, shape=jserve.INPUT_SHAPES["decode_32k"],
                        kind="decode", n_clients=1, per_client_batch=BATCH,
                        long_context=False), DistContext())

    def jit(fn):
        jitted = jax.jit(fn)
        if fn.__code__ is not decode.__code__:
            return jitted

        def recording(params, batch, cache):
            seen.append(jax.tree.map(np.asarray, batch))
            return jitted(params, batch, cache)
        return recording
    monkeypatch.setattr(jserve, "jax", types.SimpleNamespace(
        jit=jit, random=jax.random))
    return jserve.serve(ARCH, BATCH, 32, gen, log=lambda _: None)


def _port_serve(tcfg, params, monkeypatch, gen: int, seen: list):
    """The port's ``serve_config`` on the CPU, the prefill's and each
    decode step's cache recorded in ``seen`` (as numpy, with the decode
    step's batch)."""
    real_prefill, real_decode = (tserve.make_prefill_step,
                                 tserve.make_decode_step)

    def recording(real):
        def make(cfg):
            step = real(cfg)

            def wrapped(params, batch, cache):
                out = step(params, batch, cache)
                seen.append({k: v.numpy().copy() for k, v in batch.items()
                             if k in ("pos", "mrope_positions")})
                seen[-1]["cache"] = lm_cache_to_numpy(out[1])
                return out
            return wrapped
        return make
    monkeypatch.setattr(tserve, "make_prefill_step", recording(real_prefill))
    monkeypatch.setattr(tserve, "make_decode_step", recording(real_decode))
    return serve_config_cpu(tcfg, params, gen)


def serve_config_cpu(tcfg, params, gen: int, prompt_len: int = 32):
    return tserve.serve_config(tcfg, BATCH, prompt_len, gen, seed=0,
                               params=params, device="cpu",
                               log=lambda _: None)


def test_serve_config_matches_the_jax_serve_driver(monkeypatch):
    """The JAX driver's own inputs (seeded prompt, patch embeddings,
    text-only M-RoPE positions) and decode positions, from the JAX init's
    weights, fp32: the same greedy tokens."""
    jcfg, tcfg = _cfgs()
    gen = N_DECODE + 2
    want = _jax_serve(jcfg, monkeypatch, gen, [])
    params = lm_params_from_numpy(jax.device_get(
        jax_build_model(jcfg).init(jax.random.PRNGKey(0))))
    got = serve_config_cpu(tcfg, params, gen)
    np.testing.assert_array_equal(got.tokens, want)


def test_the_vision_driver_restarts_decode_at_prompt_len_in_both(
        monkeypatch):
    """The reference's fault, kept: the prefill holds 8 patch embeddings
    and 32 text tokens (positions and cache slots 0-39), yet both drivers
    decode from position 32 on all three planes, so decode step i writes
    its K/V into slot 32 + i, over the prompt's own, and slot 40 stays
    empty until the ninth step.  Both drivers hand their steps the same
    positions and generate the same tokens."""
    jcfg, tcfg = _cfgs()
    gen, prompt_len, p = 10, 32, jcfg.frontend_tokens
    jseen, tseen = [], []
    want = _jax_serve(jcfg, monkeypatch, gen, jseen)
    params = lm_params_from_numpy(jax.device_get(
        jax_build_model(jcfg).init(jax.random.PRNGKey(0))))
    got = _port_serve(tcfg, params, monkeypatch, gen, tseen)
    np.testing.assert_array_equal(got.tokens, want)
    prefill, decode = tseen[0], tseen[1:]
    assert len(jseen) == len(decode) == gen - 1
    for i, (j, t) in enumerate(zip(jseen, decode)):
        assert (j["pos"] == prompt_len + i).all()
        assert (j["mrope_positions"] == prompt_len + i).all()
        np.testing.assert_array_equal(t["pos"], j["pos"])
        np.testing.assert_array_equal(t["mrope_positions"],
                                      j["mrope_positions"])
    # (k, v, pos) of the top's one layer: the prompt's positions in slots
    # 0-39, -1 past them
    k0, _, pos0 = (a[0] for a in prefill["cache"]["top"])
    np.testing.assert_array_equal(pos0[:, :p + prompt_len], np.broadcast_to(
        np.arange(p + prompt_len), (BATCH, p + prompt_len)))
    assert (pos0[:, p + prompt_len:] == -1).all()
    k1, _, pos1 = (a[0] for a in decode[0]["cache"]["top"])
    np.testing.assert_array_equal(pos1, pos0)
    assert np.abs(k1[:, prompt_len] - k0[:, prompt_len]).max() > 1e-3
    np.testing.assert_array_equal(np.delete(k1, prompt_len, axis=1),
                                  np.delete(k0, prompt_len, axis=1))
    pos7 = decode[7]["cache"]["top"][2][0]
    assert (pos7[:, p + prompt_len:] == -1).all()
    assert (decode[8]["cache"]["top"][2][0][:, p + prompt_len] ==
            p + prompt_len).all()


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def batch(cfg, seed: int) -> dict:
    """A train batch of numpy draws in ``steps.train_batch_shapes``'
    shapes: tokens of both views, patch embeddings and distinct-plane
    M-RoPE positions (each client's)."""
    rng = np.random.RandomState(seed)
    n, b, s = dense.N_CLIENTS, dense.PER_CLIENT, dense.SEQ
    p = min(cfg.frontend_tokens, s // 4)
    out = {k: rng.randint(0, cfg.vocab_size, (n, b, s - p)).astype(np.int32)
           for k in ("tokens_weak", "tokens_strong")}
    out["patch_embeds"] = rng.randn(n, b, p, cfg.d_model).astype(np.float32)
    pos = mrope_positions(b, s - p)
    out["mrope_positions"] = np.ascontiguousarray(
        np.broadcast_to(pos, (n,) + pos.shape))
    return out


def _flatten_extras(jcfg, extras: dict, batch: dict) -> dict:
    """JAX's ``flatten_extras`` of ``make_train_step``."""
    pos = extras["positions"]
    if jcfg.rope_kind == "mrope":
        pos = pos.swapaxes(0, 1).reshape(3, -1, pos.shape[-1])
    else:
        pos = pos.reshape(-1, pos.shape[-1])
    out = {"positions": pos, "aux_loss": extras["aux_loss"].sum()}
    if jcfg.is_encoder_decoder:
        out["dec_tokens"] = batch["dec_tokens"].reshape(
            (-1,) + batch["dec_tokens"].shape[2:])
    return out


def jax_wire(jcfg, state, batch, wire) -> dict:
    """``test_torch_xlstm_train._jax_wire`` for any LM batch: what JAX's
    step sends over the wire (each client's features before and after the
    uplink's quantization, the cut's cotangent before and after the
    downlink's), replayed outside it with the bottoms' inputs and the
    top's extras as JAX's ``make_train_step`` forms them."""
    from repro.core import losses as jlosses
    from repro.core.split import apply_projection_head, pool_features
    from repro.core.wire import fake_quantize, quantize_dequantize
    from repro.kernels import clustering_loss as jclustering
    model, sc = jax_build_model(jcfg), jcfg.semisfl

    def bottoms(stack, which):
        inputs = jsteps._lm_batch_inputs(jcfg, batch, which)
        f, extras = jax.vmap(lambda p, i: model.bottom_apply(
            p, i, mode="train")[::2])(stack, inputs)
        return (f, jax.vmap(lambda x: fake_quantize(x, wire))(f),
                _flatten_extras(jcfg, extras, batch))

    def top(params, f, extras):
        return model.top_apply(params, f, extras=extras, mode="train")[0]

    flat = lambda f: f.reshape((-1,) + f.shape[2:])

    @jax.jit
    def replay(state):
        q = state["queue"]
        tf, tq, tex = bottoms(state["teacher_bottoms"], "weak")
        t_logits = top(state["t_top"], flat(tq), tex)["logits"]
        pseudo_tok, ok_tok, _ = jlosses.pseudo_labels(
            t_logits, sc.confidence_threshold)
        probs = jax.nn.softmax(t_logits.astype(jnp.float32), -1).mean(1)
        pseudo_seq = probs.argmax(-1)
        conf_seq = probs.max(-1) > sc.confidence_threshold * 0.5
        sf, sq, sex = bottoms(state["client_bottoms"], "strong")

        def loss(f):
            out = top(state["top"], flat(f), sex)
            nll, cnt = jlosses.cross_entropy_sum(out["logits"], pseudo_tok,
                                                 ok_tok)
            z = apply_projection_head(state["proj"], jcfg,
                                      pool_features(jcfg, flat(f)))
            c = jclustering(z, pseudo_seq, conf_seq, q.z, q.label, q.conf,
                            q.valid, sc.temperature)
            return nll / jnp.maximum(cnt, 1.0) + c + out["aux_loss"] * 1e-3

        g = jax.grad(loss)(sq)
        return {"teacher": (tf, tq), "student": (sf, sq),
                "cotangent": (g, jax.vmap(
                    lambda x: quantize_dequantize(x, wire))(g))}

    return jax.tree.map(np.array, replay(state))


def assert_single_code_flips(seen: dict, want: dict) -> None:
    """``test_torch_xlstm_train._assert_single_code_flips`` over the
    clients whose slice JAX sends nonzero; a client slice that JAX sends
    as all zeros (at tau 0.95 no token and no sequence is confident, so
    the cut's cotangent is zero) must be all zeros from the port too."""
    live = {}
    for name, (x_port, q_port) in seen.items():
        x_jax, q_jax = want[name]
        nz = np.abs(x_jax).reshape(len(x_jax), -1).max(1) > 0
        for t in (x_port, q_port):
            assert not t[torch.from_numpy(~nz)].any(), name
        if nz.any():
            live[name] = (x_port[torch.from_numpy(nz)],
                          q_port[torch.from_numpy(nz)])
            want = dict(want, **{name: (x_jax[nz], q_jax[nz])})
    xlt._assert_single_code_flips(live, want)


def check_train_step(jcfg, tcfg, make_batch, wire, tau, monkeypatch):
    """One step of each package from one converted JAX state: every
    metric and state leaf at TOL (the int8 case with JAX's wire roundings
    replayed into the port, the port's own held to them)."""
    b = make_batch(jcfg, 1)
    state = dense._jax_state(jcfg, wire, b)
    jnew, jm = dense._jax_step(jcfg, wire)(state, b)
    jnew = jax.device_get(jnew)
    if wire:
        want = jax_wire(jcfg, state, b, wire)
        seen = xlt._replay_wire(monkeypatch, want, wire)
    tnew, tm = steps.make_train_step(dense._plans(jcfg, tcfg)[1],
                                     wire=wire)(
        lm_train_state_from_numpy(state), torch_batch(b))
    if wire:
        assert_single_code_flips(seen, want)
    for k in ("loss", "consistency", "clustering", "mask_rate"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), err_msg=k,
                                   **TOL)
    if tau == 0.0:
        assert float(tm["mask_rate"]) == 0.0
        assert float(tm["clustering"]) > 0.0
    else:
        assert float(tm["mask_rate"]) == 1.0
    _assert_state_close(tnew, jnew, TOL)
    for key in ("t_top", "t_proj"):
        for a, b_ in zip(jax.tree_util.tree_leaves(
                lm_train_state_to_numpy(tnew)[key]),
                jax.tree_util.tree_leaves(state[key])):
            np.testing.assert_array_equal(a, b_)


def check_scanned_phase(jcfg, tcfg, make_batch):
    """Two steps: the port's scanned phase against JAX's scanned phase at
    PHASE_TOL, and bit for bit against the port's eager loop."""
    batches = [make_batch(jcfg, 3 + i) for i in range(2)]
    state = dense._jax_state(jcfg, None, batches[0], seed=2)
    stacked = scan._stack(batches)
    jplan, tplan = dense._plans(jcfg, tcfg)
    jphase = jsteps.make_scanned_train_phase(jplan, DistContext(),
                                             donate_carry=False)
    jnew, jm = jax.device_get(jphase(state, stacked))
    tnew, tm = steps.make_scanned_train_phase(tplan)(
        lm_train_state_from_numpy(state), torch_batch(stacked))
    enew, em = steps.make_train_phase(tplan)(
        lm_train_state_from_numpy(state), torch_batch(stacked))
    for a, b in zip(tree_leaves([tnew, tm]), tree_leaves([enew, em])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    scan._assert_metrics_close(tm, jm, 2)
    assert float(tm["clustering"][0]) > 0.0
    _assert_state_close(tnew, jnew, PHASE_TOL)


def check_no_host_read(tcfg, make_batch):
    """One smoke step (the config's bf16, int8 wire, tau 0) under the
    host-read guard of ``test_torch_lm_scan.py``."""
    cfg = replace(tcfg, semisfl=replace(tcfg.semisfl,
                                        confidence_threshold=0.0))
    plan = dense._plans(_cfgs()[0], cfg)[1]
    state = steps.init_train_state(plan, seed=0, device="cpu")
    b = torch_batch(make_batch(cfg, 0))
    b = {k: v.to(getattr(torch, cfg.dtype)) if v.is_floating_point() else v
         for k, v in b.items()}
    step = steps.make_train_step(plan, wire="int8")
    with scan.HostReads() as guard:
        _, metrics = step(state, b)
    assert guard.seen == [], guard.seen
    assert float(metrics["mask_rate"]) == 0.0


def jax_layout(tree):
    """A port tree of (shape, dtype) leaves in the JAX layout of (shape,
    dtype name): each list of layers (``stack``, ``prefix``,
    ``dec_stack``) or of clients stacked on a leading axis."""
    if isinstance(tree, list):
        leaves = [jax_layout(t) for t in tree]
        return jax.tree.map(lambda *ls: ((len(ls),) + ls[0][0], ls[0][1]),
                            *leaves, is_leaf=lambda x: isinstance(x, tuple))
    if isinstance(tree, dict):
        return {k: jax_layout(v) for k, v in tree.items()}
    shape, dtype = tree
    return tuple(shape), str(dtype).removeprefix("torch.")


def check_shapes(jcfg, tcfg):
    """The state's and the batch's shapes (``train_state_shapes``, nothing
    allocated) against JAX's ``input_specs``; the batch's dtypes JAX's
    with ids int64."""
    jplan, tplan = dense._plans(jcfg, tcfg)
    want = jsteps.input_specs(jplan)
    got = steps.train_state_shapes(tplan)
    for key in ("client_bottoms", "teacher_bottoms", "top", "t_top", "proj",
                "t_proj"):
        w = jax.tree.map(lambda a: (tuple(a.shape), a.dtype.name),
                         want["state"][key])
        assert jax_layout(got["state"][key]) == w, key
    assert set(got["batch"]) == set(want["batch"])
    for k, spec in want["batch"].items():
        shape, dtype = got["batch"][k]
        assert shape == spec.shape, k
        name = "int32" if dtype == torch.int64 else str(dtype)[6:]
        assert name == spec.dtype.name, k


def check_state_round_trip(jcfg):
    """The train state through the converters and back, bit for bit."""
    rng = np.random.RandomState(6)
    params = dense._realize(jax.eval_shape(jax_build_model(jcfg).init,
                                           jax.random.PRNGKey(0)), rng)
    stack = lambda t: jax.tree.map(lambda a: np.stack([a, -a]), t)
    q = jax.device_get(jax_init_queue(16, 8))._replace(
        z=rng.randn(16, 8).astype(np.float32), ptr=np.int32(7))
    proj = jax.device_get(jax_init_proj(jax.random.PRNGKey(1), jcfg))
    state = {"client_bottoms": stack(params["bottom"]),
             "teacher_bottoms": stack(params["bottom"]),
             "top": params["top"], "t_top": params["top"], "proj": proj,
             "t_proj": proj, "queue": q}
    back = lm_train_state_to_numpy(lm_train_state_from_numpy(state))
    want = dict(state, queue=dict(q._asdict(), ptr=int(q.ptr)))
    g_leaves = jax.tree_util.tree_leaves_with_path(back)
    w_leaves = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in g_leaves] == [p for p, _ in w_leaves]
    for (path, g), (_, w) in zip(g_leaves, w_leaves):
        g, w = np.asarray(g), np.asarray(w)
        assert g.tobytes() == w.astype(g.dtype).tobytes(), \
            jax.tree_util.keystr(path)


@pytest.mark.parametrize("wire,tau", STEP_CASES,
                         ids=[f"{w}-tau{t}" for w, t in STEP_CASES])
def test_train_step_matches_jax(wire, tau, monkeypatch):
    jcfg, tcfg = _cfgs(tau=tau)
    check_train_step(jcfg, tcfg, batch, wire, tau, monkeypatch)


def test_scanned_phase_matches_jax_and_the_eager_loop():
    jcfg, tcfg = _cfgs(tau=0.0)
    check_scanned_phase(jcfg, tcfg, batch)


def test_the_vision_step_reads_no_host_value():
    check_no_host_read(smoke_config(ARCH), batch)


@pytest.mark.parametrize("which", ["smoke", "full"])
def test_the_vision_shapes_are_the_jax_input_specs(which):
    check_shapes(*(_cfgs("bfloat16") if which == "smoke" else
                   (jax_get_config(ARCH), get_config(ARCH))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_vision_train_state_round_trips_bit_for_bit(dtype):
    check_state_round_trip(_cfgs(dtype)[0])


def test_the_vision_serving_cache_round_trips():
    jcfg, _ = _cfgs("bfloat16")
    cache = jax.device_get(jax_build_model(jcfg).init_cache(BATCH, 16))
    cache = jax.tree.map(lambda a: (a + (3 if a.dtype.kind == "i" else 1))
                         .astype(a.dtype), cache)
    back = lm_cache_to_numpy(lm_cache_from_numpy(cache))
    for seg in ("bottom", "top"):
        for got, want in zip(back[seg], cache[seg]["stack"]):
            np.testing.assert_array_equal(got, np.asarray(want, got.dtype))
