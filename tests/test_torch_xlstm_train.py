"""The PyTorch port's xLSTM training step against the JAX package's, on the CPU.

``repro_torch.launch.steps.make_train_step`` (and ``make_train_phase``) on
the smoke ``xlstm-1.3b`` (4 blocks in 2 groups of an mLSTM and an sLSTM
block, split 1 + 1, d_model 256, 4 sLSTM heads of 64, 8 mLSTM heads of 64),
fp32, against ``repro.launch.steps.make_train_step(plan, DistContext(),
lr, wire=...)`` with no mesh (and ``make_scanned_train_phase``): the same
JAX train state, converted by ``convert.lm_train_state_from_numpy``, and the
same numpy token batch go through both, and every metric and every leaf of
the new state is compared, as ``tests/test_torch_lm_train.py`` does for the
dense configs (whose helpers this file shares).  2 clients x 1 sequence x
256 tokens: two mLSTM chunks of 128, so the chunk carry is differentiated.
The weights are numpy draws in the shapes of the JAX ``input_specs``; the
queue is warmed by one JAX step from the same state.  Cases: (tau 0, no
wire), (tau 0, ``int8``) and (tau 0.95, no wire); tolerance atol 1e-5 /
rtol 1e-4 for a step, 1e-4 for two steps through the phase (at rate
0.002: ``PHASE_LR``).  The int8 case replays JAX's wire roundings into the
port and holds the port's own to them (``_replay_wire``).

Also the sLSTM's gradient: the plain backward ``ref.slstm_scan_bwd_ref``
with the dR product ``ref.slstm_dr``, and autograd of
``ref.slstm_scan_ref``, against ``jax.vjp`` of the JAX reference scan with
respect to (wx, r), over 3 seeds and 64 to 96 steps, and at a constructed
tie of the stabilizer's maximum (where both split the gradient in halves);
the autograd Function ``SLSTMScan`` (its launchers swapped for the plain
versions, as its kernels do not run here) under recomputed blocks;
``jax.vjp`` of ``models/xlstm.py::apply_slstm`` (train mode) with respect
to x, w, b and r; the backward kernel's plan and constants; the xLSTM
train state through the converters bit for bit; and ``_train_model``
taking xLSTM and the Zamba2 hybrid and refusing a CNN.  Run as a script, it prints the study
behind the rates and biases chosen above (not a test)."""
from dataclasses import replace
import functools
from importlib import import_module
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import INPUT_SHAPES as JAX_SHAPES
from repro.configs import smoke_config as jax_smoke_config
from repro.core.queue import init_queue as jax_init_queue
from repro.core.split import init_projection_head as jax_init_proj
from repro.kernels import ref as jref
from repro.launch import steps as jsteps
from repro.models import DistContext
from repro.models import build_model as jax_build_model
from repro.models import xlstm as jxl
from repro_torch import kernels
from repro_torch.configs import INPUT_SHAPES, smoke_config
from repro_torch.convert import (lm_params_from_numpy,
                                 lm_train_state_from_numpy,
                                 lm_train_state_to_numpy)
from repro_torch.kernels import ref as tref
from repro_torch.launch import steps
from repro_torch.models import xlstm as txl
from repro_torch.models.transformer import build_model
from repro_torch.tree import tree_leaves, tree_unflatten
from test_torch_lm_train import (PHASE_TOL, TOL, _assert_state_close,
                                 _realize, _torch_batch)
from _torch_threads import one_torch_thread  # noqa: F401

ARCH = "xlstm-1.3b"
N_CLIENTS, PER_CLIENT, SEQ = 2, 1, 256
# the rate of the steps compared: JAX's default, and a tenth of it for the
# phase (see PHASE_LR)
LR, LOW_LR = 0.02, 0.002
# (wire, tau).  Deeper random stacks are less well conditioned: at 16
# blocks in groups of 8 (fp32, no wire) a 1-ulp change of every weight
# moves JAX's first gradient by 0.449 of its norm, and at 48 blocks both
# packages' client bottoms are not finite after 2 steps (the study at the
# end of this file)
CASES = [(None, 0.0), ("int8", 0.0), (None, None)]
sl = import_module("repro_torch.kernels.slstm_scan")


def _cfgs(tau, dtype: str = "float32"):
    out = []
    for cfg in (jax_smoke_config(ARCH), smoke_config(ARCH)):
        cfg = replace(cfg, dtype=dtype)
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
    return jax.jit(jsteps.make_train_step(plan, DistContext(), LR,
                                          wire=wire))


def _forget_biases(half: dict) -> dict:
    """Add 3 to the forget gates' biases of a side's groups (the sLSTM's
    ``b`` in its third quarter, the mLSTM's ``b_if`` in its second half),
    as both packages' ``init_slstm`` and ``init_mlstm`` set them, over the
    0.02 N draws of ``_realize``.  Without them the random smoke model's
    step is ill-conditioned at the tolerance: a 1-ulp change of every
    weight moves the port's client bottoms by 1.58e-5 (JAX's lie 2.83e-5
    away); with them by 1.88e-6 (JAX's 2.94e-6; the study at the end of
    this file)."""
    g = half["groups"]
    b_if = g["mlstm"]["b_if"]
    b_if[..., b_if.shape[-1] // 2:] += 3.0
    b = g["slstm"]["b"]
    b[..., b.shape[-1] // 2:3 * b.shape[-1] // 4] += 3.0
    return half


def _jax_state(jcfg, wire, batch, seed=0, biased=True):
    """A JAX train state of numpy draws in the shapes of the JAX
    ``input_specs`` (each client and each teacher its own weights, the
    forget gates biased as the models initialise them unless not
    ``biased``), the JAX projection heads, and a queue warmed by one JAX
    step on ``batch``."""
    rng = np.random.RandomState(seed)
    specs = jsteps.input_specs(_plans(jcfg, None)[0])["state"]
    bias = _forget_biases if biased else (lambda half: half)
    state = {k: bias(_realize(specs[k], rng)) for k in
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


def _jax_wire(jcfg, state, batch, wire) -> dict:
    """What JAX's step sends over the wire, replayed outside it: the
    teacher's and the student's features before and after the uplink's
    quantization, and the cut's cotangent before and after the downlink's
    (``make_train_step``'s student loss written as a function of the
    quantized student features, with the teacher's pseudo-labels and the
    queue as the step forms them), each (N, b, S, d) as numpy."""
    from repro.core import losses as jlosses
    from repro.core.split import apply_projection_head, pool_features
    from repro.core.wire import fake_quantize, quantize_dequantize
    from repro.kernels import clustering_loss as jclustering
    model, sc = jax_build_model(jcfg), jcfg.semisfl

    def bottoms(stack, tokens):
        f = jax.vmap(lambda p, t: model.bottom_apply(
            p, {"tokens": t}, mode="train")[0])(stack, tokens)
        return f, jax.vmap(lambda x: fake_quantize(x, wire))(f)

    def top(params, f):
        pos = jnp.broadcast_to(jnp.arange(f.shape[1]), f.shape[:2])
        return model.top_apply(params, f, extras={
            "positions": pos, "aux_loss": jnp.zeros((), jnp.float32)},
            mode="train")[0]

    flat = lambda f: f.reshape((-1,) + f.shape[2:])

    @jax.jit
    def replay(state, batch):
        q = state["queue"]
        tf, tq = bottoms(state["teacher_bottoms"], batch["tokens_weak"])
        t_logits = top(state["t_top"], flat(tq))["logits"]
        pseudo_tok, ok_tok, _ = jlosses.pseudo_labels(
            t_logits, sc.confidence_threshold)
        probs = jax.nn.softmax(t_logits.astype(jnp.float32), -1).mean(1)
        pseudo_seq = probs.argmax(-1)
        conf_seq = probs.max(-1) > sc.confidence_threshold * 0.5

        def loss(f):
            out = top(state["top"], flat(f))
            nll, cnt = jlosses.cross_entropy_sum(out["logits"], pseudo_tok,
                                                 ok_tok)
            z = apply_projection_head(state["proj"], jcfg,
                                      pool_features(jcfg, flat(f)))
            c = jclustering(z, pseudo_seq, conf_seq, q.z, q.label, q.conf,
                            q.valid, sc.temperature)
            return nll / jnp.maximum(cnt, 1.0) + c + out["aux_loss"] * 1e-3

        sf, sq = bottoms(state["client_bottoms"], batch["tokens_strong"])
        g = jax.grad(loss)(sq)
        return {"teacher": (tf, tq), "student": (sf, sq),
                "cotangent": (g, jax.vmap(
                    lambda x: quantize_dequantize(x, wire))(g))}

    return jax.tree.map(np.array, replay(state, batch))


def _replay_wire(monkeypatch, want: dict, wire: str) -> dict:
    """Swap the step's wire quantizers for ones that hand on JAX's
    quantized values (``want``: :func:`_jax_wire`) in place of the port's
    own, and keep what the port would have sent: a feature that lies
    within the two sides' 1e-6 of a rounding boundary of the int8 grid
    goes to neighbouring codes on the two sides (as the seeds' draws are
    replayed into the port, the rounding decisions are replayed here).
    The uplink's features (teacher, then student) in order of the calls;
    the downlink's cotangent."""
    from repro_torch.kernels import quantize_dequantize
    seen = {"teacher": None, "student": None, "cotangent": None}

    def up(x, fmt):
        assert fmt == wire
        which = "teacher" if seen["teacher"] is None else "student"
        seen[which] = (x.detach().clone(),
                       quantize_dequantize(x.detach(), fmt, per_slice=True))
        return Uplink.apply(x, torch.from_numpy(want[which][1]))

    class Uplink(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, q):
            return q.clone()

        @staticmethod
        def backward(ctx, g):                 # straight through
            return g, None

    class Downlink(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            seen["cotangent"] = (g.detach().clone(), quantize_dequantize(
                g.contiguous(), wire, per_slice=True))
            return torch.from_numpy(want["cotangent"][1])

    monkeypatch.setattr(steps, "fake_quantize", up)
    monkeypatch.setattr(steps, "quantize_grad",
                        lambda x, fmt: Downlink.apply(x))
    return seen


def _assert_single_code_flips(seen: dict, want: dict) -> dict:
    """Each wire tensor the port would have sent against JAX's: the values
    before quantization within 1e-2 of a code step (amax / 127 of the
    client's slice), and the quantized ones equal but where the two sides
    round to neighbouring codes, one step apart, at most 1e-3 of the
    elements.  Returns the count of such flips by tensor."""
    flips = {}
    for name, (x_port, q_port) in seen.items():
        x_jax, q_jax = (torch.from_numpy(a) for a in want[name])
        n = x_jax.shape[0]
        step = (x_jax.abs().reshape(n, -1).amax(1) / 127.0).reshape(
            (n,) + (1,) * (x_jax.dim() - 1))
        near = float(((x_port - x_jax).abs() / step).max())
        assert near < 1e-2, (name, near)
        codes = ((q_port - q_jax).abs() / step).flatten()
        flip = codes > 0.5
        assert torch.allclose(codes[flip], torch.ones(()), rtol=1e-3), name
        assert codes[~flip].max() < 1e-3, name
        assert flip.sum() <= 1e-3 * flip.numel(), name
        flips[name] = (int(flip.sum()), near)
    return flips


@pytest.mark.parametrize("wire,tau", CASES,
                         ids=[f"{w}-tau{t}" for w, t in CASES])
def test_train_step_matches_jax(wire, tau, monkeypatch):
    """In the int8 case the port's step is handed JAX's quantized wire
    tensors (:func:`_replay_wire`), and what it would have sent itself is
    held to them (:func:`_assert_single_code_flips`): at this size the
    recurrent top carries a one-code flip of a student feature (11 of
    131,072 here) or of the cut's cotangent to every later token and every
    leaf, past the tolerance, where the dense models' attention step kept
    the queue rows' bound (``_wire_flip_slack``) enough."""
    jcfg, tcfg = _cfgs(tau)
    batch = _batch(jcfg, 1)
    state = _jax_state(jcfg, wire, batch)
    jnew, jm = _jax_step(jcfg, wire)(state, batch)
    jnew = jax.device_get(jnew)
    if wire:
        want = _jax_wire(jcfg, state, batch, wire)
        seen = _replay_wire(monkeypatch, want, wire)
    tnew, tm = steps.make_train_step(_plans(jcfg, tcfg)[1], wire=wire)(
        lm_train_state_from_numpy(state), _torch_batch(batch))
    if wire:
        print("wire flips (count, max pre-quantization gap in steps):",
              _assert_single_code_flips(seen, want))
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
        for a, b in zip(jax.tree_util.tree_leaves(
                lm_train_state_to_numpy(tnew)[key]),
                jax.tree_util.tree_leaves(state[key])):
            np.testing.assert_array_equal(a, b)


# the phase's rate: at the default 0.02 a step moves the random xLSTM's
# client bottoms by up to 0.6, and the second step is ill-conditioned:
# changing every weight of the state by 1 ulp moves the port's own
# two-step client bottoms by 0.0223 (JAX's lie 9.8e-4 away), past
# PHASE_TOL; at 0.002 by 8.8e-7 (JAX's 5.9e-7; the study at the end)
PHASE_LR = LOW_LR


def test_two_steps_of_the_phase_match_the_scanned_jax_phase():
    jcfg, tcfg = _cfgs(0.0)
    b0, b1 = _batch(jcfg, 3), _batch(jcfg, 4)
    state = _jax_state(jcfg, None, b0, seed=2)
    batches = {k: np.stack([b0[k], b1[k]]) for k in b0}
    jplan, tplan = _plans(jcfg, tcfg)
    jphase = jsteps.make_scanned_train_phase(jplan, DistContext(),
                                             lr=PHASE_LR, donate_carry=False)
    jnew, jm = jax.device_get(jphase(state, batches))
    tnew, tm = steps.make_train_phase(tplan, lr=PHASE_LR)(
        lm_train_state_from_numpy(state), _torch_batch(batches))
    for k in jm:
        assert tm[k].shape == (2,)
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                   err_msg=k, **PHASE_TOL)
    _assert_state_close(tnew, jnew, PHASE_TOL)


# ---------------------------------------------------------------------------
# the sLSTM's gradient
# ---------------------------------------------------------------------------

def _slstm_case(b, s, nh, hd, seed, f_bias=3.0):
    """wx as the model's projection gives it (the forget gate's bias 3 on
    half the rows, so that both branches of the stabilizer's maximum are
    taken), r as the model draws it, and an upstream gradient on h."""
    rng = np.random.RandomState(seed)
    wx = (rng.randn(b, s, 4, nh, hd) * 0.5).astype(np.float32)
    wx[: b // 2 + 1, :, 2] += f_bias
    r = (rng.randn(nh, hd, 4 * hd) / np.sqrt(hd)).astype(np.float32)
    return wx, r, rng.randn(b, s, nh, hd).astype(np.float32)


def _jax_vjp(wx, r, g):
    _, vjp = jax.vjp(jref.slstm_scan_ref, jnp.asarray(wx), jnp.asarray(r))
    return [np.asarray(x) for x in vjp(jnp.asarray(g))]


def _plain_bwd(wx, r, g, state=None):
    """dwx and dR from the plain backward and the dR product, on what the
    plain forward saves."""
    wx_t, r_t = torch.from_numpy(wx), torch.from_numpy(r)
    h, _, (pre, c, n, m) = tref.slstm_scan_ref(wx_t, r_t, state, save=True)
    dwx, dh0 = tref.slstm_scan_bwd_ref(r_t, pre, c, n, m, state,
                                       torch.from_numpy(g))
    return dwx, tref.slstm_dr(h, state and state[0], dwx), dh0


def _autograd(wx, r, g):
    wx_t = torch.from_numpy(wx).requires_grad_()
    r_t = torch.from_numpy(r).requires_grad_()
    h, _ = tref.slstm_scan_ref(wx_t, r_t)
    h.backward(torch.from_numpy(g))
    return wx_t.grad, r_t.grad


def _close(got, want, what):
    """max |err| / max |ref| within 1e-5: the two sides' sums run in other
    orders (measured: about 2e-7)."""
    got, want = np.asarray(got), np.asarray(want)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= 1e-5, f"{what}: {err:.3g} of max|ref|"


@pytest.mark.parametrize("b,s,nh,hd,seed", [(2, 64, 2, 16, 0),
                                            (1, 80, 3, 8, 1),
                                            (3, 96, 2, 32, 2)])
def test_slstm_vjp_matches_jax(b, s, nh, hd, seed):
    wx, r, g = _slstm_case(b, s, nh, hd, seed)
    jdwx, jdr = _jax_vjp(wx, r, g)
    dwx, dr, _ = _plain_bwd(wx, r, g)
    _close(dwx.numpy(), jdwx, "plain backward dwx")
    _close(dr.numpy(), jdr, "plain backward dR")
    a_dwx, a_dr = _autograd(wx, r, g)
    _close(a_dwx.numpy(), jdwx, "autograd dwx")
    _close(a_dr.numpy(), jdr, "autograd dR")


def test_slstm_bwd_splits_the_stabilizers_tie_as_jax():
    """With R = 0 the pre-activations are wx exactly: i~_0 = 0 makes m_0 =
    0, and f~_1 = i~_1 = 0.5 gives f~_1 + m_0 = i~_1, a tie of m_1's
    maximum; at t = 2 f~ + m_1 < i~.  JAX's ``jnp.maximum`` halves a tie's
    gradient, and so do the plain backward and autograd of the plain scan
    (``torch.maximum``).  (h does not depend on m where n > 1e-6, so the
    gradient reaching m is zero but for rounding: the tie's path must
    agree, not move the result.)"""
    b, s, nh, hd = 1, 3, 1, 4
    wx = np.zeros((b, s, 4, nh, hd), np.float32)
    wx[0, :, 0] = 0.25
    wx[0, 1, 1:3] = 0.5
    wx[0, 2, 1] = 1.5
    wx[0, :, 3] = -0.5
    r = np.zeros((nh, hd, 4 * hd), np.float32)
    g = np.ones((b, s, nh, hd), np.float32)
    jdwx, jdr = _jax_vjp(wx, r, g)
    dwx, dr, _ = _plain_bwd(wx, r, g)
    a_dwx, a_dr = _autograd(wx, r, g)
    for got in (dwx, a_dwx):
        np.testing.assert_allclose(got.numpy(), jdwx, atol=1e-6, rtol=1e-5)
    for got in (dr, a_dr):
        np.testing.assert_allclose(got.numpy(), jdr, atol=1e-6, rtol=1e-5)
    _, _, (pre, _, _, m) = tref.slstm_scan_ref(torch.from_numpy(wx),
                                               torch.from_numpy(r), save=True)
    assert float(pre[0, 1, 2, 0, 0] + m[0, 0, 0, 0]) == float(
        pre[0, 1, 1, 0, 0]) == float(m[0, 1, 0, 0])


def test_slstm_bwd_from_a_given_state_gives_dh0():
    """From a non-fresh state: dwx and the gradient on the initial h
    against autograd of the plain scan."""
    b, s, nh, hd = 2, 40, 2, 16
    wx, r, g = _slstm_case(b, s, nh, hd, 7)
    rng = np.random.RandomState(8)
    state = tuple(torch.from_numpy(a.astype(np.float32)) for a in (
        np.tanh(rng.randn(b, nh, hd)), rng.randn(b, nh, hd),
        rng.rand(b, nh, hd) * 2 + 0.5, rng.randn(b, nh, hd) * 2))
    dwx, dr, dh0 = _plain_bwd(wx, r, g, state)
    wx_t = torch.from_numpy(wx).requires_grad_()
    r_t = torch.from_numpy(r).requires_grad_()
    h0 = state[0].clone().requires_grad_()
    h, _ = tref.slstm_scan_ref(wx_t, r_t, (h0, *state[1:]))
    h.backward(torch.from_numpy(g))
    for got, want, what in ((dwx, wx_t.grad, "dwx"), (dr, r_t.grad, "dR"),
                            (dh0, h0.grad, "dh0")):
        _close(got.numpy(), want.numpy(), what)


def _plain_launchers(monkeypatch):
    """The Function's two launchers swapped for the plain versions, with
    the same signatures (its kernels do not run on the CPU); counts the
    backward's calls."""
    calls = []

    def fwd(wx, r, state=None, *, save=False):
        return tref.slstm_scan_ref(wx, r, state, save=save)

    def bwd(*args):
        calls.append(1)
        return tref.slstm_scan_bwd_ref(*args)

    monkeypatch.setattr(sl, "slstm_scan_cuda", fwd)
    monkeypatch.setattr(sl, "slstm_scan_bwd_cuda", bwd)
    return calls


@pytest.mark.parametrize("with_state", [False, True])
def test_slstm_scan_function_matches_autograd(monkeypatch, with_state):
    """``SLSTMScan``'s backward (dwx from its backward launcher, dR as the
    product of the shifted h with dwx) against autograd of the plain scan;
    the final state is returned but carries no gradient."""
    calls = _plain_launchers(monkeypatch)
    b, s, nh, hd = 2, 48, 2, 16
    wx, r, g = _slstm_case(b, s, nh, hd, 11)
    rng = np.random.RandomState(12)
    state = (tuple(torch.from_numpy(rng.randn(b, nh, hd).astype(np.float32))
                   for _ in range(4)) if with_state else (None,) * 4)
    wx_t = torch.from_numpy(wx).requires_grad_()
    r_t = torch.from_numpy(r).requires_grad_()
    h, *final = sl.SLSTMScan.apply(wx_t, r_t, *state)
    assert not any(t.requires_grad for t in final)
    h.backward(torch.from_numpy(g))
    assert len(calls) == 1
    wx2 = torch.from_numpy(wx).requires_grad_()
    r2 = torch.from_numpy(r).requires_grad_()
    h2, fin2 = tref.slstm_scan_ref(
        wx2, r2, None if state[0] is None else state)
    h2.backward(torch.from_numpy(g))
    assert torch.equal(h, h2)
    assert all(torch.equal(a, b_) for a, b_ in zip(final, fin2))
    _close(wx_t.grad.numpy(), wx2.grad.numpy(), "dwx")
    _close(r_t.grad.numpy(), r2.grad.numpy(), "dR")


def test_slstm_scan_function_refuses_a_state_with_a_gradient(monkeypatch):
    _plain_launchers(monkeypatch)
    wx = torch.randn(1, 4, 4, 1, 8, requires_grad=True)
    r = torch.randn(1, 8, 32)
    h0 = torch.zeros(1, 1, 8, requires_grad=True)
    z = torch.zeros(1, 1, 8)
    with pytest.raises(ValueError, match="not differentiated"):
        sl.SLSTMScan.apply(wx, r, h0, z, z, z)


def test_slstm_scan_function_under_recomputed_blocks(monkeypatch):
    """The smoke model's bottom on the card's route (``SLSTMScan`` with
    plain launchers, wired in for CPU tensors) with each block recomputed
    in the backward pass: the same gradients as autograd of the plain
    route, and one backward call a group (its sLSTM block)."""
    calls = _plain_launchers(monkeypatch)
    cfg = replace(smoke_config(ARCH), dtype="float32")
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(3)
    params = model.init(gen, "cpu")["bottom"]
    tokens = torch.randint(0, cfg.vocab_size, (2, 40), generator=gen)

    def grads(route):
        leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
        monkeypatch.setattr(kernels, "_route", lambda x, name: route)
        feats, _, _ = model.bottom_apply(tree_unflatten(params, leaves),
                                         {"tokens": tokens})
        return torch.autograd.grad((feats ** 2).sum(), leaves)

    plain = grads("cpu")
    assert not calls
    card = grads("cuda")
    assert len(calls) == model.split_groups
    for a, b_ in zip(card, plain):
        scale = max(float(b_.abs().max()), 1e-30)
        assert float((a - b_).abs().max()) / scale <= 1e-5


def test_apply_slstm_vjp_matches_jax():
    """``apply_slstm`` in train mode (the fp32 input projection, the scan
    from a zero cache) differentiated with respect to x, w, b and r on
    both sides."""
    jcfg, tcfg = _cfgs(None)
    d, nh = tcfg.d_model, tcfg.num_heads
    rng = np.random.RandomState(21)
    x = rng.randn(2, 72, d).astype(np.float32)
    p = {"w": (rng.randn(d, 4 * d) / np.sqrt(d)).astype(np.float32),
         "b": (rng.randn(4 * d) * 0.5).astype(np.float32),
         "r": (rng.randn(nh, d // nh, 4 * d // nh)
               / np.sqrt(d // nh)).astype(np.float32)}
    p["b"][2 * d:3 * d] += 3.0
    g = rng.randn(2, 72, d).astype(np.float32)

    def jf(xx, w, b, r):
        return jxl.apply_slstm({"w": w, "b": b, "r": r}, jcfg, xx,
                               mode="train")[0]

    _, vjp = jax.vjp(jf, *(jnp.asarray(a) for a in (x, p["w"], p["b"],
                                                      p["r"])))
    want = [np.asarray(a) for a in vjp(jnp.asarray(g))]
    xt = torch.from_numpy(x).requires_grad_()
    pt = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    h, _ = txl.apply_slstm(pt, tcfg, xt, mode="train")
    h.backward(torch.from_numpy(g))
    for got, w, what in zip((xt.grad, pt["w"].grad, pt["b"].grad,
                             pt["r"].grad), want, ("x", "w", "b", "r")):
        _close(got.numpy(), w, what)


# ---------------------------------------------------------------------------
# the backward kernel's plan and constants (pure Python)
# ---------------------------------------------------------------------------

H100 = (132, 232448)


def test_slstm_plan_bwd_at_the_training_shapes():
    """xLSTM-1.3B's sLSTM at the top's B 4 and a bottom's B 1: the
    forward's split (32 blocks of 16 units a head, 128 blocks) on the mma
    route, each block holding R's 64 columns of its units as bf16 hi and lo
    fragments (128 KiB), 4 m-tiles of 16 rows a warp, and in shared memory
    its dwx_t, the head's 32 partial sums of its units and the ring.
    Forced onto the simt route, the plan is the first kernel's: R's 16 rows
    of 4 x 512 (128 KiB) and the head's dwx_t in shared memory."""
    for b, smem, simt in ((4, 22528, 178944), (1, 7168, 171456)):
        p = sl.plan_bwd(b, 4, 512, *H100)
        assert p.route == "mma"
        assert (p.units, p.groups, p.blocks) == (16, 32, 128)
        assert (p.slices, p.threads) == (4, 256)
        assert p.r_bytes == 128 * 1024
        assert p.smem_bytes == smem <= H100[1]
        q = sl.plan_bwd(b, 4, 512, *H100, route="simt")
        assert q.route == "simt"
        assert (q.units, q.groups, q.blocks) == (16, 32, 128)
        assert (q.slices, q.threads) == (16, 256)
        assert q.r_bytes == 128 * 1024
        assert q.smem_bytes == simt <= H100[1]


def test_slstm_plan_bwd_routes_by_shape():
    """The route comes from the shape before any launch: mma where a
    block's units (at most 16) and R's hd rows (at most 8 warps x 4
    m-tiles of 16) tile its fragments and each of the B U pairs has a gate
    thread; else simt.  A forced route that does not take the shape
    raises."""
    for b in range(1, 17):
        assert sl.plan_bwd(b, 4, 512, *H100).route == "mma"
    assert sl._plan_mma(33, 4, 256, 132) is None           # 33 x 8 > 256
    assert sl.plan_bwd(4, 4, 513, *H100).route == "simt"   # 17 units
    assert sl.plan_bwd(4, 8, 300, *H100).route == "simt"   # 19 units
    assert sl.plan_bwd(4, 1, 513, *H100).route == "simt"   # 33 m-tiles
    with pytest.raises(ValueError, match="mma route does not take"):
        sl.plan_bwd(4, 4, 513, *H100, route="mma")
    with pytest.raises(ValueError, match="no route"):
        sl.plan_bwd(4, 4, 512, *H100, route="wgmma")


def test_slstm_plan_bwd_ragged_mma_group():
    """4 heads of 260 on 132 SMs: 33 groups of 8 units a head, the last of
    4, on the mma route.  Its units are a multiple of 4 but hd is not a
    multiple of them, so the kernel's gather of the partial sums must not
    take float4s (one would run past the head's last row); chip_smoke's
    SLSTM_BWD_CASES hold this shape on the card."""
    p = sl.plan_bwd(2, 4, 260, *H100)
    assert p.route == "mma"
    assert (p.units, p.groups, p.blocks, p.slices) == (8, 33, 132, 4)
    assert p.units % 4 == 0 and 260 % p.units == 4
    assert 260 - (p.groups - 1) * p.units == 4


def test_slstm_plan_bwd_refuses_what_does_not_fit_on_chip():
    """At 4 heads and B 4 the last hd whose rows of R fit is 594: the
    next one raises, naming the bytes and the capacity."""
    assert sl.plan_bwd(4, 4, 594, *H100).blocks == 132
    with pytest.raises(ValueError, match=r"cannot be held on chip.*232448"):
        sl.plan_bwd(4, 4, 595, *H100)
    with pytest.raises(ValueError, match="cannot be held on chip"):
        sl.plan_bwd(1, 133, 64, *H100)


@pytest.mark.parametrize("nh", [1, 2, 4, 8])
def test_slstm_plan_bwd_keeps_its_rules(nh):
    """Over hd 1..700 at B 1, 4 and 9: at most one block an SM, at most
    256 threads, a power-of-two count of slices up to 16 and of at least 4
    of the 4 hd floats, groups that cover hd with the last one not empty,
    and shared memory within the card's; past the first refusal nothing
    fits."""
    for b in (1, 4, 9):
        refused = False
        for hd in range(1, 701):
            try:
                p = sl.plan_bwd(b, nh, hd, *H100)
            except ValueError:
                refused = True
                continue
            assert not refused, (b, nh, hd)
            assert p.blocks <= H100[0] and p.threads <= 256
            assert p.slices & (p.slices - 1) == 0
            if p.route == "mma":
                assert p.units <= 16 and b * p.units <= 256
                assert p.threads == 256
                assert p.slices <= 4 and 64 * p.slices < max(hd, 65)
                assert hd <= 128 * p.slices
            else:
                assert p.slices <= 16
                assert p.slices == 1 or 4 * p.slices <= 4 * hd
            assert (p.groups - 1) * p.units < hd <= p.groups * p.units
            assert p.smem_bytes <= H100[1]


def test_slstm_bwd_constants_match_the_kernel_source():
    src = (Path(sl.__file__).parents[1] / "csrc" / "slstm_scan_bwd.cu"
           ).read_text()
    for name, value in (("kRows", sl.ROWS), ("kRing", sl.BWD_RING),
                        ("kFields", sl.BWD_FIELDS),
                        ("kMaxThreads", sl.MAX_THREADS),
                        ("kRegK", sl.BWD_REG_K),
                        ("kMmaWarps", sl.MMA_WARPS),
                        ("kMmaUnits", sl.MMA_UNITS),
                        ("kMmaRows", sl.MMA_ROWS),
                        ("kMmaRing", sl.MMA_RING),
                        ("kMaxMTiles", sl.MMA_MAX_MTILES)):
        assert f"constexpr int {name} = {value};" in src, name


def test_slstm_sources_share_their_header():
    """Both sLSTM libraries are named by their source and the shared
    ``slstm_common.cuh``, so an edit to the header rebuilds both."""
    from repro_torch.kernels import build
    for name in ("slstm_scan", "slstm_scan_bwd"):
        assert [p.name for p in build._sources(build.CSRC / f"{name}.cu")
                ] == [f"{name}.cu", "slstm_common.cuh"]


def test_slstm_bwd_cuda_wrapper_refuses_cpu_tensors():
    z = torch.zeros(1, 4, 1, 8)
    with pytest.raises(ValueError, match="CUDA device"):
        sl.slstm_scan_bwd_cuda(torch.zeros(1, 8, 32),
                               torch.zeros(1, 4, 4, 1, 8), z, z, z, None, z)


# ---------------------------------------------------------------------------
# the model's extras, the train state, the step's models
# ---------------------------------------------------------------------------

def test_xlstm_extras_are_the_jax_models():
    """``bottom_apply`` hands the top the positions and a zero aux loss,
    and ``top_apply`` returns the bottom's aux loss, as in JAX."""
    jcfg, tcfg = _cfgs(None)
    rng = np.random.RandomState(5)
    params = _realize(jax.eval_shape(jax_build_model(jcfg).init,
                                     jax.random.PRNGKey(0)), rng)
    tokens = rng.randint(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    jmodel, tmodel = jax_build_model(jcfg), build_model(tcfg)
    _, _, jex = jmodel.bottom_apply(params["bottom"],
                                    {"tokens": jnp.asarray(tokens)})
    port = lm_params_from_numpy(params)
    with torch.no_grad():
        feats, _, tex = tmodel.bottom_apply(
            port["bottom"], {"tokens": torch.from_numpy(
                tokens.astype(np.int64))})
        out, _ = tmodel.top_apply(port["top"], feats, extras=tex)
    assert set(tex) == set(jex) == {"aux_loss", "positions"}
    np.testing.assert_array_equal(tex["positions"].numpy(),
                                  np.asarray(jex["positions"]))
    assert tex["aux_loss"].dtype == torch.float32
    assert float(tex["aux_loss"]) == float(jex["aux_loss"]) == 0.0
    assert float(out["aux_loss"]) == 0.0 and out["aux_loss"].dim() == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xlstm_train_state_round_trips_bit_for_bit(dtype):
    jcfg, _ = _cfgs(0.0, dtype)
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
    g0 = port["client_bottoms"][1]["groups"][0]
    assert len(port["client_bottoms"]) == 2 and len(g0["mlstm"]) == 1
    assert g0["mlstm"][0]["wq"].dtype == getattr(torch, dtype)
    assert g0["slstm"]["r"].dtype == torch.float32
    back = lm_train_state_to_numpy(port)
    want = dict(state, queue=q._asdict())
    want["queue"]["ptr"] = int(q.ptr)
    g_leaves = jax.tree_util.tree_leaves_with_path(back)
    w_leaves = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in g_leaves] == [p for p, _ in w_leaves]
    for (path, g), (_, w) in zip(g_leaves, w_leaves):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, jax.tree_util.keystr(path)
        assert g.dtype == w.dtype or g.shape == (), path
        assert g.tobytes() == w.astype(g.dtype).tobytes(), \
            jax.tree_util.keystr(path)


def test_the_state_shapes_are_the_jax_input_specs():
    jcfg, tcfg = _cfgs(0.0, "bfloat16")
    jplan, tplan = _plans(jcfg, tcfg)
    want = jsteps.input_specs(jplan)
    got = steps.train_state_shapes(tplan)
    assert len(got["state"]["client_bottoms"]) == tplan.n_clients
    state = lm_train_state_to_numpy(steps.init_train_state(tplan, 0, "cpu"))
    for key in ("client_bottoms", "teacher_bottoms", "top", "t_top", "proj",
                "t_proj"):
        g = jax.tree.map(lambda a: (a.shape, a.dtype.name), state[key])
        w = jax.tree.map(lambda a: (a.shape, a.dtype.name),
                         want["state"][key])
        assert g == w, key


def test_train_model_takes_xlstm_and_refuses_zamba2():
    """``_train_model`` takes xLSTM and the Zamba2 hybrid (which it refused
    until the Mamba2 scan had a backward kernel; the name is the one this
    test had then) and still refuses a model the LM step does not train,
    a CNN."""
    shape = replace(INPUT_SHAPES["train_4k"], seq_len=32, global_batch=2)
    for arch, kind in ((ARCH, "XLSTMModel"), ("zamba2-7b", "HybridMamba")):
        plan = steps.make_plan(smoke_config(arch), shape, n_clients=2)
        assert type(steps._train_model(plan)).__name__ == kind
        steps.make_train_step(plan)
    cplan = steps.make_plan(smoke_config("paper-cnn"), shape, n_clients=2)
    with pytest.raises(NotImplementedError, match="trains dense decoder"):
        steps.make_train_step(cplan)


# ---------------------------------------------------------------------------
# the conditioning behind the choices above: ``python
# tests/test_torch_xlstm_train.py`` (on the CPU, a few minutes; not a test)
# ---------------------------------------------------------------------------

def _ulp_bump(tree, rng):
    """Every fp32 leaf of a numpy tree moved 1 ulp up or down at random."""
    def one(a):
        a = np.asarray(a)
        if a.dtype != np.float32:
            return a
        way = np.where(rng.rand(*a.shape) > 0.5, np.inf, -np.inf)
        return np.nextafter(a, way.astype(np.float32))
    return jax.tree.map(one, tree)


def _study_steps(biased: bool, k: int, lr: float) -> str:
    """k steps of the smoke step at rate lr from the state and batches of
    the tests above (the step test's for k 1, the phase test's for k 2):
    how far a 1-ulp change of every weight of the state moves the port's
    client bottoms, and how far JAX's lie from the port's, each as a
    fraction of the bottoms' largest move."""
    jcfg, tcfg = _cfgs(0.0)
    batches = ([_batch(jcfg, 1)] if k == 1
               else [_batch(jcfg, 3), _batch(jcfg, 4)])
    state = _jax_state(jcfg, None, batches[0], seed=0 if k == 1 else 2,
                       biased=biased)
    bumped = dict(state)
    rng = np.random.RandomState(9)
    for key in ("client_bottoms", "teacher_bottoms", "top", "t_top",
                "proj", "t_proj"):
        bumped[key] = _ulp_bump(state[key], rng)
    jstep = jax.jit(jsteps.make_train_step(_plans(jcfg, None)[0],
                                           DistContext(), lr))
    tstep = steps.make_train_step(_plans(jcfg, tcfg)[1], lr)
    js, ts, tb = state, lm_train_state_from_numpy(state), \
        lm_train_state_from_numpy(bumped)
    for b in batches:
        js = jax.device_get(jstep(js, b)[0])
        ts = tstep(ts, _torch_batch(b))[0]
        tb = tstep(tb, _torch_batch(b))[0]
    leaves = lambda x: jax.tree_util.tree_leaves(x["client_bottoms"])
    t, t2 = (leaves(lm_train_state_to_numpy(x)) for x in (ts, tb))
    j, s0 = leaves(js), leaves(state)
    move = max(np.abs(np.asarray(a, np.float64) - b).max()
               for a, b in zip(j, s0))
    ulp = max(np.abs(a - b).max() for a, b in zip(t, t2))
    gap = max(np.abs(a - np.asarray(b)).max() for a, b in zip(t, j))
    return (f"{k} step(s) at rate {lr}, forget biases {biased}: the client "
            f"bottoms move by up to {move:.3g}; 1 ulp moves the port's by "
            f"{ulp:.3g} ({ulp / move:.3g} of that), JAX's lie {gap:.3g} "
            f"away ({gap / move:.3g})")


def _own_init_state(init: str, jplan, tplan) -> dict:
    """A JAX-layout train state from one model's own initialisation, as
    both packages' steps start from it: ``"jax"``, the JAX model's
    ``init`` at key 0 (the projection head's at key 1), or ``"port"``, the
    port's ``init_train_state`` at seed 0, converted; every client and
    every teacher holding the one bottom, the teacher top and head copies,
    an empty queue."""
    jcfg, n = jplan.cfg, jplan.n_clients
    queue = jax_init_queue(jcfg.semisfl.queue_len, jsteps._proj_dim(jcfg))
    if init == "port":
        state = lm_train_state_to_numpy(steps.init_train_state(tplan, 0,
                                                               "cpu"))
        state["queue"] = type(queue)(**state["queue"])
        return state
    params = jax.device_get(jax_build_model(jcfg).init(
        jax.random.PRNGKey(0)))
    stack = lambda t: jax.tree.map(lambda a: np.stack([a] * n), t)
    proj = jax.device_get(jax_init_proj(jax.random.PRNGKey(1), jcfg))
    return {"client_bottoms": stack(params["bottom"]),
            "teacher_bottoms": stack(params["bottom"]),
            "top": params["top"], "t_top": params["top"], "proj": proj,
            "t_proj": proj, "queue": jax.device_get(queue)}


def _study_depth(layers: int, init: str, dtype: str = "bfloat16",
                 wire="int8", lr: float = 2e-4, seq: int = 256) -> str:
    """Both packages' SemiSFL steps at the smoke width (d_model 256) with
    ``layers`` blocks in groups of 8 (xLSTM-1.3B's; split at a quarter,
    snapped to a group: 8 + 8 of 16, 16 + 32 of 48, as chip_smoke.py's
    full-width runs), ``dtype`` and ``wire`` (bf16 and int8 as on the
    card), tau 0, 4 clients x 1 x ``seq`` tokens, the weak views repeated,
    at rate ``lr`` (``scripts/lm_depth_probe.py``'s), from each model's
    own initialisation (:func:`_own_init_state`).  The first step's
    gradient is read as the change / lr of the client bottoms (the step is
    plain SGD, with Eq. (8)'s factor N on the bottoms' gradient) and of
    the top: JAX's largest entry and L2 norm; how far the port's lies from
    it, and how far JAX's own moves when every fp32 weight of the state
    moves 1 ulp (:func:`_ulp_bump`), each over JAX's norm; whether each is
    finite; then whether the client bottoms are finite after 2 steps."""
    cfgs = [replace(c, num_layers=layers, dtype=dtype,
                    xlstm=replace(c.xlstm, slstm_period=8),
                    semisfl=replace(c.semisfl, confidence_threshold=0.0,
                                    split_layer=layers // 4))
            for c in (jax_smoke_config(ARCH), smoke_config(ARCH))]
    jcfg, tcfg = cfgs
    shape = lambda shapes: replace(shapes["train_4k"], seq_len=seq,
                                   global_batch=4)
    jplan = jsteps.make_plan(jcfg, shape(JAX_SHAPES), n_clients=4)
    tplan = steps.make_plan(tcfg, shape(INPUT_SHAPES), n_clients=4)
    state = _own_init_state(init, jplan, tplan)
    rng = np.random.RandomState(0)
    weak = rng.randint(0, jcfg.vocab_size, (4, 1, seq)).astype(np.int32)
    batches = [{"tokens_weak": weak, "tokens_strong": rng.randint(
        0, jcfg.vocab_size, (4, 1, seq)).astype(np.int32)} for _ in range(2)]
    jstep = jax.jit(jsteps.make_train_step(jplan, DistContext(), lr,
                                           wire=wire))
    tstep = steps.make_train_step(tplan, lr, wire=wire)
    leaves = lambda tree: [np.asarray(x, np.float64)
                           for x in jax.tree_util.tree_leaves(tree)]
    norm = lambda tree: np.sqrt(sum((a ** 2).sum() for a in tree))
    finite = lambda tree: all(np.isfinite(a).all() for a in tree)

    def grads(start, new) -> list:
        return [[(a - b) / lr for a, b in zip(leaves(new[k]),
                                              leaves(start[k]))]
                for k in ("client_bottoms", "top")]

    bumped = dict(state)
    for key in ("client_bottoms", "teacher_bottoms", "top", "t_top",
                "proj", "t_proj"):
        bumped[key] = _ulp_bump(state[key], np.random.RandomState(9))
    js, ts = state, lm_train_state_from_numpy(state)
    for i, b in enumerate(batches):
        js = jax.device_get(jstep(js, b)[0])
        ts = tstep(ts, _torch_batch(b))[0]
        if i == 0:
            gj, gt = grads(state, js), grads(state,
                                             lm_train_state_to_numpy(ts))
            gb = grads(bumped, jax.device_get(jstep(bumped, b)[0]))
    said = []
    for k, want, port, moved in zip(("client bottoms", "top"), gj, gt, gb):
        far = lambda tree: norm([a - b for a, b in zip(tree, want)]) \
            / norm(want)
        said.append(
            f"{k}: JAX's max {max(np.abs(a).max() for a in want):.4g}, "
            f"norm {norm(want):.4g}; the port's {far(port):.3g} of it away, "
            f"JAX's from 1 ulp {far(moved):.3g}; finite: JAX "
            f"{finite(want)}, the port {finite(port)}")
    return (f"{layers} blocks, {dtype}, wire {wire}, {init}'s init, rate "
            f"{lr}, the first step's gradient: " + "; ".join(said)
            + f"; client bottoms finite after 2 steps: JAX "
            f"{finite(leaves(js['client_bottoms']))}, the port "
            f"{finite(leaves(lm_train_state_to_numpy(ts)['client_bottoms']))}")


if __name__ == "__main__":
    for biased in (False, True):
        print(_study_steps(biased, 1, LR), flush=True)
    for lr in (LR, LOW_LR):
        print(_study_steps(True, 2, lr), flush=True)
    for init, dtype, wire in (("jax", "bfloat16", "int8"),
                              ("port", "bfloat16", "int8"),
                              ("jax", "float32", None)):
        for layers in (16, 48):
            print(_study_depth(layers, init, dtype, wire), flush=True)
