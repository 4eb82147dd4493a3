"""The PyTorch port's Zamba2 training step against the JAX package's, on the
CPU, and the Mamba2 scan's gradient.

The scan's gradient: the plain backward ``ref.mamba2_scan_bwd_ref`` and
autograd of the plain scan ``ref.mamba2_scan_ref`` against ``jax.vjp`` of
the JAX model's ``ssd_chunked`` (``src/repro/models/ssm.py:79``) with
respect to x, dt, A, B, C and D, at S below, at and past the kernels' chunk
of 64, at a ragged 300, at hd and N that are not multiples of 8, and with
dt in [2, 4] (A = -1) so that cum falls past fp32's exp range within a
64-step chunk (there JAX's ``ssd_chunked`` runs chunks of 16, whose masked
exponents stay finite: its VJP of a masked inf is NaN).  Tolerance: max|err|
/ max|ref| <= 1e-5 per gradient (the sequential scan and the chunked one
sum in other orders; measured: at most 1.2e-6).  Then the backward kernel's
arithmetic written out in plain PyTorch (``_kernel_arithmetic``: chunks of
64 in reverse from the saved chunk states, the SSD form, the exponent taken
only where s <= t) against the plain backward at the same shapes, the large
dt included: finite, and within KERNEL_TOL = 3e-5 of max|ref| (measured:
1.06e-5 for dA at the decay case, where the plain backward lies 1.2e-7
from an fp64 run of the recurrence: dA sums dt_u da_u over the chunk's
steps, and at dt in [2, 4] those terms are much larger than their sum;
every other gradient and case at most 1.6e-6).
``Mamba2Scan`` (its launchers swapped for the plain versions, as its
kernels do not run here) under the hybrid's recomputed layers against
autograd of the plain route.

The training step: ``repro_torch.launch.steps.make_train_step`` (and
``make_train_phase``) on the smoke ``zamba2-7b`` (4 Mamba2 layers, the
weight-shared attention + MLP block after every 2, split 2 + 2; d_model
256, 16 SSM heads of 32, state 16; attention 4 heads of 64), fp32, against
``repro.launch.steps.make_train_step(plan, DistContext(), lr, wire=...)``
with no mesh (and ``make_scanned_train_phase``), as
``tests/test_torch_lm_train.py`` and ``tests/test_torch_xlstm_train.py``
do for the dense and xLSTM configs (whose helpers this file shares): the
same JAX train state, converted, and the same numpy tokens; every metric
and every leaf of the new state.  2 clients x 1 sequence x 128 tokens.
Cases (tau 0, no wire), (tau 0, ``int8``) and (tau 0.95, no wire);
tolerance atol 1e-5 / rtol 1e-4 for a step, 1e-4 for two steps through
the phase.  The int8 case replays JAX's wire roundings into the port and
holds the port's own to them (``_replay_wire``), as the xLSTM test does:
a recurrent stack carries a one-code flip of a feature on through time.
Also the train state through the converters bit for bit, its shapes
against JAX's ``input_specs``, the hybrid's extras, and the backward
kernel's constants."""
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
from repro.launch import steps as jsteps
from repro.models import DistContext
from repro.models import build_model as jax_build_model
from repro.models import ssm as jssm
from repro_torch import kernels
from repro_torch.configs import INPUT_SHAPES, smoke_config
from repro_torch.convert import (lm_params_from_numpy,
                                 lm_train_state_from_numpy,
                                 lm_train_state_to_numpy)
from repro_torch.kernels import ref as tref
from repro_torch.launch import steps
from repro_torch.models.transformer import build_model
from repro_torch.tree import tree_leaves, tree_unflatten
from test_torch_lm_train import (PHASE_TOL, TOL, _assert_state_close,
                                 _realize, _torch_batch)
from test_torch_xlstm_train import (_assert_single_code_flips, _jax_wire,
                                    _replay_wire)
from _torch_threads import one_torch_thread  # noqa: F401

ARCH = "zamba2-7b"
N_CLIENTS, PER_CLIENT, SEQ = 2, 1, 128
LR = 0.02
CASES = [(None, 0.0), ("int8", 0.0), (None, None)]
m2 = import_module("repro_torch.kernels.mamba2_scan")
GRAD_TOL = 1e-5
KERNEL_TOL = 3e-5


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
def _jax_step(jcfg, wire, lr=LR):
    plan = _plans(jcfg, None)[0]
    return jax.jit(jsteps.make_train_step(plan, DistContext(), lr,
                                          wire=wire))


def _jax_state(jcfg, wire, batch, seed=0):
    """A JAX train state of numpy draws in the shapes of the JAX
    ``input_specs`` (each client and each teacher its own weights), the
    JAX projection heads, and a queue warmed by one JAX step on
    ``batch``."""
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


# ---------------------------------------------------------------------------
# the scan's gradient
# ---------------------------------------------------------------------------

# (b, s, nh, hd, n, dt kind, JAX chunk, seed).  "test": dt in [0.01, 0.51],
# A in [-1, -0.1] (tests/test_kernels.py's distributions); "decay": dt in
# [2, 4], A = -1, so that cum passes -88 within 64 steps
SCAN_CASES = [(2, 40, 2, 16, 8, "test", 8, 0),
              (1, 64, 3, 12, 10, "test", 64, 1),
              (2, 130, 2, 8, 16, "test", 64, 2),
              (1, 300, 2, 5, 7, "test", 4, 3),
              (2, 128, 2, 16, 16, "decay", 16, 4)]


def _scan_case(b, s, nh, hd, n, kind, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, s, nh, hd).astype(np.float32)
    if kind == "decay":
        dt = (rng.rand(b, s, nh) * 2 + 2).astype(np.float32)
        A = -np.ones(nh, np.float32)
    else:
        dt = (rng.rand(b, s, nh) * 0.5 + 0.01).astype(np.float32)
        A = -(rng.rand(nh) * 0.9 + 0.1).astype(np.float32)
    B = rng.randn(b, s, n).astype(np.float32)
    C = rng.randn(b, s, n).astype(np.float32)
    D = rng.rand(nh).astype(np.float32)
    dy = rng.randn(b, s, nh, hd).astype(np.float32)
    return (x, dt, A, B, C, D), dy


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


NAMES = ("dx", "ddt", "dA", "dB", "dC", "dD")


@pytest.mark.parametrize("case", SCAN_CASES, ids=[
    f"b{c[0]}-s{c[1]}-nh{c[2]}-hd{c[3]}-n{c[4]}-{c[5]}" for c in SCAN_CASES])
def test_scan_vjp_matches_jax_ssd_chunked(case):
    b, s, nh, hd, n, kind, chunk, seed = case
    args, dy = _scan_case(b, s, nh, hd, n, kind, seed)
    y, vjp = jax.vjp(lambda *a: jssm.ssd_chunked(*a, chunk),
                     *(jnp.asarray(a) for a in args))
    want = [np.asarray(g) for g in vjp(jnp.asarray(dy))]
    assert all(np.isfinite(w).all() for w in want)
    t_args = [torch.from_numpy(a) for a in args]
    plain = tref.mamba2_scan_bwd_ref(*t_args, torch.from_numpy(dy))
    leaves = [a.clone().requires_grad_() for a in t_args]
    y_t, _ = tref.mamba2_scan_ref(*leaves)
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y),
                               atol=1e-4, rtol=1e-4)
    auto = torch.autograd.grad(y_t, leaves, torch.from_numpy(dy))
    for name, p, a, w in zip(NAMES, plain, auto, want):
        assert p.dtype == torch.float32
        assert _rel(p, w) <= GRAD_TOL, (name, "plain", _rel(p, w))
        assert _rel(a, w) <= GRAD_TOL, (name, "autograd", _rel(a, w))


def _kernel_arithmetic(x, dt, A, B, C, D, dy, states):
    """The backward kernel's arithmetic in plain PyTorch, fp32: each (b, h)
    walks its chunks of CHUNK steps in reverse, the last zero-padded with
    dt = 0, carrying dS (N x hd, the gradient on the chunk's end state,
    0 after the last) and starting from the saved state S0 at the chunk's
    start; cum the inclusive prefix sum of dt A over the chunk; L = exp(cum_t
    - cum_s) taken only where s <= t, 0 elsewhere; G' = (C B^T) L; w_s =
    exp(cum_L - cum_s) dt_s::

      dxdt = G'^T dy + exp(cum_L - cum_s) B dS;  dx = D dy + dt dxdt
      dCB = sum_heads L dt_s (dy x^T);  dC = dCB B + exp(cum) P, P = dy S0^T
      dB = dCB^T C + w (x dS^T);  dS <- exp(cum_L) dS + (exp(cum) C)^T dy
      da_u, the gradient on a_u = dt_u A (cum's reverse prefix sum of the
        gradients on cum: +-Q, Q = G' dt_s dy x^T, to cum_t / cum_s; dy .
        y_inter; <dS, S0> exp(cum_L) + sum_s R_s to cum_L, -R_s to cum_s),
        summed as terms of one sign each:
        da_u = sum_{t >= u > s} Q[t][s] + sum_{s < u} R_s
               + exp(cum_L) <dS, S0> + sum_{t >= u} dy_t . y_inter_t
      ddt = x . dxdt + A da;  dA = dt . da

    (The gradients on cum summed first and their reverse prefix sum taken
    after cancel: at the decay case that missed dA by 8.4e-5 of max|dA|.)
    """
    b, s, nh, hd = x.shape
    n = B.shape[-1]
    L = m2.CHUNK
    xf, dtf, Bf, Cf, dyf = (t.float() for t in (x, dt, B, C, dy))
    Af, Df = A.float(), D.float()
    dS = torch.zeros(b, nh, n, hd)
    out = [torch.zeros(b, s, nh, hd), torch.zeros(b, s, nh),
           torch.zeros(nh), torch.zeros(b, s, n), torch.zeros(b, s, n),
           torch.zeros(nh)]
    tri = torch.ones(L, L, dtype=torch.bool).tril()[None, :, :, None]
    for c in range(m2.chunks(s) - 1, -1, -1):
        c0, ln = c * L, min(L, s - c * L)
        pad = lambda t: torch.cat([t[:, c0:c0 + ln], t.new_zeros(
            b, L - ln, *t.shape[2:])], 1)
        xc, dyc, Bc, Cc, dtc = pad(xf), pad(dyf), pad(Bf), pad(Cf), pad(dtf)
        S0 = states[:, c]                                # (b, nh, hd, n)
        cum = torch.cumsum(dtc * Af, 1)                  # (b, L, nh)
        ecum = torch.exp(cum)
        wl = torch.exp(cum[:, -1:] - cum)
        w = wl * dtc
        diff = cum[:, :, None] - cum[:, None]            # (b, t, s, nh)
        lm = torch.where(tri, torch.exp(torch.where(tri, diff, 0.0)), 0.0)
        gp = (Cc @ Bc.transpose(1, 2))[..., None] * lm
        m = torch.einsum("bthp,bshp->btsh", dyc, xc)
        q = gp * m * dtc[:, None]
        dcb = (lm * dtc[:, None] * m).sum(-1)
        dxdt = torch.einsum("btsh,bthp->bshp", gp, dyc) + wl[..., None] \
            * torch.einsum("bsn,bhnp->bshp", Bc, dS)
        p6 = torch.einsum("bthp,bhpn->bthn", dyc, S0)
        p7 = torch.einsum("bshp,bhnp->bshn", xc, dS)
        r = w * torch.einsum("bsn,bshn->bsh", Bc, p7)
        inter = ecum * torch.einsum("btn,bthn->bth", Cc, p6)
        # da_u = sum_{t >= u > s} Q[t][s] + sum_{s < u} R_s
        #        + exp(cum_L) <dS, S0> + sum_{t >= u} inter_t
        q_pre = torch.cumsum(q, 2) - q                   # sum_{s' < s}
        da = torch.flip(torch.cumsum(torch.flip(q_pre, [1]), 1), [1])
        da = torch.diagonal(da, dim1=1, dim2=2).transpose(1, 2)
        da = da + (torch.cumsum(r, 1) - r) + (ecum[:, -1] * torch.einsum(
            "bhnp,bhpn->bh", dS, S0))[:, None] + torch.flip(
            torch.cumsum(torch.flip(inter, [1]), 1), [1])
        grads = (Df[None, None, :, None] * dyc + dtc[..., None] * dxdt,
                 (xc * dxdt).sum(-1) + Af * da,
                 None,
                 dcb.transpose(1, 2) @ Cc
                 + torch.einsum("bsh,bshn->bsn", w, p7),
                 dcb @ Bc + torch.einsum("bth,bthn->btn", ecum, p6))
        for i, g in enumerate(grads):
            if g is not None:
                out[i][:, c0:c0 + ln] = g[:, :ln]
        out[2] += (dtc * da).sum((0, 1))
        out[5] += (dyc * xc).sum((0, 1, 3))
        dS = ecum[:, -1][..., None, None] * dS + torch.einsum(
            "bth,btn,bthp->bhnp", ecum, Cc, dyc)
    return out


@pytest.mark.parametrize("case", SCAN_CASES, ids=[
    f"b{c[0]}-s{c[1]}-nh{c[2]}-hd{c[3]}-n{c[4]}-{c[5]}" for c in SCAN_CASES])
def test_backward_kernel_arithmetic_matches_the_plain_backward(case):
    b, s, nh, hd, n, kind, _, seed = case
    args, dy = _scan_case(b, s, nh, hd, n, kind, seed)
    t_args = [torch.from_numpy(a) for a in args]
    want = tref.mamba2_scan_bwd_ref(*t_args, torch.from_numpy(dy))
    _, _, states = tref.mamba2_scan_ref(*t_args, chunk=m2.CHUNK)
    assert states.shape == (b, m2.chunks(s), nh, hd, n)
    got = _kernel_arithmetic(*t_args, torch.from_numpy(dy), states)
    for name, g, w in zip(NAMES, got, want):
        assert bool(torch.isfinite(g).all()), name
        assert _rel(g, w) <= KERNEL_TOL, (name, _rel(g, w))


def test_scan_saves_each_chunks_start_state():
    """``mamba2_scan_ref(..., chunk=64)``'s saves are the recurrence's
    state after steps 0, 64, 128, ... (zeros first), and y and the final
    state are the unsaved call's bit for bit."""
    args, _ = _scan_case(2, 150, 2, 8, 4, "test", 9)
    t_args = [torch.from_numpy(a) for a in args]
    y, final, starts = tref.mamba2_scan_ref(*t_args, chunk=m2.CHUNK)
    y0, final0 = tref.mamba2_scan_ref(*t_args)
    assert torch.equal(y, y0) and torch.equal(final, final0)
    assert torch.equal(starts[:, 0], torch.zeros_like(final))
    for c in (1, 2):
        prefix = [a[:, :64 * c] for a in t_args[:2]] + [t_args[2]] + \
            [a[:, :64 * c] for a in t_args[3:5]] + [t_args[5]]
        assert torch.equal(starts[:, c], tref.mamba2_scan_ref(*prefix)[1])


def _plain_launchers(monkeypatch):
    """``Mamba2Scan``'s two launchers swapped for the plain versions, with
    the same signatures (its kernels do not run on the CPU); counts the
    backward's calls."""
    calls = []

    def fwd(x, dt, A, B, C, D, *, save=False):
        return tref.mamba2_scan_ref(x, dt, A, B, C, D,
                                    chunk=m2.CHUNK if save else 0)

    def bwd(x, dt, A, B, C, D, states, dy):
        calls.append(states.shape)
        return tref.mamba2_scan_bwd_ref(x, dt, A, B, C, D, dy)

    monkeypatch.setattr(m2, "mamba2_scan_cuda", fwd)
    monkeypatch.setattr(m2, "mamba2_scan_bwd_cuda", bwd)
    return calls


def test_mamba2_scan_function_matches_autograd(monkeypatch):
    """The Function's gradients on all six inputs against autograd of the
    plain scan; the final state is returned but carries no gradient."""
    calls = _plain_launchers(monkeypatch)
    args, dy = _scan_case(2, 100, 3, 8, 6, "test", 5)
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    y, final = m2.Mamba2Scan.apply(*leaves)
    assert not final.requires_grad
    y.backward(torch.from_numpy(dy))
    assert calls == [(2, 2, 3, 8, 6)]
    plain = [torch.from_numpy(a).requires_grad_() for a in args]
    y2, final2 = tref.mamba2_scan_ref(*plain)
    y2.backward(torch.from_numpy(dy))
    assert torch.equal(y, y2) and torch.equal(final, final2)
    for name, a, b_ in zip(NAMES, leaves, plain):
        assert _rel(a.grad, b_.grad) <= GRAD_TOL, name


def test_mamba2_scan_function_under_recomputed_layers(monkeypatch):
    """The smoke hybrid's bottom (2 Mamba2 layers and one application of
    the shared block) with the scan on the card's route (``Mamba2Scan``
    with plain launchers, routed for CPU tensors; attention stays plain)
    and each layer recomputed in the backward pass: the same gradients as
    autograd of the plain route, and one backward call a Mamba2 layer."""
    calls = _plain_launchers(monkeypatch)
    cfg = replace(smoke_config(ARCH), dtype="float32")
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(3)
    params = model.init(gen, "cpu")["bottom"]
    tokens = torch.randint(0, cfg.vocab_size, (2, 80), generator=gen)

    def grads(route):
        leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
        monkeypatch.setattr(kernels, "_route", lambda x, name: route
                            if name == "mamba2_scan" else "cpu")
        feats, _, _ = model.bottom_apply(tree_unflatten(params, leaves),
                                         {"tokens": tokens})
        return torch.autograd.grad((feats ** 2).sum(), leaves)

    plain = grads("cpu")
    assert not calls
    card = grads("cuda")
    assert len(calls) == model.split == 2
    for a, b_ in zip(card, plain):
        scale = max(float(b_.abs().max()), 1e-30)
        assert float((a - b_).abs().max()) / scale <= GRAD_TOL


def test_mamba2_bwd_cuda_wrapper_refuses_cpu_tensors():
    args, dy = _scan_case(1, 8, 2, 8, 4, "test", 0)
    t_args = [torch.from_numpy(a) for a in args]
    with pytest.raises(ValueError, match="CUDA device"):
        m2.mamba2_scan_bwd_cuda(*t_args, torch.zeros(1, 1, 2, 8, 4),
                                torch.from_numpy(dy))


def test_mamba2_bwd_constants_match_the_kernel_sources():
    """The chunk, the padded dims and the heads a simt backward block
    takes, as the wrapper states them, are the .cu files' kL, kP and
    kHeads; the simt route's shared memory, and the mma route's threads,
    cluster, bf16 terms, packed triangle, partial set and shared memory,
    are the backward's kSmemBytes, kMmaThreads, kMmaCluster, kBwdTerms,
    kTriFloats, kSlotFloats and kMmaSmemBytes; two mma blocks fit an SM."""
    csrc = Path(m2.__file__).parents[1] / "csrc"
    fwd = (csrc / "mamba2_scan.cu").read_text()
    bwd = (csrc / "mamba2_scan_bwd.cu").read_text()
    for src in (fwd, bwd):
        assert f"constexpr int kL = {m2.CHUNK};" in src
        assert f"constexpr int kP = {m2.MAX_DIM};" in src
    assert f"constexpr int kHeads = {m2.BWD_HEADS};" in bwd
    assert f"static_assert(kSmemBytes == {m2.SIMT_SMEM}," in bwd
    assert f"constexpr int kMmaThreads = {m2.BWD_MMA_THREADS};" in bwd
    assert f"constexpr int kMmaCluster = {m2.BWD_MMA_CLUSTER};" in bwd
    assert f"constexpr int kBwdTerms = {m2.BWD_TERMS};" in bwd
    assert "constexpr int kTriTiles = 10;" in bwd
    assert "constexpr int kTriFloats = kTriTiles * 256;" in bwd
    assert m2.BWD_TRI_FLOATS == 10 * 256
    assert "constexpr int kSlotFloats = kTriFloats + 2 * kTile64;" in bwd
    assert m2.BWD_SLOT_FLOATS == m2.BWD_TRI_FLOATS + 2 * 64 * 64
    assert f"static_assert(kMmaSmemBytes == {m2.BWD_MMA_SMEM}," in bwd
    assert 2 * (m2.BWD_MMA_SMEM + 1024) <= 228 * 1024


@pytest.mark.parametrize("b", [1, 4])
def test_mamba2_bwd_plan_routes_and_refusals(b):
    """The plan, from dtype and shape alone: bf16 on the mma route (at
    Zamba2's 112 heads one block a head and batch row, 112 at B 1, in
    clusters of 8, 14 partial sets a batch row and chunk), fp32 on the simt
    route (the first design, 2 heads a block), a route forced, the cluster
    the largest power of two up to 8 dividing nh; what no route takes
    raises."""
    s, nh, hd, n = 4096, 112, 64, 64
    nc = m2.chunks(s)
    p = m2.plan_bwd(torch.bfloat16, b, s, nh, hd, n)
    assert (p.route, p.grid, p.threads, p.cluster, p.groups) == \
        ("mma", (112, b), 256, 8, 14)
    assert p.smem_bytes == m2.BWD_MMA_SMEM
    assert p.scratch_floats == b * nc * (m2.BWD_TRI_FLOATS + 14 *
                                         m2.BWD_SLOT_FLOATS) + 2 * b * nh
    # the partial sets cost fewer bytes than the simt route's partials
    simt = m2.plan_bwd(torch.bfloat16, b, s, nh, hd, n, route="simt")
    assert (simt.route, simt.grid, simt.cluster) == ("simt", (56, b), 1)
    assert p.scratch_floats < simt.scratch_floats / 2.5
    assert m2.plan_bwd(torch.float32, b, s, nh, hd, n) == simt
    for heads, cluster in ((3, 1), (6, 2), (12, 4), (16, 8), (2, 2)):
        q = m2.plan_bwd(torch.bfloat16, b, 300, heads, 32, 16)
        assert (q.cluster, q.groups, q.grid) == (cluster, heads // cluster,
                                                 (heads, b))
    for args, kw in (((torch.float16, b, s, nh, hd, n), {}),
                     ((torch.bfloat16, b, s, nh, 80, n), {}),
                     ((torch.bfloat16, b, s, nh, 20, n), {}),
                     ((torch.bfloat16, b, s, nh, hd, 12), {}),
                     ((torch.float32, b, s, nh, hd, n), {"route": "mma"}),
                     ((torch.bfloat16, b, s, nh, hd, n), {"route": "wgmma"}),
                     ((torch.bfloat16, b, 0, nh, hd, n), {})):
        with pytest.raises(ValueError, match="mamba2 scan backward"):
            m2.plan_bwd(*args, **kw)
    # hd 20 in fp32 takes the simt route
    assert m2.plan_bwd(torch.float32, b, s, nh, 20, 12).route == "simt"


# ---------------------------------------------------------------------------
# the training step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wire,tau", CASES,
                         ids=[f"{w}-tau{t}" for w, t in CASES])
def test_train_step_matches_jax(wire, tau, monkeypatch):
    """In the int8 case the port's step is handed JAX's quantized wire
    tensors (``_replay_wire``), and what it would have sent itself is held
    to them (``_assert_single_code_flips``)."""
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


def test_two_steps_of_the_phase_match_the_scanned_jax_phase():
    jcfg, tcfg = _cfgs(0.0)
    b0, b1 = _batch(jcfg, 3), _batch(jcfg, 4)
    state = _jax_state(jcfg, None, b0, seed=2)
    batches = {k: np.stack([b0[k], b1[k]]) for k in b0}
    jplan, tplan = _plans(jcfg, tcfg)
    jphase = jsteps.make_scanned_train_phase(jplan, DistContext(), lr=LR,
                                             donate_carry=False)
    jnew, jm = jax.device_get(jphase(state, batches))
    tnew, tm = steps.make_train_phase(tplan, lr=LR)(
        lm_train_state_from_numpy(state), _torch_batch(batches))
    for k in jm:
        assert tm[k].shape == (2,)
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                   err_msg=k, **PHASE_TOL)
    _assert_state_close(tnew, jnew, PHASE_TOL)


# ---------------------------------------------------------------------------
# the model's extras, the train state
# ---------------------------------------------------------------------------

def test_hybrid_extras_are_the_jax_models():
    """``bottom_apply`` hands the top the positions and a zero aux loss,
    and ``top_apply`` returns the bottom's aux loss, as in JAX (the
    training step reads both)."""
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
def test_hybrid_train_state_round_trips_bit_for_bit(dtype):
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
    b1 = port["client_bottoms"][1]
    assert len(port["client_bottoms"]) == 2 and len(b1["stack"]) == 2
    assert b1["stack"][0]["ssm"]["in_proj"].dtype == getattr(torch, dtype)
    assert b1["stack"][0]["ssm"]["A_log"].dtype == torch.float32
    assert set(b1["shared_attn"]) == {"attn_norm", "attn", "mlp_norm",
                                      "mlp"}
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


def _stack_specs(trees: list):
    """Per-layer (or per-client) trees of (shape, dtype name) stacked on a
    leading axis, as JAX stacks them."""
    if isinstance(trees[0], dict):
        return {k: _stack_specs([t[k] for t in trees]) for k in trees[0]}
    shape, name = trees[0]
    return (len(trees),) + shape, name


def _jax_layout(tree):
    """A port tree of ``train_state_shapes`` leaves, (shape, dtype), in the
    JAX layout of (shape, dtype name): each ``stack`` list stacked on a
    leading layer axis."""
    if isinstance(tree, dict):
        return {k: _stack_specs([_jax_layout(t) for t in v]) if k == "stack"
                else _jax_layout(v) for k, v in tree.items()}
    shape, dtype = tree
    return tuple(shape), str(dtype).removeprefix("torch.")


@pytest.mark.parametrize("arch", ["smoke", "full"])
def test_the_state_shapes_are_the_jax_input_specs(arch):
    """The smoke config's drawn state, and the full Zamba2-7B's shapes
    (``train_state_shapes``, nothing allocated: 81 layers split 18 + 63,
    one shared block a side), against JAX's ``input_specs``."""
    from repro.configs import get_config as jax_get_config
    from repro_torch.configs import get_config
    if arch == "smoke":
        jcfg, tcfg = _cfgs(0.0, "bfloat16")
    else:
        jcfg, tcfg = jax_get_config(ARCH), get_config(ARCH)
    jplan, tplan = _plans(jcfg, tcfg)
    want = jsteps.input_specs(jplan)["state"]
    shapes = steps.train_state_shapes(tplan)["state"]
    assert len(shapes["client_bottoms"]) == tplan.n_clients
    if arch == "smoke":
        state = lm_train_state_to_numpy(steps.init_train_state(tplan, 0,
                                                               "cpu"))
        state.pop("queue")
        got = jax.tree.map(lambda a: (a.shape, a.dtype.name), state)
    else:
        got = {k: _stack_specs([_jax_layout(t) for t in v])
               if k.endswith("bottoms") else _jax_layout(v)
               for k, v in shapes.items() if k != "queue"}
        assert len(shapes["top"]["stack"]) == 63
    for key in ("client_bottoms", "teacher_bottoms", "top", "t_top", "proj",
                "t_proj"):
        w = jax.tree.map(lambda a: (tuple(a.shape), a.dtype.name),
                         want[key])
        assert got[key] == w, key
