"""The Mamba2 SSD backward's mma route, its arithmetic emulated on the CPU.

``csrc/mamba2_scan_bwd.cu``'s bf16 route (``mamba2_bwd_cb``,
``mamba2_scan_bwd_mma_kernel``, ``mamba2_bwd_epilogue``) cannot run here,
so a plain PyTorch function (``_emulated_bwd``) does what it does, chunk by
chunk in reverse, on inputs that bf16 holds exactly (x, B, C and dy, the
route's operands): C B^T once a batch row and chunk (products of bf16
values, exact in fp32); per head M^T = x dy^T (one term), L = 2^(cum_t
log2 e - cum_s log2 e) where s <= t, G'^T, Q and dCB; the products whose
other operand is fp32 (G'^T dy, B dS, dy S0^T, x dS^T, (e^cum C)^T dy, and
the epilogue's dCB B and dCB^T C) with that operand split into
``kBwdTerms`` bf16 terms, v = hi + lo, each 16-deep k-step's products
(smallest term first) summed into a zeroed tile that is then added in
fp32; the heads' dB, dC and dCB terms summed in rank order within each
cluster (the plan's: the largest of 8, 4, 2, 1 heads dividing nh), the
clusters' partial sets in order; the da sums in fp32 as terms of one sign
each (Q's sums over s < u <= t, R's exclusive prefix, y_inter's inclusive
suffix, e^cum_L <dS, S0>).

It is held to ``ref.mamba2_scan_bwd_ref`` and to ``jax.vjp`` of
``repro.models.ssm.ssd_chunked`` at chip_smoke's ``MAMBA2_BWD_TOL``,
max|err| / max|ref| within 1e-4 for each of dx, ddt, dA, dB, dC, dD
(before dx, dB and dC are rounded to bf16, which the card's check allows
for apart), at the "test" (dt in [0.01, 0.51]), "decay" (dt in [2, 4],
A = -1: cum passes exp's range within a chunk) and "model" (Zamba2's
activations: SiLU x, softplus dt, A = -1, D = 1) inputs, with nh past one
cluster and off a power of two.  One term fewer misses the tolerance (the
term test); with ``-s`` each case prints its errors."""
from importlib import import_module

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro_torch.kernels import ref as tref
from _torch_threads import one_torch_thread  # noqa: F401

m2 = import_module("repro_torch.kernels.mamba2_scan")
TOL = 1e-4                      # chip_smoke's MAMBA2_BWD_TOL
TERMS = m2.BWD_TERMS            # the .cu's kBwdTerms
LOG2E = 1.4426950408889634
NAMES = ("dx", "ddt", "dA", "dB", "dC", "dD")


def _terms(v: torch.Tensor, terms: int) -> list:
    """v as ``terms`` bf16 values (largest first) whose fp32 sum is v to
    within 2^-8 terms of |v|, as the kernel's split() forms them."""
    out = []
    for _ in range(terms):
        hi = v.bfloat16().float()
        out.append(hi)
        v = v - hi
    return out


def _product(a_terms: list, b_terms: list, acc=None):
    """sum_k a[..., m, k] b[..., k, n] as the kernel sums it: each k-step of
    16 its term products (one side has one term; smallest first) into a
    zeroed tile, added in fp32 to ``acc`` (or to 0)."""
    k = a_terms[0].shape[-1]
    pairs = [(a, b) for a in a_terms for b in b_terms][::-1]
    for k0 in range(0, k, 16):
        tile = None
        for a, b in pairs:
            t = a[..., k0:k0 + 16] @ b[..., k0:k0 + 16, :]
            tile = t if tile is None else tile + t
        acc = tile if acc is None else acc + tile
    return acc


def _cluster(nh: int) -> int:
    return next(c for c in (m2.BWD_MMA_CLUSTER, 4, 2, 1) if nh % c == 0)


def _head_sum(v: torch.Tensor, nh: int) -> torch.Tensor:
    """The heads' terms (dim 1) summed as the route sums them: within each
    cluster in rank order, then the clusters' partial sets in order."""
    cl = _cluster(nh)
    total = None
    for g0 in range(0, nh, cl):
        part = v[:, g0]
        for r in range(1, cl):
            part = part + v[:, g0 + r]
        total = part if total is None else total + part
    return total


def _emulated_bwd(x, dt, A, B, C, D, dy, states, terms: int = TERMS):
    """(dx, ddt, dA, dB, dC, dD) in fp32 as the mma route computes them,
    from bf16-exact x, B, C, dy (fp32 tensors), fp32 dt, A, D and the
    forward's chunk states (b, nc, nh, hd, N)."""
    b, s, nh, hd = x.shape
    n = B.shape[-1]
    L = m2.CHUNK
    sp = lambda v: _terms(v, terms)
    dS = torch.zeros(b, nh, n, hd)
    out = [torch.zeros(b, s, nh, hd), torch.zeros(b, s, nh),
           torch.zeros(b, nh), torch.zeros(b, s, n), torch.zeros(b, s, n),
           torch.zeros(b, nh)]
    tri = torch.ones(L, L, dtype=torch.bool).triu()          # s <= t
    before = torch.ones(L, L, dtype=torch.bool).triu(1)      # s < u
    for c in range(m2.chunks(s) - 1, -1, -1):
        c0, ln = c * L, min(L, s - c * L)
        pad = lambda t: torch.cat([t[:, c0:c0 + ln], t.new_zeros(
            b, L - ln, *t.shape[2:])], 1)
        xc = pad(x).permute(0, 2, 1, 3)                      # (b, nh, s, p)
        yc = pad(dy).permute(0, 2, 1, 3)
        dtc = pad(dt).permute(0, 2, 1)                       # (b, nh, L)
        Bc, Cc = pad(B)[:, None], pad(C)[:, None]            # (b, 1, L, n)
        S0 = states[:, c]                                    # (b, nh, p, n)
        cum = torch.cumsum(dtc * A[:, None], -1)
        cum2 = cum * LOG2E
        ecum = torch.exp(cum)
        wl = torch.exp(cum[..., -1:] - cum)
        w = wl * dtc
        eL = ecum[..., -1]
        # C B^T by the prologue (transposed: rows s, columns t), M^T
        cbt = Bc @ Cc.transpose(-1, -2)
        mt = xc @ yc.transpose(-1, -2)
        lm = torch.where(tri, torch.exp2(torch.where(
            tri, cum2[..., None, :] - cum2[..., :, None], 0.0)), 0.0)
        gt = cbt * lm                                        # G'^T [s][t]
        dm = dtc[..., :, None] * mt
        q = gt * dm
        dcbt = lm * dm
        # dxdt = e^(cum_L - cum_s) (B dS) + G'^T dy, k-step by k-step
        acc = wl[..., None] * _product([Bc.expand(-1, nh, -1, -1)], sp(dS))
        dxdt = _product(sp(gt), [yc], acc)
        dx = D[:, None, None] * yc + dtc[..., None] * dxdt
        ddt_x = (xc * dxdt).sum(-1)
        dsd = (dS * S0.transpose(-1, -2)).sum((-1, -2))
        p6 = _product([yc], sp(S0))                          # dy S0^T [t][n]
        dc_h = ecum[..., None] * p6
        p7 = _product([xc], sp(dS.transpose(-1, -2)))        # x dS^T [s][n]
        db_h = w[..., None] * p7
        at = sp((ecum[..., :, None] * Cc).transpose(-1, -2))  # (e^cum C)^T
        dS = _product(at, [yc], eL[..., None, None] * dS)
        r = (Bc * db_h).sum(-1)
        inter = (Cc * dc_h).sum(-1)
        # da_u = sum_{s < u <= t} Q[s][t] + sum_{s < u} R_s
        #        + e^cum_L <dS, S0> + sum_{t >= u} y_inter_t
        suf = torch.flip(torch.cumsum(torch.flip(q, [-1]), -1), [-1])
        daq = (suf * before).sum(-2)
        da = daq + (torch.cumsum(r, -1) - r) + (eL * dsd)[..., None] \
            + torch.flip(torch.cumsum(torch.flip(inter, [-1]), -1), [-1])
        ddt = ddt_x + A[:, None] * da
        # the epilogue: the heads' terms summed, then dCB B and dCB^T C
        dcb_sum = _head_sum(dcbt, nh)                        # dCB^T [s][t]
        dC = _product(sp(dcb_sum.transpose(-1, -2)), [Bc[:, 0]],
                      _head_sum(dc_h, nh))
        dB = _product(sp(dcb_sum), [Cc[:, 0]], _head_sum(db_h, nh))
        out[0][:, c0:c0 + ln] = dx[..., :ln, :].permute(0, 2, 1, 3)
        out[1][:, c0:c0 + ln] = ddt[..., :ln].permute(0, 2, 1)
        out[2] += (dtc * da).sum(-1)
        out[3][:, c0:c0 + ln] = dB[:, :ln]
        out[4][:, c0:c0 + ln] = dC[:, :ln]
        out[5] += (yc * xc).sum((-1, -2))
    for i in (2, 5):                                         # over batch rows
        total = out[i][0]
        for bb in range(1, b):
            total = total + out[i][bb]
        out[i] = total
    return out


def _inputs(b, s, nh, hd, n, kind, seed):
    """numpy draws: x, B, C, dy rounded to bf16 (the route's operands),
    fp32 dt, A, D."""
    rng = np.random.RandomState(seed)
    bf = lambda a: torch.from_numpy(a.astype(np.float32)).bfloat16() \
        .float().numpy()
    x = rng.randn(b, s, nh, hd)
    if kind == "model":
        x = x / (1 + np.exp(-x))
        dt = np.log1p(np.exp(rng.randn(b, s, nh)))
        A, D = -np.ones(nh), np.ones(nh)
    elif kind == "decay":
        dt = rng.rand(b, s, nh) * 2 + 2
        A, D = -np.ones(nh), rng.rand(nh)
    else:
        dt = rng.rand(b, s, nh) * 0.5 + 0.01
        A, D = -(rng.rand(nh) * 0.9 + 0.1), rng.rand(nh)
    B, C = rng.randn(b, s, n), rng.randn(b, s, n)
    dy = rng.randn(b, s, nh, hd)
    f32 = lambda a: a.astype(np.float32)
    return (bf(x), f32(dt), f32(A), bf(B), bf(C), f32(D)), bf(dy)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _errors(args, dy, terms=TERMS, jax_chunk=None) -> dict:
    t_args = [torch.from_numpy(a) for a in args]
    t_dy = torch.from_numpy(dy)
    _, _, states = tref.mamba2_scan_ref(*t_args, chunk=m2.CHUNK)
    got = _emulated_bwd(*t_args, t_dy, states, terms)
    want = tref.mamba2_scan_bwd_ref(*t_args, t_dy)
    errs = {f"{k} vs plain": _rel(g, w) for k, g, w in zip(NAMES, got, want)}
    if jax_chunk:
        _, vjp = jax.vjp(lambda *a: jssm.ssd_chunked(*a, jax_chunk),
                         *(jnp.asarray(a) for a in args))
        for k, g, w in zip(NAMES, got, vjp(jnp.asarray(dy))):
            errs[f"{k} vs jax"] = _rel(g, np.asarray(w))
    return errs


# (b, s, nh, hd, n, inputs, JAX chunk, seed): ragged S, hd and N below the
# tile, one head past a cluster of 2, nh 16 (two clusters of 8) and 3 (no
# cluster), full 64 x 64 tiles
CASES = [(2, 130, 2, 16, 16, "test", 64, 0),
         (1, 300, 3, 32, 24, "test", 4, 1),
         (2, 192, 16, 8, 8, "test", 64, 2),
         (1, 256, 2, 64, 64, "test", 64, 3),
         (2, 128, 2, 16, 16, "decay", 16, 4),
         (1, 256, 2, 64, 64, "decay", 16, 5),
         (1, 512, 4, 64, 64, "model", 64, 6)]


@pytest.mark.parametrize("case", CASES, ids=[
    f"b{c[0]}-s{c[1]}-nh{c[2]}-hd{c[3]}-n{c[4]}-{c[5]}" for c in CASES])
def test_emulated_route_matches_jax_and_the_plain_backward(case):
    b, s, nh, hd, n, kind, chunk, seed = case
    errs = _errors(*_inputs(b, s, nh, hd, n, kind, seed), jax_chunk=chunk)
    print(f"{case}: " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))
    assert max(errs.values()) <= TOL, errs


def test_one_term_fewer_misses_the_tolerance():
    """At the full tile (hd = N = 64) with Zamba2's activations, the fp32
    operands as one bf16 term miss 1e-4 of max|ref| where kBwdTerms = 2
    meet it."""
    args, dy = _inputs(1, 256, 2, 64, 64, "model", 7)
    errs = {k: max(_errors(args, dy, k).values()) for k in (TERMS, TERMS - 1)}
    print(f"max|err| / max|ref| by bf16 terms: {errs}")
    assert errs[TERMS] <= TOL < errs[TERMS - 1], errs
