"""The sLSTM backward kernel's mma route, its arithmetic emulated on the CPU.

``csrc/slstm_scan_bwd.cu``'s ``slstm_scan_bwd_mma`` cannot run here, so a
plain PyTorch function (``_emulated_bwd``) does what it does, step by step,
at the split ``slstm_scan.plan_bwd`` gives an H100 (132 SMs): each block of
U units forms its share of dh_{t-1} = R dwx_t over its 4 U columns of R
(one k-step of 16 a gate, the units past U zero), with R and dwx_t each
split into two bf16 terms, v = hi + lo, and each gate's three products (lo
hi, hi lo, hi hi) summed into a zeroed tile (a product of two bf16 values
is exact in fp32), the four gates' tiles added in fp32 in gate order; the
head's blocks' partial sums are then added in fp32 in block order (the
exchange).  The gate math is the plain backward's, its state-only terms
taken a step ahead as the kernel takes them in the barrier's shadow, with
the reciprocals of n~ and n~^2 among them (the kernel multiplies where the
plain backward divides).

It is held to ``jax.vjp`` of a ``lax.scan`` over
``repro.models.xlstm.slstm_step`` (the scan of ``apply_slstm``) with
respect to wx and the initial h, and to ``ref.slstm_scan_bwd_ref``, over 3
seeds at B 1, 2, 3 and 4, from the zero state and a given one, at the
stabilizer's tie, at chip_smoke phase 3c's tolerance: max|err| / max|ref|
within 1e-4.  Two bf16 terms and one product less miss it (the third
term's test); with ``-s`` each case prints its errors."""
from importlib import import_module
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import xlstm as jxl
from repro_torch.kernels import ref as tref
from _torch_threads import one_torch_thread  # noqa: F401

sl = import_module("repro_torch.kernels.slstm_scan")
H100 = (132, 232448)
TOL = 1e-4                     # chip_smoke's SLSTM_BWD_TOL


def _split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = x.bfloat16().float()
    return hi, (x - hi).bfloat16().float()


def _block_product(r_terms, x: torch.Tensor, terms: int) -> torch.Tensor:
    """dh (b, nh, hd) = R dwx_t as the kernel sums it.  ``r_terms``: R's hi
    and lo as (nh, hd, 4, G, U), zero past hd; ``x``: dwx_t as (b, nh, 4, G,
    U), zero past hd.  ``terms`` 3 is the kernel; 2 drops lo hi, 1 keeps hi
    hi only."""
    rh, rl = r_terms
    xh, xl = _split(x)
    tile = lambda a, v: torch.einsum("hkgcu,bhgcu->bhkgc", a, v)
    if terms == 3:                     # lo hi, then hi lo, then hi hi
        d = tile(rl, xh) + tile(rh, xl) + tile(rh, xh)
    elif terms == 2:
        d = tile(rh, xl) + tile(rh, xh)
    else:
        d = tile(rh, xh)
    part = d[..., 0, :]
    for g in range(1, 4):                          # the gates' tiles
        part = part + d[..., g, :]
    out = part[..., 0]
    for c in range(1, part.shape[-1]):             # the blocks, in order
        out = out + part[..., c]
    return out


def _emulated_bwd(r, pre, c, n, m, state, dh, terms: int = 3):
    """dwx and dh_0 as the mma route computes them."""
    b, s, _, nh, hd = pre.shape
    p = sl.plan_bwd(b, nh, hd, *H100)
    assert p.route == "mma"
    u, g = p.units, p.groups
    rp = torch.zeros(nh, hd, 4, g * u)
    rp[..., :hd] = r.view(nh, hd, 4, hd)
    r_terms = _split(rp.view(nh, hd, 4, g, u))
    if state is None:
        z = torch.zeros(b, nh, hd)
        state = (z, z, z, torch.full_like(z, tref.NEG_INF))
    c_prev, n_prev, m_prev = state[1:]
    n_min = torch.tensor(tref.N_MIN)

    def prep(t):
        zt, it, ft, ot = pre[:, t].unbind(1)
        cp, np_, mp = ((c[:, t - 1], n[:, t - 1], m[:, t - 1]) if t > 0
                       else (c_prev, n_prev, m_prev))
        n_t, m_t = n[:, t], m[:, t]
        sig = torch.sigmoid(ot)
        n_c = torch.maximum(n_t, n_min)
        tz = torch.tanh(zt)
        return dict(g_up=dh[:, t], c=c[:, t], inv_n=1.0 / n_c, sig=sig,
                    sc=sig * c[:, t], inv_nn=1.0 / (n_c * n_c),
                    tie_n=tref._tie(n_t, n_min), i_g=torch.exp(it - m_t),
                    f_g=torch.exp(ft + mp - m_t), tz=tz, dtz=1.0 - tz * tz,
                    cp=cp, np=np_, to_f=tref._tie(ft + mp, it))

    dwx = torch.empty(b, s, 4, nh, hd)
    zero = torch.zeros(b, nh, hd)
    rec, dc_c, dn_c, dm_c = zero, zero, zero, zero
    q = prep(s - 1)
    for t in range(s - 1, -1, -1):
        gg = q["g_up"] + rec
        a = gg * q["inv_n"]
        d_o = a * q["c"] * q["sig"] * (1.0 - q["sig"])
        dc = dc_c + a * q["sig"]
        dn = dn_c + (-gg * q["sc"] * q["inv_nn"]) * q["tie_n"]
        dz = dc * q["i_g"] * q["dtz"]
        di = dc * q["tz"] + dn
        df = dc * q["cp"] + dn * q["np"]
        di_t, df_t = di * q["i_g"], df * q["f_g"]
        dm = dm_c - di_t - df_t
        dmp = df_t + dm * q["to_f"]
        df_t = df_t + dm * q["to_f"]
        di_t = di_t + dm * (1.0 - q["to_f"])
        dwx[:, t] = torch.stack([dz, di_t, df_t, d_o], 1)
        dc_c, dn_c, dm_c = dc * q["f_g"], dn * q["f_g"], dmp
        x = torch.zeros(b, nh, 4, g * u)
        x[..., :hd] = dwx[:, t].transpose(1, 2)
        rec = _block_product(r_terms, x.view(b, nh, 4, g, u), terms)
        if t > 0:
            q = prep(t - 1)
    return dwx, rec


def _jax_bwd(wx, r, state, dh):
    """dwx and dh_0 from ``jax.vjp`` of the scan over ``slstm_step``."""
    b, s, _, nh, hd = wx.shape
    cfg = SimpleNamespace(d_model=nh * hd, num_heads=nh)

    def scan(wx_, h0):
        cache = jxl.SLSTMCache(h0, *(jnp.asarray(v.reshape(b, nh * hd))
                                     for v in state[1:]))
        _, hs = jax.lax.scan(lambda cr, x: jxl.slstm_step({"r": r}, cfg, cr,
                                                           x),
                             cache, wx_.reshape(b, s, -1).swapaxes(0, 1))
        return hs.swapaxes(0, 1)

    _, vjp = jax.vjp(scan, jnp.asarray(wx),
                     jnp.asarray(state[0].reshape(b, nh * hd)))
    dwx, dh0 = vjp(jnp.asarray(dh.reshape(b, s, nh * hd)))
    return np.asarray(dwx), np.asarray(dh0).reshape(b, nh, hd)


def _inputs(b, s, nh, hd, seed, with_state):
    rng = np.random.RandomState(seed)
    wx = (rng.randn(b, s, 4, nh, hd) * 0.5).astype(np.float32)
    wx[: b // 2 + 1, :, 2] += 3.0
    r = (rng.randn(nh, hd, 4 * hd) / np.sqrt(hd)).astype(np.float32)
    dh = rng.randn(b, s, nh, hd).astype(np.float32)
    if with_state:
        state = [np.tanh(rng.randn(b, nh, hd)), rng.randn(b, nh, hd),
                 rng.rand(b, nh, hd) * 2 + 0.5, rng.randn(b, nh, hd) * 2]
    else:
        z = np.zeros((b, nh, hd))
        state = [z, z, z, np.full((b, nh, hd), tref.NEG_INF)]
    return wx, r, [a.astype(np.float32) for a in state], dh


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _check(wx, r, state, dh, terms=3, jax_too=True):
    """The emulation's errors against the plain backward (and JAX)."""
    t_state = tuple(torch.from_numpy(a) for a in state)
    wx_t, r_t = torch.from_numpy(wx), torch.from_numpy(r)
    _, _, saved = tref.slstm_scan_ref(wx_t, r_t, t_state, save=True)
    got = _emulated_bwd(r_t, *saved, t_state, torch.from_numpy(dh), terms)
    want = tref.slstm_scan_bwd_ref(r_t, *saved, t_state, torch.from_numpy(dh))
    errs = {"dwx vs plain": _rel(got[0], want[0]),
            "dh0 vs plain": _rel(got[1], want[1])}
    if jax_too:
        jdwx, jdh0 = _jax_bwd(wx, r, state, dh)
        errs.update({"dwx vs jax": _rel(got[0], jdwx),
                     "dh0 vs jax": _rel(got[1], jdh0)})
    return errs


CASES = [(b, seed, seed == 2) for b in (1, 2, 3, 4) for seed in range(3)]


@pytest.mark.parametrize("b,seed,with_state", CASES)
def test_split_product_matches_jax_and_the_plain_backward(b, seed,
                                                          with_state):
    """4 heads of 128 over 40 steps: 33 blocks a head on an H100, 32 of 4
    units and their partial sums, as the kernel splits them."""
    errs = _check(*_inputs(b, 40, 4, 128, seed, with_state))
    print(f"B {b} seed {seed} state {with_state}: "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))
    assert max(errs.values()) <= TOL, errs


def test_split_product_at_the_stabilizers_tie():
    """The tie of m_1's maximum (f~_1 + m_0 = i~_1, with R = 0 so that the
    pre-activations are wx exactly) halves the gradient as JAX does."""
    b, s, nh, hd = 1, 3, 1, 4
    wx = np.zeros((b, s, 4, nh, hd), np.float32)
    wx[0, :, 0] = 0.25
    wx[0, 1, 1:3] = 0.5
    wx[0, 2, 1] = 1.5
    wx[0, :, 3] = -0.5
    r = np.zeros((nh, hd, 4 * hd), np.float32)
    state = _inputs(b, s, nh, hd, 0, False)[2]
    errs = _check(wx, r, state, np.ones((b, s, nh, hd), np.float32))
    assert max(errs["dwx vs jax"], errs["dwx vs plain"]) <= 1e-6, errs


def test_the_third_product_is_needed():
    """At xLSTM-1.3B's head width (4 heads of 512: 32 blocks of 16 units a
    head) two products (hi hi and hi lo) miss the tolerance where three
    meet it; one (bf16 alone) misses it further."""
    wx, r, state, dh = _inputs(1, 24, 4, 512, 3, False)
    errs = {k: max(_check(wx, r, state, dh, k, jax_too=False).values())
            for k in (3, 2, 1)}
    print(f"max|err| / max|ref| by products a tile: {errs}")
    assert errs[3] <= TOL < errs[2] <= errs[1], errs
