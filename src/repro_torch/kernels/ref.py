"""Plain PyTorch versions of the port's kernels.

The same maths as the JAX package's ``kernels/ref.py`` (``flash_attention_ref``,
``clustering_loss_ref``, ``quantize_dequantize_ref``, ``slstm_scan_ref`` and
``mamba2_scan_ref``), and the flash, sLSTM and Mamba2 backwards that the JAX
package leaves to autograd (``flash_attention_bwd_ref``,
``slstm_scan_bwd_ref``, ``mamba2_scan_bwd_ref``),
written in the most direct form:
the full (Sq, Skv) and (B, Q) logit matrices, one amax per tensor or per
leading slice, one Python step per time step of the sLSTM and Mamba2
recurrences.  The wrappers
in ``repro_torch.kernels`` take these for tensors on the CPU; the CUDA
kernels are held against them on the card."""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30
# the floor of the sLSTM normalizer n in h = sigmoid(o) c / max(n, N_MIN)
N_MIN = 1e-6

# qmax per wire format: int8 symmetric range; float8_e4m3fn finite max
QMAX = {"int8": 127.0, "fp8": 448.0}


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: int = 0) -> torch.Tensor:
    """q: (B, H, Sq, hd); k: (B, KVH, Skv, hd); v: (B, KVH, Skv, hd_v) ->
    (B, H, Sq, hd_v) in q's dtype (hd_v may differ from hd, as MLA's
    does; the scale is 1 / sqrt(hd)).  GQA by head grouping (kv head = q
    head // (H / KVH)); fp32 scores and softmax; causal is ``kv_pos <=
    q_pos``, the window ``kv_pos > q_pos - window``, both counted from 0 on
    each side.  A row that sees no key gives 0."""
    b, h, sq, hd = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    g = h // kvh
    qg = q.float().reshape(b, kvh, g, sq, hd)
    logits = torch.einsum("bkgqd,bksd->bkgqs", qg,
                          k.float()) / math.sqrt(hd)
    mask = _attn_mask(sq, skv, causal, window, q.device)
    logits = logits.masked_fill(~mask, -math.inf)
    w = torch.softmax(logits, dim=-1)
    w = torch.where(mask.any(-1)[:, None], w, 0.0)
    out = torch.einsum("bkgqs,bksd->bkgqd", w, v.float())
    return out.reshape(b, h, sq, v.shape[-1]).to(q.dtype)


def _attn_mask(sq: int, skv: int, causal: bool, window: int,
               device: torch.device) -> torch.Tensor:
    """(Sq, Skv) True where query i may see key j."""
    q_pos = torch.arange(sq, device=device)[:, None]
    kv_pos = torch.arange(skv, device=device)[None, :]
    mask = torch.ones(sq, skv, dtype=torch.bool, device=device)
    if causal:
        mask &= kv_pos <= q_pos
    if window:
        mask &= kv_pos > q_pos - window
    return mask


def _group(t: torch.Tensor, kvh: int) -> torch.Tensor:
    """(H, S, hd) of one sequence -> (KVH, G, S, hd) in fp32."""
    h, s, hd = t.shape
    return t.float().reshape(kvh, h // kvh, s, hd)


def flash_attention_lse_ref(q: torch.Tensor, k: torch.Tensor, *,
                            causal: bool = True,
                            window: int = 0) -> torch.Tensor:
    """(B, H, Sq) fp32: each row's log-sum-exp of its scaled fp32 scores
    over the keys it sees (-inf for a row that sees none), the forward
    kernels' second output.  One sequence at a time."""
    b, h, sq, hd = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    mask = _attn_mask(sq, skv, causal, window, q.device)
    out = []
    for i in range(b):
        s = torch.einsum("kgqd,ksd->kgqs", _group(q[i], kvh),
                         k[i].float()) / math.sqrt(hd)
        out.append(torch.logsumexp(s.masked_fill(~mask, -math.inf),
                                   dim=-1).reshape(h, sq))
    return torch.stack(out)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            lse: torch.Tensor, do: torch.Tensor, *,
                            causal: bool = True, window: int = 0
                            ) -> tuple[torch.Tensor, ...]:
    """The backward of :func:`flash_attention_ref` written out, from the
    forward's output ``o`` and log-sum-exp ``lse`` (B, H, Sq) and the
    output's gradient ``do``; returns (dq, dk, dv) in their inputs'
    dtypes.  With s = 1 / sqrt(hd)::

      P = exp(s q k^T - lse) on unmasked keys, else 0;  D = rowsum(dO o)
      dS = P (dO v^T - D);  dv = P^T dO;  dk = s dS^T q;  dq = s dS k

    dk and dv sum over the G query heads of each KV head.  A row that sees
    no key gets zero gradients.  fp32 throughout, one sequence at a time
    (the (H, Sq, Skv) matrices of one sequence at once)."""
    b, h, sq, hd = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    mask = _attn_mask(sq, skv, causal, window, q.device)
    dqs, dks, dvs = [], [], []
    for i in range(b):
        qf, dof, of = (_group(t[i], kvh) for t in (q, do, o))
        kf, vf = k[i].float(), v[i].float()
        s = torch.einsum("kgqd,ksd->kgqs", qf, kf) * scale
        lse_i = lse[i].float().reshape(kvh, h // kvh, sq, 1)
        p = torch.where(mask, torch.exp(s - lse_i), 0.0)
        dp = torch.einsum("kgqd,ksd->kgqs", dof, vf)
        ds = p * (dp - (dof * of).sum(-1, keepdim=True))
        dvs.append(torch.einsum("kgqs,kgqd->ksd", p, dof))
        dks.append(torch.einsum("kgqs,kgqd->ksd", ds, qf) * scale)
        dqs.append(torch.einsum("kgqs,ksd->kgqd", ds,
                                kf).reshape(h, sq, hd) * scale)
    return (torch.stack(dqs).to(q.dtype), torch.stack(dks).to(k.dtype),
            torch.stack(dvs).to(v.dtype))


def masked_contrastive(z: torch.Tensor, ref: torch.Tensor,
                       pos_mask: torch.Tensor, valid_mask: torch.Tensor,
                       temperature: float) -> torch.Tensor:
    """The shared form of Eq. (3) and Eq. (5): z (B, d) anchors (gradients
    flow), ref (R, d) references (stopped), pos_mask (B, R), valid_mask
    (R,).  The softmax denominator runs over every valid reference; anchors
    with no positive contribute 0, and the mean is over the rest."""
    zf = z.float()
    rf = ref.detach().float()
    logits = (zf @ rf.T) / temperature                       # (B, R)
    logits = torch.where(valid_mask[None, :], logits, NEG_INF)
    logp = torch.log_softmax(logits, dim=-1)
    pos = pos_mask & valid_mask[None, :]
    n_pos = pos.sum(dim=-1)
    per_anchor = -(torch.where(pos, logp, 0.0).sum(dim=-1)
                   / n_pos.clamp(min=1))
    has_pos = n_pos > 0
    denom = has_pos.sum().clamp(min=1)
    return torch.where(has_pos, per_anchor, 0.0).sum() / denom


def clustering_loss_ref(z: torch.Tensor, pseudo: torch.Tensor,
                        anchor_ok: torch.Tensor, queue_z: torch.Tensor,
                        queue_label: torch.Tensor, queue_conf: torch.Tensor,
                        queue_valid: torch.Tensor,
                        temperature: float) -> torch.Tensor:
    """Eq. (5).  Anchors are the projected student features z (B, d),
    gated by ``anchor_ok``; positives are confident same-pseudo-label queue
    entries; the softmax denominator runs over every valid queue entry.
    Differentiable with respect to z; the queue is stop-gradient."""
    pos = (pseudo[:, None] == queue_label[None, :]) & queue_conf[None, :]
    return masked_contrastive(z, queue_z, pos & anchor_ok[:, None],
                              queue_valid, temperature)


def quantize_dequantize_ref(x: torch.Tensor, fmt: str, *,
                            per_slice: bool = False) -> torch.Tensor:
    """Amax-scaled fake quantization through ``fmt`` (``int8`` or ``fp8``).

    One fp32 amax scale per tensor, or with ``per_slice`` one per leading
    slice ``x[i]``.  int8 rounds half to even into [-127, 127]; fp8 round
    trips through float8_e4m3fn.  A slice of zeros passes through exactly
    (its scale falls back to 1)."""
    if fmt not in QMAX:
        raise ValueError(f"unknown wire format {fmt!r}; "
                         f"known: {', '.join(sorted(QMAX))}")
    xf = x.float()
    return qdq_from_amax(xf, slice_amax(xf, per_slice), fmt).to(x.dtype)


def slice_amax(xf: torch.Tensor, per_slice: bool) -> torch.Tensor:
    """amax(|x|) of the whole tensor, or (S,) one per leading slice: the
    plain version of the amax kernel."""
    if per_slice:
        return xf.abs().reshape(xf.shape[0], -1).amax(dim=1)
    return xf.abs().amax()


def qdq_from_amax(xf: torch.Tensor, amax: torch.Tensor,
                  fmt: str) -> torch.Tensor:
    """The quantize-dequantize pass given the amax (a scalar, or one per
    leading slice): the plain version of the qdq kernel."""
    amax = amax.reshape(amax.shape + (1,) * (xf.dim() - amax.dim()))
    # divide by a tensor, not a Python number: on CUDA PyTorch turns a
    # division by a host scalar into a multiply by its reciprocal, 1 ulp off
    # the IEEE quotient that the JAX reference and the kernel compute
    scale = torch.where(amax > 0.0, amax / amax.new_full(amax.shape,
                                                         QMAX[fmt]), 1.0)
    if fmt == "int8":
        q = torch.clamp(torch.round(xf / scale), -QMAX["int8"], QMAX["int8"])
    else:
        q = (xf / scale).to(torch.float8_e4m3fn).float()
    return q * scale


SLSTMState = tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def slstm_scan_ref(wx: torch.Tensor, r: torch.Tensor,
                   state: Optional[SLSTMState] = None, *, save: bool = False):
    """Sequential sLSTM recurrence.  wx: (B, S, 4, nh, hd) gate inputs
    [z, i, f, o]; r: (nh, hd, 4*hd) per-head recurrent weights, gate-major
    columns [z | i | f | o], each hd wide; ``state``: the initial (h, c, n,
    m), each (B, nh, hd), or None for h = c = n = 0 and m = -1e30.

    Returns h (B, S, nh, hd) in wx's dtype and the final (h, c, n, m) in
    fp32; with ``save`` also what the backward reads, as the kernel's
    training variant writes it: (pre, c, n, m), each step's gate
    pre-activations (B, S, 4, nh, hd) and cell state (B, S, nh, hd).
    Exponential input and forget gates with the m stabilizer, as the JAX
    package's ``models/xlstm.py::slstm_step`` computes them:

      m' = max(f~ + m, i~),  i = exp(i~ - m'),  f = exp(f~ + m - m'),
      c' = f c + i tanh(z~),  n' = f n + i,  h' = sigmoid(o~) c' / max(n', 1e-6)
    """
    b, s, _, nh, hd = wx.shape
    if state is None:
        z = torch.zeros(b, nh, hd, device=wx.device)
        state = (z, z, z, torch.full_like(z, NEG_INF))
    h, c, n, m = (t.float() for t in state)
    rf = r.float()
    hs, saved = [], []
    for t in range(s):
        rec = torch.einsum("bhd,hdk->bhk", h, rf)            # (b, nh, 4 hd)
        rec = rec.reshape(b, nh, 4, hd).transpose(1, 2)       # (b, 4, nh, hd)
        pre = wx[:, t].float() + rec
        zt, it, ft, ot = pre.unbind(1)
        m_new = torch.maximum(ft + m, it)
        i_g = torch.exp(it - m_new)
        f_g = torch.exp(ft + m - m_new)
        c = f_g * c + i_g * torch.tanh(zt)
        n = f_g * n + i_g
        h = torch.sigmoid(ot) * c / torch.maximum(n, n.new_full((), N_MIN))
        m = m_new
        hs.append(h)
        if save:
            saved.append((pre, c, n, m))
    out = torch.stack(hs, 1).to(wx.dtype), (h, c, n, m)
    if save:
        return (*out, tuple(torch.stack(x, 1) for x in zip(*saved)))
    return out


def slstm_scan_bwd_ref(r: torch.Tensor, pre: torch.Tensor, c: torch.Tensor,
                       n: torch.Tensor, m: torch.Tensor,
                       state: Optional[SLSTMState], dh: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The sLSTM recurrence's backward, one Python step per time step from
    t = S - 1 down to 0: the gradient on the gate inputs wx and on the
    initial h, for the upstream gradient ``dh`` (B, S, nh, hd) on the
    forward's h.  What the forward saved: ``pre`` (B, S, 4, nh, hd), each
    step's gate pre-activations wx_t + h_{t-1} R; ``c``, ``n``, ``m`` (B,
    S, nh, hd), each step's cell state; ``state`` the initial (h, c, n,
    m), or None for zeros and m = -1e30.  All fp32.

    JAX's chain rule through ``slstm_step`` taken literally, the
    stabilizer's path included (in exact arithmetic it cancels); a tie of a
    maximum splits the gradient in halves, as ``jnp.maximum`` does.  With
    n~ = max(n_t, 1e-6), s = sigmoid(o~) and the carries dc, dn, dm from
    step t + 1 (0 at S - 1)::

      dh  = dh_t + R dwx_{t+1}             (the recurrent term)
      do~ = dh (c_t / n~) s (1 - s),  dc += dh s / n~,  dn += -dh s c_t / n~^2
      i = exp(i~ - m_t),  f = exp(f~ + m_{t-1} - m_t)
      dz~ = dc i (1 - tanh^2 z~),  di = dc tanh z~ + dn,  df = dc c_{t-1} + dn n_{t-1}
      di~ = di i,  df~ = df f,  dm = dm_carry - di i - df f, then routed through
      m_t = max(f~ + m_{t-1}, i~) to i~, or to f~ and m_{t-1}
      carries: dc f, dn f, dm_{t-1} = df f (+ the routed part)

    Returns dwx (B, S, 4, nh, hd), gate-major as wx, and dh_0 (B, nh, hd),
    the gradient on the initial h.  The gradient on R is ``slstm_dr`` of
    dwx and the h the forward read."""
    b, s, _, nh, hd = pre.shape
    if state is None:
        z = torch.zeros(b, nh, hd, device=pre.device)
        state = (z, z, z, torch.full_like(z, NEG_INF))
    _, c_prev, n_prev, m_prev = (t.float() for t in state)
    rf = r.float()
    zero = torch.zeros(b, nh, hd, device=pre.device)
    dh_rec, dc, dn, dm = zero, zero, zero, zero
    dwx = torch.empty(b, s, 4, nh, hd, device=pre.device)
    for t in range(s - 1, -1, -1):
        zt, it, ft, ot = pre[:, t].unbind(1)
        c_t, n_t, m_t = c[:, t], n[:, t], m[:, t]
        cp, np_, mp = ((c[:, t - 1], n[:, t - 1], m[:, t - 1]) if t > 0
                       else (c_prev, n_prev, m_prev))
        g = dh[:, t].float() + dh_rec
        n_c = torch.maximum(n_t, n_t.new_full((), N_MIN))
        sig = torch.sigmoid(ot)
        a = g / n_c                                  # h = (s c) / n~
        d_o = a * c_t * sig * (1.0 - sig)
        dc = dc + a * sig
        dn_c = -g * (sig * c_t) / (n_c * n_c)
        dn = dn + dn_c * _tie(n_t, n_t.new_full((), N_MIN))
        i_g = torch.exp(it - m_t)
        f_g = torch.exp(ft + mp - m_t)
        tz = torch.tanh(zt)
        dz = dc * i_g * (1.0 - tz * tz)
        di = dc * tz + dn
        df = dc * cp + dn * np_
        di_t, df_t = di * i_g, df * f_g
        dm = dm - di_t - df_t
        dmp = df_t
        to_f = _tie(ft + mp, it)                     # 1, 1/2 or 0
        df_t = df_t + dm * to_f
        dmp = dmp + dm * to_f
        di_t = di_t + dm * (1.0 - to_f)
        dwx[:, t] = torch.stack([dz, di_t, df_t, d_o], 1)
        dc, dn, dm = dc * f_g, dn * f_g, dmp
        dh_rec = torch.einsum("bhk,hdk->bhd",
                              dwx[:, t].transpose(1, 2).reshape(b, nh, 4 * hd),
                              rf)
    return dwx, dh_rec


def _tie(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The share of max(x, y)'s gradient that goes to x: 1, 0 or, at a
    tie, 1/2, as ``jnp.maximum`` splits it."""
    return torch.where(x > y, 1.0, torch.where(x < y, 0.0, 0.5))


def slstm_dr(h: torch.Tensor, h0: Optional[torch.Tensor],
             dwx: torch.Tensor) -> torch.Tensor:
    """The gradient on R (nh, hd, 4 hd): for each head the product of the
    h each step read (the forward's h (B, S, nh, hd) one step back, from
    the initial h0 (B, nh, hd), zeros if None) with that step's gate
    gradients dwx (B, S, 4, nh, hd), summed over B and S; one einsum (a
    batched product over the heads), as autograd of ``slstm_step``'s
    einsum computes it."""
    nh, hd = dwx.shape[3], dwx.shape[4]
    h0 = torch.zeros_like(h[:, 0]) if h0 is None else h0
    h_prev = torch.cat([h0[:, None].float(), h[:, :-1].float()], 1)
    return torch.einsum("bshk,bsghu->hkgu", h_prev,
                        dwx).reshape(nh, hd, 4 * hd)


def _mamba2_step(h: torch.Tensor, x_t: torch.Tensor, dt_t: torch.Tensor,
                 B_t: torch.Tensor, Af: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """One step of the SSM recurrence in fp32: h (b, nh, hd, N), x_t (b,
    nh, hd), dt_t (b, nh), B_t (b, N) -> (h_t, alpha_t = exp(dt_t A))."""
    alpha = torch.exp(dt_t * Af)
    return h * alpha[..., None, None] + torch.einsum(
        "bhd,bn->bhdn", x_t * dt_t[..., None], B_t), alpha


def mamba2_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    B: torch.Tensor, C: torch.Tensor, D: torch.Tensor, *,
                    chunk: int = 0):
    """Sequential SSM recurrence from a zero state, in fp32.

    x: (b, S, nh, hd); dt: (b, S, nh); A, D: (nh,); B, C: (b, S, N), one
    group shared by all heads::

      h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t^T;  y_t = h_t . C_t + D x_t

    Returns y (b, S, nh, hd) in x's dtype and the final h (b, nh, hd, N) in
    fp32, the layout of the model's decode cache; with ``chunk`` > 0 also
    the state at the start of every chunk of that many steps, (b, ceil(S /
    chunk), nh, hd, N) in fp32, as the kernel's training variant writes
    it (zeros for the first)."""
    b, s, nh, hd = x.shape
    n = B.shape[-1]
    Af, Df = A.float(), D.float()
    h = torch.zeros(b, nh, hd, n, device=x.device)
    ys, starts = [], []
    for t in range(s):
        if chunk and t % chunk == 0:
            starts.append(h)
        xt = x[:, t].float()                                # (b, nh, hd)
        h, _ = _mamba2_step(h, xt, dt[:, t].float(), B[:, t].float(), Af)
        y = torch.einsum("bhdn,bn->bhd", h, C[:, t].float())
        ys.append(y + Df[None, :, None] * xt)
    out = torch.stack(ys, 1).to(x.dtype), h
    if chunk:
        return (*out, torch.stack(starts, 1))
    return out


def mamba2_scan_bwd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                        B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                        dy: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The backward of :func:`mamba2_scan_ref`, one Python step per time
    step from t = S - 1 down to 0, in fp32: the gradients on (x, dt, A, B,
    C, D) for the upstream gradient ``dy`` (b, S, nh, hd) on y; the final
    state takes none (training drops it).  With alpha_t = exp(dt_t A) and
    dh (b, nh, hd, N) the gradient on h_t, 0 past the end::

      dh += dy_t C_t^T
      dx_t = D dy_t + dt_t (dh B_t)
      ddt_t = x_t . (dh B_t) + A alpha_t <dh, h_{t-1}>
      dB_t = sum_heads dt_t dh^T x_t;   dC_t = sum_heads h_t^T dy_t
      dA += sum dt_t alpha_t <dh, h_{t-1}>;   dD += sum <dy_t, x_t>
      dh <- alpha_t dh

    The states come from the forward recurrence: :func:`mamba2_scan_ref`
    keeps the state at the start of every 64 steps, and each such
    segment's states are recomputed from it before the walk back through
    it, so that no more than 64 states are held at once (all of them at
    Zamba2-7B's top, B 4 and S 4096, would be 30 GB).
    Returns dx, dB, dC in their inputs' dtypes and ddt, dA, dD in fp32."""
    b, s, nh, hd = x.shape
    n = B.shape[-1]
    xf, dtf, Bf, Cf, dyf = (t.float() for t in (x, dt, B, C, dy))
    Af, Df = A.float(), D.float()
    segment = 64
    _, _, starts = mamba2_scan_ref(x, dt, A, B, C, D, chunk=segment)
    dh = torch.zeros(b, nh, hd, n, device=x.device)
    dx = torch.empty(b, s, nh, hd, device=x.device)
    ddt = torch.empty(b, s, nh, device=x.device)
    dB = torch.empty(b, s, n, device=x.device)
    dC = torch.empty(b, s, n, device=x.device)
    dA = torch.zeros(nh, device=x.device)
    dD = torch.zeros(nh, device=x.device)
    for c in range(starts.shape[1] - 1, -1, -1):
        t0, t1 = c * segment, min(s, (c + 1) * segment)
        hs, alphas = [starts[:, c]], []
        for t in range(t0, t1):
            h, alpha = _mamba2_step(hs[-1], xf[:, t], dtf[:, t], Bf[:, t], Af)
            hs.append(h)
            alphas.append(alpha)
        for t in range(t1 - 1, t0 - 1, -1):
            h_t, h_prev, alpha = hs[t - t0 + 1], hs[t - t0], alphas[t - t0]
            dtt, xt, dyt = dtf[:, t], xf[:, t], dyf[:, t]
            dh = dh + torch.einsum("bhd,bn->bhdn", dyt, Cf[:, t])
            dhb = torch.einsum("bhdn,bn->bhd", dh, Bf[:, t])
            inner = (dh * h_prev).sum((-1, -2))                  # (b, nh)
            dx[:, t] = Df[None, :, None] * dyt + dtt[..., None] * dhb
            ddt[:, t] = (xt * dhb).sum(-1) + Af * alpha * inner
            dB[:, t] = torch.einsum("bhdn,bhd->bn", dh, xt * dtt[..., None])
            dC[:, t] = torch.einsum("bhdn,bhd->bn", h_t, dyt)
            dA = dA + (dtt * alpha * inner).sum(0)
            dD = dD + (dyt * xt).sum((0, 2))
            dh = dh * alpha[..., None, None]
    return (dx.to(x.dtype), ddt, dA, dB.to(B.dtype), dC.to(C.dtype), dD)
