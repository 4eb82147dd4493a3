"""The PyTorch port's kernel modules against the JAX package, on the CPU.

On the CPU the port's wrappers take the kernels' plain versions
(``repro_torch.kernels.ref``); these are held against the JAX reference
(``repro.kernels.ref``) and against the Pallas kernels in interpret mode,
on the same numpy inputs.  The CUDA kernels themselves are held against the
same plain versions on the card by ``chip_smoke.py``.

Tolerances: flash attention to 2e-4 in fp32 and 3e-2 in bf16, the
reference suite's ``TOLS`` (tests/test_kernels.py); the clustering loss to
1e-4 and dz to atol 5e-5 / rtol 2e-3, as tests/test_kernels.py holds the
Pallas kernel (the sum over the queue runs in another order); the quantizer
bit for bit; the sLSTM scan to atol 1e-5 / rtol 1e-4, as
tests/test_kernels.py holds the Pallas kernel (the recurrent product sums
in another order); the Mamba2 scan to 5e-5 of max|y|, as
tests/test_kernels.py holds the Pallas kernel."""
import math
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.wire import quantize_grad as jax_quantize_grad
from repro.kernels import ref as jref
from repro.kernels.clustering_loss import clustering_loss_pallas
from repro.kernels.flash_attention import flash_attention as flash_pallas
from repro.kernels.mamba2_scan import mamba2_scan as mamba2_pallas
from repro.configs import smoke_config as jax_smoke_config
from repro.kernels.quantize import quantize_dequantize_pallas
from repro.kernels.slstm_scan import slstm_scan as slstm_pallas
from repro.models import ssm as jssm
from repro.models import xlstm as jxl
from repro.models.attention import _chunked_attend
from repro_torch import kernels
from repro_torch.core.wire import quantize_grad
from repro_torch.kernels import ref as tref
from _torch_threads import one_torch_thread  # noqa: F401

FLASH_TOLS = {"float32": 2e-4, "bfloat16": 3e-2}

# tests/test_kernels.py's flash-attention sweep: (b, h, kvh, s, hd)
FLASH_SHAPES = [(1, 2, 1, 128, 64), (2, 4, 2, 256, 64), (1, 8, 8, 256, 128),
                (2, 8, 2, 384, 80), (1, 4, 4, 256, 112)]

CLUSTER_SHAPES = [(16, 64, 16, 4), (64, 256, 32, 10), (100, 512, 64, 7),
                  (32, 1000, 128, 4)]


def _flash_case(b, h, kvh, sq, skv, hd, dtype, seed):
    rng = np.random.RandomState(seed)
    arrs = (rng.randn(b, h, sq, hd), rng.randn(b, kvh, skv, hd),
            rng.randn(b, kvh, skv, hd))
    jarrs = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]
    # the same rounded values on both sides
    tarrs = [torch.from_numpy(np.array(a, np.float32)).to(
        getattr(torch, dtype)) for a in jarrs]
    return jarrs, tarrs


def _check_flash(jarrs, tarrs, dtype, *, causal=True, window=0,
                 pallas=True):
    got = kernels.flash_attention(*tarrs, causal=causal, window=window)
    assert got.dtype == tarrs[0].dtype
    got = got.float().numpy()
    tol = FLASH_TOLS[dtype]
    want = [jref.flash_attention_ref(*jarrs, causal=causal, window=window)]
    if pallas:
        want.append(flash_pallas(*jarrs, causal=causal, window=window,
                                 interpret=True))
    for w in want:
        np.testing.assert_allclose(got, np.asarray(w, np.float32), atol=tol,
                                   rtol=tol)


@pytest.mark.parametrize("b,h,kvh,s,hd", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_jax(b, h, kvh, s, hd, dtype):
    """The plain version against the JAX reference and the Pallas kernel
    in interpret mode, at tests/test_kernels.py's shapes."""
    jarrs, tarrs = _flash_case(b, h, kvh, s, s, hd, dtype, b * 31 + h)
    _check_flash(jarrs, tarrs, dtype)


@pytest.mark.parametrize("window", [64, 128, 4096])
def test_flash_attention_window_matches_jax(window):
    jarrs, tarrs = _flash_case(1, 2, 2, 256, 256, 64, "float32", window)
    _check_flash(jarrs, tarrs, "float32", window=window)


def test_flash_attention_non_causal_matches_jax():
    jarrs, tarrs = _flash_case(2, 2, 2, 128, 256, 64, "float32", 7)
    _check_flash(jarrs, tarrs, "float32", causal=False)


@pytest.mark.parametrize("sq,skv,causal,window", [
    (200, 200, True, 0), (77, 300, False, 0), (1000, 1000, True, 96)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_ragged_group5_matches_jax(sq, skv, causal, window,
                                                   dtype):
    """Qwen3-14B's group of 5 query heads per KV head, at lengths that are
    no multiple of a tile (the Pallas kernel does not take them; the CUDA
    kernel does), against the JAX reference."""
    jarrs, tarrs = _flash_case(1, 10, 2, sq, skv, 64, dtype, sq + skv)
    _check_flash(jarrs, tarrs, dtype, causal=causal, window=window,
                 pallas=False)


def test_flash_attention_fully_masked_rows_are_zero():
    """A row that sees no key gives 0, on both sides: causal over 16 keys
    with a window of 8, rows 23 and later see none (key j needs
    i - 8 < j <= i and j < 16)."""
    jarrs, tarrs = _flash_case(1, 2, 1, 64, 16, 32, "float32", 3)
    got = kernels.flash_attention(*tarrs, causal=True, window=8)
    assert float(got[:, :, 23:].abs().max()) == 0.0
    assert float(got[:, :, :23].abs().amax(dim=-1).min()) > 0.0
    _check_flash(jarrs, tarrs, "float32", window=8, pallas=False)


@pytest.mark.parametrize("s,kvh,window", [(300, 4, 0), (512, 2, 0),
                                          (512, 2, 200)])
def test_chunked_attend_matches_the_plain_version(s, kvh, window):
    """The JAX model's stand-in ``_chunked_attend`` (1 and 2 q-chunks), in
    its (B, S, H, hd) layout, against the plain version transposed to it,
    in fp32."""
    rng = np.random.RandomState(s + kvh)
    q = rng.randn(2, s, 4, 64).astype(np.float32)
    k = rng.randn(2, s, kvh, 64).astype(np.float32)
    v = rng.randn(2, s, kvh, 64).astype(np.float32)
    want = _chunked_attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=True, window=window)
    t = lambda a: torch.from_numpy(a).transpose(1, 2)
    got = tref.flash_attention_ref(t(q), t(k), t(v), causal=True,
                                   window=window).transpose(1, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=2e-4)


def test_flash_cuda_wrapper_refuses_cpu_tensors():
    from importlib import import_module
    fa = import_module("repro_torch.kernels.flash_attention")
    x = torch.zeros(1, 2, 8, 64)
    with pytest.raises(ValueError, match="CUDA device"):
        fa.flash_attention_cuda(x, x, x)


def _wgmma_arithmetic(q, k, v, *, causal=True, window=0, block=128):
    """The bf16 kernel's arithmetic (``flash_kernel_wgmma``) in plain
    PyTorch: bf16 q, k, v; fp32 scores over key tiles of the kernel's 128;
    the online softmax in base 2 with log2 e folded into the fp32 scale,
    from a running max of -1e30, masked keys at -inf; P rounded to bf16
    before P V; fp32 accumulators and l; O / l, l == 0 -> 1, in bf16."""
    b, h, sq, hd = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    c = math.log2(math.e) / math.sqrt(hd)
    qf = q.float().reshape(b, kvh, h // kvh, sq, hd)
    m = torch.full((b, kvh, h // kvh, sq, 1), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    q_pos = torch.arange(sq)[:, None]
    for k0 in range(0, skv, block):
        kt, vt = k[:, :, k0:k0 + block], v[:, :, k0:k0 + block]
        s = torch.einsum("bkgqd,bksd->bkgqs", qf, kt.float())
        kv_pos = torch.arange(k0, k0 + kt.shape[2])[None, :]
        ok = torch.ones(sq, kt.shape[2], dtype=torch.bool)
        if causal:
            ok &= kv_pos <= q_pos
        if window:
            ok &= kv_pos > q_pos - window
        s = s.masked_fill(~ok, -math.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2((m - m_new) * c)
        p = torch.exp2(s * c - m_new * c)
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = alpha * acc + torch.einsum(
            "bkgqs,bksd->bkgqd", p.to(torch.bfloat16).float(), vt.float())
        m = m_new
    out = acc / torch.where(l == 0, 1.0, l)
    return out.reshape(b, h, sq, hd).to(torch.bfloat16)


@pytest.mark.parametrize("b,h,kvh,s,hd,scale", [
    *[(*shape, 1.0) for shape in FLASH_SHAPES],
    (1, 10, 2, 256, 128, 1.0), (1, 4, 2, 256, 112, 8.0),
    (1, 4, 2, 256, 128, 8.0)])
def test_wgmma_arithmetic_matches_jax(b, h, kvh, s, hd, scale):
    """The tolerance budget of the bf16 kernel's design, before the card:
    its arithmetic (bf16 P) against the Pallas kernel in interpret mode
    and the JAX model's ``_chunked_attend`` within the bf16 tolerance, at
    tests/test_kernels.py's shapes, group 5, and a peaked softmax (q x 8,
    so that P rounds near 1) at head dims 112 and 128."""
    jarrs, tarrs = _flash_case(b, h, kvh, s, s, hd, "bfloat16",
                               b * 37 + h + hd)
    if scale != 1.0:
        jarrs[0] = (jarrs[0] * scale).astype(jnp.bfloat16)
        tarrs[0] = (tarrs[0] * scale).to(torch.bfloat16)
    got = _wgmma_arithmetic(*tarrs).float().numpy()
    tol = FLASH_TOLS["bfloat16"]
    pallas = flash_pallas(*jarrs, causal=True, window=0, interpret=True)
    t = lambda a: jnp.swapaxes(a, 1, 2)
    model = t(_chunked_attend(*map(t, jarrs), causal=True, window=0))
    for want in (pallas, model):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)


@pytest.mark.parametrize("sq,skv,causal,window", [
    (1000, 1000, True, 200), (77, 300, False, 0), (300, 77, True, 0),
    (129, 129, True, 0), (64, 16, True, 8)])
def test_wgmma_arithmetic_ragged_matches_jax(sq, skv, causal, window):
    """The same arithmetic at lengths off the 128-key tile, with a window
    across tile edges and rows that see no key (the last case: rows 23 on),
    against the JAX reference within the bf16 tolerance; rows that see no
    key are exactly 0."""
    jarrs, tarrs = _flash_case(1, 10, 2, sq, skv, 112, "bfloat16",
                               sq + 3 * skv)
    got = _wgmma_arithmetic(*tarrs, causal=causal, window=window)
    want = jref.flash_attention_ref(*jarrs, causal=causal, window=window)
    tol = FLASH_TOLS["bfloat16"]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)
    if window and skv < sq:
        assert float(got[:, :, skv + window - 1:].abs().max()) == 0.0


def _projection_views(cfg, batch=4, seq=2048):
    """q, k, v as the model hands them to the kernel: (B, S, heads, hd)
    projections viewed as (B, heads, S, hd), on the meta device."""
    hd = cfg.resolved_head_dim
    proj = lambda n: torch.empty(batch, seq, n, hd, dtype=torch.bfloat16,
                                 device="meta").transpose(1, 2)
    return (proj(cfg.num_heads), proj(cfg.num_kv_heads),
            proj(cfg.num_kv_heads))


@pytest.mark.parametrize("arch", ["qwen3-14b", "zamba2-7b"])
def test_serving_projections_fit_the_wgmma_kernel(arch):
    """The full configs' prefill projections (batch 4, S 2048) meet the
    bf16 kernel's layout rule, so the serving paths never hit its raise."""
    from importlib import import_module

    from repro_torch.configs import get_config
    fa = import_module("repro_torch.kernels.flash_attention")
    q, k, v = _projection_views(get_config(arch))
    assert q.shape[-1] in fa.HEAD_DIMS
    assert fa.wgmma_layout_problem(q, k, v) is None


def test_wgmma_layout_rule_refuses_misaligned_views():
    """A view the TMA tensor map cannot read is refused with its reason;
    the stride of a dim of size 1 is not looked at."""
    from importlib import import_module
    fa = import_module("repro_torch.kernels.flash_attention")
    bf = torch.bfloat16
    ok = torch.empty(1, 2, 64, 128, dtype=bf, device="meta")
    rows = torch.empty(1, 2, 64, 129, dtype=bf, device="meta")[..., 1:]
    assert "base address" in fa.wgmma_layout_problem(rows, ok, ok)
    rows = torch.empty(1, 2, 64, 136, dtype=bf, device="meta")[..., :128]
    assert fa.wgmma_layout_problem(rows, ok, ok) is None
    rows = torch.empty(1, 2, 64, 132, dtype=bf, device="meta")[..., :128]
    assert "sequence stride" in fa.wgmma_layout_problem(ok, rows, ok)
    flat = torch.empty(2 * 64 * 128 + 1, dtype=bf, device="meta")
    shifted = flat[1:].view(1, 2, 64, 128)
    assert "base address" in fa.wgmma_layout_problem(ok, ok, shifted)
    assert "float32" in fa.wgmma_layout_problem(ok.float(), ok, ok)
    odd = torch.empty(1, 2, 64, 48, dtype=bf, device="meta")
    assert "head dim" in fa.wgmma_layout_problem(odd, odd, odd)
    one = torch.empty_strided((1, 1, 64, 128), (1, 3, 128, 1), dtype=bf,
                              device="meta")
    assert fa.wgmma_layout_problem(one, one, one) is None


def _cluster_case(b, q, d, m, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, d).astype(np.float32),
            rng.randint(0, m, b).astype(np.int32), rng.rand(b) > 0.2,
            rng.randn(q, d).astype(np.float32),
            rng.randint(0, m, q).astype(np.int32), rng.rand(q) > 0.3,
            rng.rand(q) > 0.1)


def _torch_loss_and_dz(z, args):
    zt = torch.from_numpy(z).requires_grad_(True)
    targs = [torch.from_numpy(a) for a in args]
    loss = kernels.clustering_loss(zt, *targs, 0.1)
    (dz,) = torch.autograd.grad(loss, zt)
    return float(loss.detach()), dz.numpy()


@pytest.mark.parametrize("b,q,d,m", CLUSTER_SHAPES)
@pytest.mark.parametrize("jax_side", ["ref", "pallas_interpret"])
def test_clustering_loss_matches_jax(b, q, d, m, jax_side):
    z, *args = _cluster_case(b, q, d, m, b + q)
    jargs = [jnp.asarray(a) for a in args]
    if jax_side == "ref":
        fn = lambda zz: jref.clustering_loss_ref(zz, *jargs, 0.1)
    else:
        fn = lambda zz: clustering_loss_pallas(zz, *jargs, 0.1)
    want_loss, want_dz = jax.jit(jax.value_and_grad(fn))(jnp.asarray(z))
    loss, dz = _torch_loss_and_dz(z, args)
    assert abs(loss - float(want_loss)) < 1e-4
    np.testing.assert_allclose(dz, np.asarray(want_dz), atol=5e-5,
                               rtol=2e-3)


def test_clustering_loss_empty_queue_is_zero():
    z = torch.ones(4, 8, requires_grad=True)
    loss = kernels.clustering_loss(
        z, torch.zeros(4, dtype=torch.int32), torch.ones(4, dtype=torch.bool),
        torch.ones(16, 8), torch.zeros(16, dtype=torch.int32),
        torch.zeros(16, dtype=torch.bool), torch.zeros(16, dtype=torch.bool),
        0.1)
    assert float(loss.detach()) == 0.0
    (dz,) = torch.autograd.grad(loss, z)
    assert float(dz.abs().max()) == 0.0


# the split-and-merge edges of the clustering kernels, kind -> (b, q, d, m),
# as chip_smoke.py's CLUSTER_EDGES holds the kernels to them on the card, and
# the training round's shape ("path": 10 clients x 32 anchors, the queue of
# 2048 64-d features, 10 classes)
CLUSTER_EDGES = {"path": (320, 2048, 64, 10), "hole": (100, 1000, 30, 4),
                 "tail": (100, 1000, 64, 4), "none": (64, 256, 16, 4)}
CLUSTER_EDGE_SEEDS = {"path": 11, "hole": 20, "tail": 21, "none": 22}


def _cluster_edge_case(kind, tile_q):
    """Unit-norm features, as the path's projection head gives them, drawn
    in chip_smoke.py's order and seeds.  "hole": Q-block 1 has no valid
    entry and label 0's confident entries lie only in the ragged last
    Q-block; "tail": only the ragged last Q-block has valid entries;
    "none": no valid entry at all."""
    b, q, d, m = CLUSTER_EDGES[kind]
    rng = np.random.RandomState(CLUSTER_EDGE_SEEDS[kind])
    z = rng.randn(b, d).astype(np.float32)
    qz = rng.randn(q, d).astype(np.float32)
    z /= np.linalg.norm(z, axis=1, keepdims=True)
    qz /= np.linalg.norm(qz, axis=1, keepdims=True)
    pseudo = rng.randint(0, m, b).astype(np.int32)
    aok = rng.rand(b) > 0.2
    qlab = rng.randint(0, m, q).astype(np.int32)
    qconf, qvalid = rng.rand(q) > 0.3, rng.rand(q) > 0.1
    last = (q - 1) // tile_q * tile_q
    if kind == "hole":
        qvalid[tile_q:2 * tile_q] = False
        qconf[(qlab == 0) & (np.arange(q) < last)] = False
    elif kind == "tail":
        qvalid[:last] = False
    elif kind == "none":
        qvalid[:] = False
    return z, pseudo, aok, qz, qlab, qconf, qvalid


def _split_merge_arithmetic(z, pseudo, aok, qz, qlab, qconf, qvalid,
                            temperature, tile_q):
    """The clustering kernels' arithmetic in plain PyTorch, fp32: per
    Q-block of ``tile_q`` entries, each anchor's partial (the max of the
    block's valid logits from -1e30, the sum of exp against it, the
    positive-logit sum and count), merged in Q-block order into lse,
    pos_sum and n_pos, and the loss over anchors with positives; then dz
    for a unit cotangent, per-Q-block partials of coef @ queue_z summed in
    Q-block order, 0 for anchors without positives."""
    neg, inv_t = tref.NEG_INF, 1.0 / temperature
    b, q = z.shape[0], qz.shape[0]
    pos = ((pseudo[:, None] == qlab[None, :]) & qconf[None, :]
           & qvalid[None, :] & aok[:, None])
    blocks = [slice(q0, min(q0 + tile_q, q)) for q0 in range(0, q, tile_q)]
    logits = [(z @ qz[s].T) * inv_t for s in blocks]
    parts = []
    for s, lg in zip(blocks, logits):
        valid = qvalid[s][None, :]
        m = torch.where(valid, lg, neg).amax(dim=1)
        parts.append((m, torch.where(valid, torch.exp(lg - m[:, None]),
                                     0.0).sum(dim=1),
                      torch.where(pos[:, s], lg, 0.0).sum(dim=1),
                      pos[:, s].sum(dim=1).float()))
    big_m = torch.full((b,), neg)
    for m, *_ in parts:
        big_m = torch.maximum(big_m, m)
    l_sum, pos_sum, n_pos = (torch.zeros(b) for _ in range(3))
    for m, l, ps, pc in parts:
        l_sum = l_sum + l * torch.exp(m - big_m)
        pos_sum, n_pos = pos_sum + ps, n_pos + pc
    lse = big_m + torch.log(torch.where(l_sum == 0.0, 1.0, l_sum))
    has = n_pos > 0
    inv_np = 1.0 / torch.where(has, n_pos, 1.0)
    denom = has.sum().clamp(min=1).float()
    loss = torch.where(has, lse - pos_sum * inv_np, 0.0).sum() / denom
    dz = torch.zeros_like(z)
    for s, lg in zip(blocks, logits):
        coef = (torch.exp(lg - lse[:, None])
                - torch.where(pos[:, s], inv_np[:, None], 0.0)) / denom * inv_t
        dz = dz + torch.where(has[:, None] & qvalid[s][None, :], coef,
                              0.0) @ qz[s]
    return loss, torch.where(has[:, None], dz, 0.0)


@pytest.mark.parametrize("kind", sorted(CLUSTER_EDGES))
@pytest.mark.parametrize("jax_side", ["ref", "pallas_interpret"])
def test_clustering_split_merge_matches_jax(kind, jax_side):
    """The split-and-merge arithmetic of the clustering kernels, at their
    Q-block width, against the JAX reference and the Pallas kernel in
    interpret mode: at the training round's shape, with an empty Q-block
    and positives only in the ragged last one, with valid entries only
    there, and with none."""
    from importlib import import_module
    tile_q = import_module("repro_torch.kernels.clustering_loss").TILE_Q
    z, *args = _cluster_edge_case(kind, tile_q)
    q = args[2].shape[0]
    last = (q - 1) // tile_q * tile_q
    if kind in ("hole", "tail"):
        assert q % tile_q                           # a ragged last block
    if kind == "hole":
        assert not args[5][tile_q:2 * tile_q].any()
        zero = (args[3] == 0) & args[4] & args[5]
        assert zero.any() and not zero[:last].any()
    jargs = [jnp.asarray(a) for a in args]
    if jax_side == "ref":
        fn = lambda zz: jref.clustering_loss_ref(zz, *jargs, 0.1)
    else:
        fn = lambda zz: clustering_loss_pallas(zz, *jargs, 0.1)
    want_loss, want_dz = jax.jit(jax.value_and_grad(fn))(jnp.asarray(z))
    loss, dz = _split_merge_arithmetic(
        *[torch.from_numpy(a) for a in (z, *args)], 0.1, tile_q)
    assert abs(float(loss) - float(want_loss)) < 1e-4
    np.testing.assert_allclose(dz.numpy(), np.asarray(want_dz), atol=5e-5,
                               rtol=2e-3)
    if kind == "none":
        assert float(loss) == 0.0 and float(dz.abs().max()) == 0.0


def test_clustering_tiles_match_the_kernel_source():
    """The wrapper's TILE_B and TILE_Q, which size the kernels' scratch and
    the CPU emulation above, are the .cu's kTileB and kTileQ."""
    from importlib import import_module
    from pathlib import Path
    cl = import_module("repro_torch.kernels.clustering_loss")
    src = (Path(cl.__file__).parents[1] / "csrc" / "clustering_loss.cu"
           ).read_text()
    assert f"constexpr int kTileB = {cl.TILE_B};" in src
    assert f"constexpr int kTileQ = {cl.TILE_Q};" in src


def _quant_inputs():
    rng = np.random.RandomState(5)
    big = rng.randn(4096).astype(np.float32)
    big[7] = -np.abs(big).max() * 3          # an element exactly at -amax
    return {
        "4096": big,
        "small_1000": (rng.randn(1000) * 1e-3).astype(np.float32),
        "tiny_7x33": (rng.randn(7, 33) * 1e3).astype(np.float32),
        "zeros": np.zeros((64, 8), np.float32),
        "subnormal_scale": (rng.randn(2048) * 1e-30).astype(np.float32),
    }


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
@pytest.mark.parametrize("name", sorted(_quant_inputs()))
def test_quantize_dequantize_bit_exact(fmt, name):
    x = _quant_inputs()[name]
    got = kernels.quantize_dequantize(torch.from_numpy(x), fmt).numpy()
    # eager, as the reference is written: under jit XLA may turn the
    # amax / qmax division into a reciprocal multiply (1 ulp off)
    want_ref = np.asarray(jref.quantize_dequantize_ref(jnp.asarray(x), fmt))
    want_pl = np.asarray(quantize_dequantize_pallas(jnp.asarray(x), fmt,
                                                    interpret=True))
    assert np.array_equal(got.view(np.int32), want_ref.view(np.int32))
    assert np.array_equal(got.view(np.int32), want_pl.view(np.int32))


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_quantize_dequantize_per_slice_bit_exact(fmt):
    """One scale per leading slice == the JAX engine's vmapped calls."""
    rng = np.random.RandomState(9)
    x = rng.randn(5, 4, 6, 6, 8).astype(np.float32)
    x[1] *= 1e-3
    x[2] = 0.0
    x[3] *= 50.0
    got = kernels.quantize_dequantize(torch.from_numpy(x), fmt,
                                      per_slice=True).numpy()
    both = jax.vmap(lambda t: (
        jref.quantize_dequantize_ref(t, fmt),
        quantize_dequantize_pallas(t, fmt, interpret=True)))
    want, want_pl = (np.asarray(w) for w in both(jnp.asarray(x)))
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    assert np.array_equal(got.view(np.int32), want_pl.view(np.int32))


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_quantize_grad_cotangent_bit_exact(fmt):
    """The downlink cotangent: identity forward, per-client quantized
    backward, bit for bit the JAX engine's vmapped quantize_grad."""
    rng = np.random.RandomState(13)
    x = rng.randn(3, 4, 5, 5, 6).astype(np.float32)
    ct = (rng.randn(*x.shape) * 1e-2).astype(np.float32)
    ct[1] = 0.0
    cotangent = lambda x_, ct_: jax.vjp(
        jax.vmap(lambda t: jax_quantize_grad(t, fmt)), x_)[1](ct_)[0]
    want = cotangent(jnp.asarray(x), jnp.asarray(ct))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = quantize_grad(xt, fmt)
    assert torch.equal(y, xt)
    (got,) = torch.autograd.grad(y, xt, torch.from_numpy(ct))
    want = np.asarray(want)
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))


# an H100's limits as the quantizer's plan reads them: SMs, shared memory a
# block may opt in to, amax-pass blocks resident on an SM
CARD_LIMITS = dict(n_sm=132, smem_optin=232448, amax_per_sm=8)


def _qmod():
    from importlib import import_module
    return import_module("repro_torch.kernels.quantize")


def _cut_numel(arch, batch=32):
    """Floats of one client's cut tensor at client batch ``batch``."""
    from repro_torch.configs import get_config
    from repro_torch.models.cnn import CNNModel
    cfg = get_config(arch)
    hw, c = CNNModel(cfg).feat_shape(cfg.split_layer)
    return batch * hw * hw * c


@pytest.mark.parametrize("arch, n, route, cluster", [
    ("paper-cnn", 262144, "fused", 8), ("paper-alexnet", 131072, "fused", 4),
    ("paper-vgg13", 2359296, "two_pass", 0),
    ("paper-vgg16", 5308416, "two_pass", 0)])
def test_quantize_plan_at_the_paper_cuts(arch, n, route, cluster):
    """The route of each paper model's cut, 10 clients of batch 32: the
    training round's slices take one cluster of 8 blocks, 128 KiB each."""
    q = _qmod()
    assert _cut_numel(arch) == n
    p = q.plan(10, n, **CARD_LIMITS)
    assert (p.route, p.cluster) == (route, cluster)
    if route == "fused":
        assert p.blocks == 10 * cluster and p.parts == 0
        assert p.share_bytes == 4 * n // cluster
    else:
        assert p.parts == 105 and p.blocks == 1050
    if arch == "paper-cnn":
        assert p.share_bytes == 131072 and p.blocks == 80


@pytest.mark.parametrize("s, n, route, cluster", [
    (1, 2621440, "two_pass", 0), (3, 333, "fused", 1),
    (1, 1000, "fused", 1), (1, 7, "fused", 1), (10, 64, "fused", 1),
    (4, 57855, "fused", 1), (4, 57857, "fused", 2),
    (1, 462848, "fused", 8), (1, 462849, "two_pass", 0)])
def test_quantize_plan_routes(s, n, route, cluster):
    """Whole-tensor calls beyond a cluster take two passes, tiny and
    ragged slices one block, and the fused route ends at 8 blocks of
    231,424 bytes (462,848 floats a slice)."""
    p = _qmod().plan(s, n, **CARD_LIMITS)
    assert (p.route, p.cluster) == (route, cluster)
    if route == "two_pass":
        assert p.parts == min(-(-n // (256 * 16)), 1056 // s)


def _share_bytes(n, c):
    """n / c floats, rounded up to 16 bytes."""
    return -(-(-(-n // c)) // 4) * 16


@pytest.mark.parametrize("s", [1, 10, 200])
def test_quantize_plan_keeps_its_rules(s):
    q = _qmod()
    for n in [1, 3, 4, 5, 333, 4096, 57856, 57857, 115712, 115713, 262144,
              462848, 462849, 2359296, 5308416]:
        p = q.plan(s, n, **CARD_LIMITS)
        if p.route == "fused":
            assert p.cluster in q.CLUSTER_SIZES and p.cluster <= 8
            assert p.share_bytes % 16 == 0 and p.share_bytes // 4 * p.cluster >= n
            assert p.smem_bytes == p.share_bytes + q.SCRATCH_BYTES <= 232448
            # the smallest cluster that holds the slice
            smaller = [c for c in q.CLUSTER_SIZES if c < p.cluster]
            assert all(_share_bytes(n, c) + q.SCRATCH_BYTES > 232448
                       for c in smaller)
        else:
            assert _share_bytes(n, 8) + q.SCRATCH_BYTES > 232448
            assert 1 <= p.parts and p.blocks == s * p.parts
            assert p.blocks <= max(s, 132 * 8)
    with pytest.raises(ValueError, match="no plan"):
        q.plan(0, 10, **CARD_LIMITS)


def _route_arithmetic(x, fmt, p):
    """The CPU emulation of a route's arithmetic on (S, n): the maxima of
    |x| over the plan's split of each slice (the fused route's C shares of
    share_bytes / 4 floats; the amax pass's grid-stride blocks over float4s,
    the ragged tail in block 0), their max, then the round trip."""
    q = _qmod()
    s, n = p.slices, p.n
    xs = x.reshape(s, n)
    idx = torch.arange(n)
    if p.route == "fused":
        block = idx // (p.share_bytes // 4)
        n_blocks = p.cluster
    else:
        block = (idx // 4 // q.THREADS) % p.parts
        block[idx >= n // 4 * 4] = 0
        n_blocks = p.parts
    assert int(block.max()) < n_blocks
    part = torch.zeros(s, n_blocks).scatter_reduce(
        1, block.expand(s, n), xs.abs(), "amax")
    amax = part.amax(dim=1, keepdim=True)
    scale = torch.where(amax > 0, amax / torch.full_like(amax,
                                                          tref.QMAX[fmt]),
                        torch.ones_like(amax))
    v = xs / scale
    if fmt == "int8":
        qv = torch.clamp(torch.round(v), -127.0, 127.0)
    else:
        qv = v.to(torch.float8_e4m3fn).to(torch.float32)
    return (qv * scale).reshape(x.shape), amax.reshape(-1)


def _route_inputs():
    rng = np.random.RandomState(17)
    big = rng.randn(10, 32, 16, 16, 32).astype(np.float32)
    big[1] *= 1e-3
    big[2] = 0.0                                   # an all-zero slice
    big[3] *= 50.0
    big[4].flat[123] = np.abs(big[4]).max() * 2    # x == amax in a share
    big[4].flat[200000] = -big[4].flat[123]
    return {"round": big,
            "ragged": rng.randn(3, 333).astype(np.float32),
            "zeros": np.zeros((4, 64), np.float32)}


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
@pytest.mark.parametrize("name", ["round", "ragged", "zeros"])
@pytest.mark.parametrize("route", ["fused", "fused_small", "two_pass",
                                   "two_pass_small"])
def test_quantize_route_arithmetic_bit_exact(fmt, name, route):
    """Each route's split of a slice, emulated on the CPU, gives the bits of
    the JAX reference and of the Pallas kernel in interpret mode, vmapped
    per slice: the training round's shape (a slice of zeros, one of small
    values, one at x == amax), ragged slices of 333 and all zeros.  "small"
    plans for a card whose shared memory holds a quarter of a slice a block
    (4 shares; the ragged slices' last one short) or with 2 SMs (1 partial
    a slice)."""
    q = _qmod()
    x = _route_inputs()[name]
    s, n = x.shape[0], x[0].size
    if route == "fused":
        p = q.fused_plan(s, n, CARD_LIMITS["smem_optin"])
    elif route == "fused_small":
        p = q.fused_plan(s, n, q.SCRATCH_BYTES + _share_bytes(n, 4))
    elif route == "two_pass":
        p = q.two_pass_plan(s, n, CARD_LIMITS["n_sm"],
                            CARD_LIMITS["amax_per_sm"])
    else:
        p = q.two_pass_plan(s, n, 2, 1)
    if (route, name) == ("fused", "round"):
        assert p.cluster == 8
    if route == "fused_small":
        assert p.cluster == 4
    if (route, name) == ("fused_small", "ragged"):
        assert 3 * p.share_bytes // 4 + 81 == n      # the last share short
    got, amax = _route_arithmetic(torch.from_numpy(x), fmt, p)
    assert np.array_equal(amax.numpy(), np.abs(x.reshape(s, n)).max(axis=1))
    both = jax.vmap(lambda t: (
        jref.quantize_dequantize_ref(t, fmt),
        quantize_dequantize_pallas(t, fmt, interpret=True)))
    want, want_pl = (np.asarray(w) for w in both(jnp.asarray(x)))
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))
    assert np.array_equal(got.numpy().view(np.int32), want_pl.view(np.int32))


def test_quantize_constants_match_the_kernel_source():
    """The plan's block size, chunk size, largest cluster and scratch, and
    the amax pass's threads and unroll, are the .cu's."""
    from pathlib import Path
    q = _qmod()
    src = (Path(q.__file__).parents[1] / "csrc" / "quantize.cu").read_text()
    for name, value in (("kThreads", q.THREADS), ("kUnroll", q.UNROLL),
                        ("kFusedThreads", q.FUSED_THREADS),
                        ("kChunkBytes", q.CHUNK_BYTES),
                        ("kMaxCluster", q.MAX_CLUSTER),
                        ("kScratchBytes", q.SCRATCH_BYTES)):
        assert f"constexpr int {name} = {value};" in src



def test_quantize_cuda_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA device"):
        _qmod().quantize_dequantize_cuda(torch.ones(4, 8), "int8")


def test_cpu_tensors_take_the_plain_versions():
    kernels.reset_launch_counts()
    x = torch.randn(3, 100)
    assert torch.equal(kernels.quantize_dequantize(x, "int8", per_slice=True),
                       tref.quantize_dequantize_ref(x, "int8",
                                                    per_slice=True))
    q = torch.randn(1, 4, 16, 32)
    k = torch.randn(1, 2, 16, 32)
    assert torch.equal(kernels.flash_attention(q, k, k),
                       tref.flash_attention_ref(q, k, k))
    wx, r = torch.randn(2, 8, 4, 2, 16), torch.randn(2, 16, 64) * 0.25
    got, want = kernels.slstm_scan(wx, r), tref.slstm_scan_ref(wx, r)
    assert torch.equal(got[0], want[0])
    assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))
    ssd = [torch.randn(2, 8, 2, 16), torch.rand(2, 8, 2), -torch.rand(2),
           torch.randn(2, 8, 4), torch.randn(2, 8, 4), torch.rand(2)]
    got, want = kernels.mamba2_scan(*ssd), tref.mamba2_scan_ref(*ssd)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert all(v == 0 for v in kernels.launch_counts().values())
    assert set(kernels.launch_counts()) == {
        "clustering_fwd", "clustering_bwd", "quantize_fused",
        "quantize_amax", "quantize_qdq", "flash_attention", "flash_attention_wgmma",
        "flash_attention_bwd", "flash_attention_bwd_wgmma", "slstm_scan",
        "slstm_scan_bwd", "mamba2_scan", "mamba2_scan_mma", "mamba2_scan_bwd",
        "mamba2_scan_bwd_mma"}


def test_wrappers_refuse_other_devices():
    x = torch.empty(4, 8, device="meta")
    with pytest.raises(ValueError, match="no route"):
        kernels.quantize_dequantize(x, "int8")
    with pytest.raises(ValueError, match="unknown wire format"):
        kernels.quantize_dequantize(torch.ones(4), "int4")


# ---------------------------------------------------------------------------
# sLSTM scan
# ---------------------------------------------------------------------------

SLSTM_TOL = dict(atol=1e-5, rtol=1e-4)

# tests/test_kernels.py's sLSTM sweep: (b, s, nh, hd); nh >= 2, so that a
# mix-up of heads and gates shows
SLSTM_SHAPES = [(2, 64, 2, 32), (1, 128, 4, 64), (2, 96, 2, 64)]


def _slstm_case(b, s, nh, hd, seed):
    rng = np.random.RandomState(seed)
    wx = (rng.randn(b, s, 4, nh, hd) * 0.5).astype(np.float32)
    r = (rng.randn(nh, hd, 4 * hd) / np.sqrt(hd)).astype(np.float32)
    return wx, r


def _slstm_state(b, nh, hd, seed):
    """A non-fresh (h, c, n, m): what some earlier steps could leave."""
    rng = np.random.RandomState(seed)
    h = np.tanh(rng.randn(b, nh, hd)).astype(np.float32)
    c = rng.randn(b, nh, hd).astype(np.float32)
    n = (rng.rand(b, nh, hd) * 2 + 0.5).astype(np.float32)
    m = (rng.randn(b, nh, hd) * 2).astype(np.float32)
    return h, c, n, m


@pytest.mark.parametrize("b,s,nh,hd", SLSTM_SHAPES)
def test_slstm_scan_matches_jax(b, s, nh, hd):
    """The plain version from zeros against the JAX reference and the
    Pallas kernel in interpret mode, at tests/test_kernels.py's shapes."""
    wx, r = _slstm_case(b, s, nh, hd, s)
    got, _ = kernels.slstm_scan(torch.from_numpy(wx), torch.from_numpy(r))
    want_ref = jref.slstm_scan_ref(jnp.asarray(wx), jnp.asarray(r))
    want_pl = slstm_pallas(jnp.asarray(wx), jnp.asarray(r), interpret=True)
    assert got.shape == (b, s, nh, hd) and got.dtype == torch.float32
    for w in (want_ref, want_pl):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **SLSTM_TOL)


def _jax_slstm_cfg(nh, hd):
    return replace(jax_smoke_config("xlstm-1.3b"), d_model=nh * hd,
                   num_heads=nh, num_kv_heads=nh, head_dim=hd)


@pytest.mark.parametrize("s", [1, 37])
def test_slstm_scan_state_matches_jax_steps(s):
    """From a non-fresh state, h at every step and the final (h, c, n, m)
    against a JAX loop of ``models/xlstm.py::slstm_step``, whose state is
    (B, d) with head-major units and whose wx is (B, 4d) [z | i | f | o]."""
    b, nh, hd = 2, 2, 32
    wx, r = _slstm_case(b, s, nh, hd, 5 + s)
    state = _slstm_state(b, nh, hd, 6)
    jcfg = _jax_slstm_cfg(nh, hd)
    carry = jxl.SLSTMCache(*(jnp.asarray(a.reshape(b, nh * hd))
                             for a in state))
    step = jax.jit(lambda c, w: jxl.slstm_step({"r": jnp.asarray(r)}, jcfg,
                                               c, w))
    want_h = []
    for t in range(s):
        carry, h = step(carry, jnp.asarray(wx[:, t].reshape(b, 4 * nh * hd)))
        want_h.append(np.asarray(h).reshape(b, nh, hd))
    got_h, got_state = kernels.slstm_scan(
        torch.from_numpy(wx), torch.from_numpy(r),
        tuple(torch.from_numpy(a) for a in state))
    np.testing.assert_allclose(got_h.numpy(), np.stack(want_h, 1),
                               **SLSTM_TOL)
    for g, w in zip(got_state, carry):
        np.testing.assert_allclose(g.numpy(),
                                   np.asarray(w).reshape(b, nh, hd),
                                   **SLSTM_TOL)


def test_slstm_scan_matches_apply_slstm_prefill():
    """The JAX model's prefill recurrence, ``apply_slstm(mode="prefill")``
    from a non-fresh cache, against the plain version fed the same wx (the
    model's fp32 input projection of the same x) in its (B, S, 4, nh, hd)
    view: h and the final cache."""
    b, s, nh, hd = 2, 48, 2, 32
    d = nh * hd
    jcfg = _jax_slstm_cfg(nh, hd)
    rng = np.random.RandomState(8)
    x = rng.randn(b, s, d).astype(np.float32)
    w = (rng.randn(d, 4 * d) / np.sqrt(d)).astype(np.float32)
    bias = np.concatenate([np.zeros(2 * d), np.full(d, 3.0),
                           np.zeros(d)]).astype(np.float32)
    r = (rng.randn(nh, hd, 4 * hd) / np.sqrt(hd)).astype(np.float32)
    state = _slstm_state(b, nh, hd, 9)
    p = {"w": jnp.asarray(w), "b": jnp.asarray(bias), "r": jnp.asarray(r)}
    cache = jxl.SLSTMCache(*(jnp.asarray(a.reshape(b, d)) for a in state))
    want_h, want_cache = jax.jit(lambda xx, cc: jxl.apply_slstm(
        p, jcfg, xx, mode="prefill", cache=cc))(jnp.asarray(x), cache)
    wx = torch.from_numpy(x) @ torch.from_numpy(w) + torch.from_numpy(bias)
    got_h, got_state = kernels.slstm_scan(
        wx.view(b, s, 4, nh, hd), torch.from_numpy(r),
        tuple(torch.from_numpy(a) for a in state))
    np.testing.assert_allclose(got_h.reshape(b, s, d).numpy(),
                               np.asarray(want_h), **SLSTM_TOL)
    for g, w_ in zip(got_state, want_cache):
        np.testing.assert_allclose(g.reshape(b, d).numpy(), np.asarray(w_),
                                   **SLSTM_TOL)


# an H100's 132 SMs and the 232,448 bytes of shared memory a block may
# take, the limits the kernel's wrapper reads from the card
H100 = (132, 232448)


def _slstm_plan(*args, **kw):
    from importlib import import_module
    return import_module("repro_torch.kernels.slstm_scan").plan(*args, **kw)


def test_slstm_plan_at_the_serve_shape():
    """xLSTM-1.3B's prefill (B 4, 4 heads of 512): 32 blocks of 16 units a
    head, 128 blocks on the 132 SMs, each holding 128 KiB of R."""
    p = _slstm_plan(4, 4, 512, *H100)
    assert (p.units, p.groups, p.blocks) == (16, 32, 128)
    assert p.r_bytes == 128 * 1024 == 512 * 4 * 16 * 4
    assert (p.slices, p.threads) == (16, 256)
    assert p.r_bytes < p.smem_bytes <= H100[1]


@pytest.mark.parametrize("b,nh,hd,units,groups,slices", [
    (2, 2, 32, 1, 32, 8),              # tests/test_kernels.py's shapes
    (4, 4, 64, 2, 32, 16),             # the xLSTM smoke model
    (1, 1, 4, 1, 4, 1)])
def test_slstm_plan_small_shapes(b, nh, hd, units, groups, slices):
    p = _slstm_plan(b, nh, hd, *H100)
    assert (p.units, p.groups, p.slices) == (units, groups, slices)
    assert p.blocks == nh * groups <= H100[0]
    assert p.threads == units * slices


@pytest.mark.parametrize("nh,hd,units,groups", [
    (8, 40, 3, 14), (6, 96, 5, 20), (8, 35, 3, 12), (4, 70, 3, 24)])
def test_slstm_plan_ragged_groups(nh, hd, units, groups):
    """hd need not be a multiple of the units a block: the last group of a
    head holds the rest (chip_smoke's SLSTM_EDGE_CASES run the first
    three on the card)."""
    p = _slstm_plan(2, nh, hd, *H100)
    assert (p.units, p.groups) == (units, groups)
    assert (p.groups - 1) * p.units < hd < p.groups * p.units


def test_slstm_plan_refuses_what_does_not_fit_on_chip():
    """4 heads of 1024 units hold 64 MiB of R, over what 132 blocks of
    227 KB can hold: the refusal names the bytes and the capacity.  At 4
    heads and B 4 the last hd that fits is 627."""
    with pytest.raises(ValueError, match=r"67108864 bytes.*232448 bytes"):
        _slstm_plan(4, 4, 1024, *H100)
    assert _slstm_plan(4, 4, 627, *H100).blocks == 132
    with pytest.raises(ValueError, match="cannot be held on chip"):
        _slstm_plan(4, 4, 628, *H100)
    with pytest.raises(ValueError, match="cannot be held on chip"):
        _slstm_plan(1, 133, 64, *H100)          # more heads than SMs


@pytest.mark.parametrize("nh", [1, 2, 4, 8])
def test_slstm_plan_keeps_its_rules(nh):
    """Over hd 1..700 at B 1 to 9: every plan the wrapper may launch has at
    most one block an SM, at most 256 threads, a power-of-two count of
    slices up to 16, groups that cover hd with the last one not empty, and
    shared memory within the card's; past the first refusal nothing fits."""
    for b in (1, 4, 9):
        refused = False
        for hd in range(1, 701):
            try:
                p = _slstm_plan(b, nh, hd, *H100)
            except ValueError:
                refused = True
                continue
            assert not refused, (b, nh, hd)
            assert p.blocks == nh * p.groups <= H100[0]
            assert p.threads == p.units * p.slices <= 256
            assert p.slices in (1, 2, 4, 8, 16)
            assert (p.groups - 1) * p.units < hd <= p.groups * p.units
            assert p.r_bytes == hd * 4 * p.units * 4 <= p.smem_bytes
            assert p.smem_bytes <= H100[1]


def test_slstm_cuda_wrapper_refuses_cpu_tensors():
    from importlib import import_module
    sl = import_module("repro_torch.kernels.slstm_scan")
    with pytest.raises(ValueError, match="CUDA device"):
        sl.slstm_scan_cuda(torch.zeros(1, 4, 4, 2, 32),
                           torch.zeros(2, 32, 128))


# ---------------------------------------------------------------------------
# Mamba2 (SSD) scan
# ---------------------------------------------------------------------------

# tests/test_kernels.py's Mamba2 sweep (b, s, nh, hd, n), S = 1 and a
# ragged S = 300 (the Pallas kernel halves its chunk of 128 down to 4)
MAMBA2_SHAPES = [(1, 64, 2, 32, 16), (2, 128, 4, 64, 64),
                 (1, 256, 2, 64, 64), (2, 1, 2, 32, 16), (2, 300, 2, 32, 16)]
# as tests/test_kernels.py holds the Pallas kernel: |err| / max|y|
MAMBA2_TOL = 5e-5


def _mamba2_case(b, s, nh, hd, n, seed):
    """tests/test_kernels.py's inputs, in fp32 numpy."""
    rng = np.random.RandomState(seed)
    f = lambda a: np.asarray(a, np.float32)
    return (f(rng.randn(b, s, nh, hd)), f(rng.rand(b, s, nh) * 0.5 + 0.01),
            f(-(rng.rand(nh) * 0.9 + 0.1)), f(rng.randn(b, s, n)),
            f(rng.randn(b, s, n)), f(rng.rand(nh)))


def _rel_close(got, want, tol=MAMBA2_TOL):
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max()) + 1e-6
    np.testing.assert_allclose(np.asarray(got, np.float32) / scale,
                               want / scale, atol=tol, rtol=0)


@pytest.mark.parametrize("b,s,nh,hd,n", MAMBA2_SHAPES)
def test_mamba2_scan_matches_jax(b, s, nh, hd, n):
    """The plain version from zeros against the JAX reference and the
    Pallas kernel in interpret mode."""
    arrs = _mamba2_case(b, s, nh, hd, n, s)
    got, state = kernels.mamba2_scan(*(torch.from_numpy(a) for a in arrs))
    assert got.shape == (b, s, nh, hd) and got.dtype == torch.float32
    assert state.shape == (b, nh, hd, n) and state.dtype == torch.float32
    jarrs = [jnp.asarray(a) for a in arrs]
    for want in (jref.mamba2_scan_ref(*jarrs),
                 mamba2_pallas(*jarrs, interpret=True)):
        _rel_close(got.numpy(), want)


@pytest.mark.parametrize("s", [1, 64, 300])
def test_mamba2_scan_state_matches_the_jax_model(s):
    """The final state against ``models/ssm.py::_final_state`` (the second
    scan the JAX model's prefill runs for decode, chunk 256 halved until it
    divides S) and y against ``ssd_chunked``, the model's prefill scan."""
    b, nh, hd, n = 2, 2, 32, 16
    arrs = _mamba2_case(b, s, nh, hd, n, 40 + s)
    got_y, got_state = kernels.mamba2_scan(*(torch.from_numpy(a)
                                             for a in arrs))
    x, dt, A, B, C, D = (jnp.asarray(a) for a in arrs)
    _rel_close(got_state.numpy(), jssm._final_state(x, dt, A, B))
    _rel_close(got_y.numpy(), jssm.ssd_chunked(x, dt, A, B, C, D, 256))


def test_mamba2_scan_reads_strided_bf16_views():
    """x, B and C as the model hands them over: bf16 slices of one (B, S,
    d_in + 2N) conv output.  The plain version computes in fp32 and rounds
    y once to bf16, as the JAX reference does on the same rounded values."""
    b, s, nh, hd, n = 2, 48, 2, 32, 16
    d_in = nh * hd
    rng = np.random.RandomState(7)
    conv = torch.from_numpy(rng.randn(b, s, d_in + 2 * n).astype(
        np.float32)).to(torch.bfloat16)
    x = conv[..., :d_in].reshape(b, s, nh, hd)
    B, C = conv[..., d_in:d_in + n], conv[..., d_in + n:]
    assert not x.is_contiguous() and not B.is_contiguous()
    dt = torch.from_numpy((rng.rand(b, s, nh) * 0.5 + 0.01).astype(
        np.float32))
    A = torch.from_numpy(-(rng.rand(nh) * 0.9 + 0.1).astype(np.float32))
    D = torch.from_numpy(rng.rand(nh).astype(np.float32))
    got, state = kernels.mamba2_scan(x, dt, A, B, C, D)
    assert got.dtype == torch.bfloat16
    want, want_state = tref.mamba2_scan_ref(
        x.contiguous(), dt, A, B.contiguous(), C.contiguous(), D)
    assert torch.equal(got, want) and torch.equal(state, want_state)
    jy = jref.mamba2_scan_ref(*(jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16) if t.dtype == torch.bfloat16 else
        jnp.asarray(t.numpy()) for t in (x, dt, A, B, C, D)))
    # one bf16 rounding of y on each side: at most one bf16 ulp apart
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jy, np.float32), rtol=2 ** -7,
                               atol=1e-6)


def test_mamba2_cuda_wrapper_refuses_cpu_tensors():
    from importlib import import_module
    m2 = import_module("repro_torch.kernels.mamba2_scan")
    arrs = [torch.from_numpy(a) for a in _mamba2_case(1, 4, 2, 32, 16, 0)]
    with pytest.raises(ValueError, match="CUDA device"):
        m2.mamba2_scan_cuda(*arrs)


def _bf16_terms(v, terms):
    """v (fp32) as ``terms`` bf16-representable fp32 tensors summing to it
    to within 2^-8 ``terms`` relative: hi = bf16(v), then bf16 of what is
    left, as the kernel's split() does."""
    out = []
    for _ in range(terms):
        t = v.to(torch.bfloat16).float()
        out.append(t)
        v = v - t
    return out


def _mamba2_mma_arithmetic(x, dt, A, B, C, D, terms=None):
    """The bf16 kernel's arithmetic in plain PyTorch: chunks of 64 steps,
    the last zero-padded with dt = 0; cum the inclusive prefix sum of dt A,
    kept in base 2 (cum log2 e, every exponent an exp2); C B^T exact (bf16
    inputs, fp32 sums); G = C B^T exp(cum_t - cum_s) dt_s taken only where
    s <= t (0 elsewhere, never a 0/1 mask on an exponent), so the 16 x 16
    tiles above the diagonal hold 0 and add nothing; y = e^cum_t C S + G x
    + D x with S and G split into ``terms`` bf16 terms; S^T <- e^cum_L S^T
    + (x w)^T B with x w split, w_s = exp(cum_L - cum_s) dt_s; fp32
    accumulators, y rounded once to x's dtype."""
    from importlib import import_module
    m2 = import_module("repro_torch.kernels.mamba2_scan")
    terms = terms or m2.TERMS
    b, s, nh, hd = x.shape
    n = B.shape[-1]
    L = m2.CHUNK
    xf, Bf, Cf, dtf = x.float(), B.float(), C.float(), dt.float()
    state_t = torch.zeros(b, nh, hd, n)                  # S^T per (b, h)
    tri = torch.ones(L, L, dtype=torch.bool).tril()[None, :, :, None]
    ys = []
    for c0 in range(0, s, L):
        ln = min(L, s - c0)
        pad = lambda t: torch.cat([t, t.new_zeros(b, L - ln,
                                                  *t.shape[2:])], 1)
        xc, Bc, Cc = pad(xf[:, c0:c0 + ln]), pad(Bf[:, c0:c0 + ln]), \
            pad(Cf[:, c0:c0 + ln])
        dtc = pad(dtf[:, c0:c0 + ln])                     # (b, L, nh)
        cum = torch.cumsum(dtc * A.float(), 1) * math.log2(math.e)
        cb = Cc @ Bc.transpose(1, 2)                      # (b, t, s)
        diff = cum[:, :, None, :] - cum[:, None, :, :]    # (b, t, s, nh)
        dec = torch.where(tri, torch.exp2(torch.where(tri, diff, 0.0)), 0.0)
        g = cb[..., None] * dec * dtc[:, None, :, :]
        y = torch.zeros(b, L, nh, hd)
        for st in _bf16_terms(state_t, terms):
            y += torch.einsum("btn,bhpn->bthp", Cc, st)
        y *= torch.exp2(cum)[..., None]
        for gt in _bf16_terms(g, terms):
            y += torch.einsum("btsh,bshp->bthp", gt, xc)
        y += D.float()[:, None] * xc
        ys.append(y[:, :ln])
        w = torch.exp2(cum[:, -1:] - cum) * dtc           # (b, L, nh)
        state_t = torch.exp2(cum[:, -1])[..., None, None] * state_t
        for xw in _bf16_terms(xc * w[..., None], terms):
            state_t = state_t + torch.einsum("bshp,bsn->bhpn", xw, Bc)
    return torch.cat(ys, 1).to(x.dtype), state_t


def _mamba2_bf16_case(b, s, nh, hd, n, kind, seed):
    """x, B, C as bf16 slices of one (b, s, nh hd + 2n) tensor and fp32
    dt, A, D, as chip_smoke draws them: "test" tests/test_kernels.py's
    distributions; "decay" dt in [2, 4] and A = -1, so that a 64-step
    chunk's decay passes exp's fp32 range; "model" the conv output at
    random init (SiLU of N(0, 1), dt = softplus of N(0, 1), A = -1, D =
    1)."""
    rng = np.random.RandomState(seed)
    d_in = nh * hd
    conv = rng.randn(b, s, d_in + 2 * n)
    if kind == "model":
        conv = conv / (1 + np.exp(-conv))
        dt = np.log1p(np.exp(rng.randn(b, s, nh)))
        A, D = -np.ones(nh), np.ones(nh)
    elif kind == "decay":
        dt = rng.rand(b, s, nh) * 2 + 2
        A, D = -np.ones(nh), rng.rand(nh)
    else:
        dt = rng.rand(b, s, nh) * 0.5 + 0.01
        A, D = -(rng.rand(nh) * 0.9 + 0.1), rng.rand(nh)
    conv = torch.from_numpy(conv.astype(np.float32)).to(torch.bfloat16)
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    return (conv[..., :d_in].reshape(b, s, nh, hd), f(dt), f(A),
            conv[..., d_in:d_in + n], conv[..., d_in + n:], f(D))


def _mamba2_bf16_close(got_y, got_state, want_y, want_state):
    """chip_smoke's rule for the bf16 kernel: y within MAMBA2_TOL of
    max|y| plus one bf16 ulp (2^-7) of |y|, the state within MAMBA2_TOL of
    max|state| at rtol 0."""
    if want_y is not None:
        w = np.asarray(want_y, np.float32)
        np.testing.assert_allclose(got_y.float().numpy(), w, rtol=2 ** -7,
                                   atol=MAMBA2_TOL * float(np.abs(w).max()))
    if want_state is not None:
        _rel_close(got_state.numpy(), want_state)


@pytest.mark.parametrize("b,s,nh,hd,n,kind", [
    *[(*shape, "test") for shape in MAMBA2_SHAPES],
    (2, 333, 3, 64, 64, "test"), (2, 256, 2, 64, 64, "decay"),
    (2, 300, 4, 64, 64, "model"), (1, 333, 2, 32, 16, "model")])
def test_mamba2_mma_arithmetic_matches_jax(b, s, nh, hd, n, kind):
    """The tolerance budget of the bf16 kernel's design, before the card:
    its arithmetic (2 bf16 terms per fp32 operand, chunk 64, the causal
    tiles only) against the JAX reference, the Pallas kernel in interpret
    mode, and the JAX model's ``ssd_chunked`` and ``_final_state``, on the
    same bf16 x, B and C, at tests/test_kernels.py's shapes, S = 1, ragged
    S 300 and 333, where a chunk's decay passes exp's fp32 range, and on
    the model's conv-output distribution."""
    args = _mamba2_bf16_case(b, s, nh, hd, n, kind, 11 * s + nh)
    got_y, got_state = _mamba2_mma_arithmetic(*args)
    assert got_y.dtype == torch.bfloat16 and got_state.shape == (b, nh, hd,
                                                                 n)
    jx, jdt, jA, jB, jC, jD = (
        jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
        if t.dtype == torch.bfloat16 else jnp.asarray(t.numpy())
        for t in args)
    f32 = lambda a: a.astype(jnp.float32)
    _mamba2_bf16_close(got_y, got_state,
                       jref.mamba2_scan_ref(jx, jdt, jA, jB, jC, jD),
                       jssm._final_state(f32(jx), jdt, jA, f32(jB)))
    _mamba2_bf16_close(got_y, None,
                       mamba2_pallas(jx, jdt, jA, jB, jC, jD,
                                     interpret=True), None)
    _mamba2_bf16_close(got_y, None,
                       jssm.ssd_chunked(f32(jx), jdt, jA, f32(jB), f32(jC),
                                        jD, 256), None)


@pytest.mark.parametrize("terms", [1, 2, 3])
@pytest.mark.parametrize("shape", [(2, 256, 4, 64, 64),
                                   (4, 2048, 112, 64, 64)])
def test_mamba2_mma_term_count(shape, terms):
    """Why the kernel splits each fp32 operand into two bf16 terms: one
    misses the state's tolerance (about 2e-3 of max|state|), two and three
    meet it, against the plain version on the model's distribution, at a
    small shape and at Zamba2-7B's prefill shape.  Prints the errors (run
    with -s)."""
    args = _mamba2_bf16_case(*shape, "model", 5)
    got_y, got_state = _mamba2_mma_arithmetic(*args, terms=terms)
    want_y, want_state = tref.mamba2_scan_ref(*args)
    wy = want_y.float()
    err_y = float(((got_y.float() - wy).abs() - 2 ** -7 * wy.abs()).max()
                  / wy.abs().max())
    err = float((got_state - want_state).abs().max()
                / want_state.abs().max())
    print(f"x {shape[:4]} N {shape[4]}, {terms} term(s): y beyond 2^-7 |y| "
          f"{err_y:.3g} of max|y|, state {err:.3g} of max|state| "
          f"(tol {MAMBA2_TOL})")
    assert (err <= MAMBA2_TOL) == (terms >= 2), err
    if terms >= 2:
        _mamba2_bf16_close(got_y, got_state, want_y.float().numpy(),
                           want_state.numpy())


def test_mma_constants_match_the_kernel_source():
    """The wrapper's CHUNK and TERMS, which the CPU emulation above uses,
    are the .cu's kL and kTerms."""
    from importlib import import_module
    from pathlib import Path
    m2 = import_module("repro_torch.kernels.mamba2_scan")
    src = (Path(m2.__file__).parents[1] / "csrc" / "mamba2_scan.cu"
           ).read_text()
    assert f"constexpr int kL = {m2.CHUNK};" in src
    assert f"constexpr int kTerms = {m2.TERMS};" in src


@pytest.mark.parametrize("batch,seq", [(4, 2048), (2, 256), (1, 1)])
def test_serving_conv_views_fit_the_mma_kernel(batch, seq):
    """Zamba2-7B's prefill views, as the model's ``scan_views`` cuts them
    from its conv output (x's time stride 7296 x 2 = 14,592 B, B at
    14,336 B, C at 14,464 B), meet the bf16 kernel's layout rule, so the
    serving path never hits its raise."""
    from importlib import import_module

    from repro_torch.configs import get_config
    from repro_torch.models.ssm import _dims, scan_views
    m2 = import_module("repro_torch.kernels.mamba2_scan")
    cfg = get_config("zamba2-7b")
    conv = torch.empty(batch, seq, _dims(cfg)[3], dtype=torch.bfloat16,
                       device="meta")
    x, B, C = scan_views(conv, cfg)
    assert B.storage_offset() * 2 == 14336
    assert C.storage_offset() * 2 == 14464
    assert seq == 1 or x.stride(1) * 2 == 14592
    assert m2.mma_layout_problem(x, B, C) is None


def test_mma_layout_rule_refuses_misaligned_views():
    """A view the 16-byte cp.async loads cannot read is refused with its
    reason; the stride of a dim of size 1 is not looked at."""
    from importlib import import_module
    m2 = import_module("repro_torch.kernels.mamba2_scan")
    bf = torch.bfloat16
    meta = lambda *shape: torch.empty(*shape, dtype=bf, device="meta")
    x, bc = meta(2, 64, 4, 64), meta(2, 64, 64)
    assert m2.mma_layout_problem(x, bc, bc) is None
    assert "base address" in m2.mma_layout_problem(
        meta(2, 64, 4 * 64 + 1)[..., 1:].reshape(2, 64, 4, 64), bc, bc)
    assert "base address" in m2.mma_layout_problem(
        x, meta(2, 64, 65)[..., 1:], bc)
    assert "time stride" in m2.mma_layout_problem(
        x, bc, meta(2, 64, 68)[..., :64])
    assert "head stride" in m2.mma_layout_problem(
        meta(2, 64, 4, 68)[..., :64], bc, bc)
    assert m2.mma_layout_problem(meta(2, 64, 4, 72)[..., :64], bc, bc) \
        is None
    assert "multiple of 8" in m2.mma_layout_problem(
        meta(2, 64, 4, 36), bc, bc)
    assert "multiple of 8" in m2.mma_layout_problem(x, meta(2, 64, 12), bc)
    assert "float32" in m2.mma_layout_problem(x.float(), bc, bc)
    one = torch.empty_strided((1, 1, 1, 64), (3, 5, 7, 1), dtype=bf,
                              device="meta")
    flat = torch.empty_strided((1, 1, 64), (3, 5, 1), dtype=bf,
                               device="meta")
    assert m2.mma_layout_problem(one, flat, flat) is None
