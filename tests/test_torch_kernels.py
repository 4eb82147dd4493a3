"""The PyTorch port's kernel modules against the JAX package, on the CPU.

On the CPU the port's wrappers take the kernels' plain versions
(``repro_torch.kernels.ref``); these are held against the JAX reference
(``repro.kernels.ref``) and against the Pallas kernels in interpret mode,
on the same numpy inputs.  The CUDA kernels themselves are held against the
same plain versions on the card by ``chip_smoke.py``.

Tolerances: the clustering loss to 1e-4 and dz to atol 5e-5 / rtol 2e-3,
as tests/test_kernels.py holds the Pallas kernel (the sum over the queue
runs in another order); the quantizer bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.wire import quantize_grad as jax_quantize_grad
from repro.kernels import ref as jref
from repro.kernels.clustering_loss import clustering_loss_pallas
from repro.kernels.quantize import quantize_dequantize_pallas
from repro_torch import kernels
from repro_torch.core.wire import quantize_grad
from repro_torch.kernels import ref as tref

CLUSTER_SHAPES = [(16, 64, 16, 4), (64, 256, 32, 10), (100, 512, 64, 7),
                  (32, 1000, 128, 4)]


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


def test_cpu_tensors_take_the_plain_versions():
    kernels.reset_launch_counts()
    x = torch.randn(3, 100)
    assert torch.equal(kernels.quantize_dequantize(x, "int8", per_slice=True),
                       tref.quantize_dequantize_ref(x, "int8",
                                                    per_slice=True))
    assert all(v == 0 for v in kernels.launch_counts().values())
    assert set(kernels.launch_counts()) == {
        "clustering_fwd", "clustering_bwd", "quantize_amax", "quantize_qdq"}


def test_wrappers_refuse_other_devices():
    x = torch.empty(4, 8, device="meta")
    with pytest.raises(ValueError, match="no route"):
        kernels.quantize_dequantize(x, "int8")
    with pytest.raises(ValueError, match="unknown wire format"):
        kernels.quantize_dequantize(torch.ones(4), "int4")
