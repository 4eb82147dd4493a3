"""The port's scanned round executor (``repro_torch/core/scan.py``) on the
CPU, where a phase is a loop over the same step that the card captures as
a CUDA graph.

  * the port's scanned ``run_round`` against the JAX engine's scanned one
    (``scan_rounds=True``) for every wire, from one injected state with the
    JAX draws replayed, and across a K_s change (3 then 2), at atol/rtol
    1e-4 as ``tests/test_torch_engine.py``'s rounds; the queue's labels,
    confidence, validity and ring pointer exactly;
  * the port's scanned and eager executors equal bit for bit over two
    rounds with a K_s change, with the clustering term live (tau 0), with
    a wire, and with FC dropout masks among the stacked draws;
  * ``scan_phase`` against a Python loop, as the JAX package's
    ``tests/test_scan_parity.py`` holds its own;
  * the queue's device ring pointer against JAX's across a wrap."""
import functools
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.core import queue as jqueue
from repro.core.engine import SemiSFLSystem as JaxSystem
from repro.core.engine import make_controller as jax_make_controller
from repro.data import pipeline as jpipe
from repro.data import synthetic as jsyn
from repro_torch import convert
from repro_torch.configs import smoke_config
from repro_torch.core import queue as tqueue
from repro_torch.core.engine import SemiSFLSystem, make_controller
from repro_torch.core.scan import scan_phase
from repro_torch.data import pipeline, synthetic
from repro_torch.tree import tree_leaves
from test_torch_engine import (BATCH, N_ACTIVE, WIRES, _close, _inject,
                               _port_state, _queue_equal)
from test_torch_modules import JaxReplaySampler
from _torch_threads import one_torch_thread  # noqa: F401

TOL = dict(atol=1e-4, rtol=1e-4)


@functools.cache
def _jax_scanned(wire):
    """One scanned JAX system per wire; a phase program that does not read
    the part of the wire that differs is taken from the system that
    compiled it first (the supervised phase and the evaluation read no
    wire; the semi phase reads the quantizer format, not the top-k
    fraction)."""
    sys_j = JaxSystem(jax_smoke_config("paper-cnn"),
                      n_clients_per_round=N_ACTIVE, scan_rounds=True,
                      wire_format=wire)
    if wire != "fp32":
        base = _jax_scanned("fp32")
        sys_j.supervised_phase = base.supervised_phase
        sys_j.eval_batch = base.eval_batch
    fmt, _, topk = wire.partition("+")
    if topk:
        sys_j.semi_phase = _jax_scanned(fmt).semi_phase
    return sys_j


def _rigs():
    """The same data, loaders and controller for each package."""
    out = []
    for syn, pipe in ((jsyn, jpipe), (synthetic, pipeline)):
        ds = syn.make_image_dataset(0, n=240, image_size=16)
        parts = [np.arange(40 + 50 * i, 90 + 50 * i) for i in range(4)]
        out.append((pipe.Loader(ds, np.arange(40), BATCH, 0),
                    pipe.client_loaders(ds, parts, BATCH, 1)))
    return out


def _assert_rounds_match(new_t, new_j, m_t, m_j):
    np.testing.assert_allclose([m_t.f_s, m_t.f_u, m_t.mask_rate],
                               [m_j.f_s, m_j.f_u, m_j.mask_rate], **TOL)
    assert m_t.k_s == m_j.k_s and m_t.mask_rate < 1.0
    _close(new_t.params, new_j.params, **TOL)
    _close(new_t.teacher, new_j.teacher, **TOL)
    _close(new_t.opt, new_j.opt.mu, **TOL)
    _queue_equal(new_t.queue, new_j.queue, **TOL)
    assert (new_t.round, int(new_t.step)) == (int(new_j.round),
                                             int(new_j.step))


@pytest.mark.parametrize("wire", WIRES)
def test_scanned_round_matches_jax_scanned_round(wire):
    sys_j = _jax_scanned(wire)
    cfg = smoke_config("paper-cnn")
    sys_t = SemiSFLSystem(cfg, n_clients_per_round=N_ACTIVE,
                          wire_format=wire, device="cpu")
    assert sys_t.scan_rounds
    state_j = _inject(sys_j.init_state(0), cfg)
    (lab_j, cls_j), (lab_t, cls_t) = _rigs()
    sys_t.sampler = JaxReplaySampler(state_j.rng, cfg)
    st = _port_state(state_j)
    new_t, m_t = sys_t.run_round(st, lab_t, cls_t,
                                 make_controller(cfg, 40, 240),
                                 active=[1, 3])
    new_j, m_j = sys_j.run_round(state_j, lab_j, cls_j,
                                 jax_make_controller(sys_j.cfg, 40, 240),
                                 active=[1, 3])
    _assert_rounds_match(new_t, new_j, m_t, m_j)


def test_scanned_rounds_match_jax_across_a_ks_change():
    """Two rounds with K_s forced from 3 to 2, as the JAX package's
    ``tests/test_scan_parity.py`` does: the second phase is shorter than
    the first, and the step counter counts the steps taken."""
    sys_j = _jax_scanned("fp32")
    cfg = smoke_config("paper-cnn")
    sys_t = SemiSFLSystem(cfg, n_clients_per_round=N_ACTIVE, device="cpu")
    state_j = _inject(sys_j.init_state(0), cfg)
    (lab_j, cls_j), (lab_t, cls_t) = _rigs()
    ctrl_j = jax_make_controller(sys_j.cfg, 40, 240)
    ctrl_t = make_controller(cfg, 40, 240)
    sys_t.sampler = JaxReplaySampler(state_j.rng, cfg)
    new_j, new_t = state_j, _port_state(state_j)
    for r, active in enumerate(([1, 3], [0, 2])):
        ctrl_j.k_s = ctrl_t.k_s = 3 - r
        new_t, m_t = sys_t.run_round(new_t, lab_t, cls_t, ctrl_t,
                                     active=active)
        new_j, m_j = sys_j.run_round(new_j, lab_j, cls_j, ctrl_j,
                                     active=active)
        _assert_rounds_match(new_t, new_j, m_t, m_j)
    k_u = cfg.semisfl.k_u
    assert int(new_t.step) == (3 + k_u) + (2 + k_u)


def _tiny(arch="paper-cnn"):
    """tau 0, so that pseudo-labels pass from the first round and the
    clustering term and its queue writes are live."""
    cfg = smoke_config(arch)
    return replace(cfg, image_size=8, semisfl=replace(
        cfg.semisfl, k_s_init=3, k_u=2, queue_len=32,
        confidence_threshold=0.0))


def _run_port(cfg, wire, *, scan_rounds, prefetch=False, rounds=2,
              active=None):
    """``rounds`` rounds from init_state(0), K_s forced down by one in the
    last; returns (state, metrics, system, labeled loader, client
    loaders)."""
    ds = synthetic.make_image_dataset(0, n=260, image_size=cfg.image_size)
    lab = pipeline.Loader(ds, np.arange(40), 8, 0)
    parts = [np.arange(40 + 55 * i, 95 + 55 * i) for i in range(4)]
    cls = pipeline.client_loaders(ds, parts, 8, 1)
    sys_ = SemiSFLSystem(cfg, n_clients_per_round=3, wire_format=wire,
                         scan_rounds=scan_rounds, prefetch=prefetch,
                         device="cpu")
    state = sys_.init_state(0)
    ctrl = make_controller(cfg, 40, 260)
    metrics = []
    for r in range(rounds):
        if r == rounds - 1:
            ctrl.k_s -= 1
        state, m = sys_.run_round(
            state, lab, cls, ctrl,
            active=None if active is None else active(r))
        metrics.append((m.f_s, m.f_u, m.mask_rate, m.k_s))
    return state, metrics, sys_, lab, cls


def assert_states_equal(a, b):
    """Every leaf of two SemiSFL states equal bit for bit."""
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y)
        else:
            assert x == y


@pytest.mark.parametrize("arch,wire", [("paper-cnn", "fp32"),
                                       ("paper-cnn", "int8+topk0.05"),
                                       ("paper-alexnet", "fp8")])
def test_scanned_and_eager_executors_equal_bit_for_bit(arch, wire):
    cfg = _tiny(arch)
    s_scan, m_scan, sys_scan, *_ = _run_port(cfg, wire, scan_rounds=True)
    s_eager, m_eager, *_ = _run_port(cfg, wire, scan_rounds=False)
    assert m_scan == m_eager
    assert [m[3] for m in m_scan] == [3, 2]
    assert m_scan[-1][2] < 1.0          # some anchors took part
    assert_states_equal(s_scan, s_eager)
    assert int(s_scan.step) == (3 + 2) + (2 + 2)
    # the CPU loop keeps no captured graph
    assert not sys_scan.supervised_phase.graphs


def test_scan_phase_matches_a_python_loop():
    """A phase of K steps == K calls of the step, threading the carry,
    with the outputs stacked; None inputs pass through as None."""
    def step(carry, inp):
        x, none = inp
        assert none is None
        c = {"a": carry["a"] * 0.5 + x.sum(), "n": carry["n"]}
        return c, (c["a"], x.max())

    phase = scan_phase(step)
    xs = torch.arange(12.0).reshape(4, 3)
    carry, (a, m) = phase({"a": torch.tensor(1.0), "n": 7}, (xs, None))
    c, want = {"a": torch.tensor(1.0), "n": 7}, []
    for k in range(4):
        c, out = step(c, (xs[k], None))
        want.append(out)
    assert torch.equal(a, torch.stack([o[0] for o in want]))
    assert torch.equal(m, torch.stack([o[1] for o in want]))
    assert torch.equal(carry["a"], c["a"]) and carry["n"] == 7
    with pytest.raises(ValueError, match="unequal K"):
        phase(carry, (xs, xs[:2]))


def test_queue_ptr_is_a_device_tensor_matching_jax_across_a_wrap():
    """Batches that fill the ring, wrap it and overrun it (B > Q): the
    port's ``()`` int32 pointer and every field equal JAX's."""
    rng = np.random.RandomState(0)
    qlen, d = 10, 4
    qj = jqueue.init_queue(qlen, d)
    qt = tqueue.init_queue(qlen, d, "cpu")
    assert qt.ptr.shape == () and qt.ptr.dtype == torch.int32
    for b in (3, 6, 4, 13, 1):
        z = rng.randn(b, d).astype(np.float32)
        lab = rng.randint(0, 5, b).astype(np.int32)
        conf = rng.rand(b) > 0.5
        qj = jqueue.enqueue(qj, jnp.asarray(z), jnp.asarray(lab),
                            jnp.asarray(conf))
        qt = tqueue.enqueue(qt, torch.from_numpy(z), torch.from_numpy(lab),
                            torch.from_numpy(conf))
        got = convert.queue_to_numpy(qt)
        assert got["ptr"] == int(qj.ptr)
        for f in ("z", "label", "conf", "valid"):
            np.testing.assert_array_equal(got[f],
                                          np.asarray(getattr(qj, f)))
    back = convert.queue_from_numpy(**convert.queue_to_numpy(qt))
    assert back.ptr.dtype == torch.int32 and int(back.ptr) == int(qj.ptr)


def test_a_system_and_its_phases_go_without_the_cycle_collector():
    """The phases reach their system through a weak reference, so that a
    dropped system frees its captured graphs (and their memory on the
    card) at once, not at the next cycle collection."""
    import gc
    import weakref

    sys_ = SemiSFLSystem(_tiny(), device="cpu")
    alive = weakref.ref(sys_), weakref.ref(sys_.supervised_phase)
    gc.disable()
    try:
        del sys_
        assert alive[0]() is None and alive[1]() is None
    finally:
        gc.enable()
