"""The PyTorch port's training round against the JAX engine, on the CPU.

Both systems start from the same state (the JAX state carried across by
``repro_torch.convert``) and take the same random draws (replayed from the
JAX engine's keys, ``engine.py:291`` and ``:400-406``).  The state is
injected so that the round does real work: the teacher's classifier is
scaled until part of the batch clears tau = 0.95, and the queue is
pre-filled, so that the clustering loss has anchors and positives.

Tolerance atol 1e-5 / rtol 1e-4 for one step and 1e-4 for a whole round
(convolutions and means sum in another order); pseudo-labels and the
confidence mask (they land in the queue's label and conf fields) exactly.
No teacher confidence lies within 1e-3 of tau, so no label sits on the
threshold."""
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.core.engine import SemiSFLSystem as JaxSystem
from repro.core.engine import make_controller as jax_make_controller
from repro.core.queue import FeatureQueue as JaxQueue
from repro.data import pipeline as jpipe
from repro.data import synthetic as jsyn
from repro_torch import convert
from repro_torch.configs import smoke_config
from repro_torch.core import losses
from repro_torch.core.engine import SemiCarry, SemiSFLSystem, make_controller
from repro_torch.data import pipeline, synthetic
from repro_torch.data.augment import weak_augment
from test_torch_modules import JaxReplaySampler
from _torch_threads import one_torch_thread  # noqa: F401

N_ACTIVE, BATCH = 2, 8
WIRES = ["fp32", "int8", "fp8", "int8+topk0.05"]
TAU_MARGIN = 1e-3


def _inject(state, cfg, seed=0):
    """Confident teacher, pre-filled queue (numpy in, JAX state out)."""
    rng = np.random.RandomState(seed)
    q, d = cfg.semisfl.queue_len, cfg.semisfl.proj_dim
    qz = rng.randn(q, d).astype(np.float32)
    qz /= np.linalg.norm(qz, axis=1, keepdims=True)
    queue = JaxQueue(z=jnp.asarray(qz),
                     label=jnp.asarray(rng.randint(0, 10, q), jnp.int32),
                     conf=jnp.asarray(rng.rand(q) > 0.3),
                     valid=jnp.asarray(rng.rand(q) > 0.1),
                     ptr=jnp.asarray(5, jnp.int32))
    teacher = jax.tree.map(lambda a: a, state.teacher)
    teacher["top"]["cls"]["w"] = teacher["top"]["cls"]["w"] * 40.0
    return state._replace(teacher=teacher, queue=queue)


def _port_state(state_j):
    s = jax.device_get(state_j)
    q = s.queue
    return convert.state_from_numpy(
        s.params, s.teacher, s.opt.mu,
        {"z": q.z, "label": q.label, "conf": q.conf, "valid": q.valid,
         "ptr": q.ptr}, int(s.round), int(s.step))


@functools.cache
def _jax_system(wire):
    """One JAX system per wire.  A jitted program that does not read the
    part of the wire that differs is taken from the system that compiled
    it first, so each program compiles once: the supervised step and the
    evaluation read no wire, and the semi step reads the quantizer formats
    but not the top-k fraction (that only reaches the aggregate)."""
    sys_j = JaxSystem(jax_smoke_config("paper-cnn"),
                      n_clients_per_round=N_ACTIVE, scan_rounds=False,
                      wire_format=wire)
    if wire != "fp32":
        base = _jax_system("fp32")
        sys_j.supervised_step = base.supervised_step
        sys_j.eval_batch = base.eval_batch
    fmt, _, topk = wire.partition("+")
    if topk:
        sys_j.semi_step = _jax_system(fmt).semi_step
    return sys_j


def _systems(wire):
    cfg_t = smoke_config("paper-cnn")
    sys_j = _jax_system(wire)
    sys_t = SemiSFLSystem(cfg_t, n_clients_per_round=N_ACTIVE,
                          wire_format=wire, device="cpu")
    state_j = _inject(sys_j.init_state(0), cfg_t)
    return sys_j, sys_t, state_j, cfg_t


def _close(got, want, atol=1e-5, rtol=1e-4):
    got, want = convert.params_to_numpy(got), jax.device_get(want)
    gl, wl = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        np.testing.assert_allclose(g, np.asarray(w), atol=atol, rtol=rtol)


def _queue_equal(got, want, atol=1e-5, rtol=1e-4):
    g = convert.queue_to_numpy(got)
    np.testing.assert_array_equal(g["label"], np.asarray(want.label))
    np.testing.assert_array_equal(g["conf"], np.asarray(want.conf))
    np.testing.assert_array_equal(g["valid"], np.asarray(want.valid))
    assert g["ptr"] == int(want.ptr)
    np.testing.assert_allclose(g["z"], np.asarray(want.z), atol=atol,
                               rtol=rtol)


def _images(rng, *lead):
    return rng.rand(*lead, 16, 16, 3).astype(np.float32)


@pytest.mark.parametrize("wire", WIRES)
def test_supervised_step_matches_jax(wire):
    sys_j, sys_t, state_j, cfg = _systems(wire)
    rng = np.random.RandomState(1)
    x, y = _images(rng, BATCH), rng.randint(0, 10, BATCH).astype(np.int32)
    new_j, loss_j = sys_j.supervised_step(state_j, (jnp.asarray(x),
                                                    jnp.asarray(y)))
    draws = JaxReplaySampler(state_j.rng, cfg).supervised(BATCH)
    new_t, loss_t = sys_t.supervised_step(
        _port_state(state_j), (torch.from_numpy(x), torch.from_numpy(y)),
        draws=draws)
    np.testing.assert_allclose(float(loss_t), float(loss_j), atol=1e-5,
                               rtol=1e-4)
    _close(new_t.params, new_j.params)
    _close(new_t.teacher, new_j.teacher)
    _close(new_t.opt, new_j.opt.mu)
    _queue_equal(new_t.queue, new_j.queue)
    assert new_t.step == int(new_j.step) == 1


def _teacher_confidence(sys_t, carry, xu, draws):
    """The teacher's max softmax per sample, through the port's own
    modules (the value the confidence mask thresholds)."""
    n, b = xu.shape[:2]
    flat = xu.reshape((n * b,) + xu.shape[2:])
    xw = weak_augment(flat, draws[0]).reshape(xu.shape)
    with torch.no_grad():
        feats = sys_t._bottoms_forward(carry.teacher_bottoms, xw)
        if sys_t.act_fmt is not None:
            from repro_torch.kernels import quantize_dequantize
            feats = quantize_dequantize(feats, sys_t.act_fmt, per_slice=True)
        logits = sys_t.model.top_apply(carry.teacher["top"],
                                       feats.reshape((-1,) + feats.shape[2:]))
    return losses.pseudo_labels(logits, 0.95)[2]


@pytest.mark.parametrize("wire", WIRES)
def test_semi_step_matches_jax(wire):
    sys_j, sys_t, state_j, cfg = _systems(wire)
    rng = np.random.RandomState(2)
    xu = _images(rng, N_ACTIVE, BATCH)
    bottoms_j, t_bottoms_j = sys_j.broadcast(state_j)
    carry_j = (bottoms_j, t_bottoms_j, state_j.params["top"],
               state_j.params["proj"], state_j.teacher, state_j.queue,
               state_j.rng, state_j.step)
    new_j, (loss_j, h_j, mask_j) = sys_j.semi_step(carry_j, jnp.asarray(xu))

    st = _port_state(state_j)
    bottoms_t, t_bottoms_t = sys_t.broadcast(st)
    carry_t = SemiCarry(bottoms=bottoms_t, teacher_bottoms=t_bottoms_t,
                        top=st.params["top"], proj=st.params["proj"],
                        teacher=st.teacher, queue=st.queue, step=st.step)
    draws = JaxReplaySampler(state_j.rng, cfg).semi(N_ACTIVE, BATCH)
    xu_t = torch.from_numpy(xu)
    conf = _teacher_confidence(sys_t, carry_t, xu_t, draws)
    assert float((conf - 0.95).abs().min()) > TAU_MARGIN
    n_conf = int((conf > 0.95).sum())
    assert 0 < n_conf < N_ACTIVE * BATCH

    new_t, (loss_t, h_t, mask_t) = sys_t.semi_step(carry_t, xu_t, draws)
    # the clustering term is live: the loss is more than the CE alone
    assert float(loss_t) > float(h_t) + 1e-3
    np.testing.assert_allclose([float(loss_t), float(h_t), float(mask_t)],
                               [float(loss_j), float(h_j), float(mask_j)],
                               atol=1e-5, rtol=1e-4)
    _close(new_t.bottoms, new_j[0])
    _close(new_t.teacher_bottoms, new_j[1])
    _close(new_t.top, new_j[2])
    _close(new_t.proj, new_j[3])
    _queue_equal(new_t.queue, new_j[5])
    assert new_t.step == int(new_j[7]) == 1


@pytest.mark.parametrize("wire", ["fp32", "int8+topk0.05"])
def test_run_round_matches_jax(wire):
    sys_j, sys_t, state_j, cfg = _systems(wire)
    cfg_j = sys_j.cfg
    ds_j = jsyn.make_image_dataset(0, n=240, image_size=16)
    ds_t = synthetic.make_image_dataset(0, n=240, image_size=16)
    parts = [np.arange(40 + 50 * i, 90 + 50 * i) for i in range(4)]
    lab_j = jpipe.Loader(ds_j, np.arange(40), BATCH, 0)
    lab_t = pipeline.Loader(ds_t, np.arange(40), BATCH, 0)
    cls_j = jpipe.client_loaders(ds_j, parts, BATCH, 1)
    cls_t = pipeline.client_loaders(ds_t, parts, BATCH, 1)
    ctrl_j = jax_make_controller(cfg_j, 40, 240)
    ctrl_t = make_controller(cfg, 40, 240)
    active = [1, 3]

    sys_t.sampler = JaxReplaySampler(state_j.rng, cfg)
    st = _port_state(state_j)
    new_j, m_j = sys_j.run_round(state_j, lab_j, cls_j, ctrl_j,
                                 active=active)
    new_t, m_t = sys_t.run_round(st, lab_t, cls_t, ctrl_t, active=active)

    np.testing.assert_allclose([m_t.f_s, m_t.f_u, m_t.mask_rate],
                               [m_j.f_s, m_j.f_u, m_j.mask_rate],
                               atol=1e-4, rtol=1e-4)
    assert m_t.k_s == m_j.k_s and m_t.mask_rate < 1.0
    _close(new_t.params, new_j.params, atol=1e-4, rtol=1e-4)
    _close(new_t.teacher, new_j.teacher, atol=1e-4, rtol=1e-4)
    _queue_equal(new_t.queue, new_j.queue, atol=1e-4, rtol=1e-4)
    assert (new_t.round, new_t.step) == (int(new_j.round), int(new_j.step))
    test = ds_t.x[200:], ds_t.y[200:]
    assert sys_t.evaluate(new_t, *test) == pytest.approx(
        sys_j.evaluate(new_j, *test), abs=1e-6)


def test_two_rounds_with_a_ks_change_match_jax():
    """Two rounds with K_s forced from 3 to 2 between them, as
    ``tests/test_scan_parity.py`` does for the reference: the port reads
    ``controller.k_s`` once a round, and the step counter (which the JAX
    package's learning-rate schedule reads) counts the steps actually
    taken."""
    sys_j, sys_t, state_j, cfg = _systems("fp32")
    ds_j = jsyn.make_image_dataset(0, n=240, image_size=16)
    ds_t = synthetic.make_image_dataset(0, n=240, image_size=16)
    parts = [np.arange(40 + 50 * i, 90 + 50 * i) for i in range(4)]
    lab_j = jpipe.Loader(ds_j, np.arange(40), BATCH, 0)
    lab_t = pipeline.Loader(ds_t, np.arange(40), BATCH, 0)
    cls_j = jpipe.client_loaders(ds_j, parts, BATCH, 1)
    cls_t = pipeline.client_loaders(ds_t, parts, BATCH, 1)
    ctrl_j = jax_make_controller(sys_j.cfg, 40, 240)
    ctrl_t = make_controller(cfg, 40, 240)
    sys_t.sampler = JaxReplaySampler(state_j.rng, cfg)
    new_j, new_t = state_j, _port_state(state_j)
    for r, active in enumerate(([1, 3], [0, 2])):
        ctrl_j.k_s = ctrl_t.k_s = 3 - r          # forced shrink: 3 then 2
        new_j, m_j = sys_j.run_round(new_j, lab_j, cls_j, ctrl_j,
                                     active=active)
        new_t, m_t = sys_t.run_round(new_t, lab_t, cls_t, ctrl_t,
                                     active=active)
        assert m_t.k_s == m_j.k_s == 3 - r and m_t.mask_rate < 1.0
        np.testing.assert_allclose([m_t.f_s, m_t.f_u, m_t.mask_rate],
                                   [m_j.f_s, m_j.f_u, m_j.mask_rate],
                                   atol=1e-4, rtol=1e-4)
    _close(new_t.params, new_j.params, atol=1e-4, rtol=1e-4)
    _close(new_t.teacher, new_j.teacher, atol=1e-4, rtol=1e-4)
    _close(new_t.opt, new_j.opt.mu, atol=1e-4, rtol=1e-4)
    _queue_equal(new_t.queue, new_j.queue, atol=1e-4, rtol=1e-4)
    k_u = cfg.semisfl.k_u
    assert new_t.step == int(new_j.step) == (3 + k_u) + (2 + k_u)
    assert new_t.round == int(new_j.round) == 2


def test_quickstart_runs_on_the_cpu():
    """``python -m repro_torch.quickstart --device cpu`` for a few rounds,
    in a process of its own with a time limit of its own."""
    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.quickstart",
                        "--device", "cpu", "--rounds", "4"], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    lines = r.stdout.splitlines()
    assert lines[-1].startswith("final teacher accuracy:")
    assert [ln.split(":")[0] for ln in lines[:-1]] == ["round  0",
                                                       "round  3"]
    assert 0.0 <= float(lines[-1].split(":")[1]) <= 1.0


def test_full_vgg16_diverges_at_the_default_rate_in_both_packages():
    """A fault of the reference that the port mirrors (ROADMAP Queue 3):
    the full paper-vgg16 (13 convs, no normalization) from its random init
    blows up under the default rate 0.02.  Both packages start from the
    JAX state and take the same draws; by the fourth supervised step of 4
    labeled images each loss has passed 1e3 or is no longer finite, while
    the first step agrees.  chip_smoke runs VGG16 at 0.002."""
    from repro.configs import get_config as jax_get_config
    from repro_torch.configs import get_config

    sys_j = JaxSystem(jax_get_config("paper-vgg16"), n_clients_per_round=2,
                      scan_rounds=False)
    sys_t = SemiSFLSystem(get_config("paper-vgg16"), n_clients_per_round=2,
                          device="cpu")
    state_j = sys_j.init_state(0)
    state_t = _port_state(state_j)
    replay = JaxReplaySampler(state_j.rng, sys_t.cfg)
    ds = synthetic.make_image_dataset(0, num_classes=100, n=16,
                                      image_size=144)
    losses_j, losses_t = [], []
    for k in range(4):
        x, y = ds.x[4 * k: 4 * k + 4], ds.y[4 * k: 4 * k + 4]
        state_j, loss_j = sys_j.supervised_step(
            state_j, (jnp.asarray(x), jnp.asarray(y)))
        state_t, loss_t = sys_t.supervised_step(
            state_t, (torch.from_numpy(x), torch.from_numpy(y)),
            draws=replay.supervised(4))
        losses_j.append(float(loss_j))
        losses_t.append(float(loss_t))
    np.testing.assert_allclose(losses_t[0], losses_j[0], rtol=1e-4)
    for seq in (losses_j, losses_t):
        assert not all(np.isfinite(seq)) or max(seq) > 1e3, seq
    print(f"vgg16 losses at rate 0.02: JAX {losses_j}, port {losses_t}")
