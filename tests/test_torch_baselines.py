"""The PyTorch port's baselines against the JAX package's, on the CPU.

Supervised-only, SemiFL, FedSwitch and FedMatch (``core/baselines.py``),
each on the smoke paper-cnn and the smoke paper-alexnet (FC dropout), and
the FedSwitch-SL ablation (``make_fedswitch_sl``).  Both packages start
from one state, the JAX state carried across by ``repro_torch.convert``,
and take the same random draws, replayed from the JAX package's keys in
each class's layout (``FLReplaySampler``).  The state is injected so the
steps do real work: the classifier is scaled (by a factor per arch, kept
small so that the supervised gradients stay those of a sane model) until
part of each batch clears tau = 0.95, the teacher differs from the
student, FedMatch's psi and every momentum buffer are random, and the
clients of a local step differ from each other.  Both systems step at a
rate other than the default, so the rate is held too.

Tolerance atol 1e-5 / rtol 1e-4 (convolutions and means sum in another
order)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.core import baselines as jb
from repro.core.engine import make_controller as jax_make_controller
from repro.data import pipeline as jpipe
from repro.data import synthetic as jsyn
from repro_torch import convert
from repro_torch.configs import smoke_config
from repro_torch.core import baselines
from repro_torch.core.engine import SemiCarry, grads_of, make_controller
from repro_torch.data import pipeline, synthetic
from test_torch_engine import _inject, _port_state, _queue_equal
from test_torch_modules import (JaxReplaySampler, cat_strong, cat_weak,
                                jax_dropout_masks, jax_strong_draws,
                                jax_weak_draws)
from _torch_threads import one_torch_thread  # noqa: F401

N_ACTIVE, BATCH = 2, 8
NAMES = list(baselines.BASELINES)
ARCHS = ["paper-cnn", "paper-alexnet"]
LR = 0.05
TOL = dict(atol=1e-5, rtol=1e-4)
# classifier scale at which part of a batch clears tau at init
SHARPEN = {"paper-cnn": 6.0, "paper-alexnet": 10.0}


class FLReplaySampler:
    """Stands in for ``baselines.FLDrawSampler``: replays the JAX
    baselines' key layout (``repro/core/baselines.py``: the supervised
    step's ``split(rng, 3)``, SemiFL's ``split(rng, 6)`` with the Mixup
    weight, the permutation and a dropout key folded per forward, the
    others' ``split(rng, 4)``; one fewer key without dropout)."""

    def __init__(self, key, cfg, name):
        self.key = key
        self.cfg = cfg
        self.mixup = name == "semifl"
        self.forwards = {"supervised-only": 0, "semifl": 2}.get(name, 1)
        self.dropout = cfg.cnn_dropout > 0.0

    def _masks(self, kd, n):
        return jax_dropout_masks(jax.random.split(kd, n), self.cfg.cnn_fc,
                                 self.cfg.cnn_dropout)

    def supervised(self, b):
        hw = self.cfg.image_size
        if self.dropout:
            self.key, k, kd = jax.random.split(self.key, 3)
            return jax_strong_draws(k, b, hw), self._masks(kd, b)
        self.key, k = jax.random.split(self.key)
        return jax_strong_draws(k, b, hw), None

    def local(self, n, b):
        if not self.forwards:
            return baselines.LocalDraws(None, None, ())
        keys = jax.random.split(self.key, (5 if self.mixup else 3)
                                + self.dropout)
        self.key, kw, ks_ = keys[:3]
        weak = cat_weak([jax_weak_draws(k, b)
                         for k in jax.random.split(kw, n)])
        strong = cat_strong([jax_strong_draws(k, b, self.cfg.image_size)
                             for k in jax.random.split(ks_, n)])
        masks = tuple(None for _ in range(self.forwards))
        if self.dropout:
            kd = keys[-1]
            masks = tuple(
                [torch.cat(ms) for ms in zip(*(
                    self._masks(ck, b) for ck in jax.random.split(
                        jax.random.fold_in(kd, idx), n)))]
                for idx in range(self.forwards))
        if not self.mixup:
            return baselines.LocalDraws(weak, strong, masks)
        km, kl = keys[3], keys[4]
        lam = torch.tensor(np.asarray(jax.random.beta(km, 0.75, 0.75)))
        perm = torch.tensor(np.asarray(jax.random.permutation(kl, b))).long()
        return baselines.LocalDraws(weak, strong, masks, lam, perm)


@functools.cache
def _jax_system(name, arch):
    return jb.BASELINES[name](jax_smoke_config(arch),
                              n_clients_per_round=N_ACTIVE, lr=LR)


def _port_system(name, arch):
    return baselines.BASELINES[name](
        smoke_config(arch), n_clients_per_round=N_ACTIVE, lr=LR,
        device="cpu")


def _sharpen(model, factor):
    out = jax.tree.map(lambda a: a, model)
    out["top"]["cls"]["w"] = out["top"]["cls"]["w"] * factor
    return out


def _inject_fl(name, arch, state, seed=0):
    """Partly confident classifiers, random momentum, FedMatch's psi
    random."""
    rng = np.random.RandomState(seed)
    rand = lambda t, s: jnp.asarray(
        rng.randn(*t.shape).astype(np.float32) * s)
    params = state.params
    if name == "fedmatch":
        params = {"sigma": _sharpen(params["sigma"], SHARPEN[arch]),
                  "psi": jax.tree.map(lambda t: rand(t, 1e-3),
                                      params["psi"])}
    else:
        params = _sharpen(params, SHARPEN[arch])
    teacher = jax.tree.map(lambda p: p * 0.9 + 0.01, params)
    opt = state.opt._replace(mu=jax.tree.map(lambda t: rand(t, 1e-2),
                                             state.opt.mu))
    return state._replace(params=params, teacher=teacher, opt=opt,
                          round=jnp.asarray(1, jnp.int32))


def _setup(name, arch):
    sys_j = _jax_system(name, arch)
    state_j = _inject_fl(name, arch, sys_j.init_state(0))
    s = jax.device_get(state_j)
    state_t = convert.fl_state_from_numpy(s.params, s.teacher, s.opt.mu,
                                          int(s.round))
    return sys_j, _port_system(name, arch), state_j, state_t


def _close(got, want, **tol):
    got, want = convert.params_to_numpy(got), jax.device_get(want)
    gl, wl = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl) and gl
    for g, w in zip(gl, wl):
        np.testing.assert_allclose(g, np.asarray(w), **(tol or TOL))


def _images(rng, *lead):
    return rng.rand(*lead, 16, 16, 3).astype(np.float32)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("name", NAMES)
def test_supervised_step_matches_jax(name, arch):
    sys_j, sys_t, state_j, state_t = _setup(name, arch)
    rng = np.random.RandomState(1)
    x, y = _images(rng, BATCH), rng.randint(0, 10, BATCH).astype(np.int32)
    new_j, loss_j = sys_j.supervised_step(state_j, jnp.asarray(x),
                                          jnp.asarray(y), 5)
    draws = FLReplaySampler(state_j.rng, sys_t.cfg, name).supervised(BATCH)
    new_t, loss_t = sys_t.supervised_step(
        state_t, (torch.from_numpy(x), torch.from_numpy(y)), draws=draws)
    np.testing.assert_allclose(float(loss_t), float(loss_j), **TOL)
    _close(new_t.params, new_j.params)
    _close(new_t.teacher, new_j.teacher)
    _close(new_t.opt, new_j.opt.mu)
    assert new_t.round == int(new_j.round) == 1


def _stack(tree, n):
    return jax.tree.map(lambda t: jnp.broadcast_to(t, (n,) + t.shape).copy(),
                        tree)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("name", NAMES)
def test_local_step_matches_jax(name, arch):
    sys_j, sys_t, state_j, state_t = _setup(name, arch)
    rng = np.random.RandomState(2)
    xu = _images(rng, N_ACTIVE, BATCH)
    # the clients differ from the global model and from each other, as
    # after some local steps
    cp_j = jax.tree.map(
        lambda t: t * jnp.asarray(1.0 + 0.1 * rng.randn(*t.shape),
                                  jnp.float32),
        _stack(state_j.params, N_ACTIVE))
    new_j, _, loss_j = sys_j.local_step(cp_j, state_j.teacher,
                                        state_j.params, jnp.asarray(xu),
                                        state_j.rng, 6)
    draws = FLReplaySampler(state_j.rng, sys_t.cfg, name).local(N_ACTIVE,
                                                               BATCH)
    cp_t = convert.params_from_numpy(jax.device_get(cp_j))
    new_t, loss_t = sys_t.local_step(cp_t, state_t.teacher, state_t.params,
                                     torch.from_numpy(xu), draws=draws)
    if name != "supervised-only":
        # some pseudo-label is confident: the loss is more than FedMatch's
        # L1 term on psi
        l1 = sum(float(t.abs().mean()) for t in
                 jax.tree.leaves(cp_t.get("psi", {}) if name == "fedmatch"
                                 else {}))
        assert float(loss_t) > 1e-4 * l1 + 1e-4
    np.testing.assert_allclose(float(loss_t), float(loss_j), **TOL)
    _close(new_t, new_j)


def _rig(arch):
    cfg = jax_smoke_config(arch)
    ds_j = jsyn.make_image_dataset(0, n=240, image_size=16)
    ds_t = synthetic.make_image_dataset(0, n=240, image_size=16)
    parts = [np.arange(40 + 50 * i, 90 + 50 * i) for i in range(4)]
    return (ds_j, ds_t,
            (jpipe.Loader(ds_j, np.arange(40), BATCH, 0),
             jpipe.client_loaders(ds_j, parts, BATCH, 1),
             jax_make_controller(cfg, 40, 240)),
            (pipeline.Loader(ds_t, np.arange(40), BATCH, 0),
             pipeline.client_loaders(ds_t, parts, BATCH, 1),
             make_controller(smoke_config(arch), 40, 240)))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("name", NAMES)
def test_run_round_matches_jax(name, arch):
    sys_j, sys_t, state_j, state_t = _setup(name, arch)
    ds_j, ds_t, (lab_j, cls_j, ctrl_j), (lab_t, cls_t, ctrl_t) = _rig(arch)
    sys_t.sampler = FLReplaySampler(state_j.rng, sys_t.cfg, name)
    new_j, m_j = sys_j.run_round(state_j, lab_j, cls_j, ctrl_j,
                                 rng_np=np.random.RandomState(3))
    new_t, m_t = sys_t.run_round(state_t, lab_t, cls_t, ctrl_t,
                                 rng_np=np.random.RandomState(3))
    assert m_t.keys() == m_j.keys()
    np.testing.assert_allclose([m_t["f_s"], m_t["f_u"]],
                               [m_j["f_s"], m_j["f_u"]], **TOL)
    _close(new_t.params, new_j.params)
    _close(new_t.teacher, new_j.teacher)
    _close(new_t.opt, new_j.opt.mu)
    assert new_t.round == int(new_j.round) == 2
    assert ctrl_t.k_s == ctrl_j.k_s
    test = ds_t.x[200:], ds_t.y[200:]
    for teacher in (True, False):
        assert sys_t.evaluate(new_t, *test, use_teacher=teacher) == \
            pytest.approx(sys_j.evaluate(new_j, *test, use_teacher=teacher),
                          abs=1e-6)


# ---------------------------------------------------------------------------
# FedSwitch-SL: the split pipeline without clustering and SupCon
# ---------------------------------------------------------------------------

@functools.cache
def _jax_fedswitch_sl(arch):
    return jb.make_fedswitch_sl(jax_smoke_config(arch),
                                n_clients_per_round=N_ACTIVE,
                                scan_rounds=False, lr=LR)


def _sl_setup(arch, lr=LR):
    sys_j = _jax_fedswitch_sl(arch)
    sys_t = baselines.make_fedswitch_sl(
        smoke_config(arch), n_clients_per_round=N_ACTIVE, lr=lr,
        device="cpu")
    return sys_j, sys_t, _inject(sys_j.init_state(0), sys_t.cfg)


def test_grads_of_zeros_only_the_switched_off_entries():
    """An entry named unused gets zeros; any other leaf that the loss does
    not reach raises, as autograd does."""
    a = torch.ones(2, requires_grad=True)
    proj = torch.ones(3, requires_grad=True)
    tree = {"top": {"w": a}, "proj": {"w": proj}}
    grads = grads_of((a * 2).sum(), tree, unused=("proj",))
    assert torch.equal(grads["top"]["w"], torch.full((2,), 2.0))
    assert torch.equal(grads["proj"]["w"], torch.zeros(3))
    assert list(grads) == list(tree)
    with pytest.raises(RuntimeError, match="not have been used"):
        grads_of((a * 2).sum(), tree)


@pytest.mark.parametrize("arch", ARCHS)
def test_fedswitch_sl_supervised_step_matches_jax(arch):
    sys_j, sys_t, state_j = _sl_setup(arch)
    assert sys_t.name == sys_j.name == "fedswitch-sl"
    assert not (sys_t.use_clustering or sys_t.use_supcon)
    rng = np.random.RandomState(1)
    x, y = _images(rng, BATCH), rng.randint(0, 10, BATCH).astype(np.int32)
    new_j, loss_j = sys_j.supervised_step(state_j, (jnp.asarray(x),
                                                    jnp.asarray(y)))
    draws = JaxReplaySampler(state_j.rng, sys_t.cfg).supervised(BATCH)
    new_t, loss_t = sys_t.supervised_step(
        _port_state(state_j), (torch.from_numpy(x), torch.from_numpy(y)),
        draws=draws)
    np.testing.assert_allclose(float(loss_t), float(loss_j), **TOL)
    _close(new_t.params, new_j.params)
    _close(new_t.teacher, new_j.teacher)
    _close(new_t.opt, new_j.opt.mu)
    _queue_equal(new_t.queue, new_j.queue)


def _semi_step(sys_t, state_j, draws):
    st = _port_state(state_j)
    bottoms, t_bottoms = sys_t.broadcast(st)
    carry = SemiCarry(bottoms=bottoms, teacher_bottoms=t_bottoms,
                      top=st.params["top"], proj=st.params["proj"],
                      teacher=st.teacher, queue=st.queue, step=st.step)
    xu = _images(np.random.RandomState(2), N_ACTIVE, BATCH)
    return carry, sys_t.semi_step(carry, torch.from_numpy(xu), draws), xu


@pytest.mark.parametrize("arch", ARCHS)
def test_fedswitch_sl_semi_step_matches_jax_and_keeps_proj(arch):
    sys_j, sys_t, state_j = _sl_setup(arch)
    draws = JaxReplaySampler(state_j.rng, sys_t.cfg).semi(N_ACTIVE, BATCH)
    carry_t, (new_t, (loss_t, h_t, mask_t)), xu = _semi_step(sys_t, state_j,
                                                             draws)
    bottoms_j, t_bottoms_j = sys_j.broadcast(state_j)
    new_j, (loss_j, h_j, mask_j) = sys_j.semi_step(
        (bottoms_j, t_bottoms_j, state_j.params["top"],
         state_j.params["proj"], state_j.teacher, state_j.queue,
         state_j.rng, state_j.step), jnp.asarray(xu))
    # no clustering term: the loss is the consistency CE alone, and live
    assert float(loss_t) == float(h_t) > 1e-3 and float(mask_t) < 1.0
    np.testing.assert_allclose([float(loss_t), float(h_t), float(mask_t)],
                               [float(loss_j), float(h_j), float(mask_j)],
                               **TOL)
    _close(new_t.bottoms, new_j[0])
    _close(new_t.teacher_bottoms, new_j[1])
    _close(new_t.top, new_j[2])
    _close(new_t.proj, new_j[3])
    _queue_equal(new_t.queue, new_j[5])
    # proj gets a zero gradient and stays as it was, bit for bit
    for a, b in zip(jax.tree.leaves(convert.params_to_numpy(new_t.proj)),
                    jax.tree.leaves(convert.params_to_numpy(carry_t.proj))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("step", ["supervised", "semi"])
def test_lr_moves_the_update_as_jax(step):
    """The system's rate reaches each FedSwitch-SL step: at a rate other
    than the default the port's update matches JAX's, and differs from the
    update at the default rate."""
    sys_j, sys_t, state_j = _sl_setup("paper-cnn")
    _, sys_d, _ = _sl_setup("paper-cnn", lr=0.02)
    assert sys_t.lr == LR != sys_d.lr
    rng = np.random.RandomState(1)
    x, y = _images(rng, BATCH), rng.randint(0, 10, BATCH).astype(np.int32)
    got = {}
    for key, system in (("port", sys_t), ("default", sys_d)):
        draws = JaxReplaySampler(state_j.rng, system.cfg)
        if step == "supervised":
            new, _ = system.supervised_step(
                _port_state(state_j),
                (torch.from_numpy(x), torch.from_numpy(y)),
                draws=draws.supervised(BATCH))
            got[key] = new.params["top"]
        else:
            _, (new, _), _ = _semi_step(system, state_j,
                                        draws.semi(N_ACTIVE, BATCH))
            got[key] = new.top
    if step == "supervised":
        want = sys_j.supervised_step(state_j, (jnp.asarray(x),
                                               jnp.asarray(y)))[0]
        want = want.params["top"]
    else:
        bottoms_j, t_bottoms_j = sys_j.broadcast(state_j)
        want = sys_j.semi_step(
            (bottoms_j, t_bottoms_j, state_j.params["top"],
             state_j.params["proj"], state_j.teacher, state_j.queue,
             state_j.rng, state_j.step),
            jnp.asarray(_images(np.random.RandomState(2), N_ACTIVE,
                                BATCH)))[0][2]
    _close(got["port"], want)
    assert not torch.allclose(got["port"]["cls"]["w"],
                              got["default"]["cls"]["w"], atol=1e-6)
