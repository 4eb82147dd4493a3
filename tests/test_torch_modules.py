"""The PyTorch port's modules against the JAX package, on the CPU, at small
size: losses, queue, EMA, projection head, wire top-k, the CNN (forward and
VJP, with dropout masks drawn in JAX and given to both), augmentation (with
draws replayed from the JAX package's keys), the K_s controller, the data
copies and the weight converter.  Inputs are made with numpy and go through
both sides.  Tolerance 1e-6 for the losses and modules, atol 1e-5 / rtol
1e-4 for the CNN (convolutions sum in another order)."""
import functools
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.core import losses as jlosses
from repro.core.adaptation import FreqController as JaxFreqController
from repro.core.ema import ema_update as jax_ema
from repro.core.queue import enqueue as jax_enqueue
from repro.core.queue import init_queue as jax_init_queue
from repro.core.split import apply_projection_head as jax_proj
from repro.core.split import init_projection_head as jax_init_proj
from repro.core.wire import sparse_delta_mean as jax_sparse_delta_mean
from repro.core.wire import topk_sparsify as jax_topk
from repro.data import augment as jaug
from repro.data import pipeline as jpipe
from repro.data import partition as jpart
from repro.data import synthetic as jsyn
from repro.models.cnn import CNNModel as JaxCNN
from repro_torch import convert
from repro_torch.configs import smoke_config
from repro_torch.core import losses
from repro_torch.core.adaptation import FreqController
from repro_torch.core.ema import ema_update
from repro_torch.core.queue import enqueue, init_queue
from repro_torch.core.split import apply_projection_head
from repro_torch.core.wire import sparse_delta_mean, topk_sparsify
from repro_torch.data import augment, partition, pipeline, synthetic
from repro_torch.data.augment import StrongDraws, WeakDraws
from repro_torch.models.cnn import CNNModel
from _torch_threads import one_torch_thread  # noqa: F401


def T(a) -> torch.Tensor:
    """A tensor holding its own copy of ``a``."""
    return torch.from_numpy(np.array(a))


def _np(x):
    return np.asarray(x)


# ---------------------------------------------------------------------------
# draws replayed from the JAX package's keys (data/augment.py, models/cnn.py)
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnums=1)
def _jax_weak_arrays(key, b):
    k1, k2 = jax.random.split(key)
    flip = jax.random.bernoulli(k1, 0.5, (b, 1, 1, 1)).reshape(b)
    kc1, kc2 = jax.random.split(k2)
    dx = jax.random.randint(kc1, (b,), 0, 2 * augment.PAD + 1)
    dy = jax.random.randint(kc2, (b,), 0, 2 * augment.PAD + 1)
    return flip, dx, dy


def jax_weak_draws(key, b: int) -> WeakDraws:
    """The draws ``repro.data.augment.weak_augment(key, x)`` makes."""
    flip, dx, dy = _jax_weak_arrays(key, b)
    return WeakDraws(flip=T(_np(flip)), dx=T(_np(dx)).long(),
                     dy=T(_np(dy)).long())


@functools.partial(jax.jit, static_argnums=(1, 2))
def _jax_strong_arrays(key, b, hw):
    keys = jax.random.split(key, augment.N_OPS + 3)
    ops, us = [], []
    for i in range(augment.N_OPS):
        ks, kop = jax.random.split(keys[i + 1])
        op = jax.random.randint(ks, (), 0, augment.N_STRONG_OPS)
        ops.append(jnp.full((b,), op))
        us.append(jax.random.uniform(kop, (b, 1, 1, 1)).reshape(b))
    high = hw - augment.cutout_size(hw) + 1
    kc1, kc2 = jax.random.split(keys[-1])
    return (_jax_weak_arrays(keys[0], b), jnp.stack(ops), jnp.stack(us),
            jax.random.randint(kc1, (b,), 0, high),
            jax.random.randint(kc2, (b,), 0, high))


def jax_strong_draws(key, b: int, hw: int) -> StrongDraws:
    """The draws ``repro.data.augment.strong_augment(key, x)`` makes with
    its default ops (brightness, contrast), two op slots and cutout."""
    (flip, dx, dy), op, u, cy, cx = _jax_strong_arrays(key, b, hw)
    return StrongDraws(
        weak=WeakDraws(flip=T(_np(flip)), dx=T(_np(dx)).long(),
                       dy=T(_np(dy)).long()),
        op=T(_np(op)).long(), u=T(_np(u)), cy=T(_np(cy)).long(),
        cx=T(_np(cx)).long())


def jax_dropout_masks(keys, widths, rate):
    """The per-sample FC keep masks ``repro.models.cnn.CNNModel._dropout``
    draws from a (B, key) stack."""
    draw = jax.jit(lambda ks: [jax.vmap(
        lambda k, li=li, w=w: jax.random.bernoulli(
            jax.random.fold_in(k, li), 1.0 - rate, (w,)))(ks)
        for li, w in enumerate(widths)])
    return [T(_np(m)) for m in draw(keys)]


def cat_weak(ds):
    return WeakDraws(*(torch.cat(t) for t in zip(*ds)))


def cat_strong(ds):
    return StrongDraws(weak=cat_weak([d.weak for d in ds]),
                       op=torch.cat([d.op for d in ds], dim=1),
                       u=torch.cat([d.u for d in ds], dim=1),
                       cy=torch.cat([d.cy for d in ds]),
                       cx=torch.cat([d.cx for d in ds]))


class JaxReplaySampler:
    """Stands in for ``engine.DrawSampler``: replays the JAX engine's key
    schedule (``engine.py:291``, ``:400-406``) from its ``state.rng``."""

    def __init__(self, key, cfg):
        self.key = key
        self.cfg = cfg
        self.dropout = cfg.cnn_dropout > 0.0

    def _masks(self, kd, n):
        return jax_dropout_masks(jax.random.split(kd, n), self.cfg.cnn_fc,
                                 self.cfg.cnn_dropout)

    def supervised(self, b):
        if self.dropout:
            self.key, k_aug, k_drop = jax.random.split(self.key, 3)
            return jax_weak_draws(k_aug, b), self._masks(k_drop, b)
        self.key, k_aug = jax.random.split(self.key)
        return jax_weak_draws(k_aug, b), None

    def semi(self, n, b):
        hw = self.cfg.image_size
        if self.dropout:
            self.key, kw, ks_, kd = jax.random.split(self.key, 4)
            masks = self._masks(kd, n * b)
        else:
            self.key, kw, ks_ = jax.random.split(self.key, 3)
            masks = None
        weak = cat_weak([jax_weak_draws(k, b)
                         for k in jax.random.split(kw, n)])
        strong = cat_strong([jax_strong_draws(k, b, hw)
                             for k in jax.random.split(ks_, n)])
        return weak, strong, masks


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _contrastive_case(seed=0, b=12, q=40, d=8, m=4):
    rng = np.random.RandomState(seed)
    z = rng.randn(b, d).astype(np.float32)
    z /= np.linalg.norm(z, axis=1, keepdims=True)
    return dict(z=z, qz=rng.randn(q, d).astype(np.float32),
                labels=rng.randint(0, m, b).astype(np.int32),
                qlab=rng.randint(0, m, q).astype(np.int32),
                qconf=rng.rand(q) > 0.3, qvalid=rng.rand(q) > 0.2,
                aok=rng.rand(b) > 0.3,
                logits=(rng.randn(b, m) * 3).astype(np.float32),
                mask=rng.rand(b) > 0.4)


def test_cross_entropy_and_pseudo_labels_match_jax():
    c = _contrastive_case()
    for mask in (None, c["mask"]):
        jm = None if mask is None else jnp.asarray(mask)
        tm = None if mask is None else T(mask)
        want = jlosses.cross_entropy(jnp.asarray(c["logits"]),
                                     jnp.asarray(c["labels"]), jm)
        got = losses.cross_entropy(T(c["logits"]), T(c["labels"]), tm)
        np.testing.assert_allclose(float(got), float(want), atol=1e-6)
        ws, wc = jlosses.cross_entropy_sum(jnp.asarray(c["logits"]),
                                           jnp.asarray(c["labels"]), jm)
        gs, gc = losses.cross_entropy_sum(T(c["logits"]), T(c["labels"]), tm)
        np.testing.assert_allclose([float(gs), float(gc)],
                                   [float(ws), float(wc)], atol=1e-6)
    wl, wok, wconf = jlosses.pseudo_labels(jnp.asarray(c["logits"]), 0.6)
    gl, gok, gconf = losses.pseudo_labels(T(c["logits"]), 0.6)
    np.testing.assert_array_equal(gl.numpy(), _np(wl))
    np.testing.assert_array_equal(gok.numpy(), _np(wok))
    np.testing.assert_allclose(gconf.numpy(), _np(wconf), atol=1e-6)


@pytest.mark.parametrize("which", ["supcon", "clustering"])
def test_contrastive_losses_and_grads_match_jax(which):
    c = _contrastive_case(seed=3)
    if which == "supcon":
        args_j = [jnp.asarray(c[k]) for k in ("labels", "qz", "qlab")] + [
            jnp.asarray(c["qvalid"] & c["qconf"])]
        args_t = [T(c[k]) for k in ("labels", "qz", "qlab")] + [
            T(c["qvalid"] & c["qconf"])]
        fj = lambda z: jlosses.supervised_contrastive_loss(z, *args_j, 0.1)
        ft = lambda z: losses.supervised_contrastive_loss(z, *args_t, 0.1)
    else:
        keys = ("labels", "aok", "qz", "qlab", "qconf", "qvalid")
        args_j = [jnp.asarray(c[k]) for k in keys]
        args_t = [T(c[k]) for k in keys]
        fj = lambda z: jlosses.clustering_loss(z, *args_j, 0.1)
        ft = lambda z: losses.clustering_loss(z, *args_t, 0.1)
        want_n = jlosses.clustering_anchor_count(
            *[jnp.asarray(c[k]) for k in ("labels", "aok", "qlab", "qconf",
                                          "qvalid")])
        got_n = losses.clustering_anchor_count(
            *[T(c[k]) for k in ("labels", "aok", "qlab", "qconf", "qvalid")])
        assert int(got_n) == int(want_n) > 0
    want, want_g = jax.jit(jax.value_and_grad(fj))(jnp.asarray(c["z"]))
    zt = T(c["z"]).requires_grad_(True)
    got = ft(zt)
    (got_g,) = torch.autograd.grad(got, zt)
    np.testing.assert_allclose(float(got.detach()), float(want), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(got_g.numpy(), _np(want_g), atol=1e-6,
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# queue, EMA, projection head, wire top-k
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b", [5, 23])
def test_enqueue_matches_jax_including_b_over_q(b):
    qlen, d = 16, 4
    rng = np.random.RandomState(b)
    jq = jax_init_queue(qlen, d)
    tq = init_queue(qlen, d, "cpu")
    for step in range(3):
        z = rng.randn(b, d).astype(np.float32)
        lab = rng.randint(0, 5, b).astype(np.int32)
        conf = rng.rand(b) > 0.5 if step else None
        jq = jax_enqueue(jq, jnp.asarray(z), jnp.asarray(lab),
                         None if conf is None else jnp.asarray(conf))
        tq = enqueue(tq, T(z), T(lab), None if conf is None else T(conf))
    got = convert.queue_to_numpy(tq)
    for k in ("z", "label", "conf", "valid"):
        np.testing.assert_array_equal(got[k], _np(getattr(jq, k)))
    assert got["ptr"] == int(jq.ptr)


def test_ema_and_projection_head_match_jax():
    cfg_j = jax_smoke_config("paper-cnn")
    rng = np.random.RandomState(1)
    a = {"w": rng.randn(3, 4).astype(np.float32), "b": [rng.randn(5)
                                                        .astype(np.float32)]}
    b = {"w": rng.randn(3, 4).astype(np.float32), "b": [rng.randn(5)
                                                        .astype(np.float32)]}
    want = jax_ema(jax.tree.map(jnp.asarray, a), jax.tree.map(jnp.asarray, b),
                   0.99)
    got = ema_update(convert.params_from_numpy(a),
                     convert.params_from_numpy(b), 0.99)
    np.testing.assert_allclose(got["w"].numpy(), _np(want["w"]), atol=1e-6)
    np.testing.assert_allclose(got["b"][0].numpy(), _np(want["b"][0]),
                               atol=1e-6)

    pj = jax_init_proj(jax.random.PRNGKey(4), cfg_j)
    pt = convert.params_from_numpy(jax.device_get(pj))
    feats = rng.randn(6, 32).astype(np.float32)
    zero = np.zeros((1, 32), np.float32)            # hits the 1e-6 floor
    np.testing.assert_array_equal(
        apply_projection_head(pt, T(zero)).numpy(),
        _np(jax_proj(pj, cfg_j, jnp.asarray(zero))))
    ct = rng.randn(6, cfg_j.semisfl.proj_dim).astype(np.float32)
    want, (want_gp, want_gf) = jax.jit(lambda p, f, c: (
        lambda out, vjp: (out, vjp(c)))(
            *jax.vjp(lambda p_, f_: jax_proj(p_, cfg_j, f_), p, f)))(
        pj, jnp.asarray(feats), jnp.asarray(ct))
    ptg = {k: v.requires_grad_(True) for k, v in pt.items()}
    ft = T(feats).requires_grad_(True)
    got = apply_projection_head(ptg, ft)
    grads = torch.autograd.grad(got, [ptg["w1"], ptg["w2"], ft], T(ct))
    np.testing.assert_allclose(got.detach().numpy(), _np(want), atol=1e-6)
    for g, w in zip(grads, (want_gp["w1"], want_gp["w2"], want_gf)):
        np.testing.assert_allclose(g.numpy(), _np(w), atol=1e-6, rtol=1e-5)


def test_topk_ties_and_sparse_delta_mean_match_jax():
    x = np.array([[3.0, -3.0, 1.0, 0.5], [3.0, 2.0, -2.0, 0.1]], np.float32)
    # ceil(0.25 * 8) = 2 kept by count, but all three |3| ties survive
    got = topk_sparsify(T(x), 0.25).numpy()
    want = _np(jax_topk(jnp.asarray(x), 0.25))
    np.testing.assert_array_equal(got, want)
    assert np.count_nonzero(got) == 3

    rng = np.random.RandomState(2)
    stacked = {"a": rng.randn(3, 4, 5).astype(np.float32),
               "b": [rng.randn(3, 7).astype(np.float32)]}
    ref = {"a": rng.randn(4, 5).astype(np.float32),
           "b": [rng.randn(7).astype(np.float32)]}
    for frac in (0.1, 0.5, 1.0):
        want = jax_sparse_delta_mean(jax.tree.map(jnp.asarray, stacked),
                                     jax.tree.map(jnp.asarray, ref), frac)
        got = sparse_delta_mean(jax.tree.map(T, stacked),
                                jax.tree.map(T, ref), frac)
        np.testing.assert_allclose(got["a"].numpy(), _np(want["a"]),
                                   atol=1e-6)
        np.testing.assert_allclose(got["b"][0].numpy(), _np(want["b"][0]),
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# CNN model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["paper-cnn", "paper-alexnet"])
def test_cnn_bottom_top_forward_and_vjp_match_jax(arch):
    cfg_j, cfg_t = jax_smoke_config(arch), smoke_config(arch)
    mj = JaxCNN(cfg_j)
    mt = CNNModel(cfg_t)
    assert mt.split == mj.split and mt.pool_at == mj.pool_at
    pj = mj.init(jax.random.PRNGKey(7))
    pt = convert.params_from_numpy(jax.device_get(pj))
    rng = np.random.RandomState(0)
    b = 4
    hw, c = mt.feat_shape(mt.split)
    x = rng.rand(b, cfg_t.image_size, cfg_t.image_size, 3).astype(np.float32)
    cf = rng.randn(b, hw, hw, c).astype(np.float32)
    ct = rng.randn(b, cfg_t.num_classes).astype(np.float32)
    dropout = cfg_t.cnn_dropout > 0.0
    keys = jax.random.split(jax.random.PRNGKey(3), b)

    @jax.jit
    def jax_side(p, xx, keys, cf, ct):
        feats, vjp_b = jax.vjp(
            lambda pb, xi: mj.bottom_apply(pb, {"images": xi})[0],
            p["bottom"], xx)
        extras = {"aux_loss": jnp.zeros(())}
        if dropout:
            extras["dropout_keys"] = keys
        logits, vjp_t = jax.vjp(
            lambda pt_, f: mj.top_apply(pt_, f, extras=extras,
                                        mode="train")[0]["logits"],
            p["top"], feats)
        return feats, logits, vjp_b(cf)[0], vjp_t(ct)

    feats_j, logits_j, gb_j, (gp_j, gf_j) = jax.device_get(jax_side(
        pj, jnp.asarray(x), keys, jnp.asarray(cf), jnp.asarray(ct)))
    masks = None
    if dropout:
        masks = jax_dropout_masks(keys, cfg_t.cnn_fc, cfg_t.cnn_dropout)
        assert 0 < int(masks[0].sum()) < masks[0].numel()

    bottom_t = jax.tree.map(lambda v: v.requires_grad_(True), pt["bottom"])
    feats_t = mt.bottom_apply(bottom_t, T(x))
    top_t = jax.tree.map(lambda v: v.requires_grad_(True), pt["top"])
    ft = feats_t.detach().requires_grad_(True)
    logits_t = mt.top_apply(top_t, ft, masks)
    np.testing.assert_allclose(feats_t.detach().numpy(), feats_j,
                               atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(logits_t.detach().numpy(), logits_j,
                               atol=1e-5, rtol=1e-4)

    grads_t = torch.autograd.grad(logits_t, jax.tree.leaves(top_t) + [ft],
                                  T(ct))
    got_top = convert.params_to_numpy(jax.tree.unflatten(
        jax.tree.structure(top_t), list(grads_t[:-1])))
    for g, w in zip(jax.tree.leaves(got_top), jax.tree.leaves(gp_j)):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(grads_t[-1].numpy(), gf_j, atol=1e-5,
                               rtol=1e-4)
    gb_t = torch.autograd.grad(feats_t, jax.tree.leaves(bottom_t), T(cf))
    got_b = convert.params_to_numpy(jax.tree.unflatten(
        jax.tree.structure(bottom_t), list(gb_t)))
    for g, w in zip(jax.tree.leaves(got_b), jax.tree.leaves(gb_j)):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-4)


def test_fc1_row_order_follows_jax_nhwc_flatten():
    """The FC-1 rows are indexed in JAX's NHWC flatten order: a one-hot
    cut feature at (h, w, c) picks row (h * W + w) * C + c."""
    cfg = replace(smoke_config("paper-cnn"), cnn_channels=(4,), num_layers=2)
    m = CNNModel(cfg)
    p = m.init(torch.Generator().manual_seed(0), "cpu")
    hw, c = m.feat_shape(1)
    feats = torch.zeros(1, hw, hw, c)
    feats[0, 2, 3, 1] = 1.0
    fc = p["top"]["fcs"][0]
    row = (2 * hw + 3) * c + 1
    want = torch.relu(fc["w"][row] + fc["b"]) @ p["top"]["cls"]["w"] \
        + p["top"]["cls"]["b"]
    got = m.top_apply({"convs": [], "fcs": [fc], "cls": p["top"]["cls"]},
                      feats)
    torch.testing.assert_close(got[0], want)


# ---------------------------------------------------------------------------
# augmentation
# ---------------------------------------------------------------------------

def test_weak_and_strong_augment_match_jax():
    rng = np.random.RandomState(4)
    x = rng.rand(16, 16, 16, 3).astype(np.float32)
    weak_j, strong_j = jax.jit(jaug.weak_augment), jax.jit(jaug.strong_augment)
    for seed in range(2):
        key = jax.random.PRNGKey(seed)
        want_w = _np(weak_j(key, jnp.asarray(x)))
        got_w = augment.weak_augment(T(x), jax_weak_draws(key, 16)).numpy()
        np.testing.assert_allclose(got_w, want_w, atol=1e-6)
        want_s = _np(strong_j(key, jnp.asarray(x)))
        got_s = augment.strong_augment(
            T(x), jax_strong_draws(key, 16, 16)).numpy()
        np.testing.assert_allclose(got_s, want_s, atol=1e-6)


def test_samplers_draw_in_range_on_the_generator():
    gen = torch.Generator().manual_seed(0)
    d = augment.sample_strong(3, 5, 16, gen)
    assert d.op.shape == (augment.N_OPS, 15)
    # one op index per client call and slot
    assert (d.op.view(augment.N_OPS, 3, 5) == d.op[:, ::5, None]).all()
    assert 0 <= int(d.weak.dx.min()) and int(d.weak.dx.max()) <= 8
    assert int(d.cy.max()) <= 16 - augment.cutout_size(16)


# ---------------------------------------------------------------------------
# controller, data copies, converter
# ---------------------------------------------------------------------------

def test_freq_controller_trace_matches_jax():
    cfg_j = replace(jax_smoke_config("paper-cnn").semisfl, k_s_init=40,
                    k_u=4, observation_period=2, adaptation_window=2)
    cfg_t = replace(smoke_config("paper-cnn").semisfl, k_s_init=40, k_u=4,
                    observation_period=2, adaptation_window=2)
    cj, ct = JaxFreqController(cfg_j, 100, 1000), FreqController(cfg_t, 100,
                                                                 1000)
    rng = np.random.RandomState(0)
    for r in range(40):
        f_s, f_u = 2.0 / (r + 1) + rng.rand() * 0.1, 3.0 / (r + 1) ** 1.5
        assert ct.update(f_s, f_u) == cj.update(f_s, f_u)
    assert ct.history == cj.history and len(set(ct.history)) > 1
    assert ct.state_dict() == cj.state_dict()


@pytest.mark.parametrize("arch", ["paper-cnn", "paper-alexnet",
                                  "paper-vgg13", "paper-vgg16"])
def test_config_copies_match_jax(arch):
    from dataclasses import asdict

    from repro.configs import get_config as jax_get_config
    from repro_torch.configs import get_config
    for full in (True, False):
        cj = jax_get_config(arch) if full else jax_smoke_config(arch)
        ct = get_config(arch) if full else smoke_config(arch)
        assert asdict(ct.semisfl).items() <= asdict(cj.semisfl).items()
        for f in ("name", "num_layers", "cnn_channels", "cnn_fc",
                  "num_classes", "image_size", "cnn_dropout", "split_layer"):
            assert getattr(ct, f) == getattr(cj, f), f


def test_data_copies_draw_the_same_streams():
    ds_j = jsyn.make_image_dataset(3, n=200, image_size=16)
    ds_t = synthetic.make_image_dataset(3, n=200, image_size=16)
    np.testing.assert_array_equal(ds_t.x, ds_j.x)
    np.testing.assert_array_equal(ds_t.y, ds_j.y)
    tr_j, _ = jsyn.train_test_split(ds_j, 40, seed=1)
    tr_t, _ = synthetic.train_test_split(ds_t, 40, seed=1)
    parts_j = jpart.dirichlet_partition(0, tr_j.y, 4, 0.3)
    parts_t = partition.dirichlet_partition(0, tr_t.y, 4, 0.3)
    assert all(np.array_equal(a, b) for a, b in zip(parts_t, parts_j))
    up_t = partition.uniform_partition(0, 160, 4)
    up_j = jpart.uniform_partition(0, 160, 4)
    assert all(np.array_equal(a, b) for a, b in zip(up_t, up_j))
    lj = jpipe.client_loaders(tr_j, up_j, 7, 5)
    lt = pipeline.client_loaders(tr_t, up_t, 7, 5)
    xj, yj = jpipe.stack_client_batches_many(lj, [2, 0], 9)
    xt, yt = pipeline.stack_client_batches_many(lt, [2, 0], 9)
    np.testing.assert_array_equal(xt, xj)
    np.testing.assert_array_equal(yt, yj)


def test_params_from_numpy_round_trip():
    mj = JaxCNN(jax_smoke_config("paper-alexnet"))
    pj = jax.device_get(mj.init(jax.random.PRNGKey(0)))
    pt = convert.params_from_numpy(pj)
    w = pt["bottom"]["convs"][0]["w"]
    assert w.shape == (64, 3, 3, 3)           # OIHW
    back = convert.params_to_numpy(pt)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(pj)):
        np.testing.assert_array_equal(a, b)
    # stacked client bottoms (leading client axis) round-trip too
    stacked = jax.tree.map(lambda a: np.stack([a, a * 2]), pj["bottom"])
    st = convert.params_from_numpy(stacked)
    assert st["convs"][0]["w"].shape == (2, 64, 3, 3, 3)
    for a, b in zip(jax.tree.leaves(convert.params_to_numpy(st)),
                    jax.tree.leaves(stacked)):
        np.testing.assert_array_equal(a, b)
