"""The SemiSFL training engine (Section III workflow + Alg. 1) in PyTorch:
the JAX package's ``core/engine.py`` with its vmapped executor.

One aggregation round h:

  (1) supervised training on the PS: K_s iterations on labeled data with
      l_s = CE + supervised-contrastive (Eq. (3)), momentum SGD, teacher EMA,
      and the teacher's projected features enqueued;
  (2) broadcast of the global bottom and teacher bottom to the N active
      clients (a stacked leading client axis on every bottom leaf);
  (3)-(4) K_u cross-entity iterations: clients produce student features
      (strong view) and teacher features (weak view); the PS computes
      pseudo-labels with the teacher top and l_u = H + C (Eq. (1) + the
      Eq. (5) clustering kernel); plain SGD on top and projection with the
      client-mean gradient (Eq. (7)), and on each client's own bottom with
      its own gradient (Eq. (8)), then the clients' teacher EMA;
  (5) FedAvg of the bottoms and the teacher bottoms, optionally from top-k
      sparsified deltas.

The clients are a stacked leading axis on every bottom leaf, and the
bottom forward is ``torch.func.vmap``ped over it, as JAX's ``jax.vmap``
is: the batched-weight convolutions become grouped ones, and each client's
slice of the stack gets exactly its own gradient.  The split-link wire
(``core/wire.py``) quantizes the stacked cut features with one scale per
client, through the quantize kernels.

Two executors drive a round, as in JAX: the scanned one (the default,
``scan_rounds=True``) runs each phase through ``core/scan.py``, one CUDA
graph of the step replayed K_s or K_u times on the card, with the phase's
inputs staged through pinned host memory in one copy and the losses read
once a round; the eager one (``scan_rounds=False``) dispatches every step
from Python.  Both run the same ``supervised_step`` and ``semi_step``.
With ``prefetch=True`` a worker thread (``data/prefetch.py``) assembles
the next round's stacks while this round runs.

Random draws (augmentation and dropout masks) come from a
:class:`DrawSampler` holding one ``torch.Generator`` on the device.  Both
executors call it once a step in step order (the scanned one for the whole
phase before it starts), so they draw the same streams; the steps take the
draws as arguments, so a test can feed both this port and the JAX package
the same ones."""
from __future__ import annotations

import weakref
from dataclasses import dataclass
from typing import Any, NamedTuple, Optional

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch import kernels
from repro_torch.configs import ArchConfig
from repro_torch.core import losses
from repro_torch.core.adaptation import FreqController
from repro_torch.core.ema import ema_update
from repro_torch.core.queue import FeatureQueue, enqueue, init_queue
from repro_torch.core.scan import GraphPool, scan_phase
from repro_torch.core.split import (apply_projection_head,
                                    init_projection_head, pool_features,
                                    proj_dim)
from repro_torch.core.wire import (WireFormatLike, fake_quantize,
                                   parse_wire_format, quantize_grad,
                                   resolve_fmt, sparse_delta_mean)
from repro_torch.data.augment import (sample_strong, sample_weak,
                                      strong_augment, weak_augment)
from repro_torch.data.pipeline import (Loader, stack_client_batches,
                                       stack_client_batches_many)
from repro_torch.data.prefetch import DevicePut, RoundPrefetcher, ready
from repro_torch.device import resolve_device, to_device
from repro_torch.models.cnn import CNNModel
from repro_torch.optim.optimizers import apply_updates, sgd
from repro_torch.tree import tree_leaves, tree_map, tree_stack, tree_unflatten


class SemiSFLState(NamedTuple):
    params: Any        # {"bottom", "top", "proj"}: the global model w
    teacher: Any       # same structure: w~
    opt: Any           # momentum buffers of params (supervised phase)
    queue: FeatureQueue
    round: int
    step: torch.Tensor  # () int32: supervised and semi steps taken


class SemiCarry(NamedTuple):
    """What the cross-entity phase threads from step to step."""
    bottoms: Any           # stacked (N, ...) client bottoms
    teacher_bottoms: Any   # stacked (N, ...) client teacher bottoms
    top: Any
    proj: Any
    teacher: Any           # frozen during the phase
    queue: FeatureQueue
    step: torch.Tensor


@dataclass
class RoundMetrics:
    f_s: float = 0.0
    f_u: float = 0.0
    mask_rate: float = 0.0
    k_s: int = 0
    test_acc: float = float("nan")


class DrawSampler:
    """The round's random draws, from one ``torch.Generator`` on the
    device: weak/strong augmentation draws and FC dropout masks."""

    def __init__(self, model: CNNModel, seed: int, device: torch.device):
        self.model = model
        self.device = device
        self.gen = torch.Generator(device=device).manual_seed(seed)

    def supervised(self, batch: int):
        """(weak draws, dropout masks or None) for one labeled batch."""
        return (sample_weak(batch, self.gen),
                self.model.draw_dropout_masks(batch, self.gen, self.device))

    def semi(self, n: int, batch: int):
        """(weak, strong, dropout masks or None) for N client batches,
        flattened client-major."""
        hw = self.model.cfg.image_size
        return (sample_weak(n * batch, self.gen),
                sample_strong(n, batch, hw, self.gen),
                self.model.draw_dropout_masks(n * batch, self.gen,
                                              self.device))


def requires_grad(tree):
    return tree_map(lambda t: t.detach().requires_grad_(True), tree)


def selection_rng(holder, rng_np: Optional[np.random.RandomState] = None
                  ) -> np.random.RandomState:
    """The host-side client-selection RandomState, made once a run:
    ``rng_np`` (from the launcher) if given, else the ``holder``'s
    ``_select_rng`` (seeded by ``init_state``), else seed 0.  Shared by the
    engine and every baseline."""
    if rng_np is not None:
        return rng_np
    if holder._select_rng is None:
        holder._select_rng = np.random.RandomState(0)
    return holder._select_rng


def grads_of(loss: torch.Tensor, tree: dict, unused: tuple = ()) -> dict:
    """d loss / d each leaf of the dict ``tree``, as a tree.  The entries
    named in ``unused`` are reached only by a term that is switched off:
    they get zeros, as a JAX gradient gives them.  Any other leaf that the
    loss does not reach raises, as autograd does."""
    live = {k: v for k, v in tree.items() if k not in unused}
    grads = tree_unflatten(live, list(torch.autograd.grad(
        loss, tree_leaves(live))))
    return {k: grads[k] if k in live else tree_map(torch.zeros_like, v)
            for k, v in tree.items()}


class SemiSFLSystem:
    """Paper-faithful classification-task SemiSFL.  ``use_clustering``
    and ``use_supcon`` switch off the Eq. (5) and Eq. (3) terms (the
    FedSwitch-SL ablation, ``core/baselines.py``)."""

    name = "semisfl"

    def __init__(self, cfg: ArchConfig, *, n_clients_per_round: int = 10,
                 lr: float = 0.02, momentum: float = 0.9,
                 use_clustering: bool = True, use_supcon: bool = True,
                 wire_format: WireFormatLike = None,
                 scan_rounds: bool = True, prefetch: bool = False,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.s = cfg.semisfl
        self.wire = parse_wire_format(wire_format)
        self.act_fmt = resolve_fmt(self.wire.activations)
        self.grad_fmt = resolve_fmt(self.wire.gradients)
        self.model = CNNModel(cfg)
        self.n_active = n_clients_per_round
        self.opt = sgd(momentum=momentum)
        self.lr = lr
        self.use_clustering = use_clustering
        self.use_supcon = use_supcon
        # init_state reseeds both from its seed; a test may swap the sampler
        self.sampler = DrawSampler(self.model, 1, self.device)
        self._select_rng: Optional[np.random.RandomState] = None
        # the scanned executor (the default) or the eager one; the phases
        # run the same steps, given the draws of the whole phase, and
        # share one graph memory pool.  They reach the system through a
        # weak reference, so that its graphs and their memory go with it
        self.scan_rounds = scan_rounds
        me, pool = weakref.proxy(self), GraphPool()
        self.supervised_phase = scan_phase(
            lambda st, inp: me.supervised_step(st, *inp), pool)
        self.semi_phase = scan_phase(
            lambda carry, inp: me.semi_step(carry, *inp), pool)
        # the round prefetcher (off by default, as in JAX): it owns the
        # loaders it is bound to between rounds
        self.prefetch = prefetch
        self._prefetcher: Optional[RoundPrefetcher] = None
        self._prefetch_key = None

    # ------------------------------------------------------------------
    def init_state(self, seed: int = 0) -> SemiSFLState:
        gen = torch.Generator(device=self.device).manual_seed(seed)
        mp = self.model.init(gen, self.device)
        params = {"bottom": mp["bottom"], "top": mp["top"],
                  "proj": init_projection_head(self.cfg, gen, self.device)}
        self.sampler = DrawSampler(self.model, seed + 1, self.device)
        self._select_rng = np.random.RandomState(seed)
        return SemiSFLState(
            params=params, teacher=tree_map(torch.clone, params),
            opt=self.opt.init(params),
            queue=init_queue(self.s.queue_len, proj_dim(self.cfg),
                             self.device),
            round=0, step=torch.zeros((), dtype=torch.int32,
                                      device=self.device))

    def _forward(self, params, x, dropout_masks=None):
        """Full forward: (logits, projected z, cut features)."""
        feats = self.model.bottom_apply(params["bottom"], x)
        logits = self.model.top_apply(params["top"], feats, dropout_masks)
        z = apply_projection_head(params["proj"], pool_features(feats))
        return logits, z, feats

    # ---------------- supervised step (PS, Alg. 1 lines 4-5) ----------
    def supervised_step(self, state: SemiSFLState, batch, draws=None):
        """One labeled iteration; ``batch`` = (images NHWC, labels) on the
        device.  Returns (new state, loss tensor)."""
        x, y = batch
        if draws is None:
            draws = self.sampler.supervised(x.shape[0])
        weak, masks = draws
        xs = weak_augment(x, weak)
        s, q = self.s, state.queue
        params = requires_grad(state.params)
        logits, z, _ = self._forward(params, xs, masks)
        loss = losses.cross_entropy(logits, y)
        if self.use_supcon:
            loss = loss + losses.supervised_contrastive_loss(
                z, y, q.z, q.label, q.valid & q.conf, s.temperature)
        # without the SupCon term proj gets a zero gradient and stays
        grads = grads_of(loss, params,
                         unused=() if self.use_supcon else ("proj",))
        with torch.no_grad():
            updates, mu = self.opt.update(grads, state.opt, state.params,
                                          self.lr)
            new_params = apply_updates(state.params, updates)
            teacher = ema_update(state.teacher, new_params, s.ema_decay)
            # the teacher forward is an inference pass: no dropout
            _, tz, _ = self._forward(teacher, xs)
            queue = enqueue(state.queue, tz, y)
        return SemiSFLState(params=new_params, teacher=teacher, opt=mu,
                            queue=queue, round=state.round,
                            step=state.step + 1), loss.detach()

    # --------------- cross-entity semi-supervised step ----------------
    def _bottoms_forward(self, bottoms, x):
        """Each client's bottom on its own batch, vmapped over the client
        axis: (N, B, ...) -> stacked (N, B, H', W', C) cut features."""
        return torch.func.vmap(self.model.bottom_apply)(bottoms, x)

    def _teacher_targets(self, teacher, teacher_bottoms, xw):
        """Teacher path (inference): client teacher bottoms + server
        teacher top -> (pseudo-labels, confidence mask, projected z)."""
        t_feats = self._bottoms_forward(teacher_bottoms, xw)
        if self.act_fmt is not None:
            # uplink: each client's teacher features cross the link
            # quantized, one amax scale per client
            t_feats = kernels.quantize_dequantize(t_feats, self.act_fmt,
                                                  per_slice=True)
        t_flat = t_feats.reshape((-1,) + t_feats.shape[2:])
        t_logits = self.model.top_apply(teacher["top"], t_flat)
        pseudo, conf_ok, _ = losses.pseudo_labels(
            t_logits, self.s.confidence_threshold)
        tz = apply_projection_head(teacher["proj"], pool_features(t_flat))
        return pseudo, conf_ok, tz

    def _student_forward(self, bottoms, top, xs, masks):
        feats = self._bottoms_forward(bottoms, xs)
        if self.act_fmt is not None:
            # uplink: quantized student features, straight-through gradient
            feats = fake_quantize(feats, self.act_fmt)
        if self.grad_fmt is not None:
            # downlink: the cotangent at the cut is quantized per client
            feats = quantize_grad(feats, self.grad_fmt)
        feats_flat = feats.reshape((-1,) + feats.shape[2:])
        return self.model.top_apply(top, feats_flat, masks), feats_flat

    def semi_step(self, carry: SemiCarry, xu: torch.Tensor, draws=None):
        """One cross-entity iteration; xu: (N, B, H, W, C) unlabeled client
        batches on the device.  Returns (new carry, (loss, h, mask_rate))
        as device tensors."""
        n, b = xu.shape[0], xu.shape[1]
        if draws is None:
            draws = self.sampler.semi(n, b)
        weak, strong, masks = draws
        flat = xu.reshape((n * b,) + xu.shape[2:])
        xw = weak_augment(flat, weak).reshape(xu.shape)
        xs = strong_augment(flat, strong).reshape(xu.shape)
        lr, s, q = self.lr, self.s, carry.queue

        with torch.no_grad():
            pseudo, conf_ok, tz = self._teacher_targets(
                carry.teacher, carry.teacher_bottoms, xw)

        bottoms = requires_grad(carry.bottoms)
        top = requires_grad(carry.top)
        proj = requires_grad(carry.proj)
        logits, feats_flat = self._student_forward(bottoms, top, xs, masks)
        h = losses.cross_entropy(logits, pseudo, mask=conf_ok)
        loss = h
        if self.use_clustering:
            z = apply_projection_head(proj, pool_features(feats_flat))
            # Eq. (5) through the clustering kernel; anchors are gated by
            # the pseudo-label's confidence
            loss = h + kernels.clustering_loss(z, pseudo, conf_ok, q.z,
                                               q.label, q.conf, q.valid,
                                               s.temperature)
        # without the clustering term proj gets a zero gradient and stays
        grads = grads_of(loss, {"bottoms": bottoms, "top": top,
                                "proj": proj},
                         unused=() if self.use_clustering else ("proj",))
        g_bottoms, g_top, g_proj = (grads[k] for k in ("bottoms", "top",
                                                       "proj"))
        with torch.no_grad():
            # Eq. (7): the loss already averages over all N*B samples;
            # Eq. (8): each client applies its own gradient, so undo 1/N
            g_bottoms = tree_map(lambda g: g * n, g_bottoms)
            step_ = lambda p, g: p - lr * g
            new_bottoms = tree_map(step_, carry.bottoms, g_bottoms)
            new_top = tree_map(step_, carry.top, g_top)
            new_proj = tree_map(step_, carry.proj, g_proj)
            new_t_bottoms = ema_update(carry.teacher_bottoms, new_bottoms,
                                       s.ema_decay)
            queue = enqueue(q, tz, pseudo, conf_ok)
            mask_rate = 1.0 - conf_ok.float().mean()
        new_carry = SemiCarry(bottoms=new_bottoms,
                              teacher_bottoms=new_t_bottoms, top=new_top,
                              proj=new_proj, teacher=carry.teacher,
                              queue=queue, step=carry.step + 1)
        return new_carry, (loss.detach(), h.detach(), mask_rate)

    # ------------------------------------------------------------------
    # one aggregation round
    # ------------------------------------------------------------------
    def broadcast(self, state: SemiSFLState):
        """Step (2): replicate global + teacher bottoms to active clients."""
        stack = lambda t: t.expand((self.n_active,) + t.shape).clone()
        return (tree_map(stack, state.params["bottom"]),
                tree_map(stack, state.teacher["bottom"]))

    @staticmethod
    def aggregate(client_bottoms):
        """Step (5): FedAvg over the client axis."""
        return tree_map(lambda t: t.mean(dim=0), client_bottoms)

    def _ensure_prefetcher(self, labeled: Loader,
                           client_loaders_: list[Loader]) -> RoundPrefetcher:
        """The prefetcher bound to these loader objects (it owns their
        streams between rounds); other loaders close it and bind anew."""
        key = (id(labeled), tuple(id(ld) for ld in client_loaders_))
        if self._prefetcher is not None and key != self._prefetch_key:
            self.close()
        if self._prefetcher is None:
            put = DevicePut(self.device)
            self._prefetcher = RoundPrefetcher(
                labeled, client_loaders_, k_u=self.s.k_u,
                n_active=self.n_active, sup_put=put, cli_put=put)
            self._prefetch_key = key
        return self._prefetcher

    def prefetch_stats(self) -> Optional[dict]:
        """The prefetcher's counters (``RoundPrefetcher.stats``), or None
        before the first prefetched round."""
        return self._prefetcher.stats() if self._prefetcher else None

    def close(self) -> None:
        """Shut the prefetch worker down, its speculative draws rolled
        back; idempotent, and the system stays usable."""
        if self._prefetcher is not None:
            self._prefetcher.close()
            self._prefetcher = None
            self._prefetch_key = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass

    def _supervised_inputs(self, labeled: Loader, pf, k_s: int):
        """The supervised phase's (K_s, B, ...) images and labels on the
        device."""
        if pf is not None:
            return ready(pf.get_supervised(k_s))
        xs, ys = labeled.next_many(k_s)
        return to_device(xs, self.device), to_device(ys, self.device)

    def _client_inputs(self, client_loaders_: list[Loader], pf,
                       active: list[int], k_u: int) -> torch.Tensor:
        """The cross-entity phase's (K_u, N, B, ...) images on the
        device."""
        if pf is not None:
            return ready(pf.get_clients(active, k_u))[0]
        xs, _ = stack_client_batches_many(client_loaders_, active, k_u)
        return to_device(xs, self.device)

    def run_round(self, state: SemiSFLState, labeled: Loader,
                  client_loaders_: list[Loader], controller: FreqController,
                  active: Optional[list[int]] = None,
                  rng_np: Optional[np.random.RandomState] = None
                  ) -> tuple[SemiSFLState, RoundMetrics]:
        """Drive one aggregation round; returns the new state and metrics
        (the incoming state is left as it was).  The losses stay on the
        device until one read at the round's end.  The scanned executor
        takes each phase's inputs and draws before the phase and runs it
        as one program (``core/scan.py``); the eager one takes them step
        by step.  With ``prefetch`` the stacks come from the prefetch
        worker, which starts on the next round's once this round's phases
        are dispatched.  Broadcast, selection, the aggregate and the
        controller run once a round, outside the phases.  The three phases
        are ``torch.profiler`` spans (``semisfl.supervised_phase``,
        ``semisfl.cross_entity_phase``, ``semisfl.aggregate``), which cost
        nothing with no profiler on."""
        k_s, k_u = controller.k_s, self.s.k_u
        pf = (self._ensure_prefetcher(labeled, client_loaders_)
              if self.prefetch else None)

        # (1) supervised phase
        with record_function("semisfl.supervised_phase"):
            if self.scan_rounds or pf is not None:
                xs, ys = self._supervised_inputs(labeled, pf, k_s)
            if self.scan_rounds:
                draws = tree_stack([self.sampler.supervised(xs.shape[1])
                                    for _ in range(k_s)])
                state, f_s = self.supervised_phase(state,
                                                   ((xs, ys), draws))
            else:
                f_s = []
                for i in range(k_s):
                    if pf is None:
                        x, y = (to_device(a, self.device)
                                for a in labeled.next())
                    else:
                        x, y = xs[i], ys[i]
                    state, loss = self.supervised_step(state, (x, y))
                    f_s.append(loss)
                f_s = torch.stack(f_s)

        # (2) broadcast
        if active is None:
            active = list(selection_rng(self, rng_np).choice(
                len(client_loaders_),
                size=min(self.n_active, len(client_loaders_)),
                replace=False))
        bottoms, t_bottoms = self.broadcast(state)

        # (3)-(4) cross-entity phase
        carry = SemiCarry(bottoms=bottoms, teacher_bottoms=t_bottoms,
                          top=state.params["top"],
                          proj=state.params["proj"], teacher=state.teacher,
                          queue=state.queue, step=state.step)
        f_u = masks = torch.zeros((0,), device=self.device)
        with record_function("semisfl.cross_entity_phase"):
            if k_u and (self.scan_rounds or pf is not None):
                xus = self._client_inputs(client_loaders_, pf, active, k_u)
            if k_u and self.scan_rounds:
                n, b = xus.shape[1], xus.shape[2]
                draws = tree_stack([self.sampler.semi(n, b)
                                    for _ in range(k_u)])
                carry, (f_u, _h, masks) = self.semi_phase(carry,
                                                          (xus, draws))
            elif k_u:
                f_u, masks = [], []
                for i in range(k_u):
                    if pf is None:
                        xu = to_device(stack_client_batches(
                            client_loaders_, active)[0], self.device)
                    else:
                        xu = xus[i]
                    carry, (loss, _h, mask_rate) = self.semi_step(carry, xu)
                    f_u.append(loss)
                    masks.append(mask_rate)
                f_u, masks = torch.stack(f_u), torch.stack(masks)
        if pf is not None:
            # the phases are dispatched: the worker builds the next round's
            # stacks while they run and while the losses are read below
            pf.speculate(k_s, selection_rng(self, rng_np))

        # (5) aggregate the bottoms and the teacher bottoms; a top-k wire
        # uploads sparsified deltas against the broadcast references
        frac = self.wire.topk_frac
        teacher = carry.teacher
        with record_function("semisfl.aggregate"):
            if frac < 1.0:
                agg_bottom = sparse_delta_mean(carry.bottoms,
                                               state.params["bottom"], frac)
                agg_t_bottom = sparse_delta_mean(carry.teacher_bottoms,
                                                 teacher["bottom"], frac)
            else:
                agg_bottom = self.aggregate(carry.bottoms)
                agg_t_bottom = self.aggregate(carry.teacher_bottoms)
        params = {"bottom": agg_bottom, "top": carry.top,
                  "proj": carry.proj}
        state = SemiSFLState(params=params,
                             teacher=dict(teacher, bottom=agg_t_bottom),
                             opt=state.opt, queue=carry.queue,
                             round=state.round + 1, step=carry.step)

        # one host read of the round's losses
        host = torch.cat([f_s.float(), f_u.float(), masks.float()]).cpu()
        f_s_h, f_u_h, mask_h = np.split(host.numpy(),
                                        [k_s, k_s + len(f_u)])
        mean = lambda a: float(np.mean(a)) if len(a) else 0.0
        f_s_m, f_u_m = mean(f_s_h), mean(f_u_h)
        controller.update(f_s_m, f_u_m)
        return state, RoundMetrics(f_s=f_s_m, f_u=f_u_m,
                                   mask_rate=mean(mask_h), k_s=k_s)

    @torch.no_grad()
    def evaluate(self, state: SemiSFLState, test_x: np.ndarray,
                 test_y: np.ndarray, batch: int = 256) -> float:
        """Test accuracy of the teacher model, read once at the end."""
        correct = torch.zeros((), device=self.device)
        for i in range(0, len(test_y), batch):
            xb = to_device(test_x[i: i + batch], self.device)
            yb = to_device(test_y[i: i + batch], self.device)
            logits, _, _ = self._forward(state.teacher, xb)
            correct += (logits.argmax(-1) == yb).float().sum()
        return float(correct.cpu()) / len(test_y)


def make_controller(cfg: ArchConfig, n_labeled: int,
                    n_total: int) -> FreqController:
    return FreqController(cfg.semisfl, n_labeled, n_total)
