"""The SemiSFL training engine (Section III workflow + Alg. 1) in PyTorch:
the JAX package's ``core/engine.py`` on its vmapped executor's semantics,
run eagerly.

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

The client axis is a loop over clients in the bottom forward: each
client's slice of the stacked bottom gets exactly its own gradient.  The
split-link wire (``core/wire.py``) quantizes the stacked cut features with
one scale per client, through the quantize kernels.

Random draws (augmentation and dropout masks) come from a
:class:`DrawSampler` holding one ``torch.Generator`` on the device; the
steps also take the draws as arguments, so a test can feed both this port
and the JAX package the same ones."""
from __future__ import annotations

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
from repro_torch.core.split import (apply_projection_head,
                                    init_projection_head, pool_features,
                                    proj_dim)
from repro_torch.core.wire import (WireFormatLike, fake_quantize,
                                   parse_wire_format, quantize_grad,
                                   resolve_fmt, sparse_delta_mean)
from repro_torch.data.augment import (sample_strong, sample_weak,
                                      strong_augment, weak_augment)
from repro_torch.data.pipeline import Loader, stack_client_batches
from repro_torch.device import resolve_device
from repro_torch.models.cnn import CNNModel
from repro_torch.optim.optimizers import apply_updates, sgd
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


class SemiSFLState(NamedTuple):
    params: Any        # {"bottom", "top", "proj"}: the global model w
    teacher: Any       # same structure: w~
    opt: Any           # momentum buffers of params (supervised phase)
    queue: FeatureQueue
    round: int
    step: int          # cumulative count of supervised and semi steps


class SemiCarry(NamedTuple):
    """What the cross-entity phase threads from step to step."""
    bottoms: Any           # stacked (N, ...) client bottoms
    teacher_bottoms: Any   # stacked (N, ...) client teacher bottoms
    top: Any
    proj: Any
    teacher: Any           # frozen during the phase
    queue: FeatureQueue
    step: int


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


def client_slice(stacked, i: int):
    """Client ``i``'s tree from a stacked (N, ...) tree."""
    return tree_map(lambda t: t[i], stacked)


def requires_grad(tree):
    return tree_map(lambda t: t.detach().requires_grad_(True), tree)


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


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
            round=0, step=0)

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
        """Each client's bottom on its own batch: (N, B, ...) -> stacked
        (N, B, H', W', C) cut features."""
        return torch.stack([self.model.bottom_apply(client_slice(bottoms, i),
                                                    x[i])
                            for i in range(x.shape[0])])

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

    def run_round(self, state: SemiSFLState, labeled: Loader,
                  client_loaders_: list[Loader], controller: FreqController,
                  active: Optional[list[int]] = None,
                  rng_np: Optional[np.random.RandomState] = None
                  ) -> tuple[SemiSFLState, RoundMetrics]:
        """Drive one aggregation round; returns the new state and metrics.
        The losses stay on the device until one read at the round's end.
        The three phases are ``torch.profiler`` spans
        (``semisfl.supervised_phase``, ``semisfl.cross_entity_phase``,
        ``semisfl.aggregate``), which cost nothing with no profiler on."""
        k_s, k_u = controller.k_s, self.s.k_u

        # (1) supervised phase
        f_s = []
        with record_function("semisfl.supervised_phase"):
            for _ in range(k_s):
                x, y = labeled.next()
                state, loss = self.supervised_step(
                    state, (to_device(x, self.device),
                            to_device(y, self.device)))
                f_s.append(loss)

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
        f_u, masks = [], []
        with record_function("semisfl.cross_entity_phase"):
            for _ in range(k_u):
                xu, _ = stack_client_batches(client_loaders_, active)
                carry, (loss, _h, mask_rate) = self.semi_step(
                    carry, to_device(xu, self.device))
                f_u.append(loss)
                masks.append(mask_rate)

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

        host = lambda xs: (torch.stack(xs).cpu().numpy() if xs
                           else np.zeros((0,)))
        f_s_h, f_u_h, mask_h = host(f_s), host(f_u), host(masks)
        f_s_m = float(np.mean(f_s_h)) if len(f_s_h) else 0.0
        f_u_m = float(np.mean(f_u_h)) if len(f_u_h) else 0.0
        controller.update(f_s_m, f_u_m)
        mask_m = float(np.mean(mask_h)) if len(mask_h) else 0.0
        return state, RoundMetrics(f_s=f_s_m, f_u=f_u_m, mask_rate=mask_m,
                                   k_s=k_s)

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
