"""The paper's comparison baselines (Section V-B) in PyTorch: the JAX
package's ``core/baselines.py``.

  * Supervised-only: labeled data only, on the PS (the lower bound).
  * SemiFL (Diao et al., NeurIPS'22): clients pseudo-label with the latest
    global model and train full local replicas on strongly augmented data
    with a Mixup loss; full-model FedAvg.
  * FedMatch (Jeong et al., ICLR'21): w = sigma + psi, sigma supervised on
    the PS and psi unsupervised on the clients, with inter-client
    consistency against the other clients' predictions.
  * FedSwitch (Zhao et al., 2023): an EMA teacher pseudo-labels, switched
    per client with the student on relative confidence.
  * FedSwitch-SL: SemiSFL's split pipeline without the clustering and
    supervised-contrastive terms, the paper's key ablation.

The full-model baselines keep the clients on a stacked leading axis of
every leaf, as the JAX package's vmapped steps do.  Their loss averages
over all N x B samples, so each client's gradient is scaled by N (the JAX
steps' ``grads * n``); the port loops over clients in the forward, and
each client's slice of the stack gets its own gradient.

Random draws (augmentation, dropout masks, SemiFL's Mixup weight and
permutation) come from an :class:`FLDrawSampler`; the steps also take them
as arguments, so that a test can give both packages the same ones."""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs import ArchConfig
from repro_torch.core import losses
from repro_torch.core.ema import ema_update
from repro_torch.core.engine import (SemiSFLSystem, client_slice, grads_of,
                                     requires_grad, selection_rng, to_device)
from repro_torch.data.augment import (StrongDraws, WeakDraws, sample_strong,
                                      sample_weak, strong_augment,
                                      weak_augment)
from repro_torch.data.pipeline import Loader, stack_client_batches
from repro_torch.device import resolve_device
from repro_torch.models.cnn import CNNModel
from repro_torch.optim.optimizers import apply_updates, sgd
from repro_torch.tree import tree_leaves, tree_map

MIXUP_ALPHA = 0.75        # SemiFL's Mixup weight ~ Beta(0.75, 0.75)


class FLState(NamedTuple):
    params: Any
    teacher: Any
    opt: Any          # momentum buffers of the supervised part of params
    round: int


class LocalDraws(NamedTuple):
    """One local step's draws for N client batches of B, client-major."""
    weak: Optional[WeakDraws]
    strong: Optional[StrongDraws]
    masks: tuple               # per train forward: FC keep masks or None
    lam: Optional[torch.Tensor] = None    # SemiFL: 0-d Mixup weight
    perm: Optional[torch.Tensor] = None   # SemiFL: (B,) batch permutation


class FLDrawSampler:
    """The baselines' draws from one ``torch.Generator`` on the device.
    ``forwards`` is the number of train forwards a local step takes (each
    gets its own dropout masks), ``mixup`` adds SemiFL's draws."""

    def __init__(self, model: CNNModel, seed: int, device: torch.device,
                 forwards: int = 1, mixup: bool = False):
        self.model = model
        self.device = device
        self.forwards = forwards
        self.mixup = mixup
        self.gen = torch.Generator(device=device).manual_seed(seed)

    def _masks(self, n: int):
        return self.model.draw_dropout_masks(n, self.gen, self.device)

    def supervised(self, batch: int):
        """(strong draws of one call over the batch, masks or None)."""
        return (sample_strong(1, batch, self.model.cfg.image_size, self.gen),
                self._masks(batch))

    def local(self, n: int, batch: int) -> LocalDraws:
        if not self.forwards:
            return LocalDraws(None, None, ())
        weak = sample_weak(n * batch, self.gen)
        strong = sample_strong(n, batch, self.model.cfg.image_size, self.gen)
        masks = tuple(self._masks(n * batch) for _ in range(self.forwards))
        if not self.mixup:
            return LocalDraws(weak, strong, masks)
        g = torch._standard_gamma(
            torch.full((2,), MIXUP_ALPHA, device=self.gen.device),
            generator=self.gen)
        perm = torch.randperm(batch, generator=self.gen,
                              device=self.gen.device)
        return LocalDraws(weak, strong, masks, g[0] / g.sum(), perm)


def _rows(masks, i: int, b: int):
    return None if masks is None else [m[i * b:(i + 1) * b] for m in masks]


def _full_forward(model: CNNModel, params, x, masks=None):
    """Full-model logits; ``masks`` (train mode only) are the FC dropout
    keep masks, so AlexNet/VGG baselines train under the split system's
    dropout while pseudo-labelling and evaluation stay deterministic."""
    return model.top_apply(params["top"],
                           model.bottom_apply(params["bottom"], x), masks)


def _client_forward(model: CNNModel, stacked, xs, masks):
    """Each client's model on its own batch: (N, B, ...) -> (N, B, M)."""
    b = xs.shape[1]
    return torch.stack([_full_forward(model, client_slice(stacked, i), xs[i],
                                      _rows(masks, i, b))
                        for i in range(xs.shape[0])])


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with JAX's derivative at 0 (+1; PyTorch's ``abs`` gives 0):
    FedMatch's psi starts at zero."""
    return torch.where(x >= 0, x, -x)


def _sgd_step(params, grads, lr: float, n: int):
    """Plain SGD on stacked client params with the per-client gradient."""
    return tree_map(lambda p, g: p - lr * (g * n), params, grads)


def _augment(xu, draws: LocalDraws):
    flat = xu.reshape((-1,) + xu.shape[2:])
    return (weak_augment(flat, draws.weak).reshape(xu.shape),
            strong_augment(flat, draws.strong).reshape(xu.shape))


def _mean(vals: list) -> float:
    """The mean of a phase's device losses, read once."""
    if not vals:
        return 0.0
    return float(np.mean([float(v) for v in torch.stack(vals).cpu()]))


class FLBase:
    """Shared full-model FL machinery: broadcast, local training and
    FedAvg."""

    name = "fl-base"
    local_forwards = 1         # train forwards in a local step
    mixup = False

    def __init__(self, cfg: ArchConfig, *, n_clients_per_round: int = 10,
                 lr: float = 0.02, momentum: float = 0.9,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.s = cfg.semisfl
        self.model = CNNModel(cfg)
        self.n_active = n_clients_per_round
        self.opt = sgd(momentum=momentum)
        self.lr = lr
        # init_state reseeds both from its seed; a test may swap the sampler
        self.sampler = self._sampler(1)
        self._select_rng: Optional[np.random.RandomState] = None

    def _sampler(self, seed: int) -> FLDrawSampler:
        return FLDrawSampler(self.model, seed, self.device,
                             self.local_forwards, self.mixup)

    # -- the parameter layout (FedMatch splits it in two) ----------------
    def _init_params(self, model_params):
        return model_params

    def _full(self, params):
        """The model the parameters stand for."""
        return params

    def _supervised_part(self, params):
        """What the supervised phase trains."""
        return params

    def _with_supervised_part(self, params, part):
        return part

    def init_state(self, seed: int = 0) -> FLState:
        gen = torch.Generator(device=self.device).manual_seed(seed)
        params = self._init_params(self.model.init(gen, self.device))
        self.sampler = self._sampler(seed + 1)
        self._select_rng = np.random.RandomState(seed)
        return FLState(params=params,
                       teacher=tree_map(torch.clone, params),
                       opt=self.opt.init(self._supervised_part(params)),
                       round=0)

    # -- steps ---------------------------------------------------------
    def supervised_step(self, state: FLState, batch, draws=None):
        """One labeled iteration on the PS (strong augmentation, CE,
        momentum SGD, teacher EMA).  Returns (new state, loss tensor)."""
        x, y = batch
        if draws is None:
            draws = self.sampler.supervised(x.shape[0])
        strong, masks = draws
        xs = strong_augment(x, strong)
        part = self._supervised_part(state.params)
        leaf = requires_grad(part)
        full = self._full(self._with_supervised_part(state.params, leaf))
        loss = losses.cross_entropy(
            _full_forward(self.model, full, xs, masks), y)
        grads = grads_of(loss, leaf)
        with torch.no_grad():
            updates, mu = self.opt.update(grads, state.opt, part, self.lr)
            params = self._with_supervised_part(
                state.params, apply_updates(part, updates))
            teacher = ema_update(state.teacher, params, self.s.ema_decay)
        return FLState(params=params, teacher=teacher, opt=mu,
                       round=state.round), loss.detach()

    def local_step(self, client_params, teacher, global_params, xu,
                   draws: Optional[LocalDraws] = None):
        """One unsupervised step on the stacked clients; xu: (N, B, H, W,
        C).  Returns (new client params, loss tensor)."""
        raise NotImplementedError

    # -- one aggregation round -------------------------------------------
    def run_round(self, state: FLState, labeled: Loader,
                  client_loaders_: list[Loader], controller,
                  rng_np: Optional[np.random.RandomState] = None):
        rng_np = selection_rng(self, rng_np)
        k_s = controller.k_s if controller is not None else self.s.k_s_init
        f_s = []
        for _ in range(k_s):
            x, y = labeled.next()
            state, loss = self.supervised_step(
                state, (to_device(x, self.device), to_device(y, self.device)))
            f_s.append(loss)

        active = list(rng_np.choice(len(client_loaders_),
                                    size=min(self.n_active,
                                             len(client_loaders_)),
                                    replace=False))
        n = len(active)
        client_params = tree_map(
            lambda t: t.expand((n,) + t.shape).clone(), state.params)
        f_u = []
        for _ in range(self.s.k_u):
            xu, _ = stack_client_batches(client_loaders_, active)
            client_params, loss = self.local_step(
                client_params, state.teacher, state.params,
                to_device(xu, self.device))
            f_u.append(loss)
        params = tree_map(lambda t: t.mean(dim=0), client_params)
        teacher = ema_update(state.teacher, params, self.s.ema_decay)
        state = FLState(params=params, teacher=teacher, opt=state.opt,
                        round=state.round + 1)
        fs, fu = _mean(f_s), _mean(f_u)
        if controller is not None:
            controller.update(fs, fu)
        return state, {"f_s": fs, "f_u": fu}

    @torch.no_grad()
    def evaluate(self, state: FLState, test_x: np.ndarray,
                 test_y: np.ndarray, batch: int = 256,
                 use_teacher: bool = True) -> float:
        params = self._full(state.teacher if use_teacher else state.params)
        correct = torch.zeros((), device=self.device)
        for i in range(0, len(test_y), batch):
            xb = to_device(test_x[i: i + batch], self.device)
            yb = to_device(test_y[i: i + batch], self.device)
            logits = _full_forward(self.model, params, xb)
            correct += (logits.argmax(-1) == yb).float().sum()
        return float(correct.cpu()) / len(test_y)


# ---------------------------------------------------------------------------


class SupervisedOnly(FLBase):
    name = "supervised-only"
    local_forwards = 0

    def local_step(self, client_params, teacher, global_params, xu,
                   draws=None):
        return client_params, torch.zeros((), device=self.device)

    def run_round(self, state, labeled, client_loaders_, controller,
                  rng_np=None):
        # clients are not involved (Section V-D1)
        k_s = controller.k_s if controller is not None else self.s.k_s_init
        f_s = []
        for _ in range(k_s):
            x, y = labeled.next()
            state, loss = self.supervised_step(
                state, (to_device(x, self.device), to_device(y, self.device)))
            f_s.append(loss)
        state = state._replace(round=state.round + 1)
        fs = _mean(f_s)
        if controller is not None:
            controller.update(fs, fs)
        return state, {"f_s": fs, "f_u": 0.0}


class SemiFL(FLBase):
    """Pseudo-labels from the latest *global* model + a Mixup loss."""

    name = "semifl"
    local_forwards = 2
    mixup = True

    def local_step(self, client_params, teacher, global_params, xu,
                   draws=None):
        n, b = xu.shape[:2]
        if draws is None:
            draws = self.sampler.local(n, b)
        xw, xs = _augment(xu, draws)
        with torch.no_grad():
            # pseudo-label with the up-to-date global model (an inference
            # pass: eval mode, deterministic)
            t_logits = _full_forward(self.model, global_params,
                                     xw.reshape((n * b,) + xw.shape[2:]))
            pseudo, ok, _ = losses.pseudo_labels(
                t_logits.reshape(n, b, -1), self.s.confidence_threshold)
        lam, perm = draws.lam, draws.perm
        x_mix = lam * xs + (1 - lam) * xs[:, perm]
        cp = requires_grad(client_params)
        logits = _client_forward(self.model, cp, xs, draws.masks[0])
        ce = losses.cross_entropy(logits, pseudo, mask=ok)
        logits_m = _client_forward(self.model, cp, x_mix, draws.masks[1])
        mix = (lam * losses.cross_entropy(logits_m, pseudo, mask=ok)
               + (1 - lam) * losses.cross_entropy(
                   logits_m, pseudo[:, perm], mask=ok[:, perm]))
        loss = ce + mix
        grads = grads_of(loss, cp)
        with torch.no_grad():
            return _sgd_step(client_params, grads, self.lr, n), loss.detach()


class FedSwitch(FLBase):
    """EMA teacher pseudo-labelling with an adaptive teacher/student
    switch."""

    name = "fedswitch"

    def local_step(self, client_params, teacher, global_params, xu,
                   draws=None):
        n, b = xu.shape[:2]
        if draws is None:
            draws = self.sampler.local(n, b)
        xw, xs = _augment(xu, draws)
        with torch.no_grad():
            # both labeller candidates are inference passes: eval mode
            t_logits = _full_forward(
                self.model, teacher,
                xw.reshape((n * b,) + xw.shape[2:])).reshape(n, b, -1)
            s_logits = _client_forward(self.model, client_params, xw, None)
            # per client, whichever labeller is more confident
            t_conf = torch.softmax(t_logits, -1).amax(-1).mean(-1)
            s_conf = torch.softmax(s_logits, -1).amax(-1).mean(-1)
            use_t = (t_conf >= s_conf)[:, None, None]
            pseudo, ok, _ = losses.pseudo_labels(
                torch.where(use_t, t_logits, s_logits),
                self.s.confidence_threshold)
        cp = requires_grad(client_params)
        loss = losses.cross_entropy(
            _client_forward(self.model, cp, xs, draws.masks[0]), pseudo,
            mask=ok)
        grads = grads_of(loss, cp)
        with torch.no_grad():
            return _sgd_step(client_params, grads, self.lr, n), loss.detach()


def _add(a, b):
    return tree_map(lambda x, y: x + y, a, b)


class FedMatch(FLBase):
    """Disjoint sigma/psi decomposition + inter-client consistency.

    sigma trains on labeled data at the PS, psi on unlabeled data at the
    clients; the model is sigma + psi.  Each client's consistency target
    is the mean prediction of the other clients' models on its weak batch
    (the paper ships helper models to clients; here they live in the same
    process)."""

    name = "fedmatch"

    def _init_params(self, model_params):
        return {"sigma": model_params,
                "psi": tree_map(torch.zeros_like, model_params)}

    def _full(self, params):
        return _add(params["sigma"], params["psi"])

    def _supervised_part(self, params):
        return params["sigma"]

    def _with_supervised_part(self, params, part):
        return {"sigma": part, "psi": params["psi"]}

    def local_step(self, client_params, teacher, global_params, xu,
                   draws=None):
        n, b = xu.shape[:2]
        if draws is None:
            draws = self.sampler.local(n, b)
        xw, xs = _augment(xu, draws)
        sigma = client_params["sigma"]      # frozen during local training
        with torch.no_grad():
            # helper predictions: the other clients' mean logits (inference
            # passes, eval mode)
            all_logits = _client_forward(
                self.model, _add(sigma, client_params["psi"]), xw, None)
            helper = ((all_logits.mean(dim=0, keepdim=True) * n - all_logits)
                      / max(n - 1, 1))
            tau = self.s.confidence_threshold
            pseudo, ok, _ = losses.pseudo_labels(all_logits, tau)
            h_pseudo, h_ok, _ = losses.pseudo_labels(helper, tau)
        psi = requires_grad(client_params["psi"])
        logits = _client_forward(self.model, _add(sigma, psi), xs,
                                 draws.masks[0])
        ce = losses.cross_entropy(logits, pseudo, mask=ok)
        icc = losses.cross_entropy(logits, h_pseudo, mask=h_ok)
        # L1 sparsity on psi (FedMatch's regularizer)
        l1 = sum(_abs(g).mean() for g in tree_leaves(psi))
        loss = ce + 0.5 * icc + 1e-4 * l1
        grads = grads_of(loss, psi)
        with torch.no_grad():
            return ({"sigma": sigma,
                     "psi": _sgd_step(client_params["psi"], grads, self.lr,
                                            n)},
                    loss.detach())


def make_fedswitch_sl(cfg: ArchConfig, **kw) -> SemiSFLSystem:
    """FedSwitch-SL: the split pipeline minus clustering regularization
    minus the supervised-contrastive term (the paper's ablation)."""
    sys_ = SemiSFLSystem(cfg, use_clustering=False, use_supcon=False, **kw)
    sys_.name = "fedswitch-sl"
    return sys_


BASELINES = {
    "supervised-only": SupervisedOnly,
    "semifl": SemiFL,
    "fedswitch": FedSwitch,
    "fedmatch": FedMatch,
}
