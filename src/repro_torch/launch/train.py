"""Training launcher for the PyTorch port (the JAX package's
``launch/train.py``, without its scale-out options).

Runs the paper's alternating-round training loop (Alg. 1), or one of its
baselines, on the synthetic image task, on the card unless
``device="cpu"`` is asked for:

  PYTHONPATH=src python -m repro_torch.launch.train --arch paper-cnn \
      --rounds 30 --full-config
  PYTHONPATH=src python -m repro_torch.launch.train --arch paper-cnn \
      --baseline fedswitch --dirichlet 0.1 --ckpt runs/fedswitch
"""
from __future__ import annotations

import argparse
import time
from dataclasses import replace
from typing import Any, NamedTuple, Optional

import numpy as np

from repro_torch.checkpoint.io import save_state
from repro_torch.configs import get_config, smoke_config
from repro_torch.core.adaptation import FreqController
from repro_torch.core.baselines import BASELINES, make_fedswitch_sl
from repro_torch.core.engine import SemiSFLSystem, make_controller
from repro_torch.core.wire import parse_wire_format
from repro_torch.data.partition import dirichlet_partition, uniform_partition
from repro_torch.data.pipeline import Loader, client_loaders
from repro_torch.data.synthetic import (Dataset, make_image_dataset,
                                        train_test_split)
from repro_torch.device import resolve_device


# the methods with a split link: only they carry a wire format
SPLIT_BASELINES = ("semisfl", "fedswitch-sl")
WIRE_BASELINE_ERR = ("--wire-format compresses the split-link payloads; "
                     "full-model baselines exchange whole models and have "
                     "no split link")


def build_system(name: str, cfg, **kw):
    """The system of method ``name``: SemiSFL, FedSwitch-SL or one of
    :data:`BASELINES` (which take no wire format)."""
    if name == "semisfl":
        return SemiSFLSystem(cfg, **kw)
    if name == "fedswitch-sl":
        return make_fedswitch_sl(cfg, **kw)
    kw.pop("wire_format", None)
    return BASELINES[name](cfg, **kw)


class Run(NamedTuple):
    """Everything one training run drives, as :func:`build_run` sets it
    up."""
    system: Any        # SemiSFLSystem or a baseline of core/baselines.py
    state: Any
    controller: FreqController
    labeled: Loader
    clients: list
    test: Dataset
    select_rng: np.random.RandomState


def build_run(arch: str = "paper-cnn", baseline: str = "semisfl",
              n_labeled: int = 250,
              n_total: int = 2400, n_clients: int = 10, n_active: int = 5,
              dirichlet: float = 0.0, labeled_batch: int = 32,
              client_batch: int = 16, seed: int = 0, smoke: bool = True,
              k_s: int = 15, k_u: int = 4, queue_len: int = 512,
              wire_format: Optional[str] = None, lr: float = 0.02,
              device: str = "cuda") -> Run:
    """Data, partitions, loaders, system, initial state and controller of
    a run (the set-up half of the JAX launcher's ``run_training``).

    ``queue_len`` replaces the config's queue length, as the JAX launcher's
    fixed 512 does; ``lr`` is the system's constant learning rate (the
    paper's 0.02 by default); ``device`` is where everything runs ("cuda" by
    default, raising if there is no card).  Raises ``SystemExit`` for an
    arch that is not a CNN, and for a wire format given to a full-model
    baseline."""
    dev = resolve_device(device)
    cfg = smoke_config(arch) if smoke else get_config(arch)
    cfg = replace(cfg, semisfl=replace(
        cfg.semisfl, k_s_init=k_s, k_u=k_u, queue_len=queue_len,
        observation_period=3, adaptation_window=3))
    if cfg.arch_type != "cnn":
        raise SystemExit("train.py drives the classification rig; the LM "
                         "archs serve through launch/serve.py")
    wire = parse_wire_format(wire_format)   # validates the spelling early
    if not wire.identity and baseline not in SPLIT_BASELINES:
        raise SystemExit(WIRE_BASELINE_ERR)
    ds = make_image_dataset(seed, num_classes=cfg.num_classes,
                            n=n_total + 400, image_size=cfg.image_size)
    train, test = train_test_split(ds, 400, seed=seed)
    lab_idx = np.arange(n_labeled)
    unl_idx = np.arange(n_labeled, len(train.y))
    if dirichlet > 0:
        parts = dirichlet_partition(seed, train.y[unl_idx], n_clients,
                                    dirichlet)
        parts = [unl_idx[p] for p in parts]
    else:
        parts = [unl_idx[p] for p in
                 uniform_partition(seed, len(unl_idx), n_clients)]

    system = build_system(baseline, cfg, n_clients_per_round=n_active,
                          lr=lr, wire_format=wire, device=dev)
    return Run(system=system, state=system.init_state(seed),
               controller=make_controller(cfg, n_labeled, len(train.y)),
               labeled=Loader(train, lab_idx, labeled_batch, seed),
               clients=client_loaders(train, parts, client_batch, seed + 1),
               test=test,
               # one host-side selection RandomState per run
               select_rng=np.random.RandomState(seed))


def run_training(arch: str = "paper-cnn", rounds: int = 30,
                 eval_every: int = 5, log=print, baseline: str = "semisfl",
                 state=None, **kw):
    """Train ``baseline`` for ``rounds`` rounds; returns (state, history,
    system).  ``state``, in the layout of ``baseline``'s ``init_state``
    (a trained or restored one), replaces the seeded initial state; ``kw``
    goes to :func:`build_run`."""
    run = build_run(arch, baseline, **kw)
    sys_, ctrl = run.system, run.controller
    state = run.state if state is None else state
    history = []
    for r in range(rounds):
        t0 = time.time()
        state, m = sys_.run_round(state, run.labeled, run.clients, ctrl,
                                  rng_np=run.select_rng)
        rec = {"round": r, "k_s": ctrl.k_s, "dt": time.time() - t0}
        if r % eval_every == 0 or r == rounds - 1:
            rec["test_acc"] = sys_.evaluate(state, run.test.x, run.test.y)
            if not isinstance(m, dict):
                m.test_acc = rec["test_acc"]
        rec.update(m if isinstance(m, dict) else
                   {"f_s": m.f_s, "f_u": m.f_u, "mask_rate": m.mask_rate})
        history.append(rec)
        log(f"[{baseline}] round {r}: " + " ".join(
            f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in rec.items() if k != "round"))
    return state, history, sys_


def main(argv: Optional[list] = None):
    """The CLI; returns what :func:`run_training` returns."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper-cnn")
    ap.add_argument("--baseline", default="semisfl",
                    choices=list(SPLIT_BASELINES) + list(BASELINES))
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--labeled", type=int, default=250)
    ap.add_argument("--total", type=int, default=2400)
    ap.add_argument("--clients", type=int, default=10)
    ap.add_argument("--active", type=int, default=5)
    ap.add_argument("--dirichlet", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--wire-format", default=None,
                    help="fp32 (default), int8 or fp8, optionally with a "
                         "top-k delta upload, e.g. 'int8+topk0.1'; split "
                         "methods only")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt", default=None,
                    help="write the trained params to CKPT.npz (JAX layout, "
                         "keyed by tree path) and CKPT.json")
    args = ap.parse_args(argv)
    out = run_training(arch=args.arch, baseline=args.baseline,
                       rounds=args.rounds, n_labeled=args.labeled,
                       n_total=args.total, n_clients=args.clients,
                       n_active=args.active, dirichlet=args.dirichlet,
                       seed=args.seed, smoke=not args.full_config,
                       wire_format=args.wire_format, device=args.device)
    if args.ckpt:
        # the params in the JAX layout and the run's record beside them, as
        # the JAX launcher's --ckpt writes them
        save_state(args.ckpt, out[0].params,
                   {"history": out[1], "arch": args.arch,
                    "baseline": args.baseline})
        print(f"checkpoint -> {args.ckpt}.npz")
    return out


if __name__ == "__main__":
    main()
