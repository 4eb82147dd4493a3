"""Quickstart: the port's public API in a few lines (the counterpart of
``examples/quickstart.py``).

Trains the paper's customized CNN (smoke size) with clustering
regularization on the synthetic semi-supervised rig for a handful of
rounds and prints the accuracy trajectory.  Runs on the card unless asked
for the CPU:

  PYTHONPATH=src python -m repro_torch.quickstart
  PYTHONPATH=src python -m repro_torch.quickstart --device cpu --rounds 3
"""
from __future__ import annotations

import argparse
from dataclasses import replace
from typing import Optional

import numpy as np

from repro_torch.configs import smoke_config
from repro_torch.core.engine import SemiSFLSystem, make_controller
from repro_torch.data.partition import uniform_partition
from repro_torch.data.pipeline import Loader, client_loaders
from repro_torch.data.synthetic import make_image_dataset, train_test_split


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rounds", type=int, default=12)
    args = ap.parse_args(argv)

    # --- data: 100 labeled samples on the PS, the rest unlabeled on 8
    # clients
    cfg = smoke_config("paper-cnn")
    cfg = replace(cfg, semisfl=replace(cfg.semisfl, k_s_init=15, k_u=4,
                                       queue_len=512))
    ds = make_image_dataset(0, num_classes=10, n=1500,
                            image_size=cfg.image_size)
    train, test = train_test_split(ds, 300)
    labeled = Loader(train, np.arange(100), batch=32, seed=0)
    unlabeled_idx = np.arange(100, len(train.y))
    parts = [unlabeled_idx[p]
             for p in uniform_partition(0, len(unlabeled_idx), 8)]
    clients = client_loaders(train, parts, batch=16, seed=1)

    # --- system: Alg. 1 with clustering regularization + K_s adaptation
    system = SemiSFLSystem(cfg, n_clients_per_round=4, device=args.device)
    state = system.init_state(seed=0)
    controller = make_controller(cfg, n_labeled=100, n_total=len(train.y))

    last = args.rounds - 1
    for r in range(args.rounds):
        state, metrics = system.run_round(state, labeled, clients,
                                          controller)
        if r % 3 == 0 or r == last:
            acc = system.evaluate(state, test.x, test.y)  # teacher (§V-B)
            print(f"round {r:2d}: f_s={metrics.f_s:.3f} "
                  f"f_u={metrics.f_u:.3f} mask={metrics.mask_rate:.2f} "
                  f"K_s={metrics.k_s} teacher_acc={acc:.3f}")
    print("final teacher accuracy:",
          round(system.evaluate(state, test.x, test.y), 3))


if __name__ == "__main__":
    main()
