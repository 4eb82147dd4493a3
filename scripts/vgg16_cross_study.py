#!/usr/bin/env python3
"""Where the paper-vgg16 card-against-CPU step's error comes from, on one
NVIDIA GPU.

  python3 scripts/vgg16_cross_study.py [whole runs] [reruns]   # 5 5

chip_smoke.py phase 6c trains 3 int8 rounds of the full paper-vgg16 at
rate 0.002 and takes one semi step from their state on the card and on the
CPU (``chip_smoke.cross_step``, 2 clients of 8 images, the teacher's
classifier sharpened).  This script does that under cuDNN's default
algorithms and then under deterministic ones (``torch.backends.cudnn``
``deterministic`` on, ``benchmark`` off, for the rounds and the step):

- whole runs: the 3 rounds and the step, ``whole runs`` times; each
  prints the step's largest error (and its leaf), the rounds' wall and
  how far the trained state lies from the first run's;
- reruns: the step ``reruns`` times from the first run's state;
- the CPU's own spread: how far 1 ulp either way on every float of the
  state moves the CPU's step (what the step's conditioning allows).

About 10 minutes of script.  Imports nothing of JAX."""
from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

ARCH, WIRE, ROUNDS, LR = "paper-vgg16", "int8", 3, 0.002


def _line(tag: str, r: dict) -> str:
    out = (f"{tag}: max|err| {r['err']:.4g} (leaf {r['worst'][0]} "
           f"{r['worst'][1]}), losses {r['lerr']:.3g}, classifier "
           f"x{r['factor']:g}, labels read equal {r['same_q']}, unread "
           f"flips {r['unread']}, within 1e-3 {r['close']}")
    if "ulp_spread" in r:
        out += f"; the CPU's own spread under 1 ulp {r['ulp_spread']:.4g}"
    return out


def main(whole: int, reruns: int) -> int:
    import torch

    from repro_torch.core.engine import SemiSFLSystem
    from repro_torch.tree import tree_leaves
    card = cs.phase_device()
    cs.phase_build()
    # a new system a step, so that every step takes the same draws
    fresh = lambda system: SemiSFLSystem(system.cfg, n_clients_per_round=2,
                                         wire_format=WIRE,
                                         device=system.device)
    for det in (False, True):
        mode = "deterministic" if det else "default"
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=det,
                                        allow_tf32=False):
            first = None
            for k in range(whole):
                t0 = time.perf_counter()
                state, system, _ = cs._train(card, ARCH, WIRE, ROUNDS, lr=LR)
                wall = time.perf_counter() - t0
                small = fresh(system)
                leaves = [t.detach().cpu() for t in tree_leaves(state.params)]
                if first is None:
                    first = (state, system, leaves)
                    moved = 0.0
                else:
                    moved = max(float((a - b).abs().max())
                                for a, b in zip(leaves, first[2]))
                r = cs.cross_step(state, small, batch=8,
                                  ulp_spread=k == 0)
                print(_line(f"[vgg16] {mode} whole run {k}: rounds "
                            f"{wall:.2f} s, the trained parameters "
                            f"{moved:.4g} from run 0's", r))
                del state, system, r
                torch.cuda.empty_cache()
            state, system, _ = first
            for k in range(reruns):
                r = cs.cross_step(state, fresh(system), batch=8)
                print(_line(f"[vgg16] {mode} rerun {k} from run 0's state",
                            r))
            del first, state, system
            torch.cuda.empty_cache()
    print(f"[vgg16] on {card}")
    return 0


if __name__ == "__main__":
    args = [int(a) for a in sys.argv[1:3]]
    sys.exit(main(*(args + [5, 5][len(args):])))
