#!/usr/bin/env python3
"""Where the error of chip_smoke phase 6b's Supervised-only supervised step
comes from, card against CPU, on one NVIDIA GPU.

  python3 scripts/baseline_cross_study.py [whole runs] [reruns]   # 4 5

chip_smoke.py trains 150 ``int8+topk0.05`` rounds of paper-cnn (phase 4),
then 5 Supervised-only rounds from that model (phase 6a), and holds one
supervised step from their state on the card and on the CPU to 1e-3
(phase 6b).  This script does the same on cuDNN's default algorithms:

- whole runs: the 150 rounds, the 5 rounds and the step, ``whole runs``
  times; each prints the step's largest error (and its leaf) and how far
  the Supervised-only state lies from the first run's;
- reruns: the step ``reruns`` times from the first run's state with the
  first run's draws;
- the CPU's own spread: how far 1 ulp either way on every float of the
  state moves the CPU's step (what the step's conditioning allows).

About 3 minutes of script.  Imports nothing of JAX."""
from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

METHOD = "supervised-only"
FIELDS = ("params", "teacher", "opt")     # the floats of an FLState


def _trained(card: str):
    """Phase 4's int8+topk0.05 model, then METHOD's rounds from it, as
    chip_smoke runs them; returns (state, system)."""
    from repro_torch.launch.train import run_training
    wire, rounds = cs.MAIN_RUNS[0]
    trained, _, _ = cs._train(card, "paper-cnn", wire, rounds)
    state, _, system = run_training(
        "paper-cnn", rounds=cs.BASELINE_ROUNDS, baseline=METHOD,
        state=cs._trained_start(METHOD, trained), wire_format=None,
        log=lambda _: None, **cs.MAIN_PATH)
    return state, system


def _leaves(state) -> list:
    from repro_torch.tree import tree_leaves
    return [t.detach().cpu() for f in FIELDS
            for t in tree_leaves(getattr(state, f))]


def _step(system, cpu, state, batch, draws, ulp_spread: bool) -> str:
    """The step on the card and on the CPU from ``state``; a line with the
    largest error, its leaf, the losses' error and, with ``ulp_spread``,
    the CPU's own spread under 1 ulp of the state."""
    from repro_torch.tree import tree_leaves, tree_map
    xl, yl = batch
    sg, lg = system.supervised_step(
        state, (xl.to(system.device), yl.to(system.device)), draws)
    state_c, draws_c = cs._to_cpu(state), cs._to_cpu(draws)
    sc, lc = cpu.supervised_step(state_c, (xl, yl), draws_c)
    names = [f"{f}[{i}]" for f in FIELDS
             for i in range(len(tree_leaves(getattr(sg, f))))]
    got, want = _leaves(sg), _leaves(sc)
    errs = [float((a - b).abs().max()) for a, b in zip(got, want)]
    worst = max(range(len(errs)), key=errs.__getitem__)
    line = (f"max|err| {errs[worst]:.4g} (leaf {names[worst]} "
            f"{tuple(got[worst].shape)}), loss {float(lg):.8g} vs "
            f"{float(lc):.8g}, within 1e-3 {errs[worst] <= 1e-3}")
    if ulp_spread:
        spread = 0.0
        for sign in (1, -1):
            nudged = state_c._replace(**{
                f: tree_map(lambda t: (t * (1 + sign * 2.0 ** -23)
                                       if t.is_floating_point() else t),
                            getattr(state_c, f)) for f in FIELDS})
            moved, _ = cpu.supervised_step(nudged, (xl, yl), draws_c)
            spread = max(spread, max(float((a - b).abs().max()) for a, b
                                     in zip(want, _leaves(moved))))
        line += f"; the CPU's own spread under 1 ulp {spread:.4g}"
    return line


def main(whole: int, reruns: int) -> int:
    import torch
    card = cs.phase_device()
    cs.phase_build()
    hw = None
    first = None
    for k in range(whole):
        t0 = time.perf_counter()
        state, system = _trained(card)
        wall = time.perf_counter() - t0
        if hw is None:
            hw = system.cfg.image_size
            xl, yl = cs._images(6, 1, cs.MAIN_PATH["labeled_batch"], hw)
            batch = (xl[0], yl[0])
        cpu = type(system)(system.cfg, n_clients_per_round=cs.N_ACTIVE,
                           device="cpu")
        draws = system.sampler.supervised(len(batch[1]))
        leaves = _leaves(state)
        moved = (0.0 if first is None else
                 max(float((a - b).abs().max())
                     for a, b in zip(leaves, first[3])))
        line = _step(system, cpu, state, batch, draws, ulp_spread=True)
        print(f"[sup] whole run {k}: rounds {wall:.2f} s, the state "
              f"{moved:.4g} from run 0's; {line}")
        if first is None:
            first = (state, system, draws, leaves, cpu)
        else:
            del state, system
        torch.cuda.empty_cache()
    state, system, draws, _, cpu = first
    for k in range(reruns):
        print(f"[sup] rerun {k} from run 0's state and draws: "
              + _step(system, cpu, state, batch, draws, ulp_spread=False))
    print(f"[sup] on {card}")
    return 0


if __name__ == "__main__":
    args = [int(a) for a in sys.argv[1:3]]
    sys.exit(main(*(args + [4, 5][len(args):])))
