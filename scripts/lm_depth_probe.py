#!/usr/bin/env python3
"""Probe how deep the port's LMs train on one NVIDIA GPU.

  python3 scripts/lm_depth_probe.py [--arch ARCH] [--graph] [layers:rate ...]

For each depth and rate (for xlstm-1.3b, the default arch, by default
48:2e-4 24:2e-4 16:2e-4 48:2e-5; for zamba2-7b 66:0.02 60:0.02 54:0.02; for
deepseek-v2-236b 3:0.02 2:0.02; for qwen2-vl-7b 16:0.02 14:0.02 12:0.02) it
draws the full-width train state of ARCH cut to that many blocks or layers
(bf16, seed 0), then runs 3 SemiSFL steps of chip_smoke.py's LM path
(4 clients x 1 x 4096 tokens, the ``int8`` wire, tau 0) and prints, a step,
the metrics, whether every client bottom is still finite and the step's
wall time.  After the first step it prints that step's gradient, read as
max |change| / rate of client 0's bottom (the step is plain SGD, with Eq.
(8)'s factor N on the bottoms' gradient), of the top and of the
projection head, each with whether it is finite; at the end the largest
change over the 3 steps of client 0's bottom, its teacher and the top, and
the peak device memory.  It is the witness for chip_smoke.py's
LM_TRAIN_PATHS cuts: xLSTM-1.3B's 16 blocks at rate 2e-4 (``python
tests/test_torch_xlstm_train.py`` runs the same reading on the CPU at the
smoke width through both packages) and Zamba2-7B's, DeepSeek-V2's and
Qwen2-VL-7B's depths, where memory sets them.  Each step is a call of the
step function that drops the state it started from, so the peak is one
state, the gradients and the update's new trees.  With ``--graph`` the
steps go through ``make_scanned_train_phase`` as chip_smoke.py's training
phases do (a first call of one step: the eager warm-up steps, the
capture and a replay; then the other steps as one call), whose peak is
the warm-up's or the captured graph's.  It reuses chip_smoke.py's plan and
batch helpers.  Needs a card and ``nvcc``; imports nothing of JAX."""
import gc
import sys
import time
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
STEPS = 3


DEFAULTS = {"xlstm-1.3b": ["48:2e-4", "24:2e-4", "16:2e-4", "48:2e-5"],
            "zamba2-7b": ["66:0.02", "60:0.02", "54:0.02"],
            "deepseek-v2-236b": ["3:0.02", "2:0.02"],
            "qwen2-vl-7b": ["16:0.02", "14:0.02", "12:0.02"]}


def main(arch: str, cases, graph: bool = False) -> None:
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    card = cs.phase_device()
    build.build_all()
    base = get_config(arch)
    for layers, lr in cases:
        try:
            _probe(cs, card, base, layers, lr, graph)
        except torch.cuda.OutOfMemoryError as e:
            print(f"[probe] {arch} at {layers} layers, rate {lr}: out of "
                  f"device memory ({str(e).splitlines()[0]}); peak "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; on "
                  f"{card}", flush=True)
        gc.collect()
        torch.cuda.empty_cache()


def _probe(cs, card: str, base, layers: int, lr: float,
           graph: bool = False) -> None:
    """One depth and rate: STEPS steps, as the module's docstring says."""
    import torch

    from repro_torch.launch import steps
    from repro_torch.tree import tree_leaves
    arch = base.name
    cfg = replace(base, num_layers=layers, semisfl=replace(
        base.semisfl, confidence_threshold=0.0))
    plan = cs._lm_plan(cfg, cs.LM_CLIENTS, cs.LM_SEQ)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = steps.init_train_state(plan, seed=0, device="cuda")
    trees = lambda st: (st["client_bottoms"][0], st["top"], st["proj"],
                        st["teacher_bottoms"][0])
    # copies on the host, so that they do not count in the peak
    snap = lambda st: [[t.cpu() for t in tree_leaves(x)]
                       for x in trees(st)]
    start = snap(state)
    tokens = cs._lm_batches(cfg, STEPS, cs.LM_CLIENTS, cs.LM_SEQ, seed=0)
    if graph:
        phase = steps.make_scanned_train_phase(plan, lr=lr, wire="int8")
        calls = [(0, 1), (1, STEPS)]
    else:
        one = steps.make_train_step(plan, lr=lr, wire="int8")
        phase = lambda st, b: one(st, {k: v[0] for k, v in b.items()})
        calls = [(i, i + 1) for i in range(STEPS)]
    tag = (f"[probe] {arch} at {layers} layers, rate {lr}"
           + (", through the graph" if graph else ""))
    n_bytes = sum(t.numel() * t.element_size()
                  for t in tree_leaves(state) if torch.is_tensor(t))
    print(f"{tag}: the state {n_bytes / 2**30:.3f} GiB", flush=True)
    for i, (a, b) in enumerate(calls):
        t0 = time.perf_counter()
        state, m = phase(state, {k: v[a:b] for k, v in tokens.items()})
        torch.cuda.synchronize()
        finite = all(bool(torch.isfinite(t.float()).all())
                     for t in tree_leaves(state["client_bottoms"]))
        print(f"{tag}, steps {a}-{b - 1}: "
              + ", ".join(f"{k} {m[k].flatten().tolist()}" for k in m)
              + f"; client bottoms finite {finite}; "
              f"{time.perf_counter() - t0:.3f} s; peak so far "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB",
              flush=True)
        if i == 0:
            grads = []
            for name, was, now in zip(
                    ("client 0's bottom", "the top", "the head"),
                    start[:3], snap(state)[:3]):
                ok = all(bool(torch.isfinite(t.float()).all())
                         for t in now)
                g = max(float((a.float() - b.float()).abs().max())
                        for a, b in zip(now, was)) / lr
                grads.append(f"{name} {g:.4g} (finite {ok})")
            print(f"{tag}: the first step's max|gradient|: "
                  + ", ".join(grads), flush=True)
    moved = [max(float((a.float() - b.float()).abs().max())
                 for a, b in zip(now, was))
             for was, now in zip(start, snap(state))]
    print(f"{tag}: max|change| over {STEPS} steps of client 0's bottom "
          f"{moved[0]:.4g}, its teacher {moved[3]:.4g}, the top "
          f"{moved[1]:.4g}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; on "
          f"{card}", flush=True)
    del state, phase, tokens, start


if __name__ == "__main__":
    args = sys.argv[1:]
    arch = "xlstm-1.3b"
    if args[:1] == ["--arch"]:
        arch, args = args[1], args[2:]
    graph = "--graph" in args
    args = [a for a in args if a != "--graph"]
    main(arch, [(int(a.split(":")[0]), float(a.split(":")[1]))
                for a in args or DEFAULTS[arch]], graph)
