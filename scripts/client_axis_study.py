#!/usr/bin/env python3
"""What the vmapped client axis costs the paper CNNs' bottoms on one
NVIDIA GPU.

  python3 scripts/client_axis_study.py [arch ...]   # paper-cnn paper-vgg16

The cross-entity step runs each client's bottom on its own batch
(``core/engine.py::SemiSFLSystem._bottoms_forward``).  It does so under
``torch.func.vmap`` over the stacked (N, ...) bottoms, whose batching rule
turns each batched-weight convolution into one grouped convolution.  This
script times the student bottoms' forward and backward at the main path's
10 clients of 32 images, fp32, with TF32 off, in turns:

- ``loop``: one ``bottom_apply`` a client, stacked (the port before the
  client axis was vmapped), for comparison only;
- ``vmap``: the engine's ``_bottoms_forward``, on cuDNN's default
  algorithm choice;
- ``vmap+benchmark``: the same with ``torch.backends.cudnn.benchmark``;

each with its peak device memory and the largest difference from the
loop's first output and gradients, relative to their largest entry (the
default algorithms do not repeat a run bit for bit).  A few seconds a model of script; imports
nothing of JAX."""
from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

N_CLIENTS, BATCH, ITERS = 10, 32, 5


def _loop(system, bottoms, x):
    """The client loop: each client's slice of the stack on its batch."""
    from repro_torch.tree import tree_map
    return torch.stack([system.model.bottom_apply(
        tree_map(lambda t: t[i], bottoms), x[i]) for i in range(len(x))])


def _run(fn, bottoms, x, g):
    from repro_torch.core.engine import requires_grad
    from repro_torch.tree import tree_leaves
    leaves = requires_grad(bottoms)
    out = fn(leaves, x)
    grads = torch.autograd.grad(out, tree_leaves(leaves), g)
    return out.detach(), grads


def _time(fn, bottoms, x, g) -> tuple[float, float]:
    """(ms a forward and backward, peak GiB) after a warm-up call."""
    _run(fn, bottoms, x, g)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        _run(fn, bottoms, x, g)
    end.record()
    torch.cuda.synchronize()
    return (start.elapsed_time(end) / ITERS,
            torch.cuda.max_memory_allocated() / 2 ** 30)


def study(arch: str, card: str) -> None:
    from repro_torch.configs import get_config
    from repro_torch.core.engine import SemiSFLSystem
    from repro_torch.tree import tree_map
    system = SemiSFLSystem(get_config(arch), device="cuda")
    state = system.init_state(0)
    bottoms = tree_map(
        lambda t: t.expand((N_CLIENTS,) + t.shape).clone(),
        state.params["bottom"])
    hw = system.cfg.image_size
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.rand(N_CLIENTS, BATCH, hw, hw, 3, generator=gen,
                   device="cuda")
    out0 = _loop(system, bottoms, x).detach()
    g = torch.randn(out0.shape, generator=gen, device="cuda")
    ref_out, ref_grads = _run(lambda b, xx: _loop(system, b, xx), bottoms,
                              x, g)
    cases = (("loop", lambda b, xx: _loop(system, b, xx), False),
             ("vmap", system._bottoms_forward, False),
             ("vmap+benchmark", system._bottoms_forward, True))
    for rep in range(2):
        for name, fn, bench in (cases if rep == 0 else cases[::-1]):
            with torch.backends.cudnn.flags(enabled=True, benchmark=bench,
                                            deterministic=False,
                                            allow_tf32=False):
                ms, peak = _time(fn, bottoms, x, g)
                out, grads = _run(fn, bottoms, x, g)
            err = max(float((a - b).abs().max() / b.abs().max())
                      for a, b in zip((out,) + grads,
                                      (ref_out,) + ref_grads))
            print(f"[client-axis] {arch} {name} (pass {rep + 1}): "
                  f"{ms:.3f} ms a forward and backward of {N_CLIENTS} "
                  f"clients x {BATCH} images, peak {peak:.3f} GiB, the "
                  f"largest |diff| from the loop's first run over max|x| "
                  f"of the output and each gradient {err:.3g}; on {card}",
                  flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("client_axis_study: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    t0 = time.perf_counter()
    for arch in sys.argv[1:] or ("paper-cnn", "paper-vgg16"):
        study(arch, card)
    print(f"[client-axis] done in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
