#!/usr/bin/env python3
"""Profile and time the Mamba2 SSD backward's routes on one NVIDIA GPU.

  python3 scripts/mamba2_bwd_study.py              # every route
  python3 scripts/mamba2_bwd_study.py simt         # the first design only

At Zamba2-7B's training shapes, x and dy (B, 4096, 112, 64) bf16 with x a
strided view of the conv output, N 64, for B 4 (the top) and 1 (a client's
bottom), each route that ``mamba2_scan.plan_bwd(..., route=)`` gives is
held to ``ref.mamba2_scan_bwd_ref`` at the top's shape (max|err| /
max|ref| of each gradient), split into the phases of a chunk by its
diagnostic build (``mamba2_scan.bwd_profile``: SM clocks of block (0, 0)'s
thread 0, averaged over its chunks, ``BWD_PHASES``) and timed with
``chip_smoke.time_ms`` in turns (each route, then each again in reverse
order), with each of its kernels' device time.  Prints the ptxas report of
the backward's source, the card's SM clock and its name and power limit.
About a minute and a half of script with the plain backward.  Imports
nothing of JAX."""
from __future__ import annotations

import importlib
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

SHAPE = (4096, 112, 64, 64)      # S, heads, hd, N of Zamba2-7B's scan


def _sm_clock() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def main(routes) -> int:
    import torch

    from repro_torch.kernels import build, ref
    card = cs.phase_device()
    m2 = importlib.import_module("repro_torch.kernels.mamba2_scan")
    for name, log in build.build_all(("mamba2_scan",
                                      "mamba2_scan_bwd")).items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"[study] {name} ptxas: {line.strip()}")
    s, nh, hd, n = SHAPE
    for b in (cs.LM_CLIENTS, 1):
        args = cs._mamba2_inputs(b, s, nh, hd, n, "bfloat16", "model",
                                 92 + b)
        x = args[0]
        _, _, states = m2.mamba2_scan_cuda(*args, save=True)
        dy = torch.randn(x.shape, device="cuda").to(x.dtype)
        plans = {r: m2.plan_bwd(x.dtype, b, s, nh, hd, n, route=r)
                 for r in routes}
        if b == cs.LM_CLIENTS:
            want = ref.mamba2_scan_bwd_ref(*args, dy)
            for r, p in plans.items():
                got = m2.mamba2_scan_bwd_cuda(*args, states, dy, plan=p)
                errs = [float((g.float() - w.float()).abs().max())
                        / max(float(w.float().abs().max()), 1e-30)
                        for g, w in zip(got, want)]
                print(f"[study] route {r} at x {tuple(x.shape)}: max|err| /"
                      f" max|ref| dx, ddt, dA, dB, dC, dD "
                      + ", ".join(f"{e:.3g}" for e in errs))
                del got
            del want
        for r, p in plans.items():
            prof = m2.bwd_profile(*args, states, dy, plan=p)
            total = sum(prof.values())
            print(f"[study] profile at B {b}, route {r} (SM clocks a chunk, "
                  f"block (0, 0)'s thread 0; SM clock {_sm_clock()}): "
                  f"{total:.0f} = " + ", ".join(
                      f"{k} {v:.0f} ({v / total:.3f})"
                      for k, v in prof.items()) + f"; on {card}")
        ms = {r: [] for r in plans}
        kernels = {r: {} for r in plans}
        for r in list(plans) + list(plans)[::-1]:
            ms[r].append(cs.time_ms(lambda: m2.mamba2_scan_bwd_cuda(
                *args, states, dy, plan=plans[r]), iters=5, warmup=1,
                by_kernel=kernels[r]))
        for r, p in plans.items():
            print(f"[study] time at B {b}, route {r} ({p}): device ms "
                  + ", ".join(f"{d:.4f}" for d, _ in ms[r])
                  + " (events " + ", ".join(f"{e:.4f}" for _, e in ms[r])
                  + "); by kernel " + ", ".join(
                      f"{k[:48]} {v:.4f}" for k, v in kernels[r].items())
                  + f"; on {card}")
        del args, x, states, dy
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or ["simt", "mma"]))
