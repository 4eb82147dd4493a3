#!/usr/bin/env python3
"""Measure the sLSTM backward kernel's routes and design choices on one
NVIDIA GPU.

  python3 scripts/slstm_bwd_study.py                 # the default variants
  python3 scripts/slstm_bwd_study.py simt mma early  # some of them

Variants of ``src/repro_torch/csrc/slstm_scan_bwd.cu``:

  simt     the CUDA-core route, 4 batch rows a pass at every B (the
           kernel's first design, its gate math now shared with mma)
  mma      the tensor-core route (R's columns as bf16 hi/lo A fragments in
           registers, the head's partial sums of dh exchanged): the plan's
  early    mma with the saved-state ring's copies issued at the top of
           the step (the source edited), not after the product
  div      mma whose gate math divides by n~ and n~^2 after the exchange,
           as the chain rule reads, not multiplies by reciprocals taken in
           the barrier's shadow (the source edited)
  nodwx    mma without its dwx stores to device memory (the source edited,
           to weigh what they cost; its dwx is left unwritten, so its
           check reads whatever memory the allocator handed it)

The first two are forced through ``slstm_scan.plan_bwd(..., route=)``;
an edited variant is built with the port's flags into
``build/slstm_bwd_study/`` (with and without ``-DSLSTM_PROFILE``).  At
xLSTM-1.3B's training shapes, pre (B, 4096, 4, 4, 512) for B 1 (a client's
bottom) and 4 (the top), from the zero state with a forget bias of 3, each
variant is held to ``ref.slstm_scan_bwd_ref`` (max|err| / max|ref| of dwx
and dh_0), run twice for a bit-for-bit check, profiled (SM clocks a step
by phase, ``slstm_scan.BWD_PHASES``) and timed with ``chip_smoke.time_ms``,
in turns (each variant, then each again in reverse order).  Prints the
ptxas report of the builds and the card's SM clock.  About two minutes of
script.  Imports nothing of JAX."""
from __future__ import annotations

import ctypes
import importlib
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

OUT = ROOT / "build" / "slstm_bwd_study"
SHAPE = (4096, 4, 512)           # S, heads, hd of xLSTM-1.3B's sLSTM


def _replace(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise SystemExit(f"slstm_bwd_study: the source no longer holds "
                         f"{old[:60]!r} once; update this script")
    return src.replace(old, new)


def _early(src: str) -> str:
    src = _replace(src, "    issue(t - (kMmaRing - 1));\n    asm volatile",
                   "    asm volatile")
    return _replace(src, "    PHASE(0);\n    if (t < S - 1) {",
                    "    issue(t - (kMmaRing - 1));\n    PHASE(0);\n"
                    "    if (t < S - 1) {")


def _div(src: str) -> str:
    src = _replace(src, "  q.inv_n = 1.f / n_c;", "  q.inv_n = n_c;")
    src = _replace(src, "  q.inv_nn = 1.f / (n_c * n_c);",
                   "  q.inv_nn = n_c * n_c;")
    src = _replace(src, "const float a = g * P.inv_n;",
                   "const float a = g / P.inv_n;")
    return _replace(src, "(-g * P.sc * P.inv_nn)", "(-g * P.sc / P.inv_nn)")


def _nodwx(src: str) -> str:
    return _replace(src, "      dst[0] = d.dz;\n      dst[nhd] = d.di;\n"
                    "      dst[2 * nhd] = d.df;\n      dst[3 * nhd] = d.d_o;\n"
                    "      // the B operand", "      // the B operand")


# name: (route, source edit or None)
VARIANTS = {"simt": ("simt", None), "mma": ("mma", None),
            "early": ("mma", _early), "div": ("mma", _div),
            "nodwx": ("mma", _nodwx)}
DEFAULT = ("simt", "mma")


def _sm_clock() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    return out.stdout.strip()


def _print_ptxas(what: str, log: str) -> None:
    for kernel in ("slstm_scan_bwd_mma", "slstm_scan_bwd_kernel"):
        for row in cs._ptxas_rows(log, kernel):
            if "<4>" in row or "<16>" in row:
                print(f"[study] ptxas {what}: {row}")


def _libs(names) -> dict:
    """{name: (library, profiling library)} of each variant, bound."""
    from repro_torch.kernels import build
    sl = importlib.import_module("repro_torch.kernels.slstm_scan")
    t0 = time.perf_counter()
    for defines in ((), ("SLSTM_PROFILE",)):
        reports = build.build_all(("slstm_scan", "slstm_scan_bwd"), defines)
        _print_ptxas(f"tree {defines or ''}", reports.get("slstm_scan_bwd",
                                                          ""))
    tree = (sl._bwd_lib(),
            sl._bind_bwd(build.load("slstm_scan_bwd", ("SLSTM_PROFILE",))))
    OUT.mkdir(parents=True, exist_ok=True)
    shutil.copy(build.CSRC / "slstm_common.cuh", OUT / "slstm_common.cuh")
    src = (build.CSRC / "slstm_scan_bwd.cu").read_text()
    procs = {}
    for name in names:
        edit = VARIANTS[name][1]
        if edit is None:
            continue
        (OUT / f"{name}.cu").write_text(edit(src))
        for tag, flags in (("", ()), ("_prof", ("-DSLSTM_PROFILE",))):
            out = OUT / f"{name}{tag}.so"
            procs[name, tag] = (subprocess.Popen(
                [build._nvcc(), *build.NVCC_FLAGS, *flags, "-o", str(out),
                 str(OUT / f"{name}.cu")], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True), out)
    built = {}
    for (name, tag), (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"slstm_bwd_study: {name} failed to build:\n"
                             f"{log[-4000:]}")
        _print_ptxas(name + tag, log)
        built[name, tag] = sl._bind_bwd(ctypes.CDLL(str(out)))
    print(f"[study] built in {time.perf_counter() - t0:.1f} s; SM clock "
          f"(now, max): {_sm_clock()}")
    return {name: ((built[name, ""], built[name, "_prof"])
                   if VARIANTS[name][1] else tree) for name in names}


def _profile(sl, lib, r, saved, dh, plan) -> dict:
    lib.slstm_scan_bwd_profile.argtypes = [ctypes.c_void_p]
    lib.slstm_scan_bwd_profile.restype = ctypes.c_int
    sl._launch_bwd(lib, r, *saved, None, dh, plan)
    import torch
    torch.cuda.synchronize()
    clocks = (ctypes.c_longlong * len(sl.BWD_PHASES))()
    if lib.slstm_scan_bwd_profile(clocks):
        raise SystemExit("slstm_bwd_study: the profile read failed")
    return {k: v / saved[0].shape[1] for k, v in zip(sl.BWD_PHASES, clocks)}


def main(names) -> int:
    import torch

    from repro_torch.kernels import ref
    sl = importlib.import_module("repro_torch.kernels.slstm_scan")
    card = cs.phase_device()
    libs = _libs(names)
    limits = sl.card_limits(0)
    s, nh, hd = SHAPE
    for b in (1, 4):
        wx, r, _ = cs._slstm_inputs(b, s, nh, hd, False, 3.0, 82 + b)
        _, _, saved = sl.slstm_scan_cuda(wx, r, save=True)
        dh = torch.randn(b, s, nh, hd, device="cuda")
        want = ref.slstm_scan_bwd_ref(r, *saved, None, dh)
        plans = {name: sl.plan_bwd(b, nh, hd, *limits, VARIANTS[name][0])
                 for name in names}
        run = lambda name: sl._launch_bwd(libs[name][0], r, *saved, None,
                                          dh, plans[name])
        for name, p in plans.items():
            one, two = run(name), run(name)
            torch.cuda.synchronize()
            errs = [float((g - w).abs().max() / w.abs().max())
                    for g, w in zip(one, want)]
            same = all(torch.equal(x, y) for x, y in zip(one, two))
            prof = _profile(sl, libs[name][1], r, saved, dh, p)
            print(f"[study] B {b} {name}: route {p.route}, "
                  f"{p.blocks} blocks of {p.threads} threads, "
                  f"{p.smem_bytes} B shared; max|err| / max|ref| dwx "
                  f"{errs[0]:.3g}, dh0 {errs[1]:.3g}; two launches "
                  f"bit-identical {same}")
            print(f"[study] B {b} {name} clocks a step: "
                  f"{sum(prof.values()):.1f} = "
                  + ", ".join(f"{k} {v:.1f}" for k, v in prof.items()))
            del one, two
        times = {name: [] for name in plans}
        for name in list(plans) + list(plans)[::-1]:
            ms, _ = cs.time_ms(lambda: run(name), iters=10, warmup=2)
            times[name].append(ms)
        for name, ms in times.items():
            print(f"[study] B {b} {name}: "
                  + ", ".join(f"{v:.4f}" for v in ms)
                  + f" ms a call ({min(ms) / s * 1e3:.4f} us a step); "
                  f"SM clock {_sm_clock()}; on {card}")
        del wx, r, saved, dh, want
    return 0


if __name__ == "__main__":
    names = sys.argv[1:] or list(DEFAULT)
    bad = [n for n in names if n not in VARIANTS]
    if bad:
        raise SystemExit(f"slstm_bwd_study: unknown variants {bad}; "
                         f"choose from {list(VARIANTS)}")
    sys.exit(main(names))
