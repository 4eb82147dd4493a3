#!/usr/bin/env python3
"""Measure the design choices of the bf16 flash-attention backward on one
NVIDIA GPU.

  python3 scripts/flash_bwd_study.py                 # every variant
  python3 scripts/flash_bwd_study.py tree terms22    # some of them

Each variant is ``src/repro_torch/csrc/flash_attention_bwd.cu`` with its
text edited, built with the port's flags into ``build/flash_bwd_study/``:

  tree     the source as it is: P and dS as 3 bf16 terms for dK and dV, dS
           as 2 for dQ; wgmma sums each tile's products into a zeroed
           tile, which fp32 adds fold into the gradient
  terms22  2 terms for dK and dV too
  terms33  3 terms for dQ too
  chain    every product chained by wgmma straight into the gradient's
           accumulator, with no per-tile fp32 adds

Every variant runs the same checks as ``chip_smoke.py`` phase 3b's at
H2O-Danube-1.8B's shape, q (4, 32, 4096, hd) over k, v (4, 8, 4096, hd),
bf16, causal: seeds 30-35, head dims 80 and 128, windows 0 and 1024, each
held to ``ref.flash_attention_bwd_ref`` at the unchanged bf16 tolerance.
It prints each check's worst err / (atol + rtol |x|) and the entries over
1 per gradient; for each gradient over 1, its worst entry's value from
the kernel, the plain version and an fp64 recomputation from the same
inputs, forward output and lse; then each variant's ms a call at danube's
shape (hd 80, window 0) from ``chip_smoke.time_ms``, in turns (each
variant, then each again in reverse order).  Imports nothing of JAX."""
from __future__ import annotations

import ctypes
import importlib
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

OUT = ROOT / "build" / "flash_bwd_study"
SEEDS = range(30, 36)
HEAD_DIMS = (80, 128)
WINDOWS = (0, 1024)


def _replace(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise SystemExit(f"flash_bwd_study: the source no longer holds "
                         f"{old[:60]!r} once; update this script")
    return src.replace(old, new)


def _terms(kv: int, dq: int):
    def edit(src: str) -> str:
        src = _replace(src, "constexpr int kKvTerms = 3;",
                       f"constexpr int kKvTerms = {kv};")
        return _replace(src, "constexpr int kDqTerms = 2;",
                        f"constexpr int kDqTerms = {dq};")
    return edit


def _chain(src: str) -> str:
    """add_product without its tile: wgmma accumulates into acc itself."""
    fence_tile, fence_acc = ("fence_regs<kChunk / 2>(tile);",
                             "fence_regs<HD / 2>(acc);")
    src = _replace(src, f"    {fence_tile}\n    wgmma_fence();",
                   f"    {fence_acc}\n    wgmma_fence();")
    src = _replace(src, "issue_terms<kN0, KSteps, T>(tile, a, b_addr);",
                   "issue_terms<kN0, KSteps, T>(acc, a, b_addr);")
    src = _replace(src, "issue_terms<kN1, KSteps, T>(tile, a, "
                   "b_addr + box_bytes);",
                   "issue_terms<kN1, KSteps, T>(acc + kChunk / 2, a, "
                   "b_addr + box_bytes);")
    src = _replace(src, f"    wgmma_wait<0>();\n    {fence_tile}\n",
                   f"    wgmma_wait<0>();\n    {fence_acc}\n")
    return _replace(src, "      acc[c * kChunk / 2 + i] += tile[i];",
                    "      tile[i] += 0.f;")


VARIANTS = {"tree": lambda src: src, "terms22": _terms(2, 2),
            "terms33": _terms(3, 3), "chain": _chain}


def build(names) -> dict:
    from repro_torch.kernels import build as kb
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    OUT.mkdir(parents=True, exist_ok=True)
    shutil.copy(kb.CSRC / "hopper.cuh", OUT / "hopper.cuh")
    src = (kb.CSRC / "flash_attention_bwd.cu").read_text()
    procs = {}
    for name in names:
        (OUT / f"{name}.cu").write_text(VARIANTS[name](src))
        procs[name] = subprocess.Popen(
            [kb._nvcc(), *kb.NVCC_FLAGS, "-o", str(OUT / f"{name}.so"),
             str(OUT / f"{name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    kb.build_all(("flash_attention",))
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"flash_bwd_study: {name} failed to build:\n"
                             f"{log[-4000:]}")
        for kernel in ("flash_bwd_dkdv_wgmma", "flash_bwd_dq_wgmma"):
            for row in cs._ptxas_rows(log, kernel):
                if "<80>" in row:
                    print(f"[study] {name} ptxas {row}")
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        for entry in fa.BWD_ENTRY.values():
            fn = getattr(lib, entry)
            fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def _fp64_entry(name, loc, q, k, v, o, lse, g, window) -> float:
    """One entry of dq, dk or dv (at loc = (b, head, pos, d)) in fp64 from
    the same inputs, forward output and lse."""
    import torch
    b, head, pos, d = loc
    h, kvh, s, hd = q.shape[1], k.shape[1], q.shape[2], q.shape[3]
    group, scale = h // kvh, 1.0 / math.sqrt(hd)
    rows = torch.arange(s, device=q.device)
    f64 = lambda t: t.double()
    heads = ([head] if name == "dq"
             else range(head * group, head * group + group))
    total = 0.0
    for hq in heads:
        kv = hq // group
        qh, gh, oh = f64(q[b, hq]), f64(g[b, hq]), f64(o[b, hq])
        dd = (gh * oh).sum(-1)
        if name == "dq":
            keys = torch.arange(s, device=q.device)
            ok = keys <= pos
            if window:
                ok &= keys > pos - window
            sc = f64(k[b, kv]) @ qh[pos] * scale
            p = torch.where(ok, torch.exp(sc - f64(lse[b, hq, pos])), 0.0)
            ds = p * (f64(v[b, kv]) @ gh[pos] - dd[pos])
            total += float((ds[:, None] * f64(k[b, kv])).sum(0)[d]) * scale
            continue
        ok = rows >= pos
        if window:
            ok &= rows < pos + window
        sc = qh @ f64(k[b, kv, pos]) * scale
        p = torch.where(ok, torch.exp(sc - f64(lse[b, hq])), 0.0)
        if name == "dv":
            total += float((p * gh[:, d]).sum())
        else:
            ds = p * (gh @ f64(v[b, kv, pos]) - dd)
            total += float((ds * qh[:, d]).sum()) * scale
    return total


def check(libs: dict) -> None:
    import torch

    from repro_torch.kernels import ref
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    atol, rtol = cs.FLASH_BWD_TOLS["bfloat16"]
    tally = {n: [0, 0, 0.0] for n in libs}     # checks over, entries, worst
    for seed in SEEDS:
        for hd in HEAD_DIMS:
            gen = torch.Generator(device="cuda").manual_seed(seed)
            q, k, v, g = cs._model_views(gen, torch.bfloat16, cs.LM_CLIENTS,
                                         cs.LM_SEQ, cs.LM_HEADS,
                                         cs.LM_KV_HEADS, hd, extra=(1,))
            for window in WINDOWS:
                o, lse = fa.flash_attention_cuda(q, k, v, window=window,
                                                 with_lse=True)
                want = ref.flash_attention_bwd_ref(q, k, v, o, lse, g,
                                                   window=window)
                line = []
                for name, lib in libs.items():
                    fa._bwd_lib = lambda lib=lib: lib
                    got = fa.flash_attention_bwd_cuda(q, k, v, o, lse, g,
                                                      window=window)
                    torch.cuda.synchronize()
                    over = False
                    for grad, a, w in zip(("dq", "dk", "dv"), got, want):
                        a, w = a.float(), w.float()
                        r = (a - w).abs() / (atol + rtol * w.abs())
                        worst, n = float(r.max()), int((r > 1).sum())
                        line.append(f"{name}.{grad} {worst:.4f}/{n}")
                        tally[name][1] += n
                        tally[name][2] = max(tally[name][2], worst)
                        if n:
                            over = True
                            loc = [int(x) for x in torch.unravel_index(
                                r.argmax(), r.shape)]
                            x64 = _fp64_entry(grad, loc, q, k, v, o, lse, g,
                                              window)
                            print(f"[study] {name} seed {seed} hd {hd} "
                                  f"window {window} {grad} at {loc}: kernel "
                                  f"{float(a[tuple(loc)]):.6g}, plain "
                                  f"{float(w[tuple(loc)]):.6g}, fp64 "
                                  f"{x64:.6g}")
                    tally[name][0] += over
                print(f"[study] seed {seed} hd {hd} window {window}: "
                      + " ".join(line), flush=True)
                del o, lse, want, got
            del q, k, v, g
            torch.cuda.empty_cache()
    checks = len(SEEDS) * len(HEAD_DIMS) * len(WINDOWS)
    for name, (n_over, entries, worst) in tally.items():
        print(f"[study] {name}: {n_over} of {checks} checks over the "
              f"tolerance, {entries} entries over, worst {worst:.4f}")


def timing(libs: dict, card: str) -> None:
    import torch
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    gen = torch.Generator(device="cuda").manual_seed(7)
    q, k, v, g = cs._model_views(gen, torch.bfloat16, cs.LM_CLIENTS,
                                 cs.LM_SEQ, cs.LM_HEADS, cs.LM_KV_HEADS,
                                 cs.LM_HD, extra=(1,))
    o, lse = fa.flash_attention_cuda(q, k, v, with_lse=True)
    ms = {n: [] for n in libs}
    for name in list(libs) + list(libs)[::-1]:
        fa._bwd_lib = lambda lib=libs[name]: lib
        ms[name].append(cs.time_ms(
            lambda: fa.flash_attention_bwd_cuda(q, k, v, o, lse, g),
            iters=10, warmup=2)[0])
    for name, t in ms.items():
        print(f"[study] {name}: " + ", ".join(f"{x:.4f}" for x in t)
              + f" ms a call at {cs.LM_ARCH}'s shape, hd {cs.LM_HD}, "
              f"causal; on {card}")


def main() -> int:
    names = sys.argv[1:] or list(VARIANTS)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        raise SystemExit(f"flash_bwd_study: no variant {unknown}; "
                         f"choose from {list(VARIANTS)}")
    card = cs.phase_device()
    t0 = time.perf_counter()
    libs = build(names)
    check(libs)
    timing(libs, card)
    print(f"[study] done in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
