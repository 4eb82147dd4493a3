#!/usr/bin/env python3
"""Trace the Zamba2-7B training step's device kernels to the ops and lines
of the port that launch them, on one NVIDIA GPU.

  python3 scripts/zamba2_step_trace.py            # mma, then simt
  python3 scripts/zamba2_step_trace.py simt       # one backward route

The step of chip_smoke's phase 17 (``chip_smoke.LM_TRAIN_PATHS``: Zamba2-7B
at full width cut to ``ZAMBA_TRAIN_LAYERS`` Mamba2 layers, bf16, the int8
wire, tau 0, 4 clients x 4096 tokens, weights and tokens from seed 0): a
warm-up step, then for each backward route named (``mma``: the plan's;
``simt``: the first design, forced through
``mamba2_scan.plan_bwd(..., route="simt")``) one step under
``torch.profiler`` with ``record_shapes`` and ``with_stack``.  Each device
kernel is tied to its launch by the profiler's correlation id, the launch
to the innermost op around it on the host and to the innermost Python
frame of ``src/repro_torch`` around it (for an op of the backward pass,
around the forward op autograd recorded it for).  Prints the step's
wall and device busy time, the largest kernels by device time, and for
each of the largest elementwise kernels and copies the ops, lines and
input shapes that account for its time.  Changes nothing on the path.
About 3 minutes a route.  Imports nothing of JAX."""
from __future__ import annotations

import bisect
import importlib
import sys
import time
from collections import defaultdict
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

ARCH = "zamba2-7b"
TOP_KERNELS = 12        # kernels listed by device time
TRACED = 6              # the largest elementwise kernels and copies traced
SOURCES = 4             # (op, line, shapes) listed for each


def _is_copy_or_elementwise(name: str) -> bool:
    n = name.lower()
    return ("elementwise" in n or "memcpy" in n or "memset" in n
            or "copy" in n or "reduce_kernel" in n)


class _Nest:
    """One thread's nested host events (ops, or Python frames), sorted by
    start, each with its parent, for the innermost one around a time."""

    def __init__(self, events):
        self.ev = sorted(events, key=lambda e: (e.start_ns(), -e.end_ns()))
        self.starts = [e.start_ns() for e in self.ev]
        self.parent, open_ = [], []
        for k, e in enumerate(self.ev):
            while open_ and self.ev[open_[-1]].end_ns() < e.start_ns():
                open_.pop()
            self.parent.append(open_[-1] if open_ else -1)
            open_.append(k)

    def around(self, t: int, pred=lambda e: True):
        """The innermost event around time t that ``pred`` takes, or
        None."""
        k = bisect.bisect_right(self.starts, t) - 1
        while k >= 0:
            e = self.ev[k]
            if e.end_ns() >= t and pred(e):
                return e
            k = self.parent[k]
        return None


def _port_line(name: str) -> str:
    return name.split("repro_torch/")[-1] if "repro_torch/" in name else name


def _attribute(prof) -> tuple[dict, dict, float]:
    """{kernel name: [device s, count]} and {kernel name: {(op, line,
    shapes): [device s, count]}} of a profiled run, and its device busy
    seconds.  A kernel's op is the innermost host op around its launch;
    its line the innermost frame of ``repro_torch`` around it, or, for an
    op of the backward pass, around the forward op that autograd recorded
    it for (the same sequence number on the forward thread)."""
    from torch.autograd import DeviceType
    launches, kernels = {}, []
    ops, frames = defaultdict(list), defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        python = ".py(" in e.name() and "): " in e.name()  # a frame
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                kernels.append(e)
        elif python:
            if "repro_torch/" in e.name():
                frames[e.start_thread_id()].append(e)
        elif e.name().startswith("cu"):
            launches[e.correlation_id()] = e
        elif not e.is_user_annotation():
            ops[e.start_thread_id()].append(e)
    ops = {t: _Nest(v) for t, v in ops.items()}
    frames = {t: _Nest(v) for t, v in frames.items()}
    forward = {}              # (thread, sequence number) -> forward op
    for t, nest in ops.items():
        for e in nest.ev:
            if e.sequence_nr() >= 0 and not e.name().startswith("autograd"):
                forward.setdefault((t, e.sequence_nr()), e)

    def line_at(tid: int, t: int, op=None) -> str:
        """The port's innermost line around time t: from the op's own
        recorded stack where the profiler keeps one, else from the Python
        frames around t."""
        for f in (op.stack() if op is not None else []):
            if "repro_torch/" in f:
                return _port_line(f)
        f = frames[tid].around(t) if tid in frames else None
        return _port_line(f.name()) if f is not None else ""

    by_name = defaultdict(lambda: [0.0, 0])
    sources = defaultdict(lambda: defaultdict(lambda: [0.0, 0]))
    busy = 0.0
    for k in kernels:
        dur = k.duration_ns() / 1e9
        busy += dur
        by_name[k.name()][0] += dur
        by_name[k.name()][1] += 1
        if not _is_copy_or_elementwise(k.name()):
            continue
        src = ("(no launch seen)", "", "")
        rt = launches.get(k.correlation_id())
        tid = rt.start_thread_id() if rt is not None else None
        if tid in ops:
            op = ops[tid].around(rt.start_ns())
            if op is not None:
                line = line_at(tid, rt.start_ns(), op)
                node = ops[tid].around(rt.start_ns(), lambda e: e.name()
                                       .startswith("autograd::engine"))
                if not line and node is not None:
                    fwd = forward.get((node.fwd_thread_id(),
                                       node.sequence_nr()))
                    if fwd is not None:
                        line = "backward of " + (line_at(
                            fwd.start_thread_id(), fwd.start_ns(), fwd)
                            or fwd.name())
                    else:
                        line = node.name()
                src = (op.name(), line, str(op.shapes())[:90])
        sources[k.name()][src][0] += dur
        sources[k.name()][src][1] += 1
    return by_name, sources, busy


def main(routes) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.launch.steps import init_train_state, make_train_phase
    card = cs.phase_device()
    build.build_all()
    m2 = importlib.import_module("repro_torch.kernels.mamba2_scan")
    on_plan = m2.mamba2_scan_bwd_cuda

    def forced(route):
        def bwd(x, dt, A, B, C, D, states, dy):
            p = m2.plan_bwd(x.dtype, *x.shape[:3], x.shape[3], B.shape[-1],
                            route=route)
            return on_plan(x, dt, A, B, C, D, states, dy, plan=p)
        return bwd

    _, depth, lr, *_ = cs.LM_TRAIN_PATHS[ARCH]
    base = get_config(ARCH)
    cfg = replace(base, num_layers=depth,
                  semisfl=replace(base.semisfl, confidence_threshold=0.0))
    plan = cs._lm_plan(cfg, cs.LM_CLIENTS, cs.LM_SEQ)
    state = init_train_state(plan, seed=0, device="cuda")
    tokens = cs._lm_batches(cfg, 2 + len(routes), cs.LM_CLIENTS, cs.LM_SEQ,
                           seed=0)
    phase = make_train_phase(plan, lr=lr, wire="int8")
    part = lambda a: {k: v[a:a + 1] for k, v in tokens.items()}
    state, _ = phase(state, part(0))
    torch.cuda.synchronize()
    for i, route in enumerate(routes, 1):
        m2.mamba2_scan_bwd_cuda = forced(route)
        state, _ = phase(state, part(i))          # warm on this route
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     record_shapes=True, with_stack=True) as prof:
            t0 = time.perf_counter()
            state, _ = phase(state, part(i))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        by_name, sources, busy = _attribute(prof)
        print(f"[trace] {ARCH} at {depth} layers, backward route {route}: "
              f"one profiled step, wall {wall:.6f} s (with the profiler's "
              f"shapes and stacks), device busy {busy:.6f} s; read in "
              f"{time.perf_counter() - t0:.1f} s; on {card}")
        ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
        for name, (t, n) in ranked[:TOP_KERNELS]:
            print(f"[trace] {route} device {t:9.6f} s x{n:<6d} {name[:110]}")
        traced = [kv for kv in ranked if _is_copy_or_elementwise(kv[0])]
        for name, (t, n) in traced[:TRACED]:
            print(f"[trace] {route} {name[:110]}: {t:.6f} s x{n}")
            top = sorted(sources[name].items(), key=lambda kv: -kv[1][0])
            for (op, frame, shapes), (ts, ns) in top[:SOURCES]:
                print(f"[trace] {route}     {ts:.6f} s x{ns:<5d} {op} at "
                      f"{frame or '(no line of the port)'}, inputs {shapes}")
        del prof
    m2.mamba2_scan_bwd_cuda = on_plan
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or ["mma", "simt"]))
