"""The scanned phase executor: a phase of K steps as one captured program
(the JAX package's ``core/scan.py``).

The paper's wall-clock claim (3.8x) is about engine time, not Python
dispatch, so a phase of K iterations runs as one program with one host
read a round, not K dispatches from Python.  :func:`scan_phase` turns a
step ``step_fn(carry, inputs) -> (carry, outs)`` into

    phase(carry, stacked_inputs) -> (carry, stacked_outs)

over the leading K axis of every input leaf, as JAX's ``lax.scan`` does.

On the card the CUDA graph is the port's counterpart of XLA compiling the
``lax.scan``: the step (forward, ``torch.autograd.grad``, the update, the
hand-written kernels it launches) is warmed up on a side stream, captured
once with ``torch.cuda.graph`` and replayed K times.  The graph is one
step, so K does not enter it: one capture serves every phase of the same
shapes, across rounds and across the Eq. (10) controller's changes of
K_s.  Inside the captured region the step reads its inputs from static
(K_cap, ...) stacks at a device step counter and writes its outputs at
that counter into (K_cap, ...) buffers, and the new carry is copied into
the static carry at the end, so a replay needs one call from the host and
nothing else.  That was chosen over a ``copy_`` into a one-step input
buffer before each replay, which costs the host a call a leaf a step; a
phase copies its inputs into the stacks once a leaf instead.  A phase
longer than K_cap captures anew with longer stacks.

On the CPU the phase is a plain loop over the same ``step_fn``.

The graphs of one system's phases share one memory pool
(:class:`GraphPool`), so its peak is one step's, not one a phase's.  A
capture that fails raises: nothing falls back to the eager loop.  There
is no unroll setting: a replay is the whole step either way."""
from __future__ import annotations

import functools
import time
from typing import Any, Callable, Tuple

import torch

from repro_torch import kernels
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

Carry = Any
Inputs = Any
Step = Callable[[Carry, Inputs], Tuple[Carry, Any]]

WARMUP_STEPS = 2       # eager steps on a side stream before the capture


def _at(inputs: Inputs, i) -> Inputs:
    """Step ``i``'s inputs from stacks (None leaves stay None)."""
    return tree_map(lambda t: None if t is None else t[i], inputs)


def _phase_len(inputs: Inputs) -> int:
    ks = {t.shape[0] for t in tree_leaves(inputs) if t is not None}
    if len(ks) != 1:
        raise ValueError(f"scan_phase: input stacks of unequal K {ks}")
    k = ks.pop()
    if k < 1:
        raise ValueError("scan_phase: a phase takes K >= 1 steps")
    return k


def _skeleton(tree):
    """A tree's structure with no leaves held (a graph outlives the
    tensors it was captured from)."""
    return tree_map(lambda _: None, tree)


def _spec(tree) -> str:
    """The structure, shapes, dtypes and devices of a tree's tensors (a
    leaf that is not a tensor enters by its type only)."""
    return repr(tree_map(
        lambda t: ((tuple(t.shape), t.dtype, t.device)
                   if isinstance(t, torch.Tensor) else type(t).__name__),
        tree))


class GraphPool:
    """A memory pool that several phases' CUDA graphs share, one a device.
    A graph keeps nothing alive in the pool between replays (its carry,
    inputs and outputs live in buffers allocated outside it), and the
    phases of a round replay one after another on one stream, so each
    graph's memory is scratch that the next may reuse."""

    def __init__(self):
        self._handles: dict = {}

    def handle(self, device: torch.device):
        if device not in self._handles:
            self._handles[device] = torch.cuda.graph_pool_handle()
        return self._handles[device]


@functools.cache
def _warmup_stream(device: torch.device) -> torch.cuda.Stream:
    """One side stream a device for every graph's warm-up.  cuBLAS keeps
    a workspace for each stream it has run on, for good, and that block
    pins the segment it was cut from: a stream a graph would pin another
    segment for each capture."""
    return torch.cuda.Stream(device)


def _copy(dst: list, src: list) -> None:
    pairs = [(d, s) for d, s in zip(dst, src) if d is not s]
    if pairs:
        torch._foreach_copy_([d for d, _ in pairs], [s for _, s in pairs])


class _Graph:
    """One step captured at the shapes of ``carry`` and of one step of
    ``inputs``, with input stacks of ``k_cap`` steps."""

    def __init__(self, step_fn: Step, carry: Carry, inputs: Inputs,
                 k_cap: int, pool: GraphPool):
        t0 = time.perf_counter()
        self.k_cap = k_cap
        self.carry = _skeleton(carry)
        leaves = tree_leaves(carry)
        self.static = [t.clone() if isinstance(t, torch.Tensor) else t
                       for t in leaves]
        static_carry = tree_unflatten(carry, self.static)
        dev = next(t.device for t in self.static
                   if isinstance(t, torch.Tensor))
        self.in_stacks = [None if t is None else
                          torch.empty((k_cap,) + tuple(t.shape[1:]),
                                      dtype=t.dtype, device=dev)
                          for t in tree_leaves(inputs)]
        self.k_idx = torch.zeros(1, dtype=torch.long, device=dev)
        self._load_inputs(inputs)
        first = tree_unflatten(inputs, [None if s is None else s[0]
                                        for s in self.in_stacks])

        # warm-up: cuDNN and cuBLAS handles, autograd, each kernel's build,
        # shared-memory opt-in and card queries, all before the capture
        side = _warmup_stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                outs = step_fn(static_carry, first)[1]
        torch.cuda.current_stream(dev).wait_stream(side)
        self.out_template = _skeleton(outs)
        self.out_stacks = [torch.empty((k_cap,) + tuple(o.shape),
                                       dtype=o.dtype, device=dev)
                           for o in tree_leaves(outs)]
        del outs

        before = kernels.launch_counts()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=pool.handle(dev),
                              capture_error_mode="thread_local"):
            x = tree_unflatten(inputs, [
                None if s is None else s.index_select(0, self.k_idx)[0]
                for s in self.in_stacks])
            new_carry, outs = step_fn(static_carry, x)
            new = tree_leaves(new_carry)
            if len(new) != len(self.static):
                raise ValueError("scan_phase: the step changed the carry's "
                                 "structure")
            for old, leaf in zip(self.static, new):
                if not isinstance(old, torch.Tensor) and leaf != old:
                    raise ValueError(
                        f"scan_phase: a carry leaf that is not a tensor "
                        f"must pass through the step unchanged, got "
                        f"{old!r} -> {leaf!r}")
            _copy([t for t in self.static if isinstance(t, torch.Tensor)],
                  [n for t, n in zip(self.static, new)
                   if isinstance(t, torch.Tensor)])
            for buf, o in zip(self.out_stacks, tree_leaves(outs)):
                buf.index_copy_(0, self.k_idx, o.reshape((1,) + o.shape))
            self.k_idx.add_(1)
            del new_carry, new, outs, x
        after = kernels.launch_counts()
        # the wrappers counted while the graph was captured; nothing ran
        self.launches = {k: after[k] - before[k] for k in after}
        kernels.add_launch_counts(self.launches, -1)
        # the host's seconds for the warm-up and the capture, once a shape
        self.capture_s = time.perf_counter() - t0

    def _load_inputs(self, inputs: Inputs) -> None:
        k = _phase_len(inputs)
        _copy([s[:k] for s in self.in_stacks if s is not None],
              [t for t in tree_leaves(inputs) if t is not None])

    def run(self, carry: Carry, inputs: Inputs) -> Tuple[Carry, Any]:
        k = _phase_len(inputs)
        leaves = tree_leaves(carry)
        _copy([t for t in self.static if isinstance(t, torch.Tensor)],
              [t for t, s in zip(leaves, self.static)
               if isinstance(s, torch.Tensor)])
        self._load_inputs(inputs)
        self.k_idx.zero_()
        for _ in range(k):
            self.graph.replay()
        kernels.add_launch_counts(self.launches, k)
        tensors = [t for t in self.static if isinstance(t, torch.Tensor)]
        fresh = [torch.empty_like(t) for t in tensors]
        _copy(fresh, tensors)
        it = iter(fresh)
        out_carry = [next(it) if isinstance(s, torch.Tensor) else c
                     for s, c in zip(self.static, leaves)]
        outs = [torch.empty((k,) + tuple(s.shape[1:]), dtype=s.dtype,
                            device=s.device) for s in self.out_stacks]
        _copy(outs, [s[:k] for s in self.out_stacks])
        return (tree_unflatten(self.carry, out_carry),
                tree_unflatten(self.out_template, outs))


def scan_phase(step_fn: Step, pool: GraphPool | None = None
               ) -> Callable[[Carry, Inputs], Tuple[Carry, Any]]:
    """A K-step phase from a one-step ``step_fn(carry, inputs) -> (carry,
    outs)``: ``phase(carry, stacked_inputs) -> (carry, stacked_outs)``.

    ``stacked_inputs`` is a tree whose tensor leaves share a leading K axis
    (None leaves stay None); ``stacked_outs`` stacks each step's output
    tensors on a leading K axis.  ``step_fn`` must be functional: it leaves
    its carry and inputs as they are and returns new tensors.  A carry
    leaf that is not a tensor (a host counter) must come out of the step
    as it went in, and is passed through.

    On CUDA tensors the step is captured as a CUDA graph once per shapes
    and replayed K times (see the module docstring); the returned carry
    and outputs are fresh tensors, not the graph's buffers, so a caller may
    keep an old carry.  Phases built with one ``pool`` capture into one
    memory pool (by default each phase has its own).  On CPU tensors the
    phase loops over ``step_fn``."""
    graphs: dict[str, _Graph] = {}
    pool = GraphPool() if pool is None else pool

    def phase(carry: Carry, inputs: Inputs):
        k = _phase_len(inputs)
        dev = next(t.device for t in tree_leaves(inputs) if t is not None)
        if dev.type != "cuda":
            outs = []
            for i in range(k):
                carry, out = step_fn(carry, _at(inputs, i))
                outs.append(out)
            return carry, tree_map(lambda *o: torch.stack(o), *outs)
        key = _spec(carry) + _spec(_at(inputs, 0))
        g = graphs.get(key)
        if g is None or g.k_cap < k:
            graphs.pop(key, None)
            g = graphs[key] = _Graph(step_fn, carry, inputs, k, pool)
        return g.run(carry, inputs)

    phase.graphs = graphs
    return phase
