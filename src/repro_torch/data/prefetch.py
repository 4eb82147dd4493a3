"""The round prefetcher (the JAX package's ``data/prefetch.py``): the
next round's input stacks assembled on a worker thread while this round
runs on the card.

  * :class:`Prefetcher` is the mechanism: one daemon worker thread takes
    build thunks off a request queue, runs them and posts the results into
    a bounded queue of depth 2 (one buffer being consumed while the next is
    built).  A worker's exception is re-raised in the consumer, chained,
    and :meth:`Prefetcher.close` joins the thread, so no prefetch thread
    outlives its owner.
  * :class:`RoundPrefetcher` is the SemiSFL round's policy on top: once
    round r's stacks are consumed it speculates round r+1's supervised and
    client stacks from the K_s just used, an active set drawn from a fork
    of the selection RNG (the engine's own draw in round r+1 gives the
    same set) and the loaders' restartable state.  Only K_s can change
    between the speculation and the request (the Eq. (10) controller
    reads round r first), and a caller may pin another active set, so a
    request checks the speculation and, where it differs, rolls the
    loaders back to their snapshots (``Loader.state_dict``) and builds
    inline.  The prefetched and the inline rounds draw the same samples.
  * :class:`DevicePut` is what the engine gives it to move a stack: the
    worker fills pinned host memory and copies it to the card on a side
    stream, with an event that :func:`ready` makes the consuming stream
    wait on.

Off by default, as in JAX: the prefetcher owns the loaders between rounds,
and a draw from them by anything else would race its speculation."""
from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.data.pipeline import Loader, stack_client_batches_many

THREAD_NAME = "repro-torch-prefetch"
_SHUTDOWN = object()


class PrefetchError(RuntimeError):
    """A prefetch build failed in the worker; the original exception is
    chained and the worker has been shut down."""


class Staged(NamedTuple):
    """Stacks on their device, and the copy's event (None on the CPU)."""
    tensors: tuple
    event: Optional[torch.cuda.Event]


class DevicePut:
    """Host stacks -> :class:`Staged` tensors on ``device``.  On a card:
    pinned host memory, one non-blocking copy a stack on a side stream of
    its own, and an event recorded after the copies."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = (torch.cuda.Stream(device) if device.type == "cuda"
                       else None)

    def __call__(self, *arrays: np.ndarray) -> Staged:
        host = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
        if self.stream is None:
            return Staged(tuple(host), None)
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            out = tuple(t.pin_memory().to(self.device, non_blocking=True)
                        for t in host)
            event = torch.cuda.Event()
            event.record(self.stream)
        return Staged(out, event)


def ready(staged: Staged) -> tuple:
    """The staged tensors, safe to use on the current stream: it waits on
    the copy's event, and the tensors are marked as used there, so that
    their memory is not handed out again while it reads them."""
    if staged.event is not None:
        stream = torch.cuda.current_stream(staged.tensors[0].device)
        stream.wait_event(staged.event)
        for t in staged.tensors:
            t.record_stream(stream)
    return staged.tensors


class Prefetcher:
    """A background build pipeline: submit zero-argument thunks, get their
    results in FIFO order.  ``depth`` bounds the result queue, so the
    worker blocks rather than running ahead.  ``build_s`` sums the
    worker's seconds inside thunks, ``wait_s`` the consumer's seconds
    blocked in :meth:`get`."""

    def __init__(self, *, depth: int = 2, name: str = THREAD_NAME):
        self._req: queue.Queue = queue.Queue()
        self._res: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._joined = False
        self.build_s = 0.0
        self.wait_s = 0.0
        self._thread = threading.Thread(target=self._loop, name=name,
                                        daemon=True)
        self._thread.start()

    @property
    def closed(self) -> bool:
        return self._stop.is_set()

    @property
    def worker_alive(self) -> bool:
        return self._thread.is_alive()

    def _loop(self) -> None:
        while True:
            item = self._req.get()
            if item is _SHUTDOWN or self._stop.is_set():
                return
            tag, thunk = item
            t0 = time.perf_counter()
            try:
                payload, err = thunk(), None
            except BaseException as e:  # noqa: BLE001: for the consumer
                payload, err = None, e
            self.build_s += time.perf_counter() - t0
            while not self._stop.is_set():     # a put that close() ends
                try:
                    self._res.put((tag, payload, err), timeout=0.1)
                    break
                except queue.Full:
                    continue

    def submit(self, tag: str, thunk: Callable[[], Any]) -> None:
        if self.closed:
            raise PrefetchError("submit() on a closed Prefetcher")
        self._req.put((tag, thunk))

    def get(self, timeout: Optional[float] = 600.0) -> tuple[str, Any]:
        """The next (tag, payload) in submission order.  A worker's
        exception shuts the pipeline down and is re-raised here, chained;
        a worker that died without posting is noticed at once."""
        t0 = time.perf_counter()
        deadline = None if timeout is None else t0 + timeout
        try:
            while True:
                try:
                    tag, payload, err = self._res.get(timeout=0.1)
                    break
                except queue.Empty:
                    if not self._thread.is_alive():
                        self.close()
                        raise PrefetchError("prefetch worker died without "
                                            "posting a result") from None
                    if deadline is not None and \
                            time.perf_counter() >= deadline:
                        self.close()
                        raise PrefetchError(
                            f"prefetch worker produced nothing within "
                            f"{timeout} s") from None
        finally:
            self.wait_s += time.perf_counter() - t0
        if err is not None:
            self.close()
            raise PrefetchError(
                f"prefetch build {tag!r} failed in the worker") from err
        return tag, payload

    def close(self) -> None:
        """Stop and join the worker.  Idempotent: a second close, or one
        after a worker fault, does nothing."""
        if self._stop.is_set() and (self._joined
                                    or not self._thread.is_alive()):
            return
        self._stop.set()
        self._req.put(_SHUTDOWN)
        while True:                  # free a worker blocked on a full queue
            try:
                self._res.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=10.0)
        self._joined = True

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


class RoundPrefetcher:
    """Double-buffers SemiSFL round inputs over one (labeled loader,
    client loaders) binding; see the module docstring for the speculation
    and its rollback.  ``sup_put(xs, ys)`` and ``cli_put(xs)`` run where
    the stacks are built (the worker, or the caller when it builds inline)
    and move them to the device; without them the numpy stacks are
    returned."""

    def __init__(self, labeled: Loader, client_loaders_: list[Loader], *,
                 k_u: int, n_active: int,
                 sup_put: Optional[Callable] = None,
                 cli_put: Optional[Callable] = None, depth: int = 2):
        self.labeled = labeled
        self.loaders = client_loaders_
        self.k_u = k_u
        self.n_active = n_active
        self._sup_put = sup_put
        self._cli_put = cli_put
        self._pf = Prefetcher(depth=depth)
        # in-flight speculation by tag: "sup" -> (k, labeled snapshot),
        # "cli" -> (active tuple, k, {client: snapshot})
        self._spec: dict[str, tuple] = {}
        self.rounds = 0
        self.cancels = 0
        self.inline_s = 0.0

    def _build_sup(self, k: int):
        xs, ys = self.labeled.next_many(k)
        return self._sup_put(xs, ys) if self._sup_put else (xs, ys)

    def _build_cli(self, active: list[int], k: int):
        xs, _ = stack_client_batches_many(self.loaders, active, k)
        return self._cli_put(xs) if self._cli_put else xs

    def _inline(self, build, *args):
        t0 = time.perf_counter()
        try:
            return build(*args)
        finally:
            self.inline_s += time.perf_counter() - t0

    def _rollback(self, tag: str) -> None:
        """Undo a discarded speculative build's draws.  Only once its
        result is collected (or the worker joined), so that the worker is
        not drawing from these loaders; a tag already settled is left."""
        spec = self._spec.pop(tag, None)
        if spec is None:
            return
        if tag == "sup":
            self.labeled.load_state_dict(spec[1])
        else:
            for i, sd in spec[2].items():
                self.loaders[i].load_state_dict(sd)

    def _pop(self, tag: str):
        """The speculative result for ``tag``; a result of the other tag
        queued first (a round abandoned half way) is rolled back."""
        while True:
            got, payload = self._pf.get()
            if got == tag:
                return payload
            self.cancels += 1
            self._rollback(got)

    def get_supervised(self, k: int):
        """The (K, B, ...) labeled stacks for a phase of ``k`` steps: the
        speculation's where its K is ``k``, else rolled back and built
        inline."""
        self.rounds += 1
        if "sup" not in self._spec:
            return self._inline(self._build_sup, k)
        payload = self._pop("sup")
        k_spec, snap = self._spec.pop("sup")
        if k_spec == k:
            return payload
        self.cancels += 1
        self.labeled.load_state_dict(snap)
        return self._inline(self._build_sup, k)

    def get_clients(self, active: list[int], k: int):
        """The (K, N, B, ...) client stacks of ``active``: the
        speculation's where its active set and K match, else the touched
        loaders rolled back and built inline."""
        if "cli" not in self._spec:
            return self._inline(self._build_cli, list(active), k)
        payload = self._pop("cli")
        act_spec, k_spec, snaps = self._spec.pop("cli")
        if act_spec == tuple(int(a) for a in active) and k_spec == k:
            return payload
        self.cancels += 1
        for i, sd in snaps.items():
            self.loaders[i].load_state_dict(sd)
        return self._inline(self._build_cli, list(active), k)

    def speculate(self, k_s: int,
                  select_rng: Optional[np.random.RandomState]) -> None:
        """Queue the next round's builds, once this round's stacks are
        consumed and its phases dispatched.  ``select_rng`` (the engine's
        selection RandomState) is forked, never advanced."""
        if self._pf.closed or self._spec:
            return
        self._spec["sup"] = (k_s, self.labeled.state_dict())
        self._pf.submit("sup", lambda: self._build_sup(k_s))
        if self.k_u > 0 and select_rng is not None:
            fork = np.random.RandomState()
            fork.set_state(select_rng.get_state())
            active = tuple(int(a) for a in fork.choice(
                len(self.loaders),
                size=min(self.n_active, len(self.loaders)), replace=False))
            snaps = {i: self.loaders[i].state_dict() for i in active}
            self._spec["cli"] = (active, self.k_u, snaps)
            self._pf.submit(
                "cli", lambda: self._build_cli(list(active), self.k_u))

    def stats(self) -> dict:
        """Counters: rounds, mispredictions (``cancels``), the worker's
        and the consumer's seconds, and ``overlap_frac``, the share of the
        worker's build time that the consumer did not wait out."""
        b, w = self._pf.build_s, self._pf.wait_s
        return {"rounds": self.rounds, "cancels": self.cancels,
                "spec_build_s": b, "wait_s": w, "inline_s": self.inline_s,
                "overlap_frac": max(0.0, 1.0 - w / b) if b > 0 else 0.0}

    def close(self) -> None:
        """Join the worker and roll back any speculation in flight, so the
        loaders stand where the inline path would have left them.  Never
        raises; a second close does nothing."""
        if not self._pf.closed and self._pf.worker_alive:
            try:                    # collect results before rolling back
                while self._spec:
                    tag, _ = self._pf.get(timeout=60.0)
                    self._rollback(tag)
            except PrefetchError:
                pass                # the worker faulted or died: shut down
        self._pf.close()
        if self._pf.worker_alive:
            # the join timed out: a wedged build may still be drawing, and
            # restoring snapshots under it would corrupt the loaders
            self._spec.clear()
        for tag in list(self._spec):
            self._rollback(tag)

    @property
    def closed(self) -> bool:
        return self._pf.closed

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
