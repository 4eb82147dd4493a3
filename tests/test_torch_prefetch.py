"""The port's round prefetcher (``repro_torch/data/prefetch.py``) on the
CPU, as the JAX package's ``tests/test_prefetch.py`` holds its own:

  * the prefetched executor equals the inline one bit for bit over three
    rounds whose last changes K_s (the worker speculated the old K_s and
    must roll the labeled stream back), for the scanned and the eager
    executor, and the loaders end where the inline run left them;
  * a pinned active set that differs from the speculation is rebuilt
    inline, bit for bit;
  * a worker's exception reaches the caller, chained, and its thread is
    joined; ``close`` after a fault or a dead worker is clean and
    idempotent, and rolls a speculation in flight back;
  * no prefetch thread outlives its owner (``threading.enumerate``).

There is no timing assertion: whether the worker's time hides behind the
round's is a property of the card and the host, not of the protocol."""
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.data import pipeline, synthetic
from repro_torch.data.prefetch import (THREAD_NAME, DevicePut, Prefetcher,
                                       PrefetchError, RoundPrefetcher, ready)
from test_torch_scan import _run_port, _tiny, assert_states_equal
from _torch_threads import one_torch_thread  # noqa: F401


def _live_prefetch_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith(THREAD_NAME)]


def _loader_pos(ld):
    return ld._order.copy(), ld._cursor, ld.rng.get_state()


def _same_pos(a, b):
    return (np.array_equal(a[0], b[0]) and a[1] == b[1]
            and np.array_equal(a[2][1], b[2][1]) and a[2][2] == b[2][2])


def _rig():
    ds = synthetic.make_image_dataset(0, n=260, image_size=8)
    lab = pipeline.Loader(ds, np.arange(40), 8, 0)
    parts = [np.arange(40 + 55 * i, 95 + 55 * i) for i in range(4)]
    return lab, pipeline.client_loaders(ds, parts, 8, 1)


def _run(prefetch, scan_rounds, active=None):
    state, metrics, sys_, lab, cls = _run_port(
        _tiny(), "int8+topk0.05", scan_rounds=scan_rounds,
        prefetch=prefetch, rounds=3, active=active)
    stats = sys_.prefetch_stats()
    sys_.close()
    sys_.close()                                # idempotent
    return state, metrics, stats, lab, cls


@pytest.mark.parametrize("scan_rounds", [True, False],
                         ids=["scanned", "eager"])
def test_prefetched_executor_equals_inline_bit_for_bit(scan_rounds):
    s_in, m_in, stats_in, lab_in, cls_in = _run(False, scan_rounds)
    s_pf, m_pf, stats, lab_pf, cls_pf = _run(True, scan_rounds)
    assert stats_in is None
    assert_states_equal(s_in, s_pf)
    assert m_in == m_pf
    assert [m[3] for m in m_pf] == [3, 3, 2]
    assert stats["rounds"] == 3
    # the last round's K_s change cancelled the supervised speculation
    assert stats["cancels"] >= 1
    # close() rolled the outstanding speculation back
    assert _same_pos(_loader_pos(lab_in), _loader_pos(lab_pf))
    for a, b in zip(cls_in, cls_pf):
        assert _same_pos(_loader_pos(a), _loader_pos(b))
    assert not _live_prefetch_threads()


def test_pinned_active_set_mismatch_rebuilds_inline():
    def pinned(r):
        return [(r + i) % 4 for i in range(3)]

    s_in, m_in, _, _, _ = _run(False, True, active=pinned)
    s_pf, m_pf, stats, _, _ = _run(True, True, active=pinned)
    assert_states_equal(s_in, s_pf)
    assert m_in == m_pf
    assert stats["cancels"] >= 1
    assert not _live_prefetch_threads()


def test_device_put_on_the_cpu_stages_without_an_event():
    xs = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    staged = DevicePut(torch.device("cpu"))(xs, xs[0])
    assert staged.event is None
    got = ready(staged)
    np.testing.assert_array_equal(got[0].numpy(), xs)
    np.testing.assert_array_equal(got[1].numpy(), xs[0])


def test_worker_exception_propagates_and_joins():
    lab, cls = _rig()
    calls = {"n": 0}

    def poisoned_put(xs, ys):
        calls["n"] += 1
        if calls["n"] >= 2:                     # the first (inline) is fine
            raise RuntimeError("injected worker fault")
        return xs, ys

    pf = RoundPrefetcher(lab, cls, k_u=2, n_active=3, sup_put=poisoned_put)
    try:
        pf.get_supervised(3)
        pf.get_clients([0, 1, 2], 2)
        pf.speculate(3, np.random.RandomState(0))
        with pytest.raises(PrefetchError) as exc_info:
            pf.get_supervised(3)
        assert "injected worker fault" in repr(exc_info.value.__cause__)
        assert not _live_prefetch_threads()
    finally:
        pf.close()
    assert not _live_prefetch_threads()


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_close_after_worker_death_is_clean_and_idempotent():
    """A worker that dies without posting (its result queue broken) does
    not hold ``close`` up: the speculative draws are rolled back, and every
    further close does nothing."""
    lab, cls = _rig()
    pf = RoundPrefetcher(lab, cls, k_u=2, n_active=3)
    pf.get_supervised(3)
    pf.get_clients([0, 1, 2], 2)
    consumed = (_loader_pos(lab), [_loader_pos(c) for c in cls])

    def broken_put(*a, **k):
        raise RuntimeError("result queue broken")

    pf._pf._res.put = broken_put
    pf.speculate(3, np.random.RandomState(0))
    deadline = time.time() + 10.0
    while pf._pf.worker_alive and time.time() < deadline:
        time.sleep(0.05)
    assert not pf._pf.worker_alive
    t0 = time.time()
    pf.close()
    assert time.time() - t0 < 30.0
    assert _same_pos(_loader_pos(lab), consumed[0])
    for c, pos in zip(cls, consumed[1]):
        assert _same_pos(_loader_pos(c), pos)
    pf.close()
    pf.close()
    assert not _live_prefetch_threads()

    lab2, cls2 = _rig()
    boom = {"n": 0}

    def poisoned(xs, ys):
        boom["n"] += 1
        if boom["n"] >= 2:
            raise RuntimeError("injected build fault")
        return xs, ys

    pf2 = RoundPrefetcher(lab2, cls2, k_u=2, n_active=3, sup_put=poisoned)
    pf2.get_supervised(3)
    pf2.speculate(3, np.random.RandomState(0))
    with pytest.raises(PrefetchError):
        pf2.get_supervised(3)
    pf2.close()
    pf2.close()
    assert not _live_prefetch_threads()


def test_close_rolls_back_mid_flight_speculation():
    lab, cls = _rig()
    before = (_loader_pos(lab), [_loader_pos(c) for c in cls])
    pf = RoundPrefetcher(lab, cls, k_u=2, n_active=3)
    pf.speculate(3, np.random.RandomState(0))
    pf.close()
    assert _same_pos(_loader_pos(lab), before[0])
    for c, pos in zip(cls, before[1]):
        assert _same_pos(_loader_pos(c), pos)
    assert not _live_prefetch_threads()
    pf.close()


def test_prefetcher_fifo_and_error_chaining():
    pf = Prefetcher(depth=2)
    try:
        for i in range(4):
            pf.submit(f"t{i}", lambda i=i: i * i)
        for i in range(4):
            assert pf.get() == (f"t{i}", i * i)
        pf.submit("boom", lambda: 1 / 0)
        with pytest.raises(PrefetchError) as ei:
            pf.get()
        assert isinstance(ei.value.__cause__, ZeroDivisionError)
        assert pf.closed
        with pytest.raises(PrefetchError):
            pf.submit("late", lambda: None)
    finally:
        pf.close()
    assert not _live_prefetch_threads()


def test_the_launcher_takes_prefetch_and_logs_its_stats():
    """``run_training(prefetch=True)`` and the CLI's ``--prefetch`` run
    the split methods through the prefetcher, log its counters as the JAX
    launcher does, and close its worker; a full-model baseline refuses
    it, as in JAX."""
    from repro_torch.launch.train import build_run, main, run_training

    lines = []
    run_training(rounds=2, n_active=3, k_s=2, k_u=2, device="cpu",
                 prefetch=True, log=lines.append)
    assert any(ln.startswith("[semisfl] prefetch: 2 rounds")
               for ln in lines), lines
    assert not _live_prefetch_threads()
    _, history, system = main(["--rounds", "1", "--prefetch", "--device",
                               "cpu", "--clients", "4", "--active", "2",
                               "--baseline", "fedswitch-sl"])
    assert system.prefetch and len(history) == 1
    assert not _live_prefetch_threads()
    with pytest.raises(SystemExit, match="--prefetch"):
        build_run(baseline="fedswitch", prefetch=True, device="cpu")
