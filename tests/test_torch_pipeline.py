"""The port's loaders as restartable iterators and the Eq. (10)
controller's state, against the JAX package's on the same seeds:
``Loader.next_many``, ``state_dict`` / ``load_state_dict`` / ``clone`` and
``stack_client_batches_many`` draw exactly JAX's sample streams, across
epoch boundaries; ``FreqController`` state round trips go on with JAX's
K_s trajectory."""
from dataclasses import replace

import numpy as np
import pytest

from repro.configs import smoke_config as jax_smoke_config
from repro.core.adaptation import FreqController as JaxController
from repro.data import pipeline as jpipe
from repro.data import synthetic as jsyn
from repro_torch.configs import smoke_config
from repro_torch.core.adaptation import FreqController
from repro_torch.data import pipeline, synthetic
from _torch_threads import one_torch_thread  # noqa: F401


def _loaders(idx, batch, seed):
    dj = jsyn.make_image_dataset(0, n=120, image_size=8)
    dt = synthetic.make_image_dataset(0, n=120, image_size=8)
    return jpipe.Loader(dj, idx, batch, seed), pipeline.Loader(dt, idx,
                                                               batch, seed)


def _equal(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("n_idx,batch,k", [(40, 8, 3), (13, 8, 5),
                                           (5, 8, 2), (110, 16, 9)])
def test_next_many_draws_jax_stream(n_idx, batch, k):
    """(K, B, ...) stacks, then single batches, then stacks again: every
    draw equals JAX's, with partitions smaller than a batch and epochs
    that end mid-batch."""
    lj, lt = _loaders(np.arange(7, 7 + n_idx), batch, 3)
    for _ in range(2):
        got, want = lt.next_many(k), lj.next_many(k)
        assert got[0].shape == (k, batch, 8, 8, 3)
        _equal(got, want)
        _equal(lt.next(), lj.next())


def test_state_dict_rewinds_and_clone_continues():
    lj, lt = _loaders(np.arange(30), 8, 5)
    lt.next_many(2)
    lj.next_many(2)
    snap_t, snap_j = lt.state_dict(), lj.state_dict()
    first = lt.next_many(6)                  # crosses an epoch boundary
    _equal(first, lj.next_many(6))
    lt.load_state_dict(snap_t)
    _equal(lt.next_many(6), first)           # the rewind replays the draws
    lt.load_state_dict(snap_t)               # the snapshot did not move
    lj.load_state_dict(snap_j)
    twin = lt.clone()
    drawn = twin.next_many(4)
    _equal(drawn, lt.next_many(4))
    _equal(drawn, lj.next_many(4))
    twin.next_many(3)                        # the clone is independent
    _equal(lt.next(), lj.next())
    # a snapshot of the JAX loader loads into the port's and vice versa
    lj.next_many(3)
    lt.load_state_dict(lj.state_dict())
    _equal(lt.next_many(5), lj.next_many(5))
    lt.next()
    lj.load_state_dict(lt.state_dict())
    _equal(lt.next_many(2), lj.next_many(2))


def test_stack_client_batches_many_draws_jax_stream():
    dj = jsyn.make_image_dataset(1, n=200, image_size=8)
    dt = synthetic.make_image_dataset(1, n=200, image_size=8)
    parts = [np.arange(10 * i, 10 * i + 17 + i) for i in range(5)]
    cj = jpipe.client_loaders(dj, parts, 4, 2)
    ct = pipeline.client_loaders(dt, parts, 4, 2)
    for active in ([1, 3, 4], [0, 2]):
        got = pipeline.stack_client_batches_many(ct, active, 3)
        want = jpipe.stack_client_batches_many(cj, active, 3)
        assert got[0].shape == (3, len(active), 4, 8, 8, 3)
        _equal(got, want)


def _cfgs():
    """Short observation periods and window, so that K_s shrinks within
    the test's rounds."""
    cj, ct = jax_smoke_config("paper-cnn"), smoke_config("paper-cnn")
    kw = dict(k_s_init=40, k_u=10, observation_period=2,
              adaptation_window=2)
    return replace(cj.semisfl, **kw), replace(ct.semisfl, **kw)


def test_controller_state_round_trips_continue_jax_trajectory():
    sj, st = _cfgs()
    cj = JaxController(sj, 50, 500)
    ct = FreqController(st, 50, 500)
    rng = np.random.RandomState(0)
    losses = [(1.0 + rng.rand(), 2.0 - 0.1 * r + rng.rand() * 0.05)
              for r in range(30)]
    for r, (fs, fu) in enumerate(losses):
        if r in (5, 11, 17):
            # restart the port's controller from its own saved state, or
            # (at 17) from the JAX controller's
            sd = (cj if r == 17 else ct).state_dict()
            ct = FreqController(st, 50, 500)
            ct.load_state_dict(sd)
            assert ct.state_dict() == cj.state_dict()
        assert ct.update(fs, fu) == cj.update(fs, fu)
    assert ct.k_s == cj.k_s < 40              # the trajectory moved
    assert ct.k_s >= ct.k_min
