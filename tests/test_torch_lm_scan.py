"""The port's LM training phases against the JAX package's, on the CPU.

``repro_torch.launch.steps.make_scanned_train_phase`` and
``make_prefetched_train_phase`` (on the card one CUDA graph of the step,
the state donated; on the CPU a loop over the same step) against
``repro.launch.steps.make_scanned_train_phase(plan, DistContext(), lr,
donate_carry=False)`` and ``make_prefetched_train_phase``, on the smoke
``h2o-danube-1.8b``, ``xlstm-1.3b`` and ``zamba2-7b``, from one injected
JAX state, with each family's state, batches, rate and phase tolerance
(``tests/test_torch_lm_train.py``, ``test_torch_xlstm_train.py``,
``test_torch_zamba_train.py``; no wire):

  * the scanned phase over K=3 at PHASE_TOL (atol/rtol 1e-4), the queue's
    labels, flags and pointer exactly;
  * the prefetched phase over 2 phases of K=2 equal to the port's scanned
    phase bit for bit, and to JAX's prefetched phase at PHASE_TOL; no
    prefetch thread alive after it, and a thunk that raises surfaces as a
    ``PrefetchError`` chained to its error, the worker joined;
  * a donated carry with two leaves on one storage is refused;
  * a host-read guard: one smoke step of each family (``int8`` wire, tau
    0) under a ``TorchDispatchMode`` that fails on any op that reads a
    tensor's value on the host (``aten._local_scalar_dense``: ``.item()``,
    ``float()``, ``bool()``; any op returning a Python number) or makes a
    tensor from a host value (``aten.lift_fresh``: ``torch.tensor(...)``,
    ``new_tensor``), the calls a CUDA graph's capture refuses."""
import threading
import traceback

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import test_torch_lm_train as dense
import test_torch_xlstm_train as xlt
import test_torch_zamba_train as zbt
from repro.launch import steps as jsteps
from repro.models import DistContext
from repro_torch.convert import lm_train_state_from_numpy
from repro_torch.core import losses
from repro_torch.data.prefetch import THREAD_NAME, PrefetchError
from repro_torch.launch import steps
from repro_torch.tree import tree_leaves
from test_torch_lm_train import PHASE_TOL, _assert_state_close, _torch_batch
from _torch_threads import one_torch_thread  # noqa: F401

# xLSTM's rate here: at its two-step phase test's (xlt.PHASE_LR, 2e-3)
# the third step is ill-conditioned: a 1-ulp change of every weight of
# the state moves JAX's own 3-step client bottoms by 7.3e-6 to 8.42e-4 (6
# draws), and the port's lie 1.42e-4 from JAX's, past PHASE_TOL; at 2e-4
# (chip_smoke.py's xLSTM rate) 1 ulp moves either package's 4-step client
# bottoms by 2.38e-7 and the port's lie 1.19e-7 from JAX's (``python
# tests/test_torch_lm_scan.py``)
XLSTM_LR = 2e-4
# arch -> (its test module, its (JAX, port) smoke configs at tau 0, the
# phases' rate)
FAMILIES = {
    "h2o-danube-1.8b": (dense, lambda: dense._cfgs(
        "h2o-danube-1.8b", dense.DANUBE, 0.0), 0.02),
    "xlstm-1.3b": (xlt, lambda: xlt._cfgs(0.0), XLSTM_LR),
    "zamba2-7b": (zbt, lambda: zbt._cfgs(0.0), zbt.LR),
}
ARCHS = list(FAMILIES)


def _setup(arch, n_batches):
    """The family's configs, plans, rate, a JAX state (its queue warmed
    on the first batch) and ``n_batches`` batches."""
    mod, cfgs, lr = FAMILIES[arch]
    jcfg, tcfg = cfgs()
    batches = [mod._batch(jcfg, 3 + i) for i in range(n_batches)]
    state = mod._jax_state(jcfg, None, batches[0], seed=2)
    return mod._plans(jcfg, tcfg), lr, state, batches


def _stack(batches):
    return {k: np.stack([b[k] for b in batches]) for k in batches[0]}


def _live_prefetch_threads():
    return [t for t in threading.enumerate() if t.name == THREAD_NAME]


def _assert_metrics_close(got: dict, want: dict, k: int) -> None:
    for key in want:
        assert got[key].shape == (k,)
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   err_msg=key, **PHASE_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_scanned_phase_matches_the_scanned_jax_phase(arch):
    (jplan, tplan), lr, state, batches = _setup(arch, 3)
    stacked = _stack(batches)
    jphase = jsteps.make_scanned_train_phase(jplan, DistContext(), lr=lr,
                                             donate_carry=False)
    jnew, jm = jax.device_get(jphase(state, stacked))
    tnew, tm = steps.make_scanned_train_phase(tplan, lr=lr)(
        lm_train_state_from_numpy(state), _torch_batch(stacked))
    _assert_metrics_close(tm, jm, 3)
    # the first batch's sequences are in the warmed queue: Eq. (5) is live
    assert float(tm["clustering"][0]) > 0.0
    _assert_state_close(tnew, jnew, PHASE_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefetched_phase_matches_scanned_and_jax(arch):
    """2 phases of K=2 from host numpy batches: the port's prefetched
    phase equals its scanned phase fed the same batches bit for bit, and
    JAX's prefetched phase at PHASE_TOL."""
    (jplan, tplan), lr, state, batches = _setup(arch, 4)
    hosts = [_stack(batches[:2]), _stack(batches[2:])]
    run = steps.make_prefetched_train_phase(tplan, lr=lr)
    s_pf, m_pf = run(lm_train_state_from_numpy(state),
                     [lambda h=h: h for h in hosts])
    assert not _live_prefetch_threads()
    phase = steps.make_scanned_train_phase(tplan, lr=lr)
    s_sc, m_sc = lm_train_state_from_numpy(state), []
    for h in hosts:
        s_sc, m = phase(s_sc, {k: torch.from_numpy(v) for k, v in h.items()})
        m_sc.append(m)
    assert len(m_pf) == 2
    for a, b in zip(tree_leaves([s_pf, m_pf]), tree_leaves([s_sc, m_sc])):
        assert a.dtype == b.dtype and torch.equal(a, b)

    jrun = jsteps.make_prefetched_train_phase(jplan, DistContext(), lr=lr,
                                              donate_carry=False)
    jnew, jms = jrun(state, [lambda h=h: h for h in hosts])
    jnew = jax.device_get(jnew)
    for got, want in zip(m_pf, jms):
        _assert_metrics_close(got, jax.device_get(want), 2)
    _assert_state_close(s_pf, jnew, PHASE_TOL)


def test_prefetched_phase_surfaces_a_thunk_error_with_the_worker_joined():
    (_, tplan), lr, state, batches = _setup("h2o-danube-1.8b", 1)

    def broken():
        raise ZeroDivisionError("no batch")

    run = steps.make_prefetched_train_phase(tplan, lr=lr)
    with pytest.raises(PrefetchError) as err:
        run(lm_train_state_from_numpy(state),
            [lambda: _stack(batches), broken])
    assert isinstance(err.value.__cause__, ZeroDivisionError)
    assert not _live_prefetch_threads()


def test_a_donated_carry_may_not_hold_one_storage_twice():
    """A donated carry's tensors become the graph's buffers, each written
    once a replay, so two leaves on one storage are refused."""
    from repro_torch.core.scan import _check_distinct
    a, b = torch.zeros(4), torch.zeros(4)
    _check_distinct([a, b, 3, torch.zeros(0), torch.zeros(0)])
    for leaves in ([a, a], [a, a[2:]], [a, b, a.view(2, 2)]):
        with pytest.raises(ValueError, match="one storage"):
            _check_distinct(leaves)


# ---------------------------------------------------------------------------
# the host-read guard
# ---------------------------------------------------------------------------

# a tensor made from a host value: ``torch.tensor``, ``new_tensor``
MADE_FROM_HOST = ("aten.lift_fresh", "aten.lift_fresh_copy")


class HostReads(TorchDispatchMode):
    """Records each op that reads a tensor's value on the host (returns a
    Python number: ``aten._local_scalar_dense`` under ``.item()``,
    ``float()``, ``bool()``; ``aten.equal``) or makes a tensor from a host
    value, with the port's frame that called it."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = str(func.overloadpacket)
        if name in MADE_FROM_HOST or isinstance(out, (bool, int, float)):
            where = [f"{f.filename.split('src/')[-1]}:{f.lineno}"
                     for f in traceback.extract_stack()
                     if "repro_torch" in f.filename]
            self.seen.append((name, where[-1:] or ["?"]))
        return out


def test_the_guard_sees_what_a_capture_refuses():
    x = torch.arange(6.0).reshape(2, 3)
    caught = []
    for fn in (lambda: x.sum().item(), lambda: float(x.sum()),
               lambda: bool(x.any()), lambda: torch.tensor(3.0),
               lambda: x.new_tensor(1.0), lambda: torch.equal(x, x),
               lambda: torch.tensor(float(x.numel()), device=x.device)):
        with HostReads() as guard:
            fn()
        caught.append(bool(guard.seen))
    assert all(caught), caught
    # the repaired unmasked count of cross_entropy_sum: a fill on the
    # device, the same value and dtype as the host copy it replaced
    logits, labels = torch.randn(2, 5, 7), torch.randint(0, 7, (2, 5))
    with HostReads() as guard:
        nll, count = losses.cross_entropy_sum(logits, labels)
        x.new_full((), 1.0)
    assert guard.seen == []
    want = torch.tensor(float(labels.numel()))
    assert count.dtype == want.dtype and torch.equal(count, want)
    np.testing.assert_allclose(float(nll),
                               float(losses.cross_entropy(logits, labels))
                               * labels.numel(), rtol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_the_lm_step_reads_no_host_value(arch):
    """One smoke step (int8 wire, tau 0: every gradient flows) under the
    guard, on the CPU where the kernels' plain versions run."""
    mod, cfgs, lr = FAMILIES[arch]
    jcfg, tcfg = cfgs()
    plan = mod._plans(jcfg, tcfg)[1]
    state = steps.init_train_state(plan, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(0)
    n, b, s = plan.n_clients, plan.per_client_batch, plan.shape.seq_len
    batch = {k: torch.randint(0, tcfg.vocab_size, (n, b, s), generator=gen)
             for k in ("tokens_weak", "tokens_strong")}
    step = steps.make_train_step(plan, lr=lr, wire="int8")
    with HostReads() as guard:
        new, metrics = step(state, batch)
    assert guard.seen == [], guard.seen
    assert float(metrics["mask_rate"]) == 0.0


# ---------------------------------------------------------------------------
# the conditioning behind XLSTM_LR: ``python tests/test_torch_lm_scan.py``
# (on the CPU, about 3 minutes; not a test)
# ---------------------------------------------------------------------------

def _xlstm_ulp_spread(lr: float, k: int, draws: int = 6) -> str:
    """k steps of the smoke xLSTM from the scanned phase test's state and
    batches at rate lr: how far JAX's client bottoms lie from the port's,
    and how far each package's move when every fp32 weight of the state
    moves 1 ulp (``_ulp_bump``, ``draws`` random draws)."""
    from repro_torch.convert import lm_train_state_to_numpy
    (jplan, tplan), _, state, batches = _setup("xlstm-1.3b", k)
    jstep = jax.jit(jsteps.make_train_step(jplan, DistContext(), lr))
    tstep = steps.make_train_step(tplan, lr)

    def run_jax(st):
        for b in batches:
            st = jax.device_get(jstep(st, b)[0])
        return jax.tree_util.tree_leaves(st["client_bottoms"])

    def run_port(st):
        st = lm_train_state_from_numpy(st)
        for b in batches:
            st = tstep(st, _torch_batch(b))[0]
        return jax.tree_util.tree_leaves(
            lm_train_state_to_numpy(st)["client_bottoms"])

    far = lambda a, b: max(float(np.abs(np.asarray(x, np.float64)
                                        - np.asarray(y, np.float64)).max())
                           for x, y in zip(a, b))
    j0, t0 = run_jax(state), run_port(state)
    moves = []
    for seed in range(draws):
        rng = np.random.RandomState(seed)
        bumped = dict(state)
        for key in ("client_bottoms", "teacher_bottoms", "top", "t_top",
                    "proj", "t_proj"):
            bumped[key] = xlt._ulp_bump(state[key], rng)
        moves.append((far(run_jax(bumped), j0), far(run_port(bumped), t0)))
    return (f"{k} steps at rate {lr}: the port's client bottoms lie "
            f"{far(j0, t0):.3g} from JAX's; 1 ulp moves JAX's by "
            f"{', '.join(f'{j:.3g}' for j, _ in moves)} and the port's by "
            f"{', '.join(f'{t:.3g}' for _, t in moves)}")


if __name__ == "__main__":
    print(_xlstm_ulp_spread(xlt.PHASE_LR, 3), flush=True)
    print(_xlstm_ulp_spread(XLSTM_LR, 4), flush=True)
