"""One intra-op torch thread for a test module of the port.

The port's CPU tests run thousands of tiny ops (a scan step by step, smoke
models), which a pool of threads only slows, and badly so when the suite's
workers share the cores: with torch's default pool,
``test_torch_xlstm_train.py``'s step cases took 236-282 s each and its
phase 526 s in the whole suite's ``--durations``, against 12-19 s alone.
A module takes the fixture by importing it (pytest finds fixtures among a
module's names)."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
