"""The port's accounting, checkpoints and launcher rules against
the JAX package, on the CPU.

  * ``tree_bytes`` / ``tree_params`` on both packages' trees, at their
    dtypes; ``ArchConfig.param_count`` on every config the port has;
  * ``round_bill`` equal to the JAX one, field for field, for every method
    and three wire formats, over a stream of rounds from one seed;
  * checkpoints across packages both ways, through the launcher's
    ``--ckpt`` too;
  * the launcher's ``SystemExit``s."""
import functools
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.core import baselines as jb
from repro.core import commcost as jcost
from repro.core.engine import SemiSFLSystem as JaxSystem
from repro.core.wire import parse_wire_format as jax_parse_wire
from repro_torch import convert
from repro_torch.checkpoint import io as ckpt
from repro_torch.configs import _REGISTRY, get_config, smoke_config
from repro_torch.core import commcost
from repro_torch.core.engine import SemiSFLSystem
from repro_torch.core.wire import parse_wire_format
from repro_torch.launch import train
from _torch_threads import one_torch_thread  # noqa: F401

METHODS = ["supervised-only", "semifl", "fedswitch", "fedmatch", "semisfl",
           "fedswitch-sl"]
WIRES = [None, "int8", "fp8+topk0.1"]


def _jax_params(arch="paper-cnn", fedmatch=False):
    cfg = jax_smoke_config(arch)
    if fedmatch:
        return jb.FedMatch(cfg, n_clients_per_round=2).init_state(0).params
    return JaxSystem(cfg, n_clients_per_round=2,
                     scan_rounds=False).init_state(0).params


@pytest.mark.parametrize("fedmatch", [False, True])
@pytest.mark.parametrize("arch", ["paper-cnn", "paper-alexnet"])
def test_tree_bytes_and_params_match_jax(arch, fedmatch):
    tree_j = jax.device_get(_jax_params(arch, fedmatch))
    tree_t = convert.params_from_numpy(tree_j)
    want = jcost.tree_bytes(tree_j), jcost.tree_params(tree_j)
    assert (commcost.tree_bytes(tree_t), commcost.tree_params(tree_t)) \
        == want
    assert (commcost.tree_bytes(tree_j), commcost.tree_params(tree_j)) \
        == want
    assert want[0] == 4 * want[1]


def test_tree_bytes_count_each_leaf_at_its_dtype():
    shapes = {"w": (3, 5), "b": (7,), "q": (2, 2, 2)}
    dtypes = {"w": (jnp.bfloat16, torch.bfloat16),
              "b": (jnp.float32, torch.float32),
              "q": (jnp.int8, torch.int8)}
    tree_j = {k: jnp.zeros(s, dtypes[k][0]) for k, s in shapes.items()}
    tree_t = {k: torch.zeros(s, dtype=dtypes[k][1])
              for k, s in shapes.items()}
    assert commcost.tree_bytes(tree_t) == jcost.tree_bytes(tree_j) \
        == 15 * 2 + 7 * 4 + 8
    assert commcost.tree_params(tree_t) == jcost.tree_params(tree_j) == 30
    assert commcost.tree_bytes(
        {"a": np.zeros(4, ml_dtypes.bfloat16)}) == 8


@pytest.mark.parametrize("name", sorted(_REGISTRY))
def test_param_count_matches_jax(name):
    assert get_config(name).param_count() == \
        jax_get_config(name).param_count()
    assert smoke_config(name).param_count() == \
        jax_smoke_config(name).param_count()


@functools.cache
def _bill_inputs(arch):
    """The byte sizes a run bills from its own trees (as the JAX
    benchmarks take them), from the full config's shapes."""
    cfg = get_config(arch)
    system = SemiSFLSystem(cfg, device="cpu")
    params = system.init_state(0).params
    hw, c = system.model.feat_shape(cfg.split_layer)
    return dict(bottom_bytes=commcost.tree_bytes(params["bottom"]),
                full_bytes=commcost.tree_bytes(
                    {k: params[k] for k in ("bottom", "top")}),
                feat_bytes_per_batch=16 * hw * hw * c * 4)


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("method", METHODS)
def test_round_bill_matches_jax(method, wire):
    kw = dict(_bill_inputs("paper-cnn"), k_u=4, n_active=5, batch=16)
    cost_t, cost_j = commcost.CostModel(seed=3), jcost.CostModel(seed=3)
    for k_s in (15, 10, 6):           # a stream of rounds, K_s shrinking
        got = commcost.round_bill(method, get_config("paper-cnn"),
                                  cost=cost_t, k_s=k_s,
                                  wire=parse_wire_format(wire), **kw)
        want = jcost.round_bill(method, jax_get_config("paper-cnn"),
                                cost=cost_j, k_s=k_s,
                                wire=jax_parse_wire(wire), **kw)
        assert (got.bytes_up, got.bytes_down, got.seconds) == \
            (want.bytes_up, want.bytes_down, want.seconds)
        assert got.bytes_total == want.bytes_total
    if method in ("semisfl", "fedswitch-sl") and wire:
        fp32 = commcost.round_bill(method, get_config("paper-cnn"),
                                   cost=commcost.CostModel(seed=3), k_s=6,
                                   **kw)
        assert got.bytes_up < fp32.bytes_up


def test_round_bill_of_a_transformer_config_matches_jax():
    """Non-CNN configs bill their compute from ``param_count``."""
    kw = dict(bottom_bytes=4000, full_bytes=40000, feat_bytes_per_batch=2048,
              k_s=3, k_u=2, n_active=4, batch=8)
    got = commcost.round_bill("semisfl", get_config("xlstm-1.3b"),
                              cost=commcost.CostModel(seed=1), **kw)
    want = jcost.round_bill("semisfl", jax_get_config("xlstm-1.3b"),
                            cost=jcost.CostModel(seed=1), **kw)
    assert got.seconds == want.seconds


@pytest.mark.parametrize("fedmatch", [False, True])
def test_jax_checkpoint_restores_in_the_port(tmp_path, fedmatch):
    params_j = jax.device_get(_jax_params("paper-alexnet", fedmatch))
    path = str(tmp_path / "ckpt")
    jckpt.save_state(path, params_j, {"arch": "paper-alexnet"})
    template = convert.params_from_numpy(
        jax.tree.map(np.zeros_like, params_j))
    got, meta = ckpt.restore_state(path, template)
    assert meta == {"arch": "paper-alexnet"}
    want = convert.params_from_numpy(params_j)
    gl, wl = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        assert g.shape == w.shape and torch.equal(g, w)


@pytest.mark.parametrize("fedmatch", [False, True])
def test_port_checkpoint_loads_in_jax(tmp_path, fedmatch):
    params_j = jax.device_get(_jax_params("paper-alexnet", fedmatch))
    params_t = convert.params_from_numpy(params_j)
    ckpt.save_state(str(tmp_path / "port"), params_t, {"round": 3})
    jckpt.save_state(str(tmp_path / "jax"), params_j, {"round": 3})
    with np.load(tmp_path / "port.npz") as a, \
            np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert ("sigma/bottom/convs/0/w" if fedmatch
                else "bottom/convs/0/w") in a.files
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key])
    got, meta = jckpt.restore_state(str(tmp_path / "port"), params_j)
    assert meta == {"round": 3}
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(params_j)):
        np.testing.assert_array_equal(np.asarray(g), w)


def test_restore_refuses_a_missing_key_and_a_wrong_shape(tmp_path):
    tree = {"a": torch.zeros(2, 3), "b": [torch.ones(4)]}
    ckpt.save_pytree(str(tmp_path / "t.npz"), tree)
    with pytest.raises(KeyError, match="c"):
        ckpt.load_pytree(str(tmp_path / "t.npz"),
                         dict(tree, c=torch.zeros(1)))
    with pytest.raises(ValueError, match="b/0"):
        ckpt.load_pytree(str(tmp_path / "t.npz"),
                         {"a": tree["a"], "b": [torch.zeros(5)]})


def test_cli_ckpt_writes_what_the_jax_launcher_writes(tmp_path, capsys):
    """``--ckpt`` of a FedMatch run: ``state.params`` ({"sigma", "psi"})
    in the JAX layout, and the history, arch and baseline beside it."""
    path = str(tmp_path / "run")
    state, history, _ = train.main(
        ["--baseline", "fedmatch", "--rounds", "2", "--device", "cpu",
         "--ckpt", path])
    template = jb.FedMatch(jax_smoke_config("paper-cnn"),
                           n_clients_per_round=5).init_state(0).params
    got, meta = jckpt.restore_state(path, template)
    assert meta["arch"] == "paper-cnn" and meta["baseline"] == "fedmatch"
    assert meta["history"] == json.loads(json.dumps(history))
    assert [rec["round"] for rec in meta["history"]] == [0, 1]
    want = convert.params_to_numpy(state.params)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(g), w)
    assert f"checkpoint -> {path}.npz" in capsys.readouterr().out


@pytest.mark.parametrize("baseline", list(jb.BASELINES))
def test_wire_format_on_a_full_model_baseline_exits(baseline):
    with pytest.raises(SystemExit, match="no split link"):
        train.run_training("paper-cnn", baseline=baseline, rounds=1,
                           wire_format="int8", device="cpu")
    with pytest.raises(SystemExit, match="no split link"):
        train.main(["--baseline", baseline, "--wire-format",
                    "fp8+topk0.1", "--device", "cpu"])
    # the identity wire is no compression: it is accepted
    _, history, system = train.run_training(
        "paper-cnn", baseline=baseline, rounds=1, n_active=2, k_s=1, k_u=1,
        wire_format="fp32", device="cpu")
    assert system.name == baseline and len(history) == 1


def test_a_non_cnn_arch_exits():
    with pytest.raises(SystemExit, match="classification rig"):
        train.run_training("qwen3-14b", rounds=1, device="cpu")


def test_build_system_names_every_method():
    cfg = smoke_config("paper-cnn")
    for name in METHODS:
        system = train.build_system(name, cfg, n_clients_per_round=2,
                                    wire_format=parse_wire_format("int8"),
                                    device="cpu")
        assert system.name == name
        if name in train.SPLIT_BASELINES:
            assert system.act_fmt == "int8"
            assert system.use_clustering == (name == "semisfl")


@pytest.mark.parametrize("baseline", ["semisfl", "fedmatch"])
def test_run_training_goes_on_from_a_given_state(baseline):
    """``state=`` replaces the seeded initial state: the seeded one given
    back reproduces the run, and a trained one goes on from its round."""
    kw = dict(baseline=baseline, n_active=2, k_s=1, k_u=1, device="cpu")
    first, history, _ = train.run_training("paper-cnn", rounds=1,
                                           log=lambda _: None, **kw)
    seeded = train.build_run("paper-cnn", **kw).state
    again, history_again, _ = train.run_training(
        "paper-cnn", rounds=1, state=seeded, log=lambda _: None, **kw)
    drop_dt = lambda h: [{k: v for k, v in r.items() if k != "dt"}
                         for r in h]
    assert drop_dt(history_again) == pytest.approx(drop_dt(history))
    for a, b in zip(jax.tree.leaves(convert.params_to_numpy(first.params)),
                    jax.tree.leaves(convert.params_to_numpy(again.params))):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-6)
    on, _, _ = train.run_training("paper-cnn", rounds=1, state=first,
                                  log=lambda _: None, **kw)
    assert (first.round, on.round) == (1, 2)
