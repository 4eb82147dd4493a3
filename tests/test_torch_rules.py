"""Rules of the PyTorch port, checked on the CPU.

  * ``src/repro_torch/`` and ``chip_smoke.py`` import neither JAX nor the
    JAX package (checked on the AST), and importing every module of the
    port leaves ``jax`` out of ``sys.modules``;
  * no module of the port calls a library's attention
    (``scaled_dot_product_attention``, its backends and switches, cuDNN's
    or ``nn.MultiheadAttention``): attention runs through the port's own
    kernel.  ``chip_smoke.py`` may, as its yardstick;
  * entry points run on the card unless asked for the CPU: without a card,
    ``device="cuda"`` raises rather than running on the CPU;
  * ``chip_smoke.py`` fails, and prints no result, without a card and when
    it stands alone without the repo."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__"):
            for arg in node.args[:1]:
                if isinstance(arg, ast.Constant) and isinstance(arg.value,
                                                                str):
                    roots.add(arg.value.split(".")[0])
    return roots


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


# the names through which PyTorch reaches a library's attention kernel
LIBRARY_ATTENTION = ("scaled_dot_product_attention", "sdpa_kernel",
                     "SDPBackend", "enable_flash_sdp", "enable_cudnn_sdp",
                     "enable_mem_efficient_sdp", "enable_math_sdp",
                     "_scaled_dot_product_flash_attention",
                     "_scaled_dot_product_efficient_attention",
                     "_scaled_dot_product_cudnn_attention",
                     "_flash_attention_forward",
                     "_efficient_attention_forward",
                     "_cudnn_attention_forward", "MultiheadAttention",
                     "multi_head_attention_forward", "flex_attention")


def _library_attention(path: Path) -> set[str]:
    found = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Attribute):
            name = node.attr
        elif isinstance(node, ast.Name):
            name = node.id
        elif isinstance(node, ast.ImportFrom):
            if (node.module or "").startswith("torch.nn.attention"):
                found.add(node.module)
            found.update(a.name for a in node.names
                         if a.name in LIBRARY_ATTENTION)
            continue
        elif isinstance(node, ast.Import):
            found.update(a.name for a in node.names
                         if a.name.startswith("torch.nn.attention"))
            continue
        else:
            continue
        if name in LIBRARY_ATTENTION:
            found.add(name)
    return found


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_calls_no_library_attention(path):
    bad = _library_attention(path)
    assert not bad, (f"{path.relative_to(ROOT)} reaches a library's "
                     f"attention through {sorted(bad)}")


def test_the_attention_rule_sees_a_library_call(tmp_path):
    """The rule above catches each way of reaching SDPA, and lets
    ``chip_smoke.py``'s yardstick be."""
    for code in ("import torch.nn.functional as F\n"
                 "F.scaled_dot_product_attention(q, k, v)\n",
                 "from torch.nn.functional import "
                 "scaled_dot_product_attention\n",
                 "from torch.nn.attention import sdpa_kernel\n",
                 "torch.backends.cuda.enable_flash_sdp(True)\n"):
        src = tmp_path / "m.py"
        src.write_text(code)
        assert _library_attention(src), code
    assert _library_attention(ROOT / "chip_smoke.py") == {
        "scaled_dot_product_attention"}


def _env():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_importing_the_port_loads_no_jax():
    code = ("import importlib, pkgutil, sys, repro_torch\n"
            "for m in pkgutil.walk_packages(repro_torch.__path__, "
            "'repro_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print(len(sys.modules)); assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], env=_env(),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr


def test_cuda_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the rule is for its absence")
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.core.baselines import BASELINES, make_fedswitch_sl
    from repro_torch.core.engine import SemiSFLSystem
    from repro_torch.launch.serve import serve, serve_config
    from repro_torch.launch.train import run_training
    from repro_torch.quickstart import main as quickstart
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_training("paper-cnn", rounds=1, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_training("paper-cnn", rounds=1)          # the default is cuda
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SemiSFLSystem(smoke_config("paper-cnn"))
    for name, cls in BASELINES.items():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(smoke_config("paper-cnn"))           # the default is cuda
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_training("paper-cnn", rounds=1, baseline=name)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_fedswitch_sl(smoke_config("paper-cnn"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quickstart([])                               # the default is cuda
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve("qwen3-14b")                           # the default is cuda
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_config(get_config("qwen3-14b"), device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_config(get_config("xlstm-1.3b"))       # the default is cuda
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve("zamba2-7b")                           # the default is cuda


def test_chip_smoke_fails_without_a_card_and_alone(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the rule is for its absence")
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                       env=_env(), capture_output=True, text=True,
                       timeout=300, cwd=ROOT)
    assert r.returncode != 0 and '"ok"' not in r.stdout
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    env = {k: v for k, v in _env().items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, str(alone)], env=env,
                       capture_output=True, text=True, timeout=300,
                       cwd=tmp_path)
    assert r.returncode != 0 and '"ok"' not in r.stdout
