"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``src/repro_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface under
``<repo>/build/repro_torch/``, named by a hash of its source, the headers
it includes (``csrc/hopper.cuh``, ``csrc/slstm_common.cuh``,
``csrc/mamba2_common.cuh``) and the
flags, so a changed source or header is rebuilt and an unchanged one is
loaded as it is.  The
sources are compiled without ``--use_fast_math``: the quantizer must be
bit-exact, which needs IEEE division and round-half-to-even, and flash
attention's exponent of masked scores and the sLSTM's of its -1e30
stabilizer must give 0, not NaN, and the Mamba2 scan's decays must
underflow to 0.  A build or
load failure raises; nothing falls back."""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("clustering_loss", "flash_attention", "flash_attention_bwd",
           "mamba2_scan", "mamba2_scan_bwd", "quantize", "slstm_scan",
           "slstm_scan_bwd")
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built "
                           "from source at first use and need the CUDA "
                           "toolkit")
    return path


def _flags(defines: tuple[str, ...]) -> tuple[str, ...]:
    return NVCC_FLAGS + tuple(f"-D{d}" for d in defines)


def _sources(path: Path, seen: tuple[Path, ...] = ()) -> tuple[Path, ...]:
    """``path`` and every file it includes with quotes (``#include
    "x.cuh"``, found beside it), recursively, each once, in the order met."""
    seen = seen + (path,)
    for inc in _INCLUDE.findall(path.read_text()):
        dep = (path.parent / inc).resolve()
        if dep not in seen:
            seen = _sources(dep, seen)
    return seen


def _target(name: str, defines: tuple[str, ...] = ()) -> Path:
    """The library of ``csrc/<name>.cu``, named by a digest of the source,
    every header it includes and the flags, so that an edit to any of them
    builds anew."""
    digest = hashlib.sha256()
    for path in _sources(CSRC / f"{name}.cu"):
        digest.update(path.read_bytes())
    digest.update(" ".join(_flags(defines)).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:12]}.so"


def build_all(names=SOURCES, defines: tuple[str, ...] = ()
              ) -> dict[str, str]:
    """Compile every named source that is not built yet, one ``nvcc`` per
    source, all started together, with the macros ``defines`` set (a
    diagnostic build, such as the sLSTM scan's ``SLSTM_PROFILE``, is a
    library of its own).  Returns each source's ``ptxas`` report
    (registers, shared memory, spills); raises on any failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        out = _target(name, defines)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *_flags(defines), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports = {}
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on csrc/{name}.cu "
                               f"(exit {proc.returncode}):\n{log}")
        os.replace(tmp, out)
        reports[name] = log
    return reports


@functools.cache
def load(name: str, defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """The shared library of ``csrc/<name>.cu``, built first if needed."""
    build_all((name,), defines)
    return ctypes.CDLL(str(_target(name, defines)))


def check(status: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a C entry point."""
    if status != 0:
        raise RuntimeError(f"{what} failed: cudaError_t {status}")
