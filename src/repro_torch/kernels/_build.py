"""Build the port's CUDA kernels at first use and load them with ctypes.

Three kernels, one package each (``SOURCES``): matmul_int8,
flash_attention and ssd_scan. Each package keeps its source under
``csrc/<name>.cu`` with a plain C interface. ``load(name)`` compiles it
with ``nvcc`` into ``build/repro_torch/<name>-<hash>.so`` at the
repository root, keyed by a hash of the source and the flags, so an
unchanged source builds once per checkout; ``build_all`` starts one
``nvcc`` per source at once. Nothing here runs at import time: the CPU
tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: Kernel name -> its package (``kernels/<package>/csrc/<name>.cu``).
SOURCES = {"matmul_int8": "matmul_int8", "flash_attention": "flash_attention",
           "ssd_scan": "ssd_scan"}

_loaded: dict[str, ctypes.CDLL] = {}


def source_path(name: str) -> Path:
    return KERNELS_DIR / SOURCES[name] / "csrc" / f"{name}.cu"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(fallback):
        return fallback
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    digest = hashlib.sha256(source_path(name).read_bytes() +
                            " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def log_path(name: str) -> Path:
    """The compiler's output (``-Xptxas -v``: registers, shared memory and
    spills of every instantiation) beside the library."""
    return library_path(name).with_suffix(".log")


def _start(name: str) -> tuple[subprocess.Popen, Path] | None:
    """Start ``nvcc`` for one kernel into a temporary file; ``None`` when
    the library is built already."""
    if library_path(name).exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = library_path(name).with_suffix(f".{os.getpid()}.tmp")
    with open(log_path(name), "w") as log:
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source_path(name))],
            stdout=log, stderr=subprocess.STDOUT)
    return proc, tmp


def _finish(name: str, started: tuple[subprocess.Popen, Path] | None) -> None:
    if started is None:
        return
    proc, tmp = started
    rc = proc.wait()
    if rc != 0:
        raise RuntimeError(f"nvcc failed for {name} (exit {rc}):\n"
                           f"{log_path(name).read_text()[-4000:]}")
    os.replace(tmp, library_path(name))


def build_all(names=tuple(SOURCES)) -> None:
    """Compile every named kernel that is not built yet, all at once."""
    started = {n: _start(n) for n in names}
    for n, st in started.items():
        _finish(n, st)


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if needed."""
    if name not in _loaded:
        _finish(name, _start(name))
        _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return _loaded[name]
