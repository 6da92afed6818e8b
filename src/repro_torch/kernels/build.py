"""Builds the port's CUDA sources into shared libraries with a plain C
interface and loads them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles with one ``nvcc`` call for ``sm_90a`` into
``build/repro_torch/<name>-<hash>.so`` under the repository root, keyed by
a hash of the source and the flags, so an edit rebuilds and an unchanged
source is reused.  ``build_all`` starts every compile at once.  nvcc's
output (the ptxas report: registers, spills, shared memory of each kernel)
is kept beside each library (``build_log``).  Nothing here runs at
import: the CPU tests import every module, and only a launch on a CUDA
tensor needs a library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict = {}
_LOCK = threading.Lock()  # two threads' first loads build a source once


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                           "with the CUDA toolkit")
    return nvcc


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build_all(names) -> dict:
    """Compile every named source that has no library yet, all at once.
    Returns ``{name: seconds}`` for the sources compiled by this call."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    seconds = {}
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{log}")
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return seconds


def build_log(name: str) -> str:
    """nvcc's output for ``csrc/<name>.cu``'s current library, built on first use."""
    load(name)
    return library_path(name).with_suffix(".log").read_text()


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        if name not in _LIBS:
            build_all([name])
            _LIBS[name] = ctypes.CDLL(str(library_path(name)))
        return _LIBS[name]
