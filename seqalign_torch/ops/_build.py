"""Build the CUDA kernels of ``seqalign_torch/csrc/`` on first use.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface (``native.build.build_shared``:
cached by digest, locked, published atomically) and is loaded with
``ctypes``.  Nothing builds when a module is imported; the first launch
of a kernel builds it, and ``build_all`` builds them all at once (one
``nvcc`` per source, started together).  ``nvcc -Xptxas -v`` writes each
kernel's registers, shared memory and spills to ``<library>.log``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading
from concurrent.futures import ThreadPoolExecutor

from ..native.build import build_shared

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
KERNELS = ("wavefront", "walk", "interpair", "batch_walk", "strip")
ARCH = "-gencode=arch=compute_90a,code=sm_90a"

_loaded: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's default location."""
    home = os.environ.get("CUDA_HOME")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def build(name: str) -> str:
    """Path of the shared library built from ``csrc/<name>.cu``."""
    source = os.path.join(CSRC, f"{name}.cu")
    return build_shared(
        f"seqalign_{name}", source,
        lambda out: [nvcc(), ARCH, "-std=c++17", "-O3", "-Xptxas", "-v",
                     "-shared", "-Xcompiler", "-fPIC", "-o", out, source],
    )


def build_all(names=KERNELS) -> dict[str, str]:
    """Build every kernel library in parallel; returns name -> path."""
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        paths = list(pool.map(build, names))
    return dict(zip(names, paths))


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            _loaded[name] = lib
        return lib
