"""Build the CUDA kernels of ``seqalign_torch/csrc/`` on first use.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface (``native.build.build_shared``:
cached by digest, locked, published atomically) and is loaded with
``ctypes``.  Nothing builds when a module is imported; the first launch
of a kernel builds it, and ``build_all`` builds them all at once (one
``nvcc`` per source, started together).  ``nvcc -Xptxas -v`` writes each
kernel's registers, shared memory and spills to ``<library>.log``.
Every source includes ``csrc/launch_error.cuh``, so every library
exports ``sa_error_text``, which ``check_launch`` reads to name a failed
launch's CUDA error; K1 and K5 include ``csrc/band_stream.cuh``, their
bands' shared stream helpers, K3 and K3-cell16
``csrc/interpair_chain.cuh``, their chain of warps, and
``csrc/interpair_host.cuh``, their host side (checks, shapes, launch),
and K2 and K4 ``csrc/mbarrier.cuh``, their window walks' barriers.  A
header a source includes belongs in ``HEADERS``, whose contents every
library's digest covers.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading
from concurrent.futures import ThreadPoolExecutor

import torch

from ..native.build import build_shared

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
KERNELS = ("wavefront", "walk", "interpair", "interpair16", "batch_walk",
           "strip", "probe_dpx16", "probe_chase")
HEADERS = tuple(os.path.join(CSRC, name)
                for name in ("launch_error.cuh", "band_stream.cuh",
                             "interpair_chain.cuh", "interpair_host.cuh",
                             "mbarrier.cuh"))
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
        HEADERS,
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


def c_function(lib: ctypes.CDLL, name: str, argtypes, restype=ctypes.c_int):
    """``lib``'s C function ``name``, its ctypes ``argtypes`` and
    ``restype`` set on first use."""
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = list(argtypes)
        fn.restype = restype
    return fn


def int_function(lib: ctypes.CDLL, name: str, nargs: int,
                 restype=ctypes.c_int):
    """``lib``'s C function ``name`` of ``nargs`` int arguments returning
    ``restype``."""
    return c_function(lib, name, [ctypes.c_int] * nargs, restype)


def launch_sms(launch) -> list[int]:
    """The SM each CTA of a band kernel's ``launch`` (K1's or K5's launch
    closure) ran on in its latest run, after the run has finished: the SM
    log in its scratch, SM + 1 by ticket from int32 ``launch.sm_log``, one
    entry for each of its ``launch.ctas`` CTAs."""
    log = launch.scratch.view(torch.int32)[
        launch.sm_log:launch.sm_log + launch.ctas]
    return [int(x) - 1 for x in log.cpu()]


def check_launch(name: str, rc: int) -> None:
    """Raise RuntimeError unless ``rc``, the cudaError_t a launch of the
    kernel library ``name`` returned, is 0.  The message carries the
    error's name and text, e.g. ``interpair kernel launch failed:
    cudaErrorMemoryAllocation: out of memory (cudaError_t 2)``."""
    if rc == 0:
        return
    fn = library(name).sa_error_text
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
        fn.restype = ctypes.c_int
    text = ctypes.create_string_buffer(256)
    fn(rc, text, len(text))
    raise RuntimeError(f"{name} kernel launch failed: "
                       f"{text.value.decode(errors='replace')} "
                       f"(cudaError_t {rc})")
