"""What the shape probes of the band kernels share: K1's
(``wavefront_shapes``) and K5's (``strip_shapes``).  Each builds its
kernel's source with a define that adds an entry point taking the shape
as arguments, holds every shape against the plain version, times it, and
reads the kernel's own trace (each band's first and last iteration on
the GPU's nanosecond clock) from the launch's scratch."""

from __future__ import annotations

import ctypes
import os
import sys

import numpy as np
import torch

from ..io import parse_score_matrix_file
from ..native.build import build_shared
from ..ops import _build


def all_shapes_library(kernel: str, define: str) -> ctypes.CDLL:
    """The build of ``csrc/<kernel>.cu`` with ``-D<define>`` (built once,
    cached by digest like the kernels)."""
    source = os.path.join(_build.CSRC, f"{kernel}.cu")
    return ctypes.CDLL(build_shared(
        f"seqalign_{kernel}_shapes", source,
        lambda out: [_build.nvcc(), _build.ARCH, "-std=c++17", "-O3",
                     f"-D{define}", "-Xptxas", "-v", "-shared",
                     "-Xcompiler", "-fPIC", "-o", out, source],
        _build.HEADERS))


def score_matrix() -> np.ndarray:
    sm = np.zeros((4, 4), dtype=np.int32)
    assert parse_score_matrix_file("scoreMatrices/dna/blast.txt", 4, sm) == 0
    return sm


def same(a, b) -> bool:
    return all((x is None and y is None) or torch.equal(x, y)
               for x, y in zip(a, b))


def best_ms(launch, reps=2) -> float:
    """Best of ``reps`` runs of ``launch`` (ms, CUDA events), after a warm
    one."""
    launch()
    torch.cuda.synchronize()
    best = None
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        launch()
        stop.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(stop)
        best = ms if best is None else min(best, ms)
    return best


def band_clocks(launch, counter_words, band_start, band_end, bands):
    """(counters, run, lag, start) of ``launch``'s latest run: its
    scratch's first ``counter_words`` int32 counters, and in ns, each
    band's time from its first iteration to its end, each band's end
    after band 0's, and each band's first iteration after band 0's (the
    clocks' low 32 bits, differences taken as signed numbers)."""
    c = launch.scratch.view(torch.int32)[:counter_words].cpu().numpy()
    c = c.astype(np.int64)
    first = c[band_start:band_start + bands]
    last = c[band_end:band_end + bands]

    def signed(x):
        return (x + (1 << 31)) % (1 << 32) - (1 << 31)

    return (c, signed(last - first), signed(last - last[0]),
            signed(first - first[0]))


def main(argv, name, library, check, time_shapes, trace_shapes) -> int:
    """The probes' command line: ``--trace`` runs ``trace_shapes()``;
    ``--check`` and ``--time`` (both without arguments) run ``check`` and
    ``time_shapes`` on ``library()``.  Returns 1 without a CUDA device or
    when a shape differs."""
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print(f"{name}: no CUDA device", file=sys.stderr)
        return 1
    ok = True
    if "--trace" in argv:
        trace_shapes()
    if argv and "--check" not in argv and "--time" not in argv:
        print(f"device: {torch.cuda.get_device_name(0)}")
        return 0
    lib = library()
    if "--check" in argv or not argv:
        ok &= check(lib)
    if "--time" in argv or not argv:
        ok &= time_shapes(lib)
    print(f"device: {torch.cuda.get_device_name(0)}")
    return 0 if ok else 1
