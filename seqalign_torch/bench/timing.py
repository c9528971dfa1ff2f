"""Timing helpers of the benchmarks.

On a CUDA device a call's time is read between CUDA events recorded
around back-to-back calls, so the host's launch latency overlaps the
card's work and is not counted, except where a call waits for the card
on the host (a ``.cpu()``, an ``int()`` of a device value): the window
then holds that wait and the host's gap before the next launch too.  The
JAX package instead repeats the call inside one jitted ``fori_loop`` with
a perturbed gap and differences out a fixed cost
(``seqalign_tpu/bench/timing.py``), because every dispatch to its TPU
paid a round trip of tens of milliseconds; a CUDA launch pays a few
microseconds, so nothing here needs that.
"""

from __future__ import annotations

import time
from typing import Callable

import torch

from .. import config


def device_seconds_per_call(fn: Callable[[], object], reps: int = 4,
                            timings: int = 3, device=None) -> float:
    """Seconds per call of ``fn()`` on ``device`` (default
    ``config.device()``): the median of ``timings`` windows of ``reps``
    back-to-back calls, divided by ``reps``.  On a CUDA device one warm
    call (which builds the kernels) comes first, and each window lies
    between CUDA events on the current stream; on the CPU, where nothing
    is built, each window is the host clock's."""
    device = torch.device(device or config.device())
    if device.type == "cuda":
        fn()
    windows = []
    for _ in range(timings):
        if device.type == "cuda":
            with torch.cuda.device(device):
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(reps):
                    fn()
                stop.record()
                stop.synchronize()
                windows.append(start.elapsed_time(stop) / 1e3)
        else:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            windows.append(time.perf_counter() - t0)
    return sorted(windows)[timings // 2] / reps


def wall_seconds(fn: Callable[[], object], repeats: int = 3) -> float:
    """Best-of-N wall-clock time of a host-level call (the reference's
    end-to-end protocol, tests/benchmarks.cu:44-52), the card's queued
    work finished before the clock stops."""
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best
