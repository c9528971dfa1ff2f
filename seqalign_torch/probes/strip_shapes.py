"""K5 at every shape: how many rows a lane owns, and how many columns a
lane runs an iteration, per variant.

K5 (``csrc/strip.cu``) gives each lane of a band RPL rows (1, 2 or 4),
runs SB columns (a block: 1, 2, 4 or 8) each iteration, and keeps one
shape per variant (with words, score-only) in code (``rows_of``,
``kBlock``).  This probe builds the same source with
``-DSA_STRIP_ALL_SHAPES`` into a library of its own, which exports
``sa_strip_fill_shape`` taking the shape as arguments, and

* ``--check``: holds every shape against the plain version on small
  regions, a first one and an interior one, global and local, with words
  and score-only, every output;
* ``--time``: times every shape at the main path's shapes (CUDA events,
  best of 2 after a warm launch), each shape's outputs bitwise equal to
  the first's, and prints the fastest per main-path shape;
* ``--trace``: runs K5 as the main path builds it (``kernel_launch``, the
  shape in code) once at each main-path shape and prints its trace from
  the scratch: the kernel's time, each band's time, when the last band
  ended after the first (the pipeline's fill), the ns an iteration, the
  stream windows the bands loaded and found empty, and the SMs.

``python -m seqalign_torch.probes.strip_shapes [--check] [--time]
[--trace]`` (``--check --time`` without arguments); exits 1 without a
CUDA device or when a shape differs.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops import _build
from ..ops import strip_fill as sf
from ._shapes import (all_shapes_library, band_clocks, best_ms, same,
                      score_matrix)
from ._shapes import main as probe_main

ROWS_PER_LANE = (1, 2, 4)
BLOCKS = (1, 2, 4, 8)
# Columns a lane runs an iteration in code, both variants (csrc/strip.cu's
# kBlock).
BLOCK_IN_CODE = 8
# Small regions held against the plain version: rows, columns.
CHECKS = ((256, 1024), (384, 2048), (2048, 4096))
# The main path's K5 shapes (chip_smoke.py's HELD_FULL_INTERIOR,
# HELD_LONG and HELD_SINGLE): name, rows, columns, with words, local.
SHAPES = (
    ("full-width interior block, words", 8192, 32768, True, False),
    ("long-pair block, score-only", 16384, 32768, False, False),
    ("single region, words", 7296, 49152, True, False),
    ("single region, words, local", 7296, 49152, True, True),
)


def library():
    """The all-shapes build of ``csrc/strip.cu``."""
    return all_shapes_library("strip", "SA_STRIP_ALL_SHAPES")


def in_code(with_dirs):
    """(rows a lane, columns an iteration) K5 takes for the variant."""
    return sf.rows_per_lane(with_dirs), BLOCK_IN_CODE


def region(rng, rows, w, where, local, device):
    """Random inputs of one region: (args, kwargs) of ``strip_fill``.
    ``first``: row 0 and column 0, n and m inside it, off every block and
    band edge; ``interior``: boundaries a few gaps apart, a carried state,
    the strip holding column n and the rows row m."""
    gap = 5
    if where == "first":
        row_base = strip_off = 0
        n, m = w - 37, rows - 45
        left = sf.nw_boundary_col(0, rows, gap, local)
        prev = sf.init_prev_row(w, 0, gap, local)
        state = sf.zeros_state()
    else:
        row_base, strip_off = 3 * rows, 2 * w
        n, m = strip_off + w - 333, row_base + rows - 71
        left = (np.cumsum(rng.integers(-gap, gap + 1, rows + 1))
                - gap * row_base // 4).astype(np.int32)
        prev = (np.cumsum(rng.integers(-gap, gap + 1, w))
                - gap * row_base // 4).astype(np.int32)
        if local:
            left, prev = np.maximum(left, 0), np.maximum(prev, 0)
        state = np.array([9, row_base - 3, strip_off - 5, sf.NEG_INF],
                         np.int32)
    pattern = rng.integers(0, 4, rows).astype(np.int32)
    pattern[m - row_base:] = 0
    letters = rng.integers(0, 4, w).astype(np.int32)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    args = (t(letters), t(score_matrix()), t(pattern), gap, n, m, row_base,
            strip_off, t(left), t(prev), t(state))
    return args, dict(local=local)


def shapes():
    return [(rpl, block) for rpl in ROWS_PER_LANE for block in BLOCKS]


def launcher(lib, shape, args, local, with_dirs):
    """(launch, outputs) of the all-shapes library at ``shape``."""
    return sf.shape_launch(lib, shape, *args, local, with_dirs)


def check(lib) -> bool:
    ok = True
    rng = np.random.default_rng(8)
    for rows, w in CHECKS:
        for where in ("first", "interior"):
            for local in (False, True):
                args, kw = region(rng, rows, w, where, local, "cuda")
                for with_dirs in (True, False):
                    want = sf.strip_fill_plain(*args, with_dirs=with_dirs,
                                               **kw)
                    for shape in shapes():
                        launch, out = launcher(lib, shape, args, local,
                                               with_dirs)
                        launch()
                        torch.cuda.synchronize()
                        good = same(out, want)
                        ok &= good
                        print(f"SHAPE_CHECK {rows} x {w} {where} "
                              f"{'local' if local else 'global'} "
                              f"{'words' if with_dirs else 'score'} "
                              f"rpl={shape[0]} block={shape[1]}: "
                              f"{'exact' if good else 'DIFFERS'}",
                              flush=True)
    return ok


def time_shapes(lib) -> bool:
    """Times every shape at SHAPES and prints, per variant (with words,
    score-only), each shape's time summed over the variant's shapes and
    the least: the rule ``rows_of``/``kBlock`` follow."""
    ok = True
    rng = np.random.default_rng(9)
    totals = {True: {}, False: {}}
    for name, rows, w, with_dirs, local in SHAPES:
        args, _ = region(rng, rows, w, "interior", local, "cuda")
        first, times = None, {}
        for shape in shapes():
            launch, out = launcher(lib, shape, args, local, with_dirs)
            best = best_ms(launch)
            sms = len(set(_build.launch_sms(launch)))
            if first is None:
                first, good = out, True
            else:
                good = same(out, first)
            ok &= good
            times[shape] = best
            totals[with_dirs][shape] = totals[with_dirs].get(shape, 0) + best
            print(f"SHAPE_TIME {name} ({rows} x {w}) rpl={shape[0]} "
                  f"block={shape[1]}: {best:.3f} ms, {launch.ctas} CTAs on "
                  f"{sms} SMs{'' if good else ', DIFFERS from the first'}",
                  flush=True)
            del out, launch
        best = min(times, key=times.get)
        print(f"SHAPE_BEST {name}: rpl={best[0]} block={best[1]} "
              f"{times[best]:.3f} ms (in code: {in_code(with_dirs)})",
              flush=True)
        del first
        torch.cuda.empty_cache()
    for with_dirs, total in totals.items():
        variant = "words" if with_dirs else "score-only"
        for shape, ms in total.items():
            print(f"SHAPE_TOTAL {variant} rpl={shape[0]} block={shape[1]}: "
                  f"{ms:.3f} ms", flush=True)
        best = min(total, key=total.get)
        print(f"SHAPE_CHOICE {variant}: rpl={best[0]} block={best[1]} "
              f"{total[best]:.3f} ms (in code: {in_code(with_dirs)})",
              flush=True)
    return ok


def trace_shapes():
    """``--trace``: one launch a shape through ``kernel_launch``."""
    rng = np.random.default_rng(10)
    for name, rows, w, with_dirs, local in SHAPES:
        args, _ = region(rng, rows, w, "interior", local, "cuda")
        launch, out = sf.kernel_launch(*args, local, with_dirs)
        ms = best_ms(launch, reps=1)
        rpl, block = in_code(with_dirs)
        bands = launch.ctas
        iters = w // block + 31
        c, run, lag, start = band_clocks(launch, sf.SCRATCH_COUNTERS,
                                         sf.BAND_START, sf.BAND_END, bands)
        sms = len(set(_build.launch_sms(launch)))
        print(f"K5_TRACE {name} ({rows} x {w}, rpl {rpl}, block {block}, "
              f"{bands} bands on {sms} SMs): {ms:.3f} ms; a band "
              f"{run.min() / 1e6:.3f}-{run.max() / 1e6:.3f} ms, "
              f"{run.mean() / iters:.1f} ns an iteration; the last band "
              f"started {start[-1] / 1e6:.3f} ms after the first "
              f"({start[-1] / max(bands - 1, 1):.0f} ns a band, "
              f"{start[-1] / max(bands - 1, 1) / 32:.0f} a lane) and ended "
              f"{lag[-1] / 1e6:.3f} ms after it; stream windows loaded "
              f"{c[sf.LOADS]} ({c[sf.LOADS] / max(bands - 1, 1):.0f} a "
              f"band), found empty {c[sf.MISSES]}", flush=True)
        del out, launch
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    return probe_main(argv, "strip_shapes", library, check, time_shapes,
                      trace_shapes)


if __name__ == "__main__":
    sys.exit(main())
