"""K3 and K3-cell16 at every shape: how many warps a CTA runs, and how
many columns a warp sweeps between two handoffs, per variant.

K3 (``csrc/interpair.cu``) and K3-cell16 (``csrc/interpair16.cu``) run
32 pairs a CTA (64 for cell16), W warps splitting each pair's stripes of
16 rows, a warp handing its stripe's bottom row to the next warp every
SB columns (a block), and keep one shape per variant in code
(``warps_of``, ``block_of``; W then shrinks to the stripes).  This probe
builds the two sources with ``-DSA_INTERPAIR_ALL_SHAPES`` into libraries
of their own, which export ``sa_interpair[16]_fill_shape`` taking W, SB
and a trace buffer as arguments, and

* ``--check``: holds every shape against the plain version on small
  ragged batches with padding pairs, global, local and semi-global,
  score-only and with words, linear and affine, int32 and int16 cells,
  where the stripes outnumber the warps (the wrap through the global
  scratch) and where they do not: every output;
* ``--time``: times every shape at the main path's shapes (CUDA events,
  best of 2 after a warm launch; the most warps evened over the stripes,
  as the kernels run a grid that fills the card), each shape's outputs
  bitwise equal to the first's, and prints the fastest per variant,
  beside the shape in code;
* ``--trace``: runs each variant at its shape in code once at its main
  path shape and prints the chain's trace: the kernel's time, each
  warp's time from the kernel's start to its last block, the sleeps
  waiting for the top row (the pipeline's fill and any lag) and for a
  free ring block, and how long the CTAs' warps spread.

``python -m seqalign_torch.probes.interpair_shapes [--check] [--time]
[--trace]`` (``--check --time`` without arguments); exits 1 without a
CUDA device or when a shape differs.
"""

from __future__ import annotations

import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..ops import batch_fill as bf
from ._shapes import all_shapes_library, best_ms, same, score_matrix
from ._shapes import main as probe_main

WARPS = (4, 8, 12, 16)  # --check: warps a CTA, as given
MOSTS = (4, 6, 8, 12, 16)  # --time: the most warps, evened as in code
BLOCKS = (2, 4, 8, 16)
MODES = {"global": {}, "local": {"local": True}, "semi": {"semi": True}}
AFFINE = (8, 2)  # the batch phases' open and extend costs
# Small batches held against the plain version: text columns, pattern
# rows (9 and 33 stripes: every W of WARPS wraps in one of them), of 128
# pairs with words (a tile) and 127 score-only (an odd batch, the last
# CTA short of pairs).
CHECKS = ((70, 144), (37, 528))
# The main path's K3 shapes (chip_smoke.py phases 8-9, 21-22, 24): name,
# pairs, text columns and pattern rows as launched, pairs' lengths, with
# words.  bench.py's 8,192 local DNA pairs of 512 x 512 in their
# 639 x 512 bucket, and one 16,384-pair chunk of the 65,536 pairs of
# 256 x 256.
SHAPES = (
    ("score 8192 x 512^2", 8192, 639, 512, 512, False),
    ("dirs 16384 x 256^2", 16384, 256, 256, 256, True),
)


def library():
    """The all-shapes builds of ``csrc/interpair.cu`` and
    ``interpair16.cu``, by cell16."""
    with ThreadPoolExecutor(max_workers=2) as pool:
        libs = list(pool.map(
            lambda name: all_shapes_library(name, "SA_INTERPAIR_ALL_SHAPES"),
            ("interpair", "interpair16")))
    return {False: libs[0], True: libs[1]}


def variants():
    """(with_dirs, affine, cell16) of every variant."""
    return [(d, a, c) for c in (False, True) for a in (False, True)
            for d in (False, True)]


def variant_name(with_dirs, affine, cell16):
    return ("K3" + ("-cell16" if cell16 else "")
            + ("-affine" if affine else "")
            + ("-dirs" if with_dirs else "-score"))


def shapes(lib, with_dirs, affine, cell16):
    most = bf.shape_in_code(lib, with_dirs, affine, 16, 1, cell16)[2]
    return [(w, sb) for w in WARPS if w <= most for sb in BLOCKS]


def evened_warps(most, m_rows):
    """The warps a CTA runs for at most ``most`` over ``m_rows`` pattern
    rows: the stripes evened over the passes (the kernels'
    evened_warps)."""
    stripes = max(-(-m_rows // 16), 1)
    passes = -(-stripes // most)
    return -(-stripes // passes)


def batch(rng, b, n, m, lengths, device, ragged=True):
    """A batch as the wrappers take it: pair-major letters, lengths (the
    last eighth padding pairs when ``ragged``), on ``device``."""
    texts = rng.integers(0, 4, (b, n)).astype(np.int8)
    patterns = rng.integers(0, 4, (b, m)).astype(np.int8)
    if ragged:
        ns = rng.integers(1, n + 1, b).astype(np.int32)
        ms = rng.integers(1, m + 1, b).astype(np.int32)
        ns[-b // 8:] = 0
        ms[-b // 8:] = 0
    else:
        ns = np.full(b, lengths[0], np.int32)
        ms = np.full(b, lengths[1], np.int32)
    return [torch.from_numpy(x).to(device)
            for x in (texts, patterns, ns, ms)]


def launcher(lib, shape, args, sm, mode, with_dirs, affine, cell16,
             trace=False):
    gap, ext = AFFINE if affine else (5, None)
    return bf.shape_launch(
        lib, shape, *args, sm, gap, 4, mode == "local", mode == "semi",
        tile_pairs=bf.TILE_QUANTUM if with_dirs else None,
        with_dirs=with_dirs, gap_extend=ext, cell16=cell16, trace=trace)


def plain(args, sm, mode, with_dirs, affine, cell16):
    gap, ext = AFFINE if affine else (5, None)
    kw = dict(gap_extend=ext, cell16=cell16, **MODES[mode])
    if with_dirs:
        return bf.batch_fill_dirs_plain(*args, sm, gap, 4,
                                        tile_pairs=bf.TILE_QUANTUM, **kw)
    return (bf.batch_score_plain(*args, sm, gap, 4, **kw),)


def check(libs) -> bool:
    ok = True
    rng = np.random.default_rng(11)
    sm = torch.from_numpy(score_matrix()).cuda()
    for n, m in CHECKS:
        for with_dirs, affine, cell16 in variants():
            # Score-only takes any width: 3 rows fewer than the words.
            b, rows = (bf.TILE_QUANTUM, m) if with_dirs else (127, m - 3)
            args = batch(rng, b, n, rows, None, "cuda")
            lib = libs[cell16]
            for mode in MODES:
                want = plain(args, sm, mode, with_dirs, affine, cell16)
                for shape in shapes(lib, with_dirs, affine, cell16):
                    launch, out = launcher(lib, shape, args, sm, mode,
                                           with_dirs, affine, cell16)
                    launch()
                    torch.cuda.synchronize()
                    good = same(out, want)
                    ok &= good
                    print(f"SHAPE_CHECK {b} pairs {rows} x {n} "
                          f"{variant_name(with_dirs, affine, cell16)} "
                          f"{mode} warps={shape[0]} block={shape[1]}: "
                          f"{'exact' if good else 'DIFFERS'}", flush=True)
    return ok


def main_path_shape(with_dirs):
    return next(s for s in SHAPES if s[5] == with_dirs)


def time_shapes(libs) -> bool:
    """Times each variant at its main-path shape (local DNA, as the
    workloads) for every most warps of MOSTS (evened over the stripes, as
    the kernels run it on a grid that fills the card) and block of
    BLOCKS, and prints the least: the rule warps_of/block_of follow."""
    ok = True
    rng = np.random.default_rng(12)
    sm = torch.from_numpy(np.where(np.eye(4, dtype=bool), 5, -4)
                          .astype(np.int32)).cuda()
    for with_dirs, affine, cell16 in variants():
        name, b, n, m, length, _ = main_path_shape(with_dirs)
        args = batch(rng, b, n, m, (length, length), "cuda", ragged=False)
        lib = libs[cell16]
        vname = variant_name(with_dirs, affine, cell16)
        first, times = None, {}
        for most in MOSTS:
            for sb in BLOCKS:
                shape = (evened_warps(most, m), sb)
                if shape not in times:
                    launch, out = launcher(lib, shape, args, sm, "local",
                                           with_dirs, affine, cell16)
                    times[shape] = best_ms(launch)
                    if first is None:
                        first, good = out, True
                    else:
                        good = same(out, first)
                    ok &= good
                    del out, launch
                    if not good:
                        print(f"SHAPE_TIME {vname}: warps={shape[0]} "
                              f"block={sb} DIFFERS from the first",
                              flush=True)
                print(f"SHAPE_TIME {vname} {name} most={most} "
                      f"warps={shape[0]} block={sb}: {times[shape]:.3f} ms",
                      flush=True)
        best = min(times, key=times.get)
        code = bf.shape_in_code(lib, with_dirs, affine, m, b, cell16)
        print(f"SHAPE_CHOICE {vname}: warps={best[0]} block={best[1]} "
              f"{times[best]:.3f} ms (in code: most={code[3]}, "
              f"warps={code[0]} block={code[1]}, "
              f"{times.get(code[:2], float('nan')):.3f} ms)", flush=True)
        del first, args
        torch.cuda.empty_cache()
    return ok


def trace_shapes():
    """``--trace``: each variant once at its shape in code."""
    libs = library()
    rng = np.random.default_rng(13)
    sm = torch.from_numpy(np.where(np.eye(4, dtype=bool), 5, -4)
                          .astype(np.int32)).cuda()
    for with_dirs, affine, cell16 in variants():
        name, b, n, m, length, _ = main_path_shape(with_dirs)
        args = batch(rng, b, n, m, (length, length), "cuda", ragged=False)
        lib = libs[cell16]
        shape = bf.shape_in_code(lib, with_dirs, affine, m, b, cell16)[:2]
        launch, out = launcher(lib, shape, args, sm, "local", with_dirs,
                               affine, cell16, trace=True)
        ms = best_ms(launch, reps=1)
        t = launch.trace.view(launch.ctas, launch.warps,
                              bf.TRACE_WORDS).cpu().numpy().astype(np.int64)

        def signed(x):
            return (x + (1 << 31)) % (1 << 32) - (1 << 31)

        run = signed(t[:, :, 3] - t[:, :, 2]) / 1e6
        start = signed(t[:, :, 2] - t[:, :, 2].min()) / 1e6
        end = signed(t[:, :, 3] - t[:, :, 2].min()) / 1e6
        top, slot = t[:, :, 0], t[:, :, 1]
        print(f"K3_TRACE {variant_name(with_dirs, affine, cell16)} {name} "
              f"(warps {shape[0]}, block {shape[1]}, {launch.ctas} CTAs): "
              f"{ms:.3f} ms; a warp {run.min():.3f}-{run.max():.3f} ms "
              f"(mean {run.mean():.3f}); CTAs started over "
              f"{start[:, 0].max():.3f} ms and ended over "
              f"{end.max(axis=1).min():.3f}-{end.max():.3f} ms; sleeps "
              f"for the top row {top.sum()} (a warp {top.mean():.1f}, warp "
              f"0 {top[:, 0].mean():.1f}, the last warp "
              f"{top[:, -1].mean():.1f}), for a ring block {slot.sum()}",
              flush=True)
        del out, launch, args
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    return probe_main(argv, "interpair_shapes", library, check, time_shapes,
                      trace_shapes)


if __name__ == "__main__":
    sys.exit(main())
