"""K1 at every shape: over how many lanes a slot's rows are split, and
how many steps a lane runs an iteration, per rps and variant.

K1 (``csrc/wavefront.cu``) splits each slot's rps rows over SPLIT lanes
of its band (1, 2 or 4, dividing rps), runs SB steps (a block: 1, 2 or
4) each iteration, and keeps one shape per (rps, variant) in code
(``split_of``, ``block_of``).  This probe builds the same source with
``-DSA_WAVEFRONT_ALL_SHAPES`` into a library of its own, which exports
``sa_wavefront_strip_shape`` taking the shape as arguments, and

* ``--check``: holds every shape against the plain version on small
  strips, every variant (words, score-only with checkpoints, a left
  column with words), linear and affine, global, local and semi-global;
* ``--time``: times every shape at the main path's shapes (CUDA events,
  best of 2 after a warm launch), each shape's outputs bitwise equal to
  the first's, and prints the fastest per main-path shape;
* ``--trace``: runs K1 as the main path builds it (``kernel_launch``, the
  shape in code) once at each main-path shape and prints its trace from
  the scratch: the kernel's time, each band's time, when the last band
  ended after the first (the pipeline's fill), the ns an iteration, and
  the stream windows the bands loaded and found empty.

``python -m seqalign_torch.probes.wavefront_shapes [--check] [--time]
[--trace]`` (``--check --time`` without arguments); exits 1 without a
CUDA device or when a shape differs.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops import _build, layout
from ..ops import wavefront as wf
from ._shapes import (all_shapes_library, band_clocks, best_ms, same,
                      score_matrix)
from ._shapes import main as probe_main

SPLITS = (1, 2, 4)
BLOCKS = (1, 2, 4)
# Small strips held against the plain version: rps, slots, text letters.
CHECKS = ((16, 256, 300), (8, 128, 400), (4, 128, 500), (2, 128, 300),
          (1, 128, 300))
# The main path's shapes: name, rps, slots, text letters, pattern rows,
# variant ("words", "ckpt" with 32,768 columns a checkpoint, "left": a
# tile re-filled from a left column, with words), affine.
SHAPES = (
    ("full width, words", 16, 4096, 280_482, 48_632, "words", False),
    ("phase-1 strip", 16, 4096, 211_518, 65_536, "ckpt", False),
    ("tile", 16, 4096, 32_768, 65_536, "left", False),
    ("affine full width, words", 16, 4096, 280_482, 48_632, "words", True),
    ("affine phase-1 strip", 16, 4096, 211_518, 65_536, "ckpt", True),
    ("affine tile", 16, 4096, 32_768, 65_536, "left", True),
    ("rps 8 direct, words", 8, 4096, 60_000, 30_000, "words", False),
    ("rps 4 direct, words", 4, 4096, 60_000, 15_000, "words", False),
    ("rps 4 phase-1 strip", 4, 4096, 60_000, 16_384, "ckpt", False),
    ("rps 8 x 1024, words", 8, 1024, 20_000, 8_000, "words", False),
    ("rps 1 direct, words", 1, 4096, 60_000, 4_000, "words", False),
    ("rps 1 phase-1 strip", 1, 4096, 60_000, 4_096, "ckpt", False),
    ("rps 2 phase-1 strip", 2, 4096, 60_000, 8_192, "ckpt", False),
    ("affine rps 1 direct, words", 1, 4096, 60_000, 4_000, "words", True),
    ("rps 8 phase-1 strip", 8, 4096, 60_000, 32_768, "ckpt", False),
    ("rps 4 tile", 4, 4096, 32_768, 16_384, "left", False),
    ("rps 2 direct, words", 2, 4096, 60_000, 8_000, "words", False),
    ("affine rps 8 direct, words", 8, 4096, 60_000, 30_000, "words", True),
    ("affine rps 4 direct, words", 4, 4096, 60_000, 15_000, "words", True),
    ("affine rps 4 phase-1 strip", 4, 4096, 60_000, 16_384, "ckpt", True),
    ("affine rps 8 phase-1 strip", 8, 4096, 60_000, 32_768, "ckpt", True),
    ("affine rps 4 tile", 4, 4096, 32_768, 16_384, "left", True),
    ("affine rps 2 direct, words", 2, 4096, 60_000, 8_000, "words", True),
)
CKPT_COLS = 32_768


def library():
    """The all-shapes build of ``csrc/wavefront.cu``."""
    return all_shapes_library("wavefront", "SA_WAVEFRONT_ALL_SHAPES")


def strip(rng, rps, slots, n, m, variant, affine, mode, device):
    """Random inputs of one strip: (args, kwargs) of ``wavefront_strip``."""
    local, semi = mode == "local", mode == "semi"
    gap, ext = (8, 2) if affine else (5, 0)
    steps = layout.steps_padded(n, slots)
    ckpt = 0
    if variant == "ckpt":
        ckpt = CKPT_COLS if n > CKPT_COLS else 1 << (slots + 16).bit_length()
        steps = max(steps, -(-(ckpt + slots) // layout.STEPS) * layout.STEPS)
    text = np.zeros(steps, np.int32)
    text[:n] = rng.integers(0, 4, n)
    pat = np.zeros(rps * slots, np.int32)
    pat[:min(m, rps * slots)] = rng.integers(0, 4, min(m, rps * slots))
    i0 = rps * slots if variant == "left" else 0
    if variant == "left":
        bottom = torch.as_tensor(rng.integers(-400, 0, steps, dtype=np.int32))
    else:
        bottom = layout.top_row(steps, gap, local or semi, "cpu",
                                ext=ext if affine else None).reshape(-1)
    args = layout.from_reference_arrays(
        text.reshape(-1, layout.STEPS), bottom.reshape(-1, layout.STEPS),
        layout.pattern_slots(pat, rps, slots), score_matrix(), 4, device)
    kw = dict(local=local, semi=semi, rps=rps, slots=slots, ckpt_every=ckpt,
              with_dirs=not ckpt)
    if variant == "left":
        col = torch.as_tensor(np.cumsum(rng.integers(-6, 2, rps * slots + 1)),
                              dtype=torch.int32)
        kw["left_in"] = wf.make_left_input(col, rps, slots).to(device)
        if affine:
            col_e = col - torch.as_tensor(rng.integers(0, 9, col.numel()),
                                          dtype=torch.int32)
            kw["left_e"] = wf.make_left_input(col_e, rps, slots).to(device)
    if affine:
        kw.update(affine=True, ext=ext,
                  fbot_in=(torch.full_like(args[1], wf.NEG_HALF)
                           if variant != "left"
                           else (args[1] - 3).contiguous()))
    return (*args, gap, n, i0 + m, i0, 4), kw


def shapes(rps):
    """Every (split, block) the all-shapes library takes at ``rps``."""
    return [(split, block) for split in SPLITS for block in BLOCKS
            if rps % split == 0]


def launcher(lib, shape, args, kw):
    """(launch, outputs) of the all-shapes library at ``shape``."""
    ts, bot, pat, sm, gap, n, m, i0, k = args
    return wf.split_launch(
        lib, "sa_wavefront_strip_shape", shape, ts, bot, pat, sm, gap, n, m,
        i0, k, kw["local"], kw["rps"], kw["ckpt_every"], kw["slots"],
        kw["semi"], kw.get("left_in"), kw.get("affine", False),
        kw.get("ext", 0), kw.get("fbot_in"), kw.get("left_e"))


def check(lib) -> bool:
    ok = True
    rng = np.random.default_rng(8)
    for rps, slots, n in CHECKS:
        for variant in ("words", "ckpt", "left"):
            for affine in (False, True):
                for mode in ("global", "local", "semi"):
                    m = rps * slots - 2
                    nn = n if variant != "ckpt" else 2 * slots + 300
                    args, kw = strip(rng, rps, slots, nn, m, variant, affine,
                                     mode, "cuda")
                    want = wf.wavefront_strip_plain(*args, **kw)
                    for shape in shapes(rps):
                        launch, out = launcher(lib, shape, args, kw)
                        launch()
                        torch.cuda.synchronize()
                        good = same(out, want)
                        ok &= good
                        print(f"SHAPE_CHECK {variant} affine={int(affine)} "
                              f"{mode} rps={rps} slots={slots} "
                              f"split={shape[0]} block={shape[1]}: "
                              f"{'exact' if good else 'DIFFERS'}", flush=True)
    return ok


def time_shapes(lib) -> bool:
    ok = True
    rng = np.random.default_rng(9)
    for name, rps, slots, n, m, variant, affine in SHAPES:
        args, kw = strip(rng, rps, slots, n, m, variant, affine, "global",
                         "cuda")
        first, times = None, {}
        for shape in shapes(rps):
            launch, out = launcher(lib, shape, args, kw)
            best = best_ms(launch)
            sms = len(set(_build.launch_sms(launch)))
            if first is None:
                first, good = out, True
            else:
                good = same(out, first)
            ok &= good
            times[shape] = best
            print(f"SHAPE_TIME {name} (rps {rps} x {slots}, "
                  f"{args[0].numel()} steps) split={shape[0]} "
                  f"block={shape[1]}: {best:.3f} ms, "
                  f"{launch.ctas} CTAs on {sms} SMs"
                  f"{'' if good else ', DIFFERS from the first'}",
                  flush=True)
            del out, launch
        best = min(times, key=times.get)
        print(f"SHAPE_BEST {name}: split={best[0]} block={best[1]} "
              f"(in code: {in_code(rps, affine, kw['ckpt_every'])})",
              flush=True)
        del first
        torch.cuda.empty_cache()
    return ok


def trace_shapes():
    """``--trace``: one launch a shape through ``kernel_launch``."""
    rng = np.random.default_rng(10)
    for name, rps, slots, n, m, variant, affine in SHAPES:
        args, kw = strip(rng, rps, slots, n, m, variant, affine, "global",
                         "cuda")
        ts, bot, pat, sm, gap, n_, m_, i0, k = args
        launch, out = wf.kernel_launch(
            ts, bot, pat, sm, gap, n_, m_, i0, k, kw["local"], rps,
            kw["ckpt_every"], slots, kw["semi"], kw.get("left_in"),
            affine=affine, ext=kw.get("ext", 0), fbot_in=kw.get("fbot_in"),
            left_e=kw.get("left_e"))
        ms = best_ms(launch, reps=1)
        split, block = in_code(rps, affine, kw["ckpt_every"])
        bands = slots * split // 32
        steps = ts.numel()
        iters = steps // block + (
            (32 // split - 1) * (split - 1) + split - 1 if block == 1 else 31)
        c, run, lag, _ = band_clocks(launch, wf.SCRATCH_COUNTERS,
                                     wf.BAND_START, wf.BAND_END, bands)
        print(f"K1_TRACE {name} (rps {rps} x {slots}, {steps} steps, split "
              f"{split}, block {block}, {bands} bands): {ms:.3f} ms; a band "
              f"{run.min() / 1e6:.3f}-{run.max() / 1e6:.3f} ms, "
              f"{run.mean() / iters:.1f} ns an iteration; the last band "
              f"ended {lag[-1] / 1e6:.3f} ms after the first "
              f"({lag[-1] / max(bands - 1, 1):.0f} ns a band); stream "
              f"windows loaded {c[1]} ({c[1] / max(bands - 1, 1):.0f} a "
              f"band, {steps / max(c[1] / max(bands - 1, 1), 1):.1f} "
              f"entries a load), found empty {c[2]}", flush=True)
        del out, launch
        torch.cuda.empty_cache()


def in_code(rps, affine, ckpt_every):
    """(split, block) K1 takes for this rps and variant."""
    lib = _build.library("wavefront")
    return (lib.sa_wavefront_split(rps, int(affine), ckpt_every),
            lib.sa_wavefront_block(rps, int(affine), ckpt_every))


def main(argv=None) -> int:
    return probe_main(argv, "wavefront_shapes", library, check, time_shapes,
                      trace_shapes)


if __name__ == "__main__":
    sys.exit(main())
