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

* ``--sass``: counts, from ``cuobjdump -sass`` of the main build, the
  instructions of the main path's instances' iteration loop
  (``K1_SASS`` lines: the loop's instructions, those a started block
  runs in the common case and per cell, and the loop's DPX and integer
  max instructions).

``python -m seqalign_torch.probes.wavefront_shapes [--check] [--time]
[--trace] [--sass]`` (``--check --time`` without arguments); exits 1
without a CUDA device or when a shape differs.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys

import numpy as np
import torch

from ..ops import _build, layout
from ..ops import wavefront as wf
from ._shapes import (all_shapes_library, band_clocks, best_ms, same,
                      score_matrix)
from ._shapes import main as probe_main
from .dpx16 import loop_code

SPLITS = (1, 2, 4)
BLOCKS = (1, 2, 4)
# Small strips held against the plain version: rps, slots, text letters.
CHECKS = ((16, 256, 300), (8, 128, 400), (4, 128, 500), (2, 128, 300),
          (1, 128, 300))
# The main path's shapes: name, rps, slots, text letters, pattern rows,
# variant ("words", "ckpt" with 32,768 columns a checkpoint, "left": a
# tile re-filled from a left column, with words), affine, mode.
SHAPES = (
    ("full width, words", 16, 4096, 280_482, 48_632, "words", False, "global"),
    ("phase-1 strip", 16, 4096, 211_518, 65_536, "ckpt", False, "global"),
    ("tile", 16, 4096, 32_768, 65_536, "left", False, "global"),
    ("affine full width, words", 16, 4096, 280_482, 48_632, "words",
     True, "global"),
    ("affine phase-1 strip", 16, 4096, 211_518, 65_536, "ckpt",
     True, "global"),
    ("affine tile", 16, 4096, 32_768, 65_536, "left", True, "global"),
    ("rps 8 direct, words", 8, 4096, 60_000, 30_000, "words", False, "global"),
    ("rps 4 direct, words", 4, 4096, 60_000, 15_000, "words", False, "global"),
    ("rps 4 phase-1 strip", 4, 4096, 60_000, 16_384, "ckpt", False, "global"),
    ("rps 8 x 1024, words", 8, 1024, 20_000, 8_000, "words", False, "global"),
    ("rps 1 direct, words", 1, 4096, 60_000, 4_000, "words", False, "global"),
    ("rps 1 phase-1 strip", 1, 4096, 60_000, 4_096, "ckpt", False, "global"),
    ("rps 2 phase-1 strip", 2, 4096, 60_000, 8_192, "ckpt", False, "global"),
    ("affine rps 1 direct, words", 1, 4096, 60_000, 4_000, "words",
     True, "global"),
    ("rps 8 phase-1 strip", 8, 4096, 60_000, 32_768, "ckpt", False, "global"),
    ("rps 4 tile", 4, 4096, 32_768, 16_384, "left", False, "global"),
    ("rps 2 direct, words", 2, 4096, 60_000, 8_000, "words", False, "global"),
    ("affine rps 8 direct, words", 8, 4096, 60_000, 30_000, "words",
     True, "global"),
    ("affine rps 4 direct, words", 4, 4096, 60_000, 15_000, "words",
     True, "global"),
    ("affine rps 4 phase-1 strip", 4, 4096, 60_000, 16_384, "ckpt",
     True, "global"),
    ("affine rps 8 phase-1 strip", 8, 4096, 60_000, 32_768, "ckpt",
     True, "global"),
    ("affine rps 4 tile", 4, 4096, 32_768, 16_384, "left", True, "global"),
    ("affine rps 2 direct, words", 2, 4096, 60_000, 8_000, "words",
     True, "global"),
    ("genome.direct 8,192", 4, 4096, 211_518, 8_192, "words", False, "local"),
    ("genome.direct 16,384", 4, 4096, 211_518, 16_384, "words",
     False, "local"),
    ("genome.direct 32,768", 8, 4096, 211_518, 32_768, "words",
     False, "local"),
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
    for name, rps, slots, n, m, variant, affine, mode in SHAPES:
        args, kw = strip(rng, rps, slots, n, m, variant, affine, mode,
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
        code = in_code(rps, affine, kw["ckpt_every"], kw["local"],
                       variant == "left")
        print(f"SHAPE_BEST {name}: split={best[0]} block={best[1]} "
              f"(in code: {code})", flush=True)
        del first
        torch.cuda.empty_cache()
    return ok


def trace_shapes():
    """``--trace``: one launch a shape through ``kernel_launch``."""
    rng = np.random.default_rng(10)
    for name, rps, slots, n, m, variant, affine, mode in SHAPES:
        args, kw = strip(rng, rps, slots, n, m, variant, affine, mode,
                         "cuda")
        ts, bot, pat, sm, gap, n_, m_, i0, k = args
        launch, out = wf.kernel_launch(
            ts, bot, pat, sm, gap, n_, m_, i0, k, kw["local"], rps,
            kw["ckpt_every"], slots, kw["semi"], kw.get("left_in"),
            affine=affine, ext=kw.get("ext", 0), fbot_in=kw.get("fbot_in"),
            left_e=kw.get("left_e"))
        ms = best_ms(launch, reps=1)
        split, block = in_code(rps, affine, kw["ckpt_every"], kw["local"],
                               variant == "left")
        bands = slots * split // 32
        steps = ts.numel()
        iters = steps // block + (
            (32 // split - 1) * (split - 1) + split - 1 if block == 1 else 31)
        c, run, lag, _ = band_clocks(launch, wf.SCRATCH_COUNTERS,
                                     wf.BAND_START, wf.BAND_END, bands)
        started, general = (int(x) for x in launch.scratch[
            wf.STARTED_BLOCKS // 2:wf.GENERAL_BLOCKS // 2 + 1].cpu())
        print(f"K1_TRACE {name} (rps {rps} x {slots}, {steps} steps, split "
              f"{split}, block {block}, {bands} bands): {ms:.3f} ms; a band "
              f"{run.min() / 1e6:.3f}-{run.max() / 1e6:.3f} ms, "
              f"{run.mean() / iters:.1f} ns an iteration; the last band "
              f"ended {lag[-1] / 1e6:.3f} ms after the first "
              f"({lag[-1] / max(bands - 1, 1):.0f} ns a band); stream "
              f"windows loaded {c[1]} ({c[1] / max(bands - 1, 1):.0f} a "
              f"band, {steps / max(c[1] / max(bands - 1, 1), 1):.1f} "
              f"entries a load), found empty {c[2]}; blocks on the started "
              f"path {started}, on the general path {general} "
              f"({100 * general / max(started + general, 1):.2f} %)",
              flush=True)
        del out, launch
        torch.cuda.empty_cache()


def in_code(rps, affine, ckpt_every, local=False, left=False):
    """(split, block) K1 takes for this rps and variant."""
    lib = _build.library("wavefront")
    args = (rps, int(affine), ckpt_every, int(local), int(left))
    return lib.sa_wavefront_split(*args), lib.sa_wavefront_block(*args)


# The main path's instances, as --sass names them: rps, mode (0 global,
# 1 local), words, from a left column.
SASS_INSTANCES = {
    (16, 0, False, False): "rps 16 score-only global (phase-1 strips)",
    (16, 0, True, True): "rps 16 words global from a left column (tiles)",
    (16, 0, True, False): "rps 16 words global (full width)",
    (4, 1, True, False): "rps 4 words local (genome.direct)",
    (8, 1, True, False): "rps 8 words local (genome.direct)",
}
_FUNCTION = re.compile(r"Function : (\S+)")
_KERNEL = re.compile(r"wavefront_strip_kernelILi(\d+)ELi(\d+)ELi(\d+)"
                     r"EL[ib](\d)ELb(\d)ELb(\d)E")
_DPX = ("VIADDMNMX", "VIMNMX", "VIMNMX3", "VIBMAX")


def sass_instances(path):
    """{(rps, split, block, mode, dirs): ``loop_code`` of its iteration
    loop} of the linear instances in ``cuobjdump -sass`` of the library
    at ``path``."""
    tool = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", path], check=True,
                          capture_output=True, text=True).stdout
    parts = _FUNCTION.split(text)
    found = {}
    for name, body in zip(parts[1::2], parts[2::2]):
        k = _KERNEL.search(name)
        if k and k[6] == "0":
            found[tuple(int(x) for x in k.groups()[:5])] = loop_code(body)
    return found


def common_walk(code, lo, hi):
    """The instructions from address ``lo`` up to ``hi`` when every forward
    branch between them is taken, as in a block's common case (a branch
    skips what runs only at a word's end, at a checkpoint, in lane 31)."""
    index = {x[0]: i for i, x in enumerate(code)}
    i, out = index[lo], []
    while i < len(code) and code[i][0] < hi:
        out.append(code[i])
        target = code[i][3]
        i = (index[target] if target is not None and
             code[i][0] < target <= hi and target in index else i + 1)
    return out


def started_block(code):
    """The instructions a lane's started block runs in the common case:
    the block's code (the widest predicated forward branch skips it when
    the lane has no block) with, at the if/else of the two paths (the
    widest predicated branch over an arm that ends in a branch past it),
    the shorter arm, the started path."""
    index = {x[0]: i for i, x in enumerate(code)}
    branches = [x for x in code if x[1] and x[3] is not None
                and x[3] > x[0] and x[3] in index]
    skip = max(branches, key=lambda x: x[3] - x[0])
    arms = None
    for at, _, _, target in branches:
        last = code[index[target] - 1]
        if (last[2] == "BRA" and not last[1] and last[3] is not None
                and last[3] > target and (arms is None or
                                          target - at > arms[1] - arms[0])):
            arms = (at, target, last[3])
    after = code[index[arms[0]] + 1][0]
    return (common_walk(code, code[index[skip[0]] + 1][0], after)
            + min(common_walk(code, after, arms[1]),
                  common_walk(code, arms[1], arms[2]), key=len)
            + common_walk(code, arms[2], skip[3]))


def sass_report(path=None):
    """``K1_SASS`` lines for the main path's instances at their shapes in
    code."""
    found = sass_instances(path or _build.build("wavefront"))
    lines = []
    for (rps, mode, dirs, left), what in SASS_INSTANCES.items():
        split, block = in_code(rps, False, 0 if dirs else 1 << 20, mode,
                               left)
        loop = found[rps, split, block, mode, int(dirs)]
        started = started_block(loop)
        cells = rps // split * block
        ops = [x[2].split(".")[0] for x in loop]
        lines.append(
            f"K1_SASS {what}, split {split} x block {block} ({cells} cells "
            f"a block): loop {len(loop)} instructions; a started block "
            f"{len(started)}, {len(started) / cells:.2f} a cell; "
            + ", ".join(f"{op} {ops.count(op)}" for op in _DPX))
    return lines


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if "--sass" in argv:
        for line in sass_report():
            print(line, flush=True)
        argv = [a for a in argv if a != "--sass"]
        if not argv:
            return 0
    return probe_main(argv, "wavefront_shapes", library, check, time_shapes,
                      trace_shapes)


if __name__ == "__main__":
    sys.exit(main())
