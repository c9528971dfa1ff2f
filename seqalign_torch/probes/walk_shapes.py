"""K2 at every window shape: how many slots and word groups a window of
the skewed words holds.

K2 (``csrc/walk.cu``) walks from windows of S slots x G word groups
staged in shared memory, and keeps one shape per rps and variant in code
(``window_slots``, ``window_groups``; ``ops/walk.window_shape``).  This
probe builds the same source with ``-DSA_WALK_ALL_SHAPES`` into a library
of its own, which exports ``sa_walk_skewed_shape`` taking the shape (and
a trace buffer) as arguments, and

* ``--check``: holds every shape of the build against
  ``walk_skewed_window_plain``: linear and affine, global, local and
  semi-global, from each gap state, tiles with row_lo and col_lo > 0, a
  move buffer that ends mid-path, at rps 1, 2, 4, 8 and 16, on words made
  from a numpy seed; and all-LEFT, all-TOP, all-DIAG and zig-zag paths.
  The least shape (8 slots x 2 groups) makes a walk cross dozens of
  windows;
* ``--time``: times every rps-16 shape of each variant at the main
  path's shapes (CUDA events, best of 2 after a warm launch), each
  shape's outputs bitwise equal to the first's, and prints the fastest;
* ``--trace``: runs the production shape at the main path's shapes with
  the walker's trace: windows loaded, waits at a window's edge and their
  ns, misses, polls that found a load still running, switches on a poll,
  moves a window and ns a move.

The main path's shapes: phase 5's full-width words (NC_045839 x
GCA_003434045, 48,632 x 280,482, rps 16 x 4,096 slots) walked from the
last cell; an interior path tile of phase 12's long pair (AbHV_ORF111 x
mutated, the checkpoint engine's tile (1, 2)) walked from its middle;
phase 15's affine words of both (open 8, extend 2).  A shape's total
weighs each walk by its launches in one run of the workloads: the
full-width walk once, a tile 10 times.

``python -m seqalign_torch.probes.walk_shapes [--check] [--time]
[--trace]`` (``--check --time`` without arguments); exits 1 without a
CUDA device or when a shape differs.  ``chip_smoke.py`` runs
``check_walks`` at the least shape.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..cli import parse_arguments
from ..ops import checkpoint, direct, layout, wavefront
from ..ops import walk
from ..types import Request
from ._shapes import all_shapes_library, best_ms
from ._shapes import main as probe_main

LEFT, DIAG, TOP, STOP = 0, 1, 2, 3
SMALLEST = (8, 2)
# The all-shapes build's windows (csrc/walk.cu's SA_WALK_*_SHAPES): the
# least and the production shape at every rps, more at rps 16.
SHAPES = {
    affine: {rps: [SMALLEST, walk.window_shape(rps, affine)]
             for rps in walk.WINDOW_SHAPES}
    for affine in (False, True)
}
SHAPES[False][16] += [(8, 32), (8, 128), (16, 16), (16, 64), (32, 16)]
SHAPES[True][16] += [(8, 32), (8, 64), (16, 16), (32, 16)]
TRACE_WORDS = 9
FULL_WIDTH = ["data/dna/NC_045839.txt", "data/dna/GCA_003434045.txt"]
LONG_PAIR = ["data/dna/AbHV_ORF111.txt", "data/dna/mutated_AbHV_ORF111.txt"]
AFFINE = ["--gap-penalty", "8", "--gap-extend", "2"]
# --check: slots of the words, columns, rows at most.
CHECK_SLOTS, CHECK_COLS, CHECK_ROWS = 512, 2500, 3000


def library():
    """The all-shapes build of ``csrc/walk.cu``."""
    return all_shapes_library("walk", "SA_WALK_ALL_SHAPES")


def pack_words_skewed(dirs, rps: int, slots: int) -> np.ndarray:
    """K1's skewed words of a (rows+1, cols+1) direction matrix (its row
    0 and column 0 ignored): (steps_pad/16 * rps, slots/128, 128) int32,
    cell (i, j) at bits 2*(t%16) of word (t/16)*rps + r, column s, where
    s, r = divmod(i-1, rps) and t = j-1+s."""
    m, p = dirs.shape[0] - 1, dirs.shape[1] - 1
    groups = -(-(p + slots - 1) // 16)
    i = np.arange(m)
    slot = i // rps
    by_step = np.zeros((m, groups * 16), np.uint64)
    by_step[i[:, None], slot[:, None] + np.arange(p)[None, :]] = dirs[1:, 1:]
    packed = (by_step.reshape(m, groups, 16)
              << (2 * np.arange(16, dtype=np.uint64))).sum(axis=2)
    words = np.zeros((groups, rps, slots), np.uint64)
    words[:, i % rps, slot] = packed.T
    return (words.astype(np.uint32).view(np.int32)
            .reshape(groups * rps, slots // 128, 128))


def path_dirs(kind, rows, cols, rng):
    """Directions that make one path shape: random (LEFT, DIAG, TOP),
    random with a STOP one cell in 400 ("stops"), all LEFT, all TOP, all
    DIAG, or a zig-zag of LEFT and TOP runs of 1-40 moves."""
    shape = (rows + 1, cols + 1)
    if kind in ("random", "stops"):
        dirs = rng.integers(0, 3, shape).astype(np.uint8)
        if kind == "stops":
            dirs[rng.random(shape) < 1 / 400] = STOP
        return dirs
    if kind == "zigzag":
        edges = np.cumsum(rng.integers(1, 41, rows + cols + 2))
        band = np.searchsorted(edges, np.add.outer(np.arange(rows + 1),
                                                   np.arange(cols + 1)))
        return np.where(band % 2, TOP, LEFT).astype(np.uint8)
    return np.full(shape, {"left": LEFT, "top": TOP, "diag": DIAG}[kind],
                   np.uint8)


def check_cases(rps, rng):
    """(name, words, words2, walk arguments) of --check at this rps."""
    rows = min(rps * CHECK_SLOTS, CHECK_ROWS)
    cols = CHECK_COLS

    def words_of(kind):
        return torch.from_numpy(pack_words_skewed(
            path_dirs(kind, rows, cols, rng), rps, CHECK_SLOTS)).cuda()

    words, stops = words_of("random"), words_of("stops")
    bits = torch.from_numpy(pack_words_skewed(
        rng.integers(0, 4, (rows + 1, cols + 1)).astype(np.uint8), rps,
        CHECK_SLOTS)).cuda()
    full = rows + cols + 1
    lo_r, lo_c = 4096, 9000  # a tile's first row and column less one
    cases = [
        ("global", words, None, (0, 0, rows, cols, False, full, 0)),
        ("semi", words, None, (0, 0, rows, 2 * cols // 3, False, full, 0)),
        ("local", stops, None, (0, 0, rows - 7, cols - 5, True, full, 0)),
        ("tile", words, None, (lo_r, lo_c, lo_r + rows - 1, lo_c + cols - 3,
                               False, full, 0)),
        ("local tile", stops, None, (lo_r, lo_c, lo_r + rows, lo_c + cols,
                                     True, full, 0)),
        ("buffer end", words, None, (0, 0, rows, cols, False, 1000, 0)),
    ] + [
        (f"affine from state {st}", words, bits,
         (0, 0, rows, cols, False, full, st)) for st in (0, 1, 2)
    ] + [
        ("affine local", stops, bits, (0, 0, rows - 3, cols, True, full, 0)),
        ("affine tile", words, bits, (lo_r, lo_c, lo_r + rows - 2,
                                      lo_c + cols, False, full, 1)),
        ("affine buffer end", words, bits, (0, 0, rows, cols, False, 777, 2)),
    ]
    if rps in (1, 16):
        for kind in ("left", "top", "diag", "zigzag"):
            cases.append((f"all {kind}" if kind != "zigzag" else kind,
                          words_of(kind), None,
                          (0, 0, rows, cols, False, full, 0)))
    return cases


def launcher(lib, shape, rps, words, words2, args, trace=None):
    row_lo, col_lo, i0, j0, local, max_moves, state0 = args
    return walk.shape_launch(lib, shape, words, rps, row_lo, col_lo, i0, j0,
                             local, max_moves, words2, state0, trace)


def plain(rps, words, words2, args):
    row_lo, col_lo, i0, j0, local, max_moves, state0 = args
    return walk.walk_skewed_window_plain(words, rps, row_lo, col_lo, i0, j0,
                                         local, max_moves, words2, state0)


def same_walk(got, want):
    """Equal results and equal moves up to the count."""
    (mv, res), (mv_w, res_w) = got, want
    count = int(res_w[0])
    used = -(-count // 16)
    return (torch.equal(res.cpu(), res_w.cpu())
            and torch.equal(mv[:used].cpu(), mv_w[:used].cpu()))


def check_walks(lib, smallest_only=False, affine=None):
    """Every shape (``smallest_only``: the least) against the plain walk
    in every case of ``check_cases`` (``affine`` True or False: that
    variant's alone).  Returns [(rps, case, shape, moves, exact)]."""
    rows = []
    rng = np.random.default_rng(10)
    for rps in walk.WINDOW_SHAPES:
        for name, words, words2, args in check_cases(rps, rng):
            variant = words2 is not None
            if affine is not None and variant != affine:
                continue
            want = plain(rps, words, words2, args)
            for shape in ([SMALLEST] if smallest_only
                          else SHAPES[variant][rps]):
                launch, out = launcher(lib, shape, rps, words, words2, args)
                launch()
                torch.cuda.synchronize()
                rows.append((rps, name, shape, int(want[1][0]),
                             same_walk(out, want)))
        torch.cuda.empty_cache()
    return rows


def check(lib) -> bool:
    """``check_walks`` at every shape, a line a case and shape."""
    rows = check_walks(lib)
    for rps, name, shape, moves, good in rows:
        print(f"WALK_CHECK rps={rps} {name} window={shape[0]}x{shape[1]}: "
              f"{moves} moves {'exact' if good else 'DIFFERS'}", flush=True)
    return all(good for *_, good in rows)


def read_pair(argv):
    request = Request()
    assert parse_arguments(["alignSequence", "-g", *argv], request) == 0
    text = np.asarray(request.text, dtype=np.int32)
    pattern = np.asarray(request.pattern, dtype=np.int32)
    sm = layout.pack_score_matrix(request.score_matrix,
                                  request.alphabet_size)
    return request, text, pattern, sm


def full_width_words(affine):
    """Phase 5's (or, affine, phase 15's) words of the full-width pair on
    the card, and the walk's arguments from its last cell."""
    request, text, pattern, sm = read_pair([*AFFINE, *FULL_WIDTH] if affine
                                           else FULL_WIDTH)
    n, m, k = len(text), len(pattern), request.alphabet_size
    rps, slots = direct._direct_geometry(m)
    ts, pat, sm_dev = direct.strip_inputs(text, pattern, sm, k, rps, slots,
                                          "cuda")
    ext = request.gap_extend if affine else None
    bottom = layout.top_row(ts.numel(), request.gap_penalty, False, "cuda",
                            ext=ext)
    outs = wavefront.wavefront_strip(
        ts, bottom, pat, sm_dev, request.gap_penalty, n, m, 0, k_alpha=k,
        rps=rps, slots=slots, affine=affine, ext=ext or 0,
        fbot_in=(torch.full_like(bottom, wavefront.NEG_HALF) if affine
                 else None))
    words, words2 = outs[0], outs[6] if affine else None
    del outs
    torch.cuda.synchronize()
    return (f"{'affine ' if affine else ''}full width {m} x {n}", rps, words,
            words2, (0, 0, m, n, False, -(-(n + m + 1) // 16) * 16, 0))


def tile_words(affine):
    """Phase 12's (or, affine, phase 15's) interior path tile (1, 2) of
    the long pair, re-filled from its checkpoints, and the walk's
    arguments from its middle."""
    request, text, pattern, _ = read_pair([*AFFINE, *LONG_PAIR] if affine
                                          else LONG_PAIR)
    k = request.alphabet_size
    ck = checkpoint.checkpointed_fill(
        text, pattern, request.score_matrix, k, request.gap_penalty,
        gap_extend=request.gap_extend if affine else None)
    tiles = checkpoint.Tiles(ck, text, pattern, request.score_matrix, k)
    b, c = 1, 2
    args, kwargs = tiles.strip_args(b, c)
    outs = wavefront.wavefront_strip(*args, **kwargs)
    words, words2 = outs[0], outs[6] if affine else None
    rows, cols = tiles.rps * tiles.slots, tiles.cols
    del ck, tiles, outs
    torch.cuda.synchronize()
    return (f"{'affine ' if affine else ''}long-pair tile ({b}, {c}), "
            f"{rows} x {cols}", 16, words, words2,
            (b * rows, c * cols, b * rows + rows // 2, c * cols + cols // 2,
             False, rows + cols + 1, 0))


# K2's launches at each main-path walk in one run of each workload
# (chip_smoke.py's workload_ledger): the full-width walk once, a path
# tile 10 times (the long pair's path crosses 10 tiles).
WEIGHTS = {"full width": 1, "tile": 10}


def main_path_shapes():
    """The four main-path walks, one at a time (the words of each are
    several GB): (name, rps, words, words2, walk arguments, weight)."""
    for affine in (False, True):
        yield (*full_width_words(affine), WEIGHTS["full width"])
        torch.cuda.empty_cache()
        yield (*tile_words(affine), WEIGHTS["tile"])
        torch.cuda.empty_cache()


def time_shapes(lib) -> bool:
    """Times every rps-16 shape of each variant at the main path's walks;
    prints each and the fastest, and per variant each shape's time
    weighted by the walks' launches in one run of the workloads and the
    least: the rule ``window_shape`` follows."""
    ok = True
    totals = {False: {}, True: {}}
    for name, rps, words, words2, args, weight in main_path_shapes():
        affine = words2 is not None
        first, times = None, {}
        for shape in SHAPES[affine][rps]:
            launch, out = launcher(lib, shape, rps, words, words2, args)
            ms = best_ms(launch)
            if first is None:
                first, good = out, True
            else:
                good = same_walk(out, first)
            ok &= good
            times[shape] = ms
            totals[affine][shape] = totals[affine].get(shape, 0) + weight * ms
            moves = int(out[1][0])
            print(f"WALK_TIME {name} window={shape[0]}x{shape[1]}: {ms:.3f} "
                  f"ms, {moves} moves, {ms * 1e6 / max(moves, 1):.1f} ns a "
                  f"move{'' if good else ', DIFFERS from the first'}",
                  flush=True)
        best = min(times, key=times.get)
        print(f"WALK_BEST {name}: window={best[0]}x{best[1]} "
              f"{times[best]:.3f} ms (in code: "
              f"{walk.window_shape(rps, affine)})", flush=True)
        del words, words2, first
    for affine, total in totals.items():
        variant = "affine" if affine else "linear"
        for shape, ms in total.items():
            print(f"WALK_TOTAL {variant} window={shape[0]}x{shape[1]}: "
                  f"{ms:.3f} ms", flush=True)
        best = min(total, key=total.get)
        print(f"WALK_CHOICE {variant}: window={best[0]}x{best[1]} "
              f"{total[best]:.3f} ms (in code: "
              f"{walk.window_shape(16, affine)})", flush=True)
    return ok


def trace_shapes():
    """``--trace``: the production shape at the main path's walks, with
    the walker's trace."""
    lib = library()
    for name, rps, words, words2, args, _ in main_path_shapes():
        shape = walk.window_shape(rps, words2 is not None)
        trace = torch.zeros(TRACE_WORDS, dtype=torch.int64, device="cuda")
        launch, out = launcher(lib, shape, rps, words, words2, args, trace)
        ms = best_ms(launch, reps=1)
        loads, waits, wait_ns, misses, polls, early, first_ns, walker_ns, \
            moves = trace.tolist()
        entered = max(loads - misses, 1)
        print(f"K2_TRACE {name} (window {shape[0]} x {shape[1]}): {ms:.3f} "
              f"ms, {moves} moves, {walker_ns / max(moves, 1):.1f} ns a move "
              f"on the walker's clock ({walker_ns / 1e6:.3f} ms); windows "
              f"loaded {loads} ({moves / entered:.0f} moves a window), the "
              f"first in {first_ns} ns; switches on a poll {early}, polls "
              f"that found the load running {polls}; waits at a window's "
              f"edge {waits}, misses {misses}, {wait_ns} ns waiting in all",
              flush=True)
        del words, words2, out
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    return probe_main(argv, "walk_shapes", library, check, time_shapes,
                      trace_shapes)


if __name__ == "__main__":
    sys.exit(main())
