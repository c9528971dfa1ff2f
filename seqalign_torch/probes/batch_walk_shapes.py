"""K4 at every shape: the batch walk's run and block, the single-pair
walk's window.

K4 (``csrc/batch_walk.cu``) keeps its shapes in code: the batch walk's
run of column words a lane (``kRun``) and most threads a block, the
single-pair walk's window of word rows x columns (``kWinRows``,
``kWinCols``; ``ops/batch_traceback.RUN``, ``BATCH_THREADS``,
``PACKED_WINDOW``).  This probe builds the same source with
``-DSA_BATCH_WALK_ALL_SHAPES`` into a library of its own, which exports
``sa_batch_walk_shape`` and ``sa_walk_packed_shape`` taking the shape
(and a trace buffer) as arguments, and

* ``--check``: holds every shape against the plain walks
  (``batch_walk_plain``, ``walk_packed``'s plain version): global, local
  and semi-global, linear and affine, padding pairs, starts outside the
  words, 64-move buffers, paths that cross every word row, all-LEFT and
  all-TOP runs, on words K3 filled and words packed from a numpy seed;
  the single-pair walk's refusal of words whose P is not a multiple of 4
  or that are not 16-byte aligned (the wrapper's ValueError, the entry
  point's cudaErrorInvalidValue).  The production build, and every run and window
  of the probe's, the batch walk with the production block and 32
  threads; the least run (1) and window (2 x 8) make every column a wait
  or a window's edge;
* ``--time``: times every shape at the main path's walks (CUDA events,
  best of 2 after a warm launch), each shape's outputs bitwise equal to
  the first's, and prints the least total: the batch walk on one
  16,384-pair chunk of 256 x 256 local DNA pairs (``chip_smoke.py``
  phase 9's, seed 9; linear, and affine at open 8 extend 2, phase 22's),
  weighed by the 4 chunks of each workload; the single-pair walk on the
  strip engine's words of the full-width pair (phase 18's, NC_045839 x
  GCA_003434045, global, from (m, n));
* ``--trace``: runs the production shapes there (the batch walk also at
  run 16) with the walks' own trace: the batch walk's copies, restarts,
  lane iterations spent waiting for a head, warp iterations, ns an
  iteration and the part of it in the wait for copies; the
  single-pair walk's windows loaded, waits, misses, polls, crossings
  into a word row below, steps and ns a step.

``python -m seqalign_torch.probes.batch_walk_shapes [--check] [--time]
[--trace]`` (``--check --time`` without arguments); exits 1 without a
CUDA device or when a shape differs.  ``chip_smoke.py`` runs
``check_batch`` and ``check_packed`` at the least shapes.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..cli import parse_arguments
from ..ops import batch_fill, batch_traceback, layout, tiled
from ..ops._build import library as library_of
from ..types import Request
from ._shapes import all_shapes_library, best_ms
from ._shapes import main as probe_main

LEFT, DIAG, TOP, STOP = 0, 1, 2, 3
# The all-shapes build's shapes (csrc/batch_walk.cu's SA_BATCH_WALK_RUNS
# and SA_PACKED_WALK_WINDOWS); threads 0 is the production rule.
RUNS = (1, 2, 4, 8, 16, 32)
THREADS = (0, 32, 64, 128)
WINDOWS = ((2, 8), (2, 8192), (4, 4096), (8, 2048), (16, 1024), (32, 512),
           (64, 256), (8, 1024), (16, 512))
LEAST_RUN, LEAST_WINDOW = 1, (2, 8)
BATCH_TRACE, PACKED_TRACE = 9, 11
FULL_WIDTH = ["data/dna/NC_045839.txt", "data/dna/GCA_003434045.txt"]
# chip_smoke.py's phase 9 workload: pairs, length, seed; one chunk of it.
ALIGN_WIDTH, CHUNK = (65536, 256, 9), 16384
CHUNKS = ALIGN_WIDTH[0] // CHUNK
DNA_5_4 = np.where(np.eye(4, dtype=bool), 5, -4).astype(np.int32)
BATCH_AFFINE = (8, 2)


def library():
    """The all-shapes build of ``csrc/batch_walk.cu``."""
    return all_shapes_library("batch_walk", "SA_BATCH_WALK_ALL_SHAPES")


def path_cells(kind, shape, rng, local):
    """Directions (…, rows+1, cols+1) of one path shape: random (LEFT,
    DIAG, TOP; local also STOP one cell in 300), all LEFT, all TOP, all
    DIAG, or a zig-zag of LEFT and TOP runs of 1-40 moves."""
    if kind == "random":
        cells = rng.integers(0, 3, shape).astype(np.uint8)
        if local:
            cells[rng.random(shape) < 1 / 300] = STOP
        return cells
    if kind == "zigzag":
        rows, cols = shape[-2], shape[-1]
        edges = np.cumsum(rng.integers(1, 41, rows + cols + 2))
        band = np.searchsorted(edges, np.add.outer(np.arange(rows),
                                                   np.arange(cols)))
        return np.broadcast_to(np.where(band % 2, TOP, LEFT),
                               shape).astype(np.uint8)
    return np.full(shape, {"left": LEFT, "top": TOP, "diag": DIAG}[kind],
                   np.uint8)


def pack_packed_words(cells) -> np.ndarray:
    """The strip engine's (W, P) words of a (rows+1, cols+1) direction
    matrix (its row 0 and column 0 ignored): cell (i, j) at bits
    2*((i-1)%16) of word ((i-1)//16, j-1)."""
    m, p = cells.shape[0] - 1, cells.shape[1] - 1
    rows = -(-m // 16) * 16
    body = np.zeros((rows, p), np.uint64)
    body[:m] = cells[1:, 1:]
    words = (body.reshape(rows // 16, 16, p)
             << (2 * np.arange(16, dtype=np.uint64))[None, :, None]).sum(1)
    return words.astype(np.uint32).view(np.int32)


def pack_batch_words(cells, tile_pairs) -> np.ndarray:
    """K3's words of (B, rows+1, cols+1) direction matrices: (B/tile_pairs,
    rows_pad/16, cols, tile_pairs/128, 128) int32, pair p's cell (i, j) at
    bits 2*((i-1)%16) of word (p//tile_pairs, (i-1)//16, j-1,
    p%tile_pairs)."""
    b = cells.shape[0]
    words = np.stack([pack_packed_words(c) for c in cells])  # (B, W, P)
    w, p = words.shape[1:]
    return np.ascontiguousarray(
        words.reshape(b // tile_pairs, tile_pairs, w, p)
        .transpose(0, 2, 3, 1)
        .reshape(b // tile_pairs, w, p, tile_pairs // 128, 128))


def batch_cases(rng, device="cuda"):
    """(name, dirs, dirs2, ns, ms, bis, bjs, local, semi, max_len) of the
    batch walk's check: K3-filled ragged batches in the three modes,
    linear and affine; synthetic words with random, all-LEFT, all-TOP,
    all-DIAG and zig-zag paths; starts outside the words; 64-move
    buffers."""
    cases = []
    b, n, m = 256, 200, 160
    sm = torch.from_numpy(DNA_5_4).to(device)
    for mode in ("global", "local", "semi"):
        local, semi = mode == "local", mode == "semi"
        for ext in (None, 2):
            texts = torch.from_numpy(rng.integers(0, 4, (b, n))
                                     .astype(np.int8)).to(device)
            patterns = torch.from_numpy(rng.integers(0, 4, (b, m))
                                        .astype(np.int8)).to(device)
            ns = rng.integers(1, n + 1, b).astype(np.int32)
            ms = rng.integers(1, m + 1, b).astype(np.int32)
            ns[-b // 8:] = 0  # padding pairs
            ms[-b // 8:] = 0
            ns_t, ms_t = (torch.from_numpy(x).to(device) for x in (ns, ms))
            out = batch_fill.batch_fill_dirs(
                texts, patterns, ns_t, ms_t, sm, 8 if ext else 5, 4,
                local=local, semi=semi, tile_pairs=128, gap_extend=ext)
            scores, bis, bjs, dirs = out[:4]
            dirs2 = out[4] if ext else None
            if local:
                bis = torch.where(scores > 0, bis, 0)
                bjs = torch.where(scores > 0, bjs, 0)
            kind = "affine " if ext else ""
            for max_len in (-(-(n + m) // 16) * 16, 64):
                cases.append((f"{kind}{mode} K3 words, buffer {max_len}",
                              dirs, dirs2, ns_t, ms_t, bis, bjs, local, semi,
                              max_len))
    # Synthetic words: every pair's path shape, starts at and past the
    # words' edges.
    b, rows, cols = 128, 96, 150
    for kind in ("random", "left", "top", "diag", "zigzag"):
        for mode in ("global", "local", "semi"):
            local, semi = mode == "local", mode == "semi"
            cells = path_cells(kind, (b, rows + 1, cols + 1), rng, local)
            dirs = torch.from_numpy(pack_batch_words(cells, 128)).to(device)
            bits = torch.from_numpy(pack_batch_words(
                rng.integers(0, 4, (b, rows + 1, cols + 1)).astype(np.uint8),
                128)).to(device)
            ms = rng.integers(0, rows + 1, b).astype(np.int32)
            ns = rng.integers(0, cols + 1, b).astype(np.int32)
            ms[:4], ns[:4] = rows, cols
            ms[4], ns[5] = rows + 1, cols + 1  # outside: no move
            ms[6], ns[7] = -1, -1
            starts = [torch.from_numpy(x).to(device)
                      for x in (ns, ms, ms.copy(), ns.copy())]
            for dirs2 in (None, bits):
                cases.append((f"{'affine ' if dirs2 is not None else ''}"
                              f"{mode} {kind} paths", dirs, dirs2, *starts,
                              local, semi, -(-(rows + cols + 2) // 16) * 16))
    return cases


def same(got, want) -> bool:
    return all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(got, want))


def check_batch(lib, least_only=False, affine=None):
    """The production build (shape None) and every run (``least_only``:
    the least) at the production block and 32 threads against
    ``batch_walk_plain`` in every case of ``batch_cases`` (``affine`` True
    or False: that variant's alone).  Returns [(case, (run, threads) or
    None, moves, exact)]."""
    rows = []
    for (name, dirs, dirs2, ns, ms, bis, bjs, local, semi,
         max_len) in batch_cases(np.random.default_rng(12)):
        if affine is not None and (dirs2 is not None) != affine:
            continue
        want = batch_traceback.batch_walk_plain(dirs, ns, ms, bis, bjs,
                                                local, semi, max_len,
                                                dirs2=dirs2)
        _, num_w, n_cols, sub, _ = dirs.shape
        shapes = [None] + [(run, threads)
                           for run in ((LEAST_RUN,) if least_only else RUNS)
                           for threads in (0, 32)]
        for shape in shapes:
            launch, out = batch_traceback.shape_launch(
                lib if shape else library_of("batch_walk"), shape, dirs,
                num_w, n_cols, sub * 128, ns, ms, bis, bjs, local, semi,
                max_len, dirs2)
            launch()
            torch.cuda.synchronize()
            rows.append((name, shape, int(want[1].sum()), same(out, want)))
    return rows


def packed_cases(rng, device="cuda"):
    """(name, words, n, m, bi, bj, local, max_len) of the single-pair
    walk's check: random words global and local (with STOP), from the
    last cell and from inside; all-LEFT, all-TOP, all-DIAG and zig-zag
    paths; starts in row 0 and column 0; buffer ends mid-path; P a
    multiple of 4 but not of 8."""
    cases = []
    for rows, cols in ((300, 1000), (250, 1004)):
        for kind in ("random", "left", "top", "diag", "zigzag"):
            for local in (False, True):
                cells = path_cells(kind, (rows + 1, cols + 1), rng, local)
                words = torch.from_numpy(pack_packed_words(cells)).to(device)
                full = -(-(rows + cols + 1) // 16) * 16
                name = f"{'local' if local else 'global'} {kind} {rows}x{cols}"
                if local:
                    starts = [(rows, cols), (rows - 17, cols - 300)]
                else:
                    starts = [(rows, cols)]
                for bi, bj in starts:
                    n, m = (cols, rows) if not local else (bj, bi)
                    cases.append((name, words, n, m, bi, bj, local, full))
                if kind == "random" and not local:
                    cases.append((f"{name}, buffer 160", words, cols, rows, 0,
                                  0, False, 160))
                    cases.append((f"{name} from row 0", words, cols // 2, 0, 0,
                                  0, False, full))
                    cases.append((f"{name} from column 0", words, 0, rows - 5,
                                  0, 0, False, full))
    return cases


def check_packed(lib, least_only=False):
    """The production build (window None) and every window
    (``least_only``: the least) against ``walk_packed``'s plain version
    in every case of ``packed_cases``.  Returns [(case, window or None,
    moves, exact)]."""
    rows = []
    for name, words, n, m, bi, bj, local, max_len in packed_cases(
            np.random.default_rng(13)):
        want = batch_traceback.walk_packed(words.cpu(), n, m, bi, bj, local,
                                           max_len)
        for window in (None, *((LEAST_WINDOW,) if least_only else WINDOWS)):
            launch, out = batch_traceback.packed_shape_launch(
                lib if window else library_of("batch_walk"), window, words,
                n, m, bi, bj, local, max_len)
            launch()
            torch.cuda.synchronize()
            rows.append((name, window, int(want[1][0]), same(out, want)))
    return rows + check_packed_refusals(lib, least_only)


def refused(call, error) -> bool:
    """Whether ``call()`` raises ``error``."""
    try:
        call()
    except error:
        return True
    return False


def check_packed_refusals(lib, least_only=False):
    """Words the single-pair walk's loaders cannot read in 16-byte
    chunks: P not a multiple of 4 (1,003 columns), and words at an offset
    of one word from a 16-byte boundary.  ``walk_packed`` raises
    ValueError, and the entry point of the production build and of every
    window (``least_only``: the least) returns cudaErrorInvalidValue
    (``check_launch``'s RuntimeError).  Returns rows as ``check_packed``
    does, 0 moves, exact where refused."""
    rows = []
    odd = torch.zeros((16, 1003), dtype=torch.int32, device="cuda")
    flat = torch.zeros(16 * 1000 + 1, dtype=torch.int32, device="cuda")
    shifted = flat[1:].view(16, 1000)
    for name, words in (("P = 1003", odd), ("words at 4 B past 16", shifted)):
        n, m = words.shape[1], 200
        rows.append((f"refused: {name}", None, 0, refused(
            lambda: batch_traceback.walk_packed(words, n, m, 0, 0, False,
                                                1216), ValueError)))
        for window in (None, *((LEAST_WINDOW,) if least_only else WINDOWS)):
            launch, _ = batch_traceback.packed_shape_launch(
                lib if window else library_of("batch_walk"), window, words,
                n, m, 0, 0, False, 1216)
            rows.append((f"refused by the entry point: {name}", window, 0,
                         refused(launch, RuntimeError)))
    return rows


def check(lib) -> bool:
    """``check_batch`` and ``check_packed`` at every shape, a line a case
    and shape."""
    ok = True
    for name, shape, moves, good in check_batch(lib):
        shape = ("production" if shape is None else
                 f"run={shape[0]} threads={shape[1]}")
        print(f"BATCH_WALK_CHECK {name} {shape}: {moves} moves "
              f"{'exact' if good else 'DIFFERS'}", flush=True)
        ok &= good
    for name, window, moves, good in check_packed(lib):
        window = ("production" if window is None else
                  f"window={window[0]}x{window[1]}")
        print(f"PACKED_WALK_CHECK {name} {window}: {moves} moves "
              f"{'exact' if good else 'DIFFERS'}", flush=True)
        ok &= good
    return ok


def chunk(affine):
    """One chunk of phase 9's (affine: phase 22's) workload filled by K3:
    the walk's arguments (dirs, num_w, n_cols, tile_pairs, ns, ms, bis,
    bjs, local, semi, max_len, dirs2)."""
    b, size, seed = ALIGN_WIDTH
    rng = np.random.default_rng(seed)
    texts = np.stack([rng.integers(0, 4, size) for _ in range(b)])[:CHUNK]
    rng = np.random.default_rng(seed)
    for _ in range(b):  # the patterns follow the texts in the stream
        rng.integers(0, 4, size)
    patterns = np.stack([rng.integers(0, 4, size)
                         for _ in range(b)])[:CHUNK]
    ns = torch.full((CHUNK,), size, dtype=torch.int32, device="cuda")
    gap, ext = BATCH_AFFINE if affine else (5, None)
    out = batch_fill.batch_fill_dirs(
        torch.from_numpy(texts.astype(np.int8)).cuda(),
        torch.from_numpy(patterns.astype(np.int8)).cuda(), ns, ns,
        torch.from_numpy(DNA_5_4).cuda(), gap, 4, local=True, tile_pairs=128,
        gap_extend=ext)
    scores, bis, bjs, dirs = out[:4]
    matched = scores > 0
    bis, bjs = torch.where(matched, bis, 0), torch.where(matched, bjs, 0)
    _, num_w, n_cols, sub, _ = dirs.shape
    return (dirs, num_w, n_cols, sub * 128, ns, ns, bis, bjs, True, False,
            2 * size, out[4] if affine else None)


def full_width_words():
    """Phase 18's strip-engine words of the full-width pair, on the card,
    and the walk's arguments (n, m, bi, bj, local, max_len)."""
    request = Request()
    assert parse_arguments(["alignSequence", "-g", *FULL_WIDTH],
                           request) == 0
    text = np.asarray(request.text, dtype=np.int32)
    pattern = np.asarray(request.pattern, dtype=np.int32)
    sm = layout.pack_score_matrix(request.score_matrix,
                                  request.alphabet_size)
    result = tiled.tiled_fill(text, pattern, sm, request.alphabet_size,
                              request.gap_penalty, device="cuda")
    words = torch.from_numpy(result.words).cuda()
    n, m = len(text), len(pattern)
    return words, (n, m, 0, 0, False, -(-(n + m) // 16) * 16)


def time_shapes(lib) -> bool:
    """Times every shape at the main path's walks; prints each, the
    chunks' weighted totals and the least."""
    ok = True
    totals = {}
    for affine in (False, True):
        args = chunk(affine)
        first = None
        for shape in ((run, threads) for run in RUNS for threads in THREADS):
            launch, out = batch_traceback.shape_launch(
                lib, shape, *args[:-1], dirs2=args[-1])
            ms = best_ms(launch)
            good = first is None or same(out, first)
            first = first if first is not None else out
            ok &= good
            totals[shape] = totals.get(shape, 0) + CHUNKS * ms
            moves = int(out[1].long().sum())
            print(f"BATCH_WALK_TIME {'affine' if affine else 'linear'} chunk "
                  f"{CHUNK} x {ALIGN_WIDTH[1]}^2 run={shape[0]} "
                  f"threads={shape[1] or 'rule'}: {ms:.4f} ms, {moves} moves"
                  f"{'' if good else ', DIFFERS from the first'}",
                  flush=True)
        del args, first
        torch.cuda.empty_cache()
    for shape, ms in sorted(totals.items()):
        print(f"BATCH_WALK_TOTAL run={shape[0]} threads={shape[1] or 'rule'}"
              f": {ms:.4f} ms ({CHUNKS} linear + {CHUNKS} affine chunks)",
              flush=True)
    best = min(totals, key=totals.get)
    print(f"BATCH_WALK_CHOICE run={best[0]} threads={best[1] or 'rule'} "
          f"{totals[best]:.4f} ms (in code: run {batch_traceback.RUN}, "
          f"threads rule from {batch_traceback.BATCH_THREADS})", flush=True)
    words, args = full_width_words()
    first, times = None, {}
    for window in WINDOWS[1:]:  # the least window is for --check
        launch, out = batch_traceback.packed_shape_launch(lib, window, words,
                                                          *args)
        ms = best_ms(launch)
        good = first is None or same(out, first)
        first = first if first is not None else out
        ok &= good
        times[window] = ms
        moves = int(out[1][0])
        print(f"PACKED_WALK_TIME full width window={window[0]}x{window[1]}: "
              f"{ms:.3f} ms, {moves} moves, {ms * 1e6 / max(moves, 1):.1f} "
              f"ns a move{'' if good else ', DIFFERS from the first'}",
              flush=True)
    best = min(times, key=times.get)
    print(f"PACKED_WALK_CHOICE window={best[0]}x{best[1]} {times[best]:.3f} "
          f"ms (in code: {batch_traceback.PACKED_WINDOW})", flush=True)
    return ok


def trace_shapes():
    """``--trace``: the production shapes at the main path's walks, with
    the walks' own traces."""
    lib = library()
    for affine in (False, True):
        args = chunk(affine)
        for run in sorted({batch_traceback.RUN, RUNS[-2]}):
            trace = torch.zeros(BATCH_TRACE, dtype=torch.int64,
                                device="cuda")
            launch, out = batch_traceback.shape_launch(
                lib, (run, 0), *args[:-1], dirs2=args[-1], trace=trace)
            trace[6] = -1  # the first start: an atomic minimum of uint64
            launch()
            torch.cuda.synchronize()
            copies, restarts, waiting, moves, warp_its, most, t0, t1, \
                wait_ns = (int(x) for x in trace.tolist())
            span = t1 - t0
            print(f"K4_TRACE {'affine' if affine else 'linear'} chunk (run "
                  f"{run}{', production' if run == batch_traceback.RUN else ''}"
                  f"): {moves} moves, {copies} copies "
                  f"({copies / max(moves, 1):.2f} a move), {restarts} "
                  f"restarts ({restarts / CHUNK:.1f} a pair), {waiting} lane "
                  f"iterations waiting for a head ({waiting / CHUNK:.1f} a "
                  f"pair); warp iterations {warp_its} (most {most} a warp, "
                  f"moves a lane {moves / CHUNK:.1f}); blocks' span {span} "
                  f"ns, {span / max(most, 1):.1f} ns an iteration, "
                  f"{wait_ns / max(warp_its, 1):.1f} of it in the wait for "
                  f"copies", flush=True)
            del out
        del args
        torch.cuda.empty_cache()
    words, args = full_width_words()
    trace = torch.zeros(PACKED_TRACE, dtype=torch.int64, device="cuda")
    window = batch_traceback.PACKED_WINDOW
    launch, out = batch_traceback.packed_shape_launch(lib, window, words,
                                                      *args, trace=trace)
    ms = best_ms(launch, reps=1)
    (loads, waits, wait_ns, misses, polls, early, first_ns, walker_ns,
     moves, crossings, steps) = trace.tolist()
    print(f"K4_PACKED_TRACE full width (window {window[0]} x {window[1]}): "
          f"{ms:.3f} ms, {moves} moves, {walker_ns / max(moves, 1):.1f} ns a "
          f"move on the walker's clock ({walker_ns / 1e6:.3f} ms); windows "
          f"loaded {loads} ({moves / max(loads - misses, 1):.0f} moves a "
          f"window), the first in {first_ns} ns; switches on a poll {early}, "
          f"polls that found the load running {polls}; waits at a window's "
          f"edge {waits}, misses {misses}, {wait_ns} ns waiting in all; "
          f"crossings into a word row below {crossings}; steps {steps} "
          f"({moves / max(steps, 1):.2f} moves a step, "
          f"{walker_ns / max(steps, 1):.1f} ns a step)", flush=True)


def main(argv=None) -> int:
    return probe_main(argv, "batch_walk_shapes", library, check, time_shapes,
                      trace_shapes)


if __name__ == "__main__":
    sys.exit(main())
