#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``seqalign_torch``) on one GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failed check raises and the script exits non-zero
without its last line:

1. Build the CUDA kernels (K1 ``csrc/wavefront.cu``, K2 ``csrc/walk.cu``,
   K3 ``csrc/interpair.cu``, K3-cell16 ``csrc/interpair16.cu``, K4
   ``csrc/batch_walk.cu``, K5 ``csrc/strip.cu``, the probes P2
   ``csrc/probe_dpx16.cu`` and P1 ``csrc/probe_chase.cu``) and the native
   oracle from the sources, all at once (and the all-shapes builds of
   K2, ``probes/walk_shapes.py``, and K4, ``probes/batch_walk_shapes.py``,
   beside them), and print the build time and ptxas's lines; fail if any
   K1, K5, K2, K3, K3-cell16 or K4 instance spills, or if K2's window
   shapes (``sa_walk_window_slots``/``_groups``) differ from
   ``ops/walk.window_shape``'s or K4's (``sa_batch_walk_shape_of``) from
   ``ops/batch_traceback``'s.
2. K1 against its plain PyTorch version, on the card: global, local and
   semi-global, DNA and protein, at rps 8 and 16 with 4096 slots and at
   rps 8 with 1024 slots.  Every output is an integer, so the comparison
   is exact (tolerance 0).  K1's bands hand their rows on through
   streams in a scratch buffer: at rps 8 x 4096 one launch closure runs
   5 times on the same inputs, its outputs and its streams' values
   poisoned between runs, each run equal to the plain version, and its
   128 CTAs must run on more than 100 SMs (``repeat_launches``; phases 10
   and 13 do the same for the other five variants).
3. K2 against its plain version on the words of phase 2, also with a
   move buffer shorter than the path; then ``walk_shapes``' check at the
   least window (8 slots x 2 groups, so that each walk crosses dozens of
   windows), its linear cases at rps 1-16: global, local, semi-global,
   tiles, a buffer's end, all-LEFT, all-TOP, all-DIAG and zig-zag paths.
   Exact.
4. The single-pair main path: the ``-g`` command line (``cli.main``, the
   body of ``python -m seqalign_torch``) in this process on the bundled
   pairs, each compared byte for byte with ``python -m seqalign_torch -c``
   (the native oracle) run in a subprocess.  The launch counters are set
   to 0 just before and read just after, and show which route each pair
   took.  One ``python -m seqalign_torch -g`` subprocess proves the
   module entry point in a fresh process.
5. Full width: the largest bundled pair the direct route takes,
   NC_045839 x GCA_003434045 (280,482 x 48,632, rps 16 x 4096 slots),
   through ``-g``.  Its score must equal the oracle's O(n)-memory
   score-only fill, and rescoring the printed alignment must give it too.
   Then each kernel's launch alone is timed at this shape with CUDA
   events; K2 is held against its plain version there, and its launch
   closure runs 5 times with its moves and result poisoned before each,
   each run exact; K1 at a smaller
   depth (the text's first PLAIN_DEPTH letters) and on a late window:
   the last whole WINDOW_COLS columns, re-filled from a column
   checkpoint of the score-only fill by K1 and by its plain version,
   must equal the run's words there.
6. K3 (score-only and with direction words) and K4 against their plain
   versions, on the card: global, local and semi-global, DNA and protein,
   ragged lengths with padding pairs, n not a multiple of 128, tile_pairs
   128 and 256; every score, best cell, word, move word, length and
   final cursor, K4 with the full buffer and with 64 moves.  Then K3 on
   256 pairs of 2,080 rows (K3_WRAP: 130 stripes, more than a CTA's
   warps, so the last warp hands its rows to the first through the
   global scratch), both variants in the three modes, and each launch
   closure 5 times with its outputs and scratch poisoned between runs
   (``repeat_k3_launches``).  Then K4's stress set (``k4_stress_checks``:
   K3-filled batches with padding pairs and 64-move buffers, numpy words
   with random, all-LEFT, all-TOP, all-DIAG and zig-zag paths and starts
   outside the words, through the production build and the least run)
   and its launch closure 5 times with every output poisoned before each
   run.  Exact.
7. The batch main path: ``BatchAligner.score`` and ``.align`` on a
   ragged mix of random and bundled pairs with empty ones among them, in
   the three modes, DNA and protein; every score equals ``oracle_fill``'s
   and every alignment is byte-identical to ``oracle_align``'s.  The
   launch counters are set to 0 just before and read just after, and the
   plain versions are replaced by a function that raises.
8. Full width, scores: ``BatchAligner(local=True).score`` on bench.py's
   headline workload (8,192 DNA pairs of 512 x 512, seed 42), 512
   sampled pairs against the oracle; then K3 timed at that shape and
   held against its plain version there, printed beside the row's time
   before the chain of warps (K3_BEFORE_MS).
9. Full width, alignments: ``BatchAligner(local=True).align`` on the
   64k-pair workload of ``scripts/bench_batch_e2e_metric.py`` (65,536
   DNA pairs of 256 x 256, seed 9, 4 chunks), 1,024 sampled pairs
   byte-identical to the oracle; then K3 with words and K4 timed on one
   16,384-pair chunk and held against their plain versions there.
10. K1's checkpoint-engine variants against their plain versions, on
    the card: score-only with column checkpoints at rps 16 x 4096, 4 x
    1024 and 1 x 128 slots, three modes, DNA and protein, every output
    and checkpoint entry; then with a left column and words on a tile in
    row 0, one in column 0 and an interior one of a real phase-1 fill
    (rps 4 x 1024, 2048 columns), each walked by K2 and its plain
    version (in a local tile from the best cell of its bottom row).
    Exact.
11. The checkpoint engine at forced small geometries, so that the
    paths cross many tiles: ``checkpointed_align`` on NC_034972.1 x
    mutated_NC_034972.1 (rps 4 x 1024, 2048 columns) and on P33450 x
    mutated_P33450 (rps 1 x 128, 256 columns), three modes each, every
    alignment byte-identical to ``oracle_align``; launch counters read
    around each call (K1 = strips + path tiles, K2 = path tiles), the
    plain versions made to raise.
12. Full width, long pair: ``-g`` on AbHV_ORF111 x mutated_AbHV_ORF111
    (232k x 221k-byte files; both sequences past one 65,536-row strip)
    at the default geometry (rps 16 x 4096 slots, 32,768 columns a
    tile).  Its score must equal the oracle's score-only fill and the
    rescored alignment; K1 = strips + path tiles and K2 = path tiles;
    the wall, the two phases' times, the tiles crossed and the peak
    device memory are printed.  Then, on that run's fill, one phase-1
    strip (K1 score-only with checkpoints) and one full-size interior
    tile (K1 with the left column and words, K2 from the middle of the
    tile) are timed, their launches alone, and held against their plain
    versions (the strip's at a smaller depth, past its first checkpoint
    column; the tile's bottom row must equal phase 1's strip there, which
    holds the strip's deep columns too); and the host's share of a path
    tile is timed:
    ``Tiles.walk`` on the host's clock less the two launches, and the
    read-back of K2's result and moves alone.
13. Affine (Gotoh) K1 and K2 against their plain versions, on the card:
    K1 with words and score-only with checkpoints at rps 16 x 4096, 4 x
    1024 and 1 x 128 slots, global DNA and local protein at extend <
    open (every K1 and K2 instance), with words also semi-global DNA at
    extend == open; K1 with the left columns of H and E on the interior
    tile of a real affine phase-1 fill at rps 16 x 4096 slots (8192
    columns a tile, two strips), and on row-0, column-0 and interior
    tiles at 4 x 1024 and 1 x 128; every output (words, run bits, both streams, trackers, the H
    and E checkpoints), and K2 on each set of words from gap states 0, 1
    and 2 and with a buffer of 64 moves (in a local tile from the best
    cell of its bottom row); then ``walk_shapes``' check at the least
    window, its affine cases.  Exact.
14. The affine main path: ``-g --gap-extend`` (``cli.main``) in this
    process on NC_018874 x mutated (three modes) and on P08519 x P10635
    (protein, local), each byte-identical to ``python -m seqalign_torch
    -c`` with the same flags and each taking the direct route (the launch
    counters); then ``checkpointed_align(gap_extend=...)`` at rps 1 x
    128, 256 columns, on NC_018874 x mutated and P33450 x mutated, three
    modes each, byte-identical to ``oracle_align_affine``, K1 = strips +
    path tiles and K2 = path tiles, the plain versions made to raise.
15. Affine at full width, ``-g --gap-penalty 8 --gap-extend 2``: the
    direct route on phase 5's pair (two word planes) and the checkpoint
    engine on phase 12's, each score equal to the oracle's affine
    score-only fill and to the rescored alignment (a run of L gaps costs
    8 + 2(L-1)); walls, phase times, tiles and peak memory printed.  Then
    each affine kernel's launch alone is timed (K1 with words at full
    width, one phase-1 strip, one full-size interior tile, K2), held
    against the plain versions at phase 13's shapes.
16. K5 (the strip engine's region fill, a chain of warp bands) against
    its plain version, on the card: global and local, with words and
    score-only, DNA and protein, a pair's first region and an interior
    region of a real tiled fill (row_base and strip_off > 0, the state
    carried, the left column strip 0's right one), at 1,024, 32,768,
    49,152 and 65,536 columns with columns past n, over STRIP_PLAIN_ROWS
    rows (512 at 1,024); then regions of 16 bands and more
    (STRIP_BAND_REGIONS: 2,048 x 4,096, m and n mid-band).  Every output
    (words, last row, right column, state) exact.  K5's launch closure,
    with words and score-only, runs 5 times on the same inputs, each run
    exact, with the outputs and the bands' stream values poisoned
    between runs.
17. The strip engine through ``-g`` (``SEQALIGN_PAIR_ENGINE=strip``),
    with the native walk and with ``SEQALIGN_TRACEBACK=device`` (K4's
    single-pair walk, K4-packed): the
    main path's global and local pairs, GCA_003434045 x NC_001490.1
    (one K5 launch of 7,296 x 49,152) and GCA_003434045 x NC_024446.1
    (tiled, 2 strips x 4 blocks) in both modes, each byte-identical to
    ``-c``; launch counters show K5 (and K4-packed in device mode), never
    K1;
    the semi-global and affine requests still take K1, never K5.  The
    7,296 x 49,152 region, global and local, whole through the wrapper
    against the plain version on the run's own inputs.
18. The strip engine at full width: ``-g`` on phase 5's pair (tiled, 9
    strips x 6 blocks, 3.59 GB of words on the host) in both traceback
    modes, byte-identical to phase 5's output, its score the oracle's;
    the wall, K5's launches (CUDA events), the walk, the words' way into
    the host array (each block's wait for its D2H and its copy, host
    clock), the print and peak memory;
    then ``tiled_fill_score`` of phase 12's long pair (7 strips x 13
    blocks) against the oracle's score.  Whole blocks of these runs
    (8,192 x 32,768 interior and 7,680 x 32,768 last, with words; 16,384
    x 32,768 score-only) through the wrapper against the plain version
    on their own inputs; the launches alone of the interior block (its
    CTAs and the SMs they ran on logged), the long pair's block and
    phase 17's single region (CUDA events, best of 3), each beside its
    bound, and the interior block's words' D2H.  Then K4-packed
    (``walk_packed``) of the device-mode run alone, beside its bound and
    chain floor, equal to the run's walk and to the plain version on a
    CPU copy of the same words (the plain version timed there), and exact
    against the plain version on the probe's window-edge set, with the
    words its loaders cannot read refused (``phase_packed_walk``).
19. Affine K3 (score-only and with the words and run bits) and affine
    K4 against their plain versions, on the card: global, local and
    semi-global, DNA and protein, extend below open and equal to it,
    ragged lengths with padding pairs, n not a multiple of 128,
    tile_pairs 128 and 256; every score, best cell, word, run-bit word,
    move word, length and final cursor, K4 with the full buffer and with
    64 moves; then the wrapping K3 pairs of phase 6 at open 8 extend 2,
    with 5 poisoned runs of each launch closure; then K4-affine's stress
    set and 5 poisoned runs, as in phase 6.  Exact.
20. The affine batch main path: ``BatchAligner(gap_extend=2)`` at open
    8 (phase 15's costs), ``.score`` and ``.align`` on phase 7's mix in
    the three modes, DNA and protein; every score equals
    ``oracle_fill_affine``'s and every alignment is byte-identical to
    ``oracle_align_affine``'s; launch counters and the plain versions as
    in phase 7.
21. Affine at full width, scores: ``BatchAligner(local=True,
    gap_penalty=8, gap_extend=2).score`` on phase 8's workload, 512
    sampled pairs against the oracle; then affine K3 timed at that shape
    and held against its plain version there.
22. Affine at full width, alignments: ``.align`` with the same costs on
    phase 9's workload, 1,024 sampled pairs byte-identical to the
    oracle; then affine K3 with words and affine K4 timed on one chunk
    and held against their plain versions there.
23. K3-cell16 (the int16 cell mode, two pairs a lane) against its
    plain version and against the int32 K3, on the card: phase 6's and
    19's cases (global, local and semi-global, DNA and protein, linear
    and affine at both costs, ragged lengths with padding pairs, n not a
    multiple of 128, an odd batch score-only, tile_pairs 128 and 256) and
    the +-127 matrix at the largest shape the gate admits with gap 127.
    Every score, best cell, word and run-bit word exact, and equal to the
    int32 K3's but the padding pairs' scores (NEG_16 for NEG_INF).  Then
    the wrapping pairs of phase 6, linear at gap 5 and affine at open 5
    extend 2 (open 8 is past the int16 gate at 2,080 rows), with 5
    poisoned runs of each launch closure.
24. The int16 batch path: phase 7's and 20's mixes under
    ``SEQALIGN_INT16_CELLS=1`` (refused with the JAX ValueError where the
    gate does not admit a bucket) and ``auto`` (a spy and the launch
    counters show each bucket in K3-cell16 exactly when the gate admits
    it; every result the oracle's); then phases 8, 9, 21 and 22 under
    ``1``: every score and alignment equal to that phase's int32 run's,
    K3-cell16 timed beside its K3 and held against its plain version.
25. P2 (``python -m seqalign_torch.probes.dpx16``): each packed int16
    formulation of ``scripts/mosaic_micro_probe.py``'s patterns and each
    DPX intrinsic on 2^24 random words against its plain version, its
    rate beside its int32 counterpart's (the DPX16_OK / DPX16_FAIL
    lines); each rate kernel's loop instructions from ``cuobjdump
    -sass`` (DPX16_SASS lines), and __viaddmax_s32's rate in operations
    beside the int32 peak of the bounds.
26. P1 (``python -m seqalign_torch.probes.walk_costs``): the JAX probe's
    dependent chain of loads over tables in shared memory (32 KiB, 128
    KiB), L2 (16 MiB) and HBM (1 GiB), each result against its plain
    version, ns a step.
27. K1's sequence-parallel chunk (score-only with column checkpoints
    every chunk and a left column; affine with the top row of F and E's
    left column) against its plain version: at the main path's geometry
    (rps 16 x 4096 slots, 32,768 columns a chunk) six cases on the long
    pair's own fills (global interior and last, local first, semi-global
    last, affine interior and last; the last chunk is 14,910 columns,
    ending inside the kernel's drain), the chunk's inputs those of
    ``checkpoint.Tiles``; the other (mode, position) cases at 16 x 1,024
    slots with 2,048-column chunks; the global and affine interior
    chunks timed alone beside their bounds.  Then four main-path cases'
    launch closures (one a mode) on four streams of the card at once, and
    four K5 regions the same way, 5 runs each with the outputs and the
    bands' streams poisoned between runs, every output exact.
28. Sequence parallel on a mesh of one (the default mesh, this card;
    ``SEQALIGN_SEQUENCE_PARALLEL=1``): ``-g`` on phase 5's pair takes the
    route (9 chunks of one strip, then the checkpoint engine's
    traceback), byte-identical to phase 5; K1 = chunks + path tiles.
29. Sequence parallel on ``cuda:0 x 4`` (the default mesh set so): ``-g``
    on phase 12's pair, linear and at phase 15's affine costs (4 strips,
    7 chunks, 10 supersteps), byte-identical to phases 12 and 15; each
    strip's colvals and boundaries (and E's and F's) equal to the
    single-card ``checkpointed_fill``'s; walls beside phases 12 and 15.
30. ``sequence_parallel_fill`` (K5) on ``cuda:0 x 4``: phase 5's pair in
    8,192-row blocks, each strip of 70,656 columns two regions, score
    and best cell equal to the oracle's, global and local; then its words
    on a 4 x 2,048-column x 300-row case equal to the plain version's
    (the same pipeline on CPU entries).
31. Data parallel in one process: ``BatchAligner(mesh=...)`` on meshes
    of 1 and 2 entries of the card, phases 8-9's and 21-22's workloads,
    every score and alignment equal to those phases'; walls beside them.
32. Data parallel across processes: two ``python -m
    seqalign_torch.parallel.worker`` processes share the card over gloo,
    two entries each; each byte-checks its shard against the oracle,
    and the all-gathered scores equal one process's.
33. The models' ``score()`` (K1 score-only with checkpoints, the
    checkpoint engine's phase 1): global, local and semi-global on phase
    4's bundled pairs, each equal to ``oracle_fill``'s score; global and
    local on phase 5's and phase 12's pairs, each equal to the oracle's
    score-only fill, K1 launched once a strip and no plain version run;
    each wall and its K1 time (the ledger's events) beside the same
    pair's ``-g`` wall (phases 5 and 12).
34. ``seqalign_torch.bench.suite``'s verbs at reduced sizes (BENCH_VERBS:
    throughput global and local, latency, batch linear and affine,
    batch-e2e, maxlength through K1 and through the tiled fill at its
    default 120,000 x 120,000, engines at its default 4,096), each
    verb's kernels launched and no plain version run; maxlength's two
    engines and ``SmithWaterman.score()`` equal on its pair; then
    ``python -m seqalign_torch.bench.headline`` in a process of its own,
    its last line parsed as the four-key JSON, beside phase 8's K3.
35. A ``launch_ledger`` JSON line (each kernel row's launches and device
    ms summed over every launch made under a user entry point, timed
    between CUDA events from phase 2 on, in all and by phase), the
    longest K3 launch of the ragged mixes (phases 7, 20, 24) beside its
    time before the chain of warps, the K3 repeat checks, a
    ``workload_ledger`` line (the same over WORKLOAD_PHASES, one run of
    each workload, the rows in order of their longest launch), a JSON
    line of the kernels (each with its sums as ``main_path_ms`` and
    ``workload_ms``; the ``K1-chunk`` rows are phase 27's; K2's rows
    also with a path tile's time and the chain floor, the moves times
    P1's shared-memory step of this run; K4's three rows, ``K4
    batch_walk``, ``K4-affine`` and ``K4-packed walk_packed``, with their
    floors: the batch walks' sectors, a 32-byte sector a 4-byte read,
    over the memory rate, the single-pair walk's chain), a ``mesh`` line
    (phases 27-32's walls beside the single-card routes'; the mesh
    repeats one card, so they measure the pipeline's overhead, not
    scaling), the card's name and power limit from nvidia-smi, and
    ``{"ok": true, "device": {...}}``; the kernels line's launches take
    in phases 33-34's from the ledger.

The oracle's side of phases 4, 5, 7-9, 11, 12, 14, 15, 17, 18, 20-22 and
33 (and 24, which reuses 7-9's and 20-22's) runs in subprocesses and threads
beside the device phases.
A host without a CUDA device fails at once and prints no result.
"""

from __future__ import annotations

import contextlib
import hashlib
import inspect
import io
import json
import os
import re
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from seqalign_torch import cli, config, pretty
from seqalign_torch.bench import suite
from seqalign_torch.io import parse_score_matrix_file
from seqalign_torch.models import NeedlemanWunsch, SemiGlobal, SmithWaterman
from seqalign_torch.native import bindings
from seqalign_torch.native.build import ensure_built
from seqalign_torch.ops import (_build, batch_fill, batch_traceback,
                                checkpoint, direct, layout, strip_fill, tiled,
                                walk, wavefront)
from seqalign_torch.parallel import BatchAligner
from seqalign_torch.parallel import mesh as mesh_lib
from seqalign_torch.parallel import sequence, worker
from seqalign_torch.probes import (batch_walk_shapes, dpx16, walk_costs,
                                   walk_shapes)
from seqalign_torch.types import Request

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).  Memory:
# 3.35 TB/s.  int32: the 67 TFLOP/s float32 rate is 132 SMs x 128 lanes
# x 2 (an FMA counts twice) x 1.98 GHz.  An SM has 64 int32 lanes, and a
# three-operand integer instruction (DPX add-max or max of three, IADD3,
# LOP3) does two operations, as an FMA does: 132 x 64 x 2 x 1.98 GHz =
# 33.5 T int32 operations a second.  P2 (``python -m
# seqalign_torch.probes.dpx16 --sass``) runs __viaddmax_s32 at one
# VIADDMNMX an op, 16.2 T instructions a second on an NVIDIA H100 80GB
# HBM3 at 700 W (32.3 T operations, 97 % of this figure); no variant it
# times runs more operations a second.  Packed int16: two lanes an
# instruction at the same instruction rate (P2: 32.2-32.3 T results a
# second for __viaddmax_s16x2, __vimax3_s16x2 and __vimax_s16x2_relu).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 2
# Integer operations per cell of the linear fill: H = max(diag + s,
# max(top, left) - gap) is 4; the 2-bit direction (two compares, two
# selects, a shift and an or into the word) is 6.
K1_OPS_PER_CELL = 10
# Score-only (the checkpoint engine's phase 1): H alone, 4.
K1_SCORE_OPS_PER_CELL = 4
# Per move of the walk: the cell's slot, row and step (4), the word's
# index (2), the 2 bits out of it (2), packing them (2), the i/j step (2).
K2_OPS_PER_MOVE = 12
# K3, per cell: H as in K1 (4) and the substitution's table index (1);
# with direction words, the 2-bit direction as in K1 (6) besides.
K3_OPS_PER_CELL = 5
K3_DIRS_OPS_PER_CELL = K3_OPS_PER_CELL + 6
# K4, per move: as K2's walk.
K4_OPS_PER_MOVE = K2_OPS_PER_MOVE
# Affine (Gotoh) K1, per cell: H is 9 (for each of E and F two
# subtractions and a max; the max of the two; the diagonal's add; the
# best's max), the whole of the score-only variant; the words add the 6
# direction operations and 4 for the run bits (two compares, a shift and
# an or into the second word).
K1_AFFINE_SCORE_OPS_PER_CELL = 9
K1_AFFINE_OPS_PER_CELL = K1_AFFINE_SCORE_OPS_PER_CELL + 6 + 4
# Affine K2, per move: the run bits out of the second word (2) and the
# next gap state (2) besides the linear walk's.
K2_AFFINE_OPS_PER_MOVE = K2_OPS_PER_MOVE + 4
# Affine K3, per cell: H with E and F as in affine K1 (9) and the
# substitution's table index (1); with words, the 2-bit direction (6) and
# the run bits (4: two compares, a shift and an or into the second word).
K3_AFFINE_OPS_PER_CELL = K1_AFFINE_SCORE_OPS_PER_CELL + 1
K3_AFFINE_DIRS_OPS_PER_CELL = K3_AFFINE_OPS_PER_CELL + 6 + 4
# Affine K4, per move: as affine K2's walk.
K4_AFFINE_OPS_PER_MOVE = K2_AFFINE_OPS_PER_MOVE

# K5, per cell: the same recurrence as K1, and the substitution's table
# index, as in K3: H (4) and the index (1); with words, the 2-bit
# direction (6) besides.
K5_SCORE_OPS_PER_CELL = K1_SCORE_OPS_PER_CELL + 1
K5_OPS_PER_CELL = K5_SCORE_OPS_PER_CELL + 6

DNA = ("data/dna/dna_01.txt", "data/dna/dna_02.txt")
NC_034972 = ("data/dna/NC_034972.1.txt", "data/dna/mutated_NC_034972.1.txt")
# (route the pair must take, argv after -g / -c)
MAIN_PATH = [
    ("wavefront", [*DNA]),
    ("wavefront", ["-p", "data/protein/P04775.fasta",
                   "data/protein/P10635.fasta"]),
    ("direct", ["--protein", "--gap-penalty", "10", "--local",
                "data/protein/P08519.fasta", "data/protein/P10635.fasta"]),
    ("direct", ["--global", *NC_034972]),
    ("direct", ["--local", *NC_034972]),
    ("direct", ["--semi-global", *NC_034972]),
]
FULL_WIDTH = ["data/dna/NC_045839.txt", "data/dna/GCA_003434045.txt"]
# The checkpoint engine's full-width pair: both sequences past one strip.
LONG_PAIR = ["data/dna/AbHV_ORF111.txt", "data/dna/mutated_AbHV_ORF111.txt"]
# Text letters of phase 5's plain comparison, and the width of its late
# window (a power of two >= slots + 16: a checkpoint spacing).
PLAIN_DEPTH = 16384
WINDOW_COLS = 8192
# K1's checkpoint variants against their plain versions: rps, slots,
# ckpt_every, n.
CKPT_GEOMETRIES = ((16, 4096, 8192, 9000), (4, 1024, 2048, 5000),
                   (1, 128, 256, 3000))
# The checkpoint engine at forced small geometries (argv of
# parse_arguments, checkpointed_align's geometry): many tiles a path.
CKPT_MAIN_PATH = [
    ([*NC_034972], dict(rps=4, slots=1024, ckpt_cols=2048)),
    (["-p", "data/protein/P33450.fasta", "data/protein/mutated_P33450.fasta"],
     dict(rps=1, slots=128, ckpt_cols=256)),
]

# The strip engine's pairs at real size (phase 17): one K5 launch of
# 7,296 rows x 49,152 columns, and a tiled fill of 2 strips x 4 blocks.
SINGLE_REGION = ["data/dna/GCA_003434045.txt", "data/dna/NC_001490.1.txt"]
TILED_PAIR = ["data/dna/GCA_003434045.txt", "data/dna/NC_024446.1.txt"]
STRIP_BIG = [["--global", *SINGLE_REGION], ["--local", *SINGLE_REGION],
             ["--global", *TILED_PAIR], ["--local", *TILED_PAIR]]
# K5 against its plain version (phase 16): strip widths, and the rows of
# the plain comparison (it steps once a row).
STRIP_WIDTHS = (1024, 32768, 49152, 65536)
STRIP_PLAIN_ROWS = 256
# K5 regions of many bands (phase 16): rows, columns; m and n fall
# inside a band and a block.
STRIP_BAND_REGIONS = ((2048, 4096),)
# K5's interior full-width block runs on at least this many SMs.
K5_MIN_SMS = 64
# Main-path K5 launches held whole against the plain version on their own
# inputs, (rows, width, row_base, strip_off, local, with_dirs): phase
# 17's single region of SINGLE_REGION in both modes; phase 18's interior
# block of the full-width run (strip 1, block 2) and its last block of
# its last strip (column n and row m late in it); and an interior block
# of the long pair's score-only fill (strip 3, block 5).
HELD_SINGLE = [(7296, 49152, 0, 0, local, True) for local in (False, True)]
HELD_FULL_INTERIOR = (8192, 32768, 16384, 32768, False, True)
HELD_FULL_LAST = (7680, 32768, 40960, 262144, False, True)
HELD_LONG = (16384, 32768, 81920, 98304, False, False)

MODES = {"global": {}, "local": {"local": True}, "semi": {"semi": True}}
# Runs of one K1 launch closure on the same inputs (repeat_launches).
REPEATS = 5
ALGO = {"global": 0, "local": 1, "semi": 2}
# Affine K1 and K2 against their plain versions (phase 13): rps, slots,
# ckpt_every, text letters with words, text letters score-only.
AFFINE_GEOMETRIES = ((16, 4096, 8192, 1200, 8500),
                     (4, 1024, 2048, 2000, 4500),
                     (1, 128, 256, 2000, 2000))
# Phase 13's (k, mode) cases at each geometry, with words and score-only.
# A K1 instance is set by rps, words or not, affine or not and whether
# the fill tracks a best cell (local and semi-global do, global does
# not); the alphabet and the costs are arguments.  So global DNA and
# local protein hold every instance, and semi-global DNA adds the linear
# costs through the affine kernel (extend == open, ``affine_costs``).
AFFINE_WORD_CASES = ((4, "global"), (23, "local"), (4, "semi"))
AFFINE_SCORE_CASES = ((4, "global"), (23, "local"))
# Tiles of a real affine phase-1 fill (phase 13): rps, slots, columns a
# tile, n, m, the (k, mode) cases, the tiles (strip, column tile, where).
# The first is the main path's tile geometry (rps 16 x 4096 slots, two
# strips), at 8192 columns a tile: its interior tile (the row-0 and
# column-0 tiles take the same instance, held at the other geometries).
AFFINE_TILES = ((0, 1, "row 0"), (1, 0, "column 0"), (1, 1, "interior"))
AFFINE_TILE_FILLS = (
    (16, 4096, 8192, 12000, 65536 + 1500, ((4, "global"),),
     AFFINE_TILES[2:]),
    (4, 1024, 2048, 5000, 6000, ((4, "global"), (23, "local")),
     AFFINE_TILES),
    (1, 128, 256, 1500, 600, AFFINE_WORD_CASES, AFFINE_TILES),
)
NC_018874 = ("data/dna/NC_018874.txt", "data/dna/mutated_NC_018874.txt")
DNA_AFFINE = ["--gap-penalty", "8", "--gap-extend", "2"]
# The affine main path through -g (phase 14): all take the direct route.
AFFINE_MAIN_PATH = [
    ["--global", *DNA_AFFINE, *NC_018874],
    ["--local", *DNA_AFFINE, *NC_018874],
    ["--semi-global", *DNA_AFFINE, *NC_018874],
    ["-p", "--gap-penalty", "11", "--gap-extend", "1", "--local",
     "data/protein/P08519.fasta", "data/protein/P10635.fasta"],
]
# The affine checkpoint engine at a forced small geometry (phase 14).
AFFINE_CKPT_PAIRS = (
    [*DNA_AFFINE, *NC_018874],
    ["-p", "--gap-penalty", "11", "--gap-extend", "1",
     "data/protein/P33450.fasta", "data/protein/mutated_P33450.fasta"],
)
AFFINE_CKPT_GEOMETRY = dict(rps=1, slots=128, ckpt_cols=256)
# Bundled pairs in the batch main path's mix (argv of parse_arguments).
BATCH_BUNDLED = {
    4: [["data/dna/NC_018874.txt", "data/dna/mutated_NC_018874.txt"],
        ["data/dna/GCA_003231495.txt", "data/dna/NC_001490.1.txt"]],
    23: [["-p", "data/protein/P28167.fasta",
          "data/protein/mutated_P28167.fasta"],
         ["-p", "data/protein/P33450.fasta",
          "data/protein/mutated_P33450.fasta"],
         ["-p", "data/protein/P56980.fasta", "data/protein/P10635.fasta"]],
}
# bench.py's sw_batch_fill: pairs, text and pattern length, seed.
SCORE_WIDTH = (8192, 512, 512, 42)
# scripts/bench_batch_e2e_metric.py (BASELINE.json's 64k-pair batch):
# pairs, length of both sequences, seed.
ALIGN_WIDTH = (65536, 256, 9)
# The local DNA matrix and gap of both workloads.
DNA_5_4 = np.where(np.eye(4, dtype=bool), 5, -4).astype(np.int32)
# Affine costs of the batch phases 20-22 (open, extend): phase 15's, the
# oracle's sa_align_affine costs.
BATCH_AFFINE = (8, 2)
# Affine costs of phase 19 by alphabet size, (open, extend): extend below
# open, and equal to it (the linear costs through the affine kernels).
BATCH_AFFINE_KERNEL_COSTS = {4: ((8, 2), (5, 5)), 23: ((11, 1), (10, 10))}
# K3 pairs whose stripes outnumber a CTA's warps (phases 6, 19, 23):
# pairs, text columns, pattern rows (130 stripes of 16 rows, so every
# variant's warps wrap over them: the last warp hands its rows to the
# first through the global scratch).
K3_WRAP = (256, 300, 2080)
# K3's costs there (open, extend) by phase: linear, affine, and the int16
# cells (whose gate admits open 5 at these widths, not open 8).
K3_WRAP_COSTS = {"6": ((5, None),), "19": ((8, 2),),
                 "23": ((5, None), (5, 2))}
# The K3 rows' times before the chain of warps, one pair (K3-cell16: two)
# a thread (PERF.md section 6; NVIDIA H100 80GB HBM3, 700 W): each launch
# alone at phases 8, 9, 21, 22 and 24's shapes.
K3_BEFORE_MS = {
    "K3-score": 6.878, "K3-dirs": 2.062, "K3-affine-score": 13.368,
    "K3-affine-dirs": 2.895, "K3-cell16-score": 4.927,
    "K3-cell16-dirs": 7.806, "K3-cell16-affine-score": 5.386,
    "K3-cell16-affine-dirs": 8.580}
# The longest K3 launch of the ragged mixes (phases 7, 20, 24) before
# the chain: a bundled 4,405 x 4,334 pair on one thread (PERF.md).
K3_RAGGED_BEFORE_MS = 1023.9


def log(*parts):
    print(*parts, flush=True)


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def in_thread(fn, *args):
    """Run fn(*args) in a daemon thread (native calls and subprocess
    pipes release the GIL); returns a function that waits and returns
    its value or raises its exception."""
    box = {}

    def run():
        try:
            box["value"] = fn(*args)
        except BaseException as e:  # handed to the caller by result()
            box["error"] = e

    thread = threading.Thread(target=run, daemon=True)
    thread.start()

    def result():
        thread.join()
        if "error" in box:
            raise box["error"]
        return box["value"]

    return result


class Subprocesses:
    """Subprocesses run beside the device phases; ``stop`` kills every
    one still running."""

    def __init__(self):
        self._procs = []

    def start(self, argv, env=None):
        proc = subprocess.Popen(
            argv, cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True,
        )
        self._procs.append(proc)

        def wait():
            out, err = proc.communicate()
            return proc.returncode, out, err

        return in_thread(wait)

    def stop(self):
        for proc in self._procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def port_cli(flag, argv):
    return [sys.executable, "-m", "seqalign_torch", flag, *argv]


def launches():
    return {"K1": wavefront.wavefront_strip.launches,
            "K2": walk.walk_skewed_window.launches}


def reset_launches():
    wavefront.wavefront_strip.launches = 0
    walk.walk_skewed_window.launches = 0


def run_cli(argv):
    """``cli.main`` in this process, stdout captured: (rc, stdout)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["alignSequence", *argv])
    torch.cuda.synchronize()
    return rc, out.getvalue()


def score_matrix(k):
    path = ("scoreMatrices/dna/blast.txt" if k == 4
            else "scoreMatrices/protein/blosum62.txt")
    sm = np.zeros((k, k), dtype=np.int32)
    check(parse_score_matrix_file(path, k, sm) == 0, f"cannot read {path}")
    return sm


def max_abs_err(got, want):
    """Largest |a - b| over pairs of int32 tensors of equal shape (words
    compared as int32), in chunks to bound the int64 temporaries."""
    err = 0
    chunk = 1 << 26
    for a, b in zip(got, want):
        if a is None or b is None:  # an output neither computed
            check(a is None and b is None, "an output only one computed")
            continue
        check(a.shape == b.shape, f"shape {tuple(a.shape)} != "
                                  f"{tuple(b.shape)}")
        a, b = a.reshape(-1), b.reshape(-1)
        for s in range(0, a.numel(), chunk):
            d = (a[s:s + chunk].long() - b[s:s + chunk].long()).abs().max()
            err = max(err, int(d))
    return err


# Device time of every launch made on behalf of a user entry point, by
# phase and kernel row (install_ledger): the launch closures a module's
# kernel_launch returns to a call under the CLI's engine, BatchAligner,
# the tiled score fill or the checkpoint engine are timed between CUDA
# events.  chip_smoke's own comparisons and timings call the wrappers or
# kernel_launch directly and are left out.  (phase, row, start, stop)
# each; PHASE[0] is the phase running (begin_phase).
LEDGER = []
PHASE = [""]
# The phases that run each workload of PERF.md's cells once through its
# user entry point: the full-width -g (5), the batch score and alignment
# workloads (8, 9; affine 21, 22; int16 cells, "24 width"), the long
# pair (12), both pairs affine (15), the strip engine's full-width -g in
# both walk modes and the long pair's tiled_fill_score (18).  The other
# phases run correctness mixes (4, 7, 11, 14, 17, 20, "24 mixes"), some
# of them more than once.
WORKLOAD_PHASES = ("5", "8", "9", "12", "15", "18", "21", "22", "24 width",
                   "33")
ENTRY_POINTS = (
    (os.path.join("seqalign_torch", "api.py"), None),
    (os.path.join("seqalign_torch", "models", "base.py"), "score"),
    (os.path.join("seqalign_torch", "bench", "suite.py"), None),
    (os.path.join("seqalign_torch", "parallel", "batch.py"), None),
    (os.path.join("seqalign_torch", "ops", "tiled.py"), "tiled_fill_score"),
    (os.path.join("seqalign_torch", "ops", "checkpoint.py"),
     "checkpointed_align"),
    (os.path.join("seqalign_torch", "parallel", "sequence.py"), None),
)


def begin_phase(label):
    """Tag the ledger's launches from here on with phase ``label``;
    returns the host clock."""
    PHASE[0] = label
    return time.time()


def on_main_path():
    frame = sys._getframe(2)
    while frame is not None:
        code = frame.f_code
        for path, name in ENTRY_POINTS:
            if code.co_filename.endswith(path) and name in (None,
                                                            code.co_name):
                return True
        frame = frame.f_back
    return False


def ledger_row(kernel, a):
    """The kernels line's row of a launch, from kernel_launch's (or K4's
    _launcher's) bound arguments ``a``."""
    if kernel == "K1":
        kind = ("-chunk" if a["ckpt_every"] and a["left_in"] is not None
                else "-ckpt" if a["ckpt_every"] else
                "-tile" if a["left_in"] is not None else "")
        return "K1" + ("-affine" if a["affine"] else "") + kind
    if kernel == "K2":
        return "K2-affine" if a["words2"] is not None else "K2"
    if kernel == "K3":
        return ("K3" + ("-cell16" if a["cell16"] else "")
                + ("-affine" if a["gap_extend"] is not None else "")
                + ("-dirs" if a["with_dirs"] else "-score"))
    if kernel == "K4":
        return "K4-affine" if a["dirs2"] is not None else "K4"
    return kernel  # K5, K4-packed


def install_ledger():
    """Wrap each kernel module's launch builder for the rest of the run
    (chip_smoke's other wrappers stack on top and restore it)."""
    for kernel, module, name in (
            ("K1", wavefront, "kernel_launch"), ("K2", walk, "kernel_launch"),
            ("K3", batch_fill, "kernel_launch"),
            ("K4", batch_traceback, "_launcher"),
            ("K4-packed", batch_traceback, "packed_launch"),
            ("K5", strip_fill, "kernel_launch")):
        real = getattr(module, name)
        sig = inspect.signature(real)

        def wrapped(*args, _real=real, _sig=sig, _kernel=kernel, **kwargs):
            launch, out = _real(*args, **kwargs)
            if not on_main_path():
                return launch, out
            bound = _sig.bind(*args, **kwargs)
            bound.apply_defaults()
            row = ledger_row(_kernel, bound.arguments)

            def timed_launch(_launch=launch):
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                _launch()
                stop.record()
                LEDGER.append((PHASE[0], row, start, stop))

            timed_launch.__dict__.update(launch.__dict__)
            return timed_launch, out

        setattr(module, name, wrapped)


def ledger_sums(phases=None):
    """{row: {"launches", "ms", "max_ms", "phases": {phase: [launches,
    ms, max_ms]}}} over LEDGER's launches in ``phases`` (None: all)."""
    torch.cuda.synchronize()
    sums = {}
    for phase, row, start, stop in LEDGER:
        if phases is not None and phase not in phases:
            continue
        ms = start.elapsed_time(stop)
        s = sums.setdefault(row, {"launches": 0, "ms": 0.0, "max_ms": 0.0,
                                  "phases": {}})
        s["launches"] += 1
        s["ms"] += ms
        s["max_ms"] = max(s["max_ms"], ms)
        p = s["phases"].setdefault(phase, [0, 0.0, 0.0])
        p[0] += 1
        p[1] += ms
        p[2] = max(p[2], ms)
    return sums


def cuda_ms(fn, *args, **kwargs):
    """(result, milliseconds) of one call, between CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn(*args, **kwargs)
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def ptxas_summary(path):
    """One line per kernel instantiation from ``nvcc -Xptxas -v``:
    registers, stack and spill bytes."""
    with open(path + ".log") as f:
        text = f.read()
    pattern = re.compile(
        r"Function properties for (\S+)\n\s+(\d+) bytes stack frame, "
        r"(\d+) bytes spill stores, (\d+) bytes spill loads\n"
        r"ptxas info\s+: Used (\d+) registers"
    )
    lines = []
    probes = []  # P2's instances, summarised in one line
    for name, stack, st, ld, regs in pattern.findall(text):
        args = re.search(r"ILi(\d+)ELi(\d+)ELi(\d+)ELb(\d)ELb(\d)ELb(\d)E",
                         name)
        if args:
            label = (f"<rps {args[1]}, lanes/slot {args[2]}, steps/iteration "
                     f"{args[3]}, track {args[4]}, dirs {args[5]}, "
                     f"affine {args[6]}>")
        elif args := re.search(r"strip_band_kernelILi(\d+)ELi(\d+)ELb(\d)"
                               r"ELb(\d)E", name):
            label = (f"<rows/lane {args[1]}, columns/iteration {args[2]}, "
                     f"local {args[3]}, dirs {args[4]}>")
        elif args := re.search(r"walk_window_kernelILi(\d+)ELi(\d+)ELi(\d+)"
                               r"ELb(\d)ELb(\d)E", name):
            label = (f"<rps {args[1]}, window {args[2]} slots x {args[3]} "
                     f"groups, affine {args[4]}, local {args[5]}>")
        elif args := re.search(r"interpair(?:16)?_kernelILi(\d)ELb(\d)ELb"
                               r"(\d)ELi(\d+)E", name):
            label = (f"<mode {args[1]}, dirs {args[2]}, "
                     f"affine {args[3]}, columns/block {args[4]}>")
        elif args := re.search(r"batch_walk_kernelILi(\d)ELb(\d)ELi(\d+)E",
                               name):
            label = f"<mode {args[1]}, affine {args[2]}, run {args[3]}>"
        elif args := re.search(r"packed_walk_kernelILi(\d+)ELi(\d+)ELb(\d)E",
                               name):
            label = (f"<window {args[1]} word rows x {args[2]} columns, "
                     f"local {args[3]}>")
        elif re.search(r"(apply|rate)_kernelILi\d+ELb\dE", name):
            probes.append((int(regs), int(st)))
            continue
        else:
            label = ""
        kernel = re.search(r"(wavefront_strip_kernel|walk_window_kernel|"
                           r"interpair16_kernel|interpair_kernel|"
                           r"batch_walk_kernel|packed_walk_kernel|"
                           r"strip_band_kernel|"
                           r"chase_shared|chase_global)", name)
        lines.append(f"  {kernel[1] if kernel else name}{label}: {regs} "
                     f"registers, stack {stack} B, spill stores {st} B, "
                     f"loads {ld} B")
    if probes:
        regs = [r for r, _ in probes]
        lines.append(f"  apply_kernel/rate_kernel: {len(probes)} instances, "
                     f"{min(regs)}-{max(regs)} registers, spill stores "
                     f"{max(st for _, st in probes)} B at most")
    return lines


def repeat_launches(what, want, text_steps, bottom_in, pattern_slots,
                    score_matrix, gap, n, m, i0, k_alpha, local=False,
                    with_dirs=True, rps=wavefront.ROWS_PER_SLOT, ckpt_every=0,
                    slots=wavefront.SLOTS, semi=False, left_in=None,
                    affine=False, ext=0, fbot_in=None, left_e=None,
                    times=REPEATS):
    """K1's launch closure run ``times`` times on the same inputs (the
    arguments of ``wavefront_strip``), each run bitwise equal to ``want``
    (the plain version's outputs), so all equal to each other.  Before
    each run the outputs but the checkpoints are poisoned, and before
    each run after the first the values of the bands' streams (not their
    tags) too: a run that read a stale stream entry or a ticket left from
    the run before would differ.  Returns the CTAs and the SMs they ran
    on (the last run)."""
    launch, out = wavefront.kernel_launch(
        text_steps, bottom_in, pattern_slots, score_matrix, gap, n, m, i0,
        k_alpha, local, rps, ckpt_every, slots, semi, left_in, affine=affine,
        ext=ext, fbot_in=fbot_in, left_e=left_e)
    streams = launch.scratch[wavefront.SCRATCH_COUNTERS // 2:]
    poisoned = [x for i, x in enumerate(out)
                if x is not None and i not in (5, 8)]
    for r in range(times):
        for x in poisoned:
            x.fill_(-12345)
        if r:
            streams.bitwise_xor_(0x5A5A5)
        launch()
        torch.cuda.synchronize()
        err = max_abs_err(out, want)
        check(err == 0, f"{what}: run {r + 1} of {times} of one launch "
                        f"closure: max_abs_err {err}")
    sms = len(set(_build.launch_sms(launch)))
    ctas = launch.ctas
    if slots == 4096:
        check(ctas > 1 and sms > 100, f"{what}: {ctas} CTAs on {sms} SMs")
    REPEATED.append((what, ctas, sms))
    log(f"{what}: {times} runs of one launch closure, each exact; "
        f"{ctas} CTAs on {sms} SMs")


# K1's repeat-launch checks (phases 2, 10, 13): (what, CTAs, SMs).
REPEATED = []


def strip_case(rng, n, m, k, rps, slots, local, semi, device):
    """Random one-strip inputs from row 0, as the JAX wrapper takes them,
    as tensors on ``device``."""
    text = rng.integers(0, k, n).astype(np.int32)
    pattern = rng.integers(0, k, m).astype(np.int32)
    steps = layout.steps_padded(n, slots)
    pat_pad = np.zeros(rps * slots, dtype=np.int32)
    pat_pad[:m] = pattern
    gap = 5 if k == 4 else 10
    bottom = layout.top_row(steps, gap, local or semi, "cpu").numpy()
    return gap, layout.from_reference_arrays(
        layout.text_steps(text, steps), bottom,
        layout.pattern_slots(pat_pad, rps, slots), score_matrix(k), k,
        device,
    )


def walk_start(out, n, m, rps, slots, local, semi):
    _, _, rowmax, argj, snap, _ = out
    _, bi, bj = direct.best_cell(rowmax, argj, snap, rps, slots, n, m,
                                 local, semi)
    return bi, bj


def tile_walk_start(out, b, c, rows, cols, slots, n, m, local):
    """K2's start in tile (b, c) re-filled as ``out``: its last real cell;
    local, the best cell of the tile's bottom row, as the last cell is
    mostly a STOP, where the walk makes no move."""
    i0, j0 = min((b + 1) * rows, m), min((c + 1) * cols, n)
    if local:
        width = min(cols, n - c * cols)
        last = out[1].reshape(-1)[slots - 1:slots - 1 + width]
        if int(last.max()) > 0:
            i0, j0 = (b + 1) * rows, c * cols + int(last.argmax()) + 1
    return i0, j0


def compare_walk(words, rps, i0, j0, local, max_moves, row_lo=0, col_lo=0,
                 words2=None, state0=0):
    """K2 and its plain version from (i0, j0), affine with words2 from
    state0: (max_abs_err, result)."""
    mv, res = walk.walk_skewed_window(words, rps, row_lo, col_lo, i0, j0,
                                      local, max_moves, words2, state0)
    torch.cuda.synchronize()
    mv_p, res_p = walk.walk_skewed_window_plain(words, rps, row_lo, col_lo,
                                                i0, j0, local, max_moves,
                                                words2, state0)
    used = -(-int(res_p[0]) // 16)
    err = max_abs_err([res, mv[:used]], [res_p, mv_p[:used]])
    return err, [int(x) for x in res.cpu()]


def phase_kernels(device="cuda", n=4000,
                  geometries=((8, 4096), (16, 4096), (8, 1024))):
    """Phases 2 and 3: K1 and K2 against their plain versions."""
    rng = np.random.default_rng(2024)
    k1_err = k2_err = 0
    for rps, slots in geometries:
        for k in (4, 23):
            for mode in ("global", "local", "semi"):
                local, semi = mode == "local", mode == "semi"
                m = rps * slots - 3
                gap, args = strip_case(rng, n, m, k, rps, slots, local,
                                       semi, device)
                kw = dict(local=local, rps=rps, slots=slots, semi=semi)
                t0 = time.time()
                out = wavefront.wavefront_strip(*args, gap, n, m, 0, k, **kw)
                torch.cuda.synchronize()
                t1 = time.time()
                plain = wavefront.wavefront_strip_plain(*args, gap, n, m, 0,
                                                        k, **kw)
                torch.cuda.synchronize()
                err = max_abs_err(out, plain)
                check(err == 0, f"K1 {mode} k={k} rps={rps} slots={slots}: "
                                f"max_abs_err {err}")
                k1_err = max(k1_err, err)
                if (rps, slots, k, mode) == (8, 4096, 4, "global"):
                    repeat_launches(f"K1 with words, rps {rps} x {slots}",
                                    plain, *args, gap, n, m, 0, k, **kw)
                i0, j0 = walk_start(out, n, m, rps, slots, local, semi)
                werr, res = compare_walk(out[0], rps, i0, j0, local,
                                         -(-(n + m + 1) // 16) * 16)
                check(werr == 0, f"K2 {mode} k={k} rps={rps}: max_abs_err "
                                 f"{werr}")
                # A buffer of 64 moves: the walk stops there, done = 0.
                terr, tres = compare_walk(out[0], rps, i0, j0, local, 64)
                check(terr == 0 and (res[0] <= 64 or tres[0] == 64
                                     and tres[4] == 0),
                      f"K2 {mode} k={k} rps={rps}: short buffer {tres}")
                k2_err = max(k2_err, werr, terr)
                log(f"K1 {mode:6s} k={k:2d} rps={rps:2d} slots={slots}: "
                    f"exact, kernel {t1 - t0:.3f} s, plain "
                    f"{time.time() - t1:.2f} s; K2 from ({i0}, {j0}): "
                    f"exact, {res[0]} moves")
    return k1_err, k2_err


def walk_window_check(lib, affine):
    """Phases 3 and 13: ``walk_shapes --check`` at the least window (8
    slots x 2 groups, so that each walk crosses dozens of windows), the
    linear or the affine cases, each exact against the plain walk."""
    rows = walk_shapes.check_walks(lib, smallest_only=True, affine=affine)
    bad = [row for row in rows if not row[-1]]
    check(rows and not bad, f"K2 at the least window differs: {bad}")
    log(f"K2 at the least window ({walk_shapes.SMALLEST[0]} slots x "
        f"{walk_shapes.SMALLEST[1]} groups, the probe's build): "
        f"{len(rows)} {'affine' if affine else 'linear'} walks at rps "
        f"{', '.join(map(str, walk.WINDOW_SHAPES))}, "
        f"{sum(row[3] for row in rows)} moves, each exact")


def repeat_walks(what, launch, out, want, times=REPEATS):
    """K2's launch closure run ``times`` times on the same words, its
    moves and result poisoned before each run, each run bitwise equal to
    the plain walk ``want`` (moves up to its count)."""
    mv, res = out
    used = -(-int(want[1][0]) // 16)
    for r in range(times):
        mv.fill_(-12345)
        res.fill_(-12345)
        launch()
        torch.cuda.synchronize()
        err = max_abs_err([res, mv[:used]], [want[1], want[0][:used]])
        check(err == 0, f"{what}: run {r + 1} of {times} of one launch "
                        f"closure: max_abs_err {err}")
    log(f"{what}: {times} runs of one launch closure, moves and result "
        f"poisoned before each, each exact")


def phase_main_path(oracle_outputs):
    """Phase 4: ``-g`` in process against the ``-c`` subprocess outputs;
    returns the launches per route."""
    reset_launches()
    by_route = {"wavefront": {"K1": 0, "K2": 0}, "direct": {"K1": 0, "K2": 0}}
    for (route, argv), oracle in zip(MAIN_PATH, oracle_outputs):
        before = launches()
        t0 = time.time()
        rc, out = run_cli(["-g", *argv])
        wall = time.time() - t0
        delta = {k: v - before[k] for k, v in launches().items()}
        rc_c, out_c, err_c = oracle()
        check(rc == 0 and rc_c == 0, f"{argv}: rc -g {rc}, -c {rc_c} "
                                     f"{err_c}")
        check(out == out_c, f"{argv}: -g output differs from -c")
        if route == "direct":
            check(delta == {"K1": 1, "K2": 1}, f"{argv}: launches {delta}, "
                                               f"not the direct route")
        else:
            check(delta["K1"] >= 1 and delta["K2"] == 0,
                  f"{argv}: launches {delta}, not the wavefront route")
        for kname in delta:
            by_route[route][kname] += delta[kname]
        score = out.rstrip("\n").rsplit("\t", 1)[-1]
        log(f"-g {' '.join(argv)}: {route} route, launches {delta}, "
            f"{wall:.2f} s, Score {score}, byte-identical to -c")
    total = launches()
    check(total["K1"] == sum(r["K1"] for r in by_route.values()) and
          total["K2"] == sum(r["K2"] for r in by_route.values()),
          "launch counts do not add up")
    return by_route


def parse_alignment(out):
    """The aligned text and pattern rows from the pretty report."""
    lines = out.split("\n")
    text, pattern = [], []
    i = 0
    while not lines[i].startswith("#"):
        text.append(lines[i].split()[1])
        pattern.append(lines[i + 2].split()[1])
        i += 4
    return "".join(text), "".join(pattern)


def rescore(aligned_text, aligned_pattern, alphabet, sm, gap):
    """Linear-gap score of an alignment (gap = the last letter)."""
    table = np.full(256, -1, dtype=np.int64)
    for idx, letter in enumerate(alphabet):
        table[ord(letter)] = idx
    a = table[np.frombuffer(aligned_text.encode(), dtype=np.uint8)]
    b = table[np.frombuffer(aligned_pattern.encode(), dtype=np.uint8)]
    check((a >= 0).all() and (b >= 0).all(), "unknown letter in the output")
    k = len(alphabet) - 1
    gaps = (a == k) | (b == k)
    check(not ((a == k) & (b == k)).any(), "a column of two gaps")
    return int(sm[a[~gaps], b[~gaps]].sum()) - gap * int(gaps.sum())


def late_window(words, text, pattern, sm, k, gap, rps, slots):
    """Deep cells of phase 5's run against the plain version: the last
    whole window of WINDOW_COLS columns, re-filled from the score-only
    fill's column checkpoint before it by K1 with the left column and by
    its plain version, whose words must equal ``words`` (the whole run's)
    there, cell for cell, but for the words that straddle a slot's window
    edges.  Global, one strip from row 0.  Returns (what was compared,
    max_abs_err)."""
    n, m = len(text), len(pattern)
    ck = checkpoint.checkpointed_fill(text, pattern, sm, k, gap,
                                      ckpt_cols=WINDOW_COLS, rps=rps,
                                      slots=slots, device=words.device)
    tiles = checkpoint.Tiles(ck, text, pattern, sm, k)
    c = n // WINDOW_COLS - 1
    c0 = c * WINDOW_COLS
    targs, tkw = tiles.strip_args(0, c)
    launch, out = wavefront.kernel_launch(*targs, False, rps, 0, slots, False,
                                          tkw["left_in"])
    launch()
    plain, plain_ms = timed(wavefront.wavefront_strip_plain, *targs, **tkw)
    err = max_abs_err(out, plain)
    del plain
    # Block w of a slot s holds steps 16w .. 16w+15, the columns c0 + 16w
    # - s + 1 .. c0 + 16w - s + 16, in the tile and at block c0/16 + w of
    # the whole run alike.
    blocks = tiles.tile_steps // 16
    check(c0 % 16 == 0 and c0 // 16 + blocks <= words.shape[0] // rps,
          "late window: past the run's words")
    w = 16 * torch.arange(blocks, device=words.device)[:, None]
    s = torch.arange(slots, device=words.device)[None, :]
    inside = ((w >= s) & (w + 16 <= WINDOW_COLS + s))[:, None, :]
    run = words.reshape(-1, rps, slots)[c0 // 16:c0 // 16 + blocks]
    diff = torch.where(inside, run.long() - out[0].reshape(blocks, rps,
                                                           slots).long(), 0)
    err = max(err, int(diff.abs().max()))
    cells = int(inside.sum()) * rps * 16
    return (f"the columns {c0 + 1}-{c0 + WINDOW_COLS} of its {rps * slots} "
            f"rows ({cells} cells), re-filled from the score-only fill's "
            f"column-{c0} checkpoint by K1 and by the plain version "
            f"({plain_ms:.0f} ms), equal to the run's words there"), err


def phase_full_width(oracle_score):
    """Phase 5: the full-width pair through -g, then each kernel timed
    at its shape and held against its plain version."""
    request = Request()
    check(cli.parse_arguments(["alignSequence", "-g", *FULL_WIDTH],
                              request, err=sys.stderr) == 0,
          "cannot read the full-width pair")
    text = np.asarray(request.text, dtype=np.int32)
    pattern = np.asarray(request.pattern, dtype=np.int32)
    n, m, k, gap = len(text), len(pattern), request.alphabet_size, \
        request.gap_penalty
    sm = layout.pack_score_matrix(request.score_matrix, k)
    rps, slots = direct._direct_geometry(m)
    check(direct.fits_direct(n, m), f"{m} x {n} does not fit the direct "
                                    f"route")

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.time()
    rc, out = run_cli(["-g", *FULL_WIDTH])
    wall = time.time() - t0
    counts = launches()
    peak = torch.cuda.max_memory_allocated()
    check(rc == 0, f"-g on the full-width pair: rc {rc}")
    check(counts == {"K1": 1, "K2": 1}, f"full width: launches {counts}")
    score = int(out.rstrip("\n").rsplit("\t", 1)[-1])
    aligned_text, aligned_pattern = parse_alignment(out)
    rescored = rescore(aligned_text, aligned_pattern, request.alphabet, sm,
                       gap)
    expected = oracle_score()
    check(score == expected == rescored,
          f"full width: -g Score {score}, oracle {expected}, rescored "
          f"{rescored}")
    log(f"full width {m} x {n} (rps {rps}, slots {slots}): -g wall "
        f"{wall:.2f} s, Score {score} == oracle score-only fill == "
        f"rescored alignment of {len(aligned_text)} columns; launches "
        f"{counts}; max_memory_allocated {peak} B")

    # Each kernel at this shape: CUDA-event time, then the plain version.
    ts, pat, sm_dev = direct.strip_inputs(text, pattern, sm, k, rps, slots,
                                          "cuda")
    bottom = layout.top_row(ts.numel(), gap, False, "cuda")
    args = (ts, bottom, pat, sm_dev, gap, n, m, 0, k)
    kw = dict(local=False, rps=rps, slots=slots, semi=False)
    # Each kernel's launch alone: outputs allocated before the events.
    launch, k1_out = wavefront.kernel_launch(*args, False, rps, 0, slots,
                                             False, None)
    _, k1_ms = cuda_ms(launch)
    max_moves = -(-(n + m + 1) // 16) * 16
    k2_launch, (mv, res) = walk.kernel_launch(k1_out[0], rps, 0, 0, m, n,
                                              False, max_moves)
    _, k2_ms = cuda_ms(k2_launch)
    moves = int(res[0])
    log(f"full width: K1 {k1_ms:.3f} ms, K2 {k2_ms:.3f} ms "
        f"({moves} moves), each launch alone, CUDA events")

    # K1 against its plain version at a smaller depth, the first
    # PLAIN_DEPTH letters of the text (the plain version steps once a
    # sweep step: the whole text takes it 100-130 s).
    ts_s, pat_s, _ = direct.strip_inputs(text[:PLAIN_DEPTH], pattern, sm, k,
                                         rps, slots, "cuda")
    args_s = (ts_s, layout.top_row(ts_s.numel(), gap, False, "cuda"), pat_s,
              sm_dev, gap, PLAIN_DEPTH, m, 0, k)
    launch, k1_small = wavefront.kernel_launch(*args_s, False, rps, 0, slots,
                                               False, None)
    launch()
    t1 = time.time()
    k1_plain = wavefront.wavefront_strip_plain(*args_s, **kw)
    torch.cuda.synchronize()
    k1_plain_ms = (time.time() - t1) * 1e3
    k1_err = max_abs_err(k1_small, k1_plain)
    check(k1_err == 0, f"full width: K1 max_abs_err {k1_err}")
    del k1_plain, k1_small
    t1 = time.time()
    mv_p, res_p = walk.walk_skewed_window_plain(k1_out[0], rps, 0, 0, m, n,
                                                False, max_moves)
    torch.cuda.synchronize()
    k2_plain_ms = (time.time() - t1) * 1e3
    used = -(-moves // 16)
    k2_err = max_abs_err([res, mv[:used]], [res_p, mv_p[:used]])
    check(k2_err == 0, f"full width: K2 max_abs_err {k2_err}")
    repeat_walks("full width: K2", k2_launch, (mv, res), (mv_p, res_p))
    plain_shape = (f"{m} x {PLAIN_DEPTH} (the text's first {PLAIN_DEPTH} "
                   f"letters), rps {rps}, slots {slots}, global")
    log(f"full width: plain K1 {k1_plain_ms:.1f} ms at a smaller depth, "
        f"{plain_shape}, plain K2 {k2_plain_ms:.1f} ms at full width; both "
        f"exact")
    window, werr = late_window(k1_out[0], text, pattern, sm, k, gap, rps,
                               slots)
    check(werr == 0, f"full width: K1's late window max_abs_err {werr}")
    log(f"full width: K1's late window, {window}; exact")
    k1_err = max(k1_err, werr)
    plain_shape += f"; and {window}"

    steps = ts.numel()
    cells = n * m
    k1_bytes = (4 * (2 * steps + rps * slots + k * k)       # inputs
                + cells // 4                                # 2-bit words
                + 4 * (steps + 2 * rps * slots + slots))    # stream, trackers
    k1_ops = cells * K1_OPS_PER_CELL
    k2_bytes = 4 * moves + 4 * used + 4 * 5   # one word per move, out
    k2_ops = moves * K2_OPS_PER_MOVE
    return {
        "shape": f"{m} x {n}, rps {rps}, slots {slots}, global",
        "wall_s": wall, "peak_bytes": peak, "counts": counts, "out": out,
        "K1": bound(k1_bytes, k1_ops) | {
            "ms": k1_ms, "plain_ms": k1_plain_ms, "err": k1_err,
            "plain_shape": plain_shape},
        "K2": bound(k2_bytes, k2_ops) | {
            "ms": k2_ms, "plain_ms": k2_plain_ms, "err": k2_err,
            "moves": moves},
    }


def batch_launches():
    return {"K3-score": batch_fill.batch_score.launches,
            "K3-dirs": batch_fill.batch_fill_dirs.launches,
            "K4": batch_traceback.batch_walk.launches,
            "K3-cell16-score": batch_fill.batch_score.cell16_launches,
            "K3-cell16-dirs": batch_fill.batch_fill_dirs.cell16_launches}


def reset_batch_launches():
    batch_fill.batch_score.launches = 0
    batch_fill.batch_fill_dirs.launches = 0
    batch_traceback.batch_walk.launches = 0
    batch_fill.batch_score.cell16_launches = 0
    batch_fill.batch_fill_dirs.cell16_launches = 0


BATCH_PLAIN = ((batch_fill, "batch_score_plain"),
               (batch_fill, "batch_fill_dirs_plain"),
               (batch_traceback, "batch_walk_plain"))
PAIR_PLAIN = ((wavefront, "wavefront_strip_plain"),
              (walk, "walk_skewed_window_plain"))


@contextlib.contextmanager
def plain_versions_forbidden(plain=BATCH_PLAIN):
    """Within the block a call of one of the kernels' plain versions
    named in ``plain`` raises: the wrappers look them up by name in their
    modules."""
    saved = []
    for module, name in plain:
        def refuse(*args, _name=name, **kwargs):
            raise AssertionError(f"{_name} ran on the main path")
        saved.append((module, name, getattr(module, name)))
        setattr(module, name, refuse)
    try:
        yield
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)


def timed(fn, *args, **kwargs):
    """(result, milliseconds) of one call, host clock, synchronised."""
    torch.cuda.synchronize()
    t0 = time.time()
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    return out, (time.time() - t0) * 1e3


def cuda_ms_best(fn, *args, reps=3, **kwargs):
    """(result of the last call, least milliseconds) over ``reps`` calls
    between CUDA events."""
    best = None
    for _ in range(reps):
        out, ms = cuda_ms(fn, *args, **kwargs)
        best = ms if best is None else min(best, ms)
    return out, best


def batch_case(rng, b, n, m, k, device):
    """A ragged batch as the JAX wrappers take it, as tensors on
    ``device``: the last eighth of the pairs are padding (ns = ms = 0)."""
    texts = rng.integers(0, k, (b, n)).astype(np.int8)
    patterns = rng.integers(0, k, (b, m)).astype(np.int8)
    ns = rng.integers(1, n + 1, b).astype(np.int32)
    ms = rng.integers(1, m - 2, b).astype(np.int32)
    ns[-b // 8:] = 0
    ms[-b // 8:] = 0
    return [torch.from_numpy(x).to(device)
            for x in (texts, patterns, ns, ms)]


def walk_starts(scores, bis, bjs, local):
    if local:
        matched = scores > 0
        return torch.where(matched, bis, 0), torch.where(matched, bjs, 0)
    return bis, bjs


def affine_walk_reads(packed, lengths, dirs2, bis, bjs, tile_pairs):
    """The 4-byte loads the local affine walks from (bis, bjs) need,
    worked out from their moves (``packed``, ``lengths``) and the run bits
    ``dirs2`` they read: the direction word of every move taken in state
    H, and the run bits of every LEFT or TOP move (in H they say whether a
    run starts, in a run whether it goes on).  A DIAG move leaves the walk
    in H, so its run bits are not needed; a move inside a run is forced,
    so its word is not.  Checks that each move inside a run repeats the
    move before it."""
    b = packed.shape[1]
    shifts = 2 * torch.arange(16, device=packed.device, dtype=torch.int32)
    moves = ((packed.t().unsqueeze(-1) >> shifts) & 3).reshape(b, -1)
    valid = (torch.arange(moves.shape[1], device=moves.device)
             < lengths.long().unsqueeze(1))
    left, diag, top = moves == 0, moves == 1, moves == 2
    # The cell each move starts from.
    up, back = (diag | top).long(), (diag | left).long()
    i = bis.long().unsqueeze(1) - (up.cumsum(1) - up)
    j = bjs.long().unsqueeze(1) - (back.cumsum(1) - back)
    tiles, num_w, n_cols = dirs2.shape[:3]
    ic = (i - 1).clamp(0, num_w * 16 - 1)
    jc = (j - 1).clamp(0, n_cols - 1)
    pair = torch.arange(b, device=moves.device).unsqueeze(1)
    tile, slot = pair // tile_pairs, pair % tile_pairs
    at = ((tile * num_w + ic // 16) * n_cols + jc) * tile_pairs + slot
    bits = (dirs2.reshape(-1)[at] >> (2 * (ic % 16)).int()) & 3
    gap_moves = valid & ~diag
    enters = gap_moves & ((left & (bits & 1 != 0)) | (top & (bits & 2 != 0)))
    in_run = enters[:, :-1] & valid[:, 1:]   # move t+1 is inside a run
    check(bool((moves[:, 1:] == moves[:, :-1])[in_run].all()),
          "a move inside a run is not the run's direction")
    return (int(valid.sum()) - int(in_run.sum())) + int(gap_moves.sum())


def repeat_k3_launches(what, args, kwargs, want, times=REPEATS):
    """K3's launch closure (``batch_fill.kernel_launch(*args,
    **kwargs)``) run ``times`` times on the same inputs, each run bitwise
    equal to ``want`` (the plain version's outputs).  Before each run the
    outputs and the global scratch the last warp hands to the first are
    poisoned: a run that read a stale scratch entry, or a ring entry
    before its warp wrote it, would differ."""
    launch, out = batch_fill.kernel_launch(*args, **kwargs)
    for r in range(times):
        for x in out:
            if x is not None:
                x.fill_(-12345)
        for x in launch.scratch:
            if x is not None:
                x.fill_(0x5A5A5 + r)
        launch()
        torch.cuda.synchronize()
        err = max_abs_err(out, want)
        check(err == 0, f"{what}: run {r + 1} of {times} of one launch "
                        f"closure: max_abs_err {err}")
    K3_REPEATED.append((what, launch.ctas, launch.warps))


# K3's repeat-launch checks (phases 6, 19, 23): (what, CTAs, warps).
K3_REPEATED = []


def k3_wrap_checks(rng, costs, ids, device="cuda", cell16=False):
    """K3 (``cell16``: K3-cell16) on K3_WRAP's pairs of DNA, where the
    stripes outnumber the warps: every output of the wrappers, score-only
    (``ids[0]``) and with words (``ids[1]``), against the plain versions
    in the three modes at each (open, extend) of ``costs``; then each
    launch closure REPEATS times (``repeat_k3_launches``).  Returns {id:
    max_abs_err}."""
    b, n, m = K3_WRAP
    sm_np = score_matrix(4)
    sm = torch.from_numpy(sm_np).to(device)
    errs = dict.fromkeys(ids, 0)
    for gap, ext in costs:
        check(not cell16 or batch_fill.int16_cells_ok(n, m, sm_np, 4, gap,
                                                      ext),
              f"K3 wrap case {gap}/{ext} outside the int16 gate")
        for mode, kw in MODES.items():
            texts, patterns, ns, ms = batch_case(rng, b, n, m, 4, device)
            ms[:16] = m - 3  # pairs through the last stripe
            for with_dirs in (False, True):
                kid = ids[with_dirs]
                tile = batch_fill.TILE_QUANTUM if with_dirs else None
                what = f"{kid} {mode} {gap}/{ext}: {b} pairs {m} x {n}"
                args = (texts, patterns, ns, ms, sm, gap, 4)
                common = dict(gap_extend=ext, cell16=cell16, **kw)
                if with_dirs:
                    got = batch_fill.batch_fill_dirs(*args, tile_pairs=tile,
                                                     **common)
                    torch.cuda.synchronize()
                    want = batch_fill.batch_fill_dirs_plain(
                        *args, tile_pairs=tile, **common)
                else:
                    got = (batch_fill.batch_score(*args, **common),)
                    torch.cuda.synchronize()
                    want = (batch_fill.batch_score_plain(*args, **common),)
                err = max_abs_err(got, want)
                check(err == 0, f"{what}: max_abs_err {err}")
                errs[kid] = max(errs[kid], err)
                repeat_k3_launches(
                    what, (*args, mode == "local", mode == "semi"),
                    dict(tile_pairs=tile, with_dirs=with_dirs,
                         gap_extend=ext, cell16=cell16), want)
                _, ctas, warps = K3_REPEATED[-1]
                log(f"{what}, {ctas} CTAs of {warps} warps (the stripes "
                    f"wrap): every output == the plain version's; "
                    f"{REPEATS} runs of one launch closure, outputs and "
                    f"scratch poisoned between them, each exact")
    return errs


def phase_batch_kernels(walk_lib, device="cuda", b=512, n=300, m=208,
                        affine=False):
    """Phase 6: K3 (both variants) and K4 against their plain versions,
    then K4's stress set (``k4_stress_checks``, through ``walk_lib``, the
    probe's all-shapes build); with ``affine``, phase 19: their affine
    instances (the run bits too), at BATCH_AFFINE_KERNEL_COSTS."""
    rng = np.random.default_rng(2027 if affine else 2026)
    ids = (("K3-affine-score", "K3-affine-dirs", "K4-affine") if affine
           else ("K3-score", "K3-dirs", "K4"))
    errs = dict.fromkeys(ids, 0)
    for k in (4, 23):
        sm = torch.from_numpy(score_matrix(k)).to(device)
        costs = (BATCH_AFFINE_KERNEL_COSTS[k] if affine
                 else ((5 if k == 4 else 10, None),))
        for mode, kw in MODES.items():
            for gap, ext in costs:
                what = f"{mode} k={k}" + (f" {gap}/{ext}" if affine else "")
                texts, patterns, ns, ms = batch_case(rng, b, n, m, k, device)
                # Score-only: a width that is not a multiple of 16.
                narrow = patterns[:, :m - 3].contiguous()
                got = batch_fill.batch_score(texts, narrow, ns, ms, sm, gap,
                                             k, gap_extend=ext, **kw)
                torch.cuda.synchronize()
                want = batch_fill.batch_score_plain(
                    texts, narrow, ns, ms, sm, gap, k, gap_extend=ext, **kw)
                err = max_abs_err([got], [want])
                check(err == 0, f"{ids[0]} {what}: max_abs_err {err}")
                errs[ids[0]] = max(errs[ids[0]], err)
                for tile in (128, 256):
                    out = batch_fill.batch_fill_dirs(
                        texts, patterns, ns, ms, sm, gap, k, tile_pairs=tile,
                        gap_extend=ext, **kw)
                    torch.cuda.synchronize()
                    plain = batch_fill.batch_fill_dirs_plain(
                        texts, patterns, ns, ms, sm, gap, k, tile_pairs=tile,
                        gap_extend=ext, **kw)
                    check(len(out) == (5 if affine else 4),
                          f"{ids[1]} {what}: {len(out)} outputs")
                    derr = max_abs_err(out, plain)
                    check(derr == 0, f"{ids[1]} {what} tile {tile}: "
                                     f"max_abs_err {derr}")
                    errs[ids[1]] = max(errs[ids[1]], derr)
                    bis, bjs = walk_starts(*out[:3], mode == "local")
                    dirs2 = out[4] if affine else None
                    moves = []
                    for max_len in (-(-(n + m) // 16) * 16, 64):
                        walk_args = (out[3], ns, ms, bis, bjs,
                                     mode == "local", mode == "semi",
                                     max_len)
                        wk = batch_traceback.batch_walk(*walk_args,
                                                        dirs2=dirs2)
                        torch.cuda.synchronize()
                        wp = batch_traceback.batch_walk_plain(*walk_args,
                                                              dirs2=dirs2)
                        werr = max_abs_err(wk, wp)
                        check(werr == 0, f"{ids[2]} {what} tile {tile} "
                                         f"max_len {max_len}: max_abs_err "
                                         f"{werr}")
                        errs[ids[2]] = max(errs[ids[2]], werr)
                        moves.append(int(wk[1].max()))
                    check(moves[1] == 64 or moves[0] <= 64,
                          f"{ids[2]} {what}: the 64-move buffer did not "
                          f"stop the longest walk ({moves})")
                    words = ("every word exact" if not affine else
                             f"every word and run-bit word exact "
                             f"({int((dirs2 != 0).sum())} run-bit words "
                             f"set)")
                    log(f"{'affine ' if affine else ''}K3 {mode:6s} "
                        f"k={k:2d}{f' {gap}/{ext}' if affine else ''} tile "
                        f"{tile}: {b} pairs {m} x {n}, scores, best cells "
                        f"and {words}; K4 exact, longest walk {moves[0]} "
                        f"moves")
    wrap = k3_wrap_checks(rng, K3_WRAP_COSTS["19" if affine else "6"],
                          ids[:2], device)
    for kid, err in wrap.items():
        errs[kid] = max(errs[kid], err)
    k4_stress_checks(walk_lib, affine)
    return errs


def k4_stress_checks(lib, affine):
    """K4's stress set (``batch_walk_shapes.check_batch`` at the least
    run, the linear or the affine cases): K3-filled ragged batches with
    padding pairs in the three modes and 64-move buffers, words packed
    from numpy with random, all-LEFT, all-TOP, all-DIAG and zig-zag paths
    and starts outside the words, through the production build and the
    probe's at run 1, each exact against the plain walk.  Then the
    production launch closure of the first K3-filled case REPEATS times,
    every output poisoned before each run: lengths and final cursors
    equal to the plain walk's, the move words up to each pair's last
    move equal, the words past it still the poison (the kernel leaves
    them as the caller gave them)."""
    what = f"K4{'-affine' if affine else ''}"
    rows = batch_walk_shapes.check_batch(lib, least_only=True, affine=affine)
    bad = [row for row in rows if not row[-1]]
    check(rows and not bad, f"{what} stress set differs: {bad}")
    log(f"{what} stress set (probes/batch_walk_shapes.py, the production "
        f"build and run {batch_walk_shapes.LEAST_RUN}): {len(rows)} walks "
        f"of {len({row[0] for row in rows})} batches, "
        f"{sum(row[2] for row in rows)} moves, each exact")
    (name, dirs, dirs2, ns, ms, bis, bjs, local, semi, max_len) = next(
        case for case in batch_walk_shapes.batch_cases(
            np.random.default_rng(12))
        if (case[2] is not None) == affine)
    want = batch_traceback.batch_walk_plain(dirs, ns, ms, bis, bjs, local,
                                            semi, max_len, dirs2=dirs2)
    launch, out = batch_traceback.kernel_launch(dirs, ns, ms, bis, bjs,
                                                local, semi, max_len,
                                                dirs2=dirs2)
    packed = out[0]
    words = torch.arange(packed.shape[0], device=packed.device)[:, None]
    used = words * 16 < want[1][None, :]
    for r in range(REPEATS):
        poison = -12345 - r
        for x in out:
            x.fill_(poison)
        launch()
        torch.cuda.synchronize()
        good = (all(torch.equal(x, y) for x, y in zip(out[1:], want[1:]))
                and torch.equal(packed[used], want[0][used])
                and bool((packed[~used] == poison).all()))
        check(good, f"{what} {name}: run {r + 1} of {REPEATS} of one launch "
                    f"closure differs")
    log(f"{what} {name}: {REPEATS} runs of one launch closure, every output "
        f"poisoned before each: lengths, cursors and moves exact, the words "
        f"past the last move untouched")


def read_request(argv):
    request = Request()
    check(cli.parse_arguments(["alignSequence", *argv], request) == 0,
          f"cannot read {argv}")
    return request


def read_pair(argv):
    request = read_request(argv)
    return (np.asarray(request.text, dtype=np.int32),
            np.asarray(request.pattern, dtype=np.int32))


def batch_mix(k, seed):
    """The batch main path's pairs: ragged random ones (1-700 letters,
    both orientations), the bundled pairs of BATCH_BUNDLED, and pairs
    with an empty text, pattern or both."""
    rng = np.random.default_rng(seed)
    texts, patterns = [], []
    for _ in range(160):
        texts.append(rng.integers(0, k, int(rng.integers(1, 700)))
                     .astype(np.int32))
        patterns.append(rng.integers(0, k, int(rng.integers(1, 700)))
                        .astype(np.int32))
    for argv in BATCH_BUNDLED[k]:
        text, pattern = read_pair(argv)
        texts += [text, pattern]
        patterns += [pattern, text]
    empty = np.zeros(0, np.int32)
    texts += [empty, texts[0], empty]
    patterns += [patterns[0], empty, empty]
    return texts, patterns


def batch_oracle(cases, costs=None):
    """The oracle's scores (score()'s default swap) and alignments of
    every case of the batch main path: linear gaps (5 for DNA, 10 for
    protein), or the affine (open, extend) ``costs``."""
    out = {}
    for (k, mode), (texts, patterns) in cases.items():
        sm = score_matrix(k)
        gap = 5 if k == 4 else 10
        scores, aligned = [], []
        for t, p in zip(texts, patterns):
            st, sp = (p, t) if len(t) < len(p) else (t, p)
            if costs is None:
                scores.append(bindings.oracle_fill(ALGO[mode], st, sp, sm, k,
                                                   gap)[1])
                aligned.append(bindings.oracle_align(ALGO[mode], t, p, sm,
                                                     k, gap))
            else:
                scores.append(bindings.oracle_fill_affine(
                    ALGO[mode], st, sp, sm, k, *costs)[0])
                aligned.append(bindings.oracle_align_affine(
                    ALGO[mode], t, p, sm, k, *costs))
        out[k, mode] = (scores, aligned)
    return out


def same_alignment(r, want):
    at, ap, st, sp, score = want
    return (r.score == score and r.start_in_aligned_text == st
            and r.start_in_aligned_pattern == sp
            and np.array_equal(r.aligned_text, at)
            and np.array_equal(r.aligned_pattern, ap))


def phase_batch_main_path(cases, oracle, device="cuda", costs=None):
    """Phase 7: BatchAligner.score and .align against the oracle; with the
    affine (open, extend) ``costs``, phase 20.  Returns the launches of
    the phase."""
    expected = oracle()
    fill, align = (("oracle_fill", "oracle_align") if costs is None
                   else ("oracle_fill_affine", "oracle_align_affine"))
    reset_batch_launches()
    with plain_versions_forbidden():
        for (k, mode), (texts, patterns) in cases.items():
            gap, ext = costs or (5 if k == 4 else 10, None)
            what = (f"batch {mode:6s} k={k:2d}" if costs is None else
                    f"affine batch {mode:6s} k={k:2d} {gap}/{ext}")
            aligner = BatchAligner(score_matrix(k), k, gap, gap_extend=ext,
                                   device=device, **MODES[mode])
            before = batch_launches()
            t0 = time.time()
            scores = aligner.score(texts, patterns)
            t1 = time.time()
            results = aligner.align(texts, patterns)
            t2 = time.time()
            delta = {kid: v - before[kid]
                     for kid, v in batch_launches().items()}
            want_scores, want_aligned = expected[k, mode]
            check(list(scores) == want_scores,
                  f"{what}: scores differ from {fill}")
            bad = [i for i, (r, w) in enumerate(zip(results, want_aligned))
                   if not same_alignment(r, w)]
            check(not bad, f"{what}: pairs {bad[:10]} differ from {align}")
            check(all(delta[kid] >= 1 for kid in ("K3-score", "K3-dirs",
                                                   "K4"))
                  and delta["K3-cell16-score"] == delta["K3-cell16-dirs"]
                  == 0, f"{what}: launches {delta}")
            log(f"{what}: {len(texts)} pairs, score {t1 - t0:.2f} s, align "
                f"{t2 - t1:.2f} s, launches {delta}; scores == {fill}, "
                f"alignments byte-identical to {align}")
    return batch_launches()


def score_width_data():
    b, n, m, seed = SCORE_WIDTH
    rng = np.random.default_rng(seed)
    texts = rng.integers(0, 4, (b, n)).astype(np.int32)
    patterns = rng.integers(0, 4, (b, m)).astype(np.int32)
    sample = np.sort(np.random.default_rng(7).choice(b, min(b, 512),
                                                     replace=False))
    return texts, patterns, sample


def align_width_data():
    b, size, seed = ALIGN_WIDTH
    rng = np.random.default_rng(seed)
    texts = [rng.integers(0, 4, size).astype(np.int32) for _ in range(b)]
    patterns = [rng.integers(0, 4, size).astype(np.int32) for _ in range(b)]
    sample = np.sort(np.random.default_rng(8).choice(b, min(b, 1024),
                                                     replace=False))
    return texts, patterns, sample


def phase_score_width(data, oracle_scores, device="cuda", costs=None,
                      linear=None, int32=None):
    """Phase 8: BatchAligner(local=True).score at bench.py's headline,
    then K3 at its bucket's shape against its plain version; with the
    affine (open, extend) ``costs``, phase 21, printed beside phase 8's
    result ``linear``.  With ``int32``, the result of phase 8 or 21 at the
    same costs, phase 24: the same under SEQALIGN_INT16_CELLS=1 through
    K3-cell16, every score equal to that run's, K3-cell16 timed beside
    its K3."""
    texts, patterns, sample = data
    b, n, m, _ = SCORE_WIDTH
    gap, ext = costs or (5, None)
    affine = costs is not None
    cell16 = int32 is not None
    kid32 = "K3-affine-score" if affine else "K3-score"
    kid = kid32.replace("K3-", "K3-cell16-") if cell16 else kid32
    what = f"affine score width ({gap}/{ext})" if affine else "score width"
    what = f"int16 {what}" if cell16 else what
    fill = "oracle_fill_affine" if affine else "oracle_fill"
    aligner = BatchAligner(DNA_5_4, 4, gap, local=True, gap_extend=ext,
                           device=device)
    reset_batch_launches()
    with plain_versions_forbidden(), environment(
            SEQALIGN_INT16_CELLS="1" if cell16 else "0"):
        scores, wall_ms = timed(aligner.score, list(texts), list(patterns))
    counts = batch_launches()
    check(counts == ({"K3-score": 0, "K3-dirs": 0, "K4": 0,
                      "K3-cell16-score": 1, "K3-cell16-dirs": 0} if cell16
                     else {"K3-score": 1, "K3-dirs": 0, "K4": 0,
                           "K3-cell16-score": 0, "K3-cell16-dirs": 0}),
          f"{what}: launches {counts}")
    want = oracle_scores()
    check(list(scores[sample]) == want,
          f"{what}: sampled scores differ from {fill}")
    if cell16:
        check(np.array_equal(scores, int32["scores"]),
              f"{what}: scores differ from the int32 run's")
    cells = b * n * m
    beside = (f" (linear, phase 8: {linear['wall_ms']:.1f} ms, "
              f"{linear['gcups_wall']:.2f} GCUPS)" if linear else "")
    if cell16:
        beside = (f" (int32: {int32['wall_ms']:.1f} ms, "
                  f"{int32['gcups_wall']:.2f} GCUPS)")
    log(f"{what} {b} pairs {m} x {n} local: wall {wall_ms:.1f} ms, "
        f"{cells / wall_ms / 1e6:.2f} GCUPS end to end{beside}, launches "
        f"{counts}; {len(sample)} sampled scores == {fill}"
        + ("; all scores == the int32 run's" if cell16 else ""))

    # K3 at the bucket's shape (the JAX buckets: n_pad = 639, m_pad = 512).
    n_pad = layout.padded_width(n) - 1
    m_pad = layout.padded_rows(m)
    t_arr = np.zeros((b, n_pad), np.int8)
    t_arr[:, :n] = texts
    p_arr = np.zeros((b, m_pad), np.int8)
    p_arr[:, :m] = patterns
    args = [torch.from_numpy(x).to(device) for x in (
        t_arr, p_arr, np.full(b, n, np.int32), np.full(b, m, np.int32))]
    sm = torch.from_numpy(DNA_5_4).to(device)
    # The kernel's launch alone: inputs transposed and outputs allocated
    # before the events.
    launch, (got, *_) = batch_fill.kernel_launch(
        *args, sm, gap, 4, True, False, tile_pairs=None, with_dirs=False,
        gap_extend=ext, cell16=cell16)
    _, k3_ms = cuda_ms_best(launch)
    check(np.array_equal(got.cpu().numpy(), scores),
          f"{what}: K3 differs from the BatchAligner run")
    plain, plain_ms = timed(batch_fill.batch_score_plain, *args, sm, gap, 4,
                            local=True, gap_extend=ext, cell16=cell16)
    err = max_abs_err([got], [plain])
    check(err == 0, f"{what}: {kid} max_abs_err {err}")
    beside = (f" (linear {linear['gcups_kernel']:.1f})" if linear else "")
    if cell16:
        k3_32 = int32[kid32]["ms"]
        beside = (f" (int32 K3 in phase {21 if affine else 8}: {k3_32:.3f} "
                  f"ms, {cells / k3_32 / 1e6:.1f} GCUPS; int16 / int32 = "
                  f"{k3_ms / k3_32:.3f})")
    log(f"{what}: {kid} {k3_ms:.3f} ms (its launch alone, CUDA events, "
        f"best of 3) = {cells / k3_ms / 1e6:.1f} GCUPS{beside}; row {kid} "
        f"before the chain of warps {K3_BEFORE_MS[kid]:.3f} ms, "
        f"{K3_BEFORE_MS[kid] / k3_ms:.2f}x this; plain {plain_ms:.1f} ms; "
        f"exact")
    nbytes = b * (n_pad + m_pad) + 3 * 4 * b   # letters, ns, ms, scores
    ops = K3_AFFINE_OPS_PER_CELL if affine else K3_OPS_PER_CELL
    return {
        "shape": f"{b} pairs, {m} x {n} in a {m_pad} x {n_pad} bucket, "
                 f"local DNA" + (f", open {gap} extend {ext}" if affine
                                 else "") + (", int16 cells" if cell16
                                             else ""),
        "wall_ms": wall_ms, "gcups_wall": cells / wall_ms / 1e6,
        "gcups_kernel": cells / k3_ms / 1e6, "counts": counts,
        "scores": scores,
        kid: bound(nbytes, cells * ops, packed=cell16) | {
            "ms": k3_ms, "plain_ms": plain_ms, "err": err},
    }


def phase_align_width(data, oracle_aligned, device="cuda", costs=None,
                      linear=None, int32=None):
    """Phase 9: BatchAligner(local=True).align on the 64k-pair workload,
    then K3 with words and K4 on one chunk against their plain versions;
    with the affine (open, extend) ``costs``, phase 22 (their affine
    instances), printed beside phase 9's result ``linear``.  With
    ``int32``, the result of phase 9 or 22 at the same costs, phase 24:
    the same under SEQALIGN_INT16_CELLS=1 through K3-cell16 (and K4 on its
    words), every alignment byte-identical to that run's, K3-cell16 timed
    beside its K3."""
    texts, patterns, sample = data
    b, size, _ = ALIGN_WIDTH
    gap, ext = costs or (5, None)
    affine = costs is not None
    cell16 = int32 is not None
    k3_32, k4 = (("K3-affine-dirs", "K4-affine") if affine
                 else ("K3-dirs", "K4"))
    k3 = k3_32.replace("K3-", "K3-cell16-") if cell16 else k3_32
    what = f"affine align width ({gap}/{ext})" if affine else "align width"
    what = f"int16 {what}" if cell16 else what
    align = "oracle_align_affine" if affine else "oracle_align"
    aligner = BatchAligner(DNA_5_4, 4, gap, local=True, gap_extend=ext,
                           device=device)
    tile, chunk = aligner._dirs_tile_pairs(size, size)
    chunk = min(chunk, b)
    chunks = -(-b // chunk)
    torch.cuda.reset_peak_memory_stats()
    reset_batch_launches()
    with plain_versions_forbidden(), environment(
            SEQALIGN_INT16_CELLS="1" if cell16 else "0"):
        results, wall_ms = timed(aligner.align, texts, patterns)
    counts = batch_launches()
    peak = torch.cuda.max_memory_allocated()
    check(counts == {"K3-score": 0, "K3-dirs": 0 if cell16 else chunks,
                     "K4": chunks, "K3-cell16-score": 0,
                     "K3-cell16-dirs": chunks if cell16 else 0},
          f"{what}: launches {counts}")
    want = oracle_aligned()
    bad = [int(i) for i, w in zip(sample, want)
           if not same_alignment(results[i], w)]
    check(not bad, f"{what}: pairs {bad[:10]} differ from {align}")
    if cell16:
        bad = [i for i, (r, w) in enumerate(zip(results, int32["results"]))
               if not same_alignment(r, (w.aligned_text, w.aligned_pattern,
                                         w.start_in_aligned_text,
                                         w.start_in_aligned_pattern,
                                         w.score))]
        check(not bad, f"{what}: pairs {bad[:10]} differ from the int32 "
                       f"run's")
    beside = (f" (linear, phase 9: {linear['wall_ms']:.1f} ms, "
              f"{linear['pairs_per_s']:.0f} pairs/s)" if linear else "")
    if cell16:
        beside = (f" (int32: {int32['wall_ms']:.1f} ms, "
                  f"{int32['pairs_per_s']:.0f} pairs/s)")
    log(f"{what} {b} pairs {size} x {size} local: wall {wall_ms:.1f} ms, "
        f"{b / wall_ms * 1e3:.0f} pairs/s{beside}, launches {counts}, "
        f"max_memory_allocated {peak} B; {len(sample)} sampled alignments "
        f"byte-identical to {align}"
        + ("; every alignment byte-identical to the int32 run's" if cell16
           else ""))

    # The first chunk, as align dispatches it.
    t_arr = np.stack(texts[:chunk]).astype(np.int8)
    p_arr = np.stack(patterns[:chunk]).astype(np.int8)
    ns = np.full(chunk, size, np.int32)
    args = [torch.from_numpy(x).to(device) for x in (t_arr, p_arr, ns, ns)]
    sm = torch.from_numpy(DNA_5_4).to(device)
    # Each kernel's launch alone: inputs prepared and outputs allocated
    # before the events.
    launch, timed_fill = batch_fill.kernel_launch(
        *args, sm, gap, 4, True, False, tile_pairs=tile, with_dirs=True,
        gap_extend=ext, cell16=cell16)
    _, k3_ms = cuda_ms_best(launch)
    # The wrappers on the same chunk (after the counts were read), held
    # against the timed launch, the plain versions and the aligner's run.
    out = batch_fill.batch_fill_dirs(*args, sm, gap, 4, local=True,
                                     tile_pairs=tile, gap_extend=ext,
                                     cell16=cell16)
    check(len(out) == len(timed_fill)
          and max_abs_err(out, timed_fill) == 0,
          f"{what}: batch_fill_dirs differs from its timed launch")
    del timed_fill
    bis, bjs = walk_starts(*out[:3], True)
    dirs2 = out[4] if affine else None
    max_len = 2 * size
    launch, timed_walk = batch_traceback.kernel_launch(
        out[3], args[2], args[3], bis, bjs, True, False, max_len,
        dirs2=dirs2)
    _, k4_ms = cuda_ms_best(launch)
    walked = batch_traceback.batch_walk(out[3], args[2], args[3], bis, bjs,
                                        True, False, max_len, dirs2=dirs2)
    check(max_abs_err(walked, timed_walk) == 0,
          f"{what}: batch_walk differs from its timed launch")
    del timed_walk
    plain, k3_plain_ms = timed(batch_fill.batch_fill_dirs_plain, *args, sm,
                               gap, 4, local=True, tile_pairs=tile,
                               gap_extend=ext, cell16=cell16)
    k3_err = max_abs_err(out, plain)
    check(k3_err == 0, f"{what}: {k3} max_abs_err {k3_err}")
    del plain
    walked_plain, k4_plain_ms = timed(
        batch_traceback.batch_walk_plain, out[3], args[2], args[3], bis, bjs,
        True, False, max_len, dirs2=dirs2)
    k4_err = max_abs_err(walked, walked_plain)
    check(k4_err == 0, f"{what}: K4 max_abs_err {k4_err}")
    # The aligner's first chunk is these pairs: its scores and its
    # alignments' columns (one a move) are the wrappers'.
    check([r.score for r in results[:chunk]] == out[0].tolist()
          and [len(r.aligned_text) for r in results[:chunk]]
          == walked[1].tolist(),
          f"{what}: the chunk's scores or moves differ from the aligner's")
    moves = int(walked[1].long().sum())
    cells = chunk * size * size
    beside = ""
    if cell16:
        k3_32_ms = int32[k3_32]["ms"]
        beside = (f" (int32 K3 in phase {22 if affine else 9}: "
                  f"{k3_32_ms:.3f} ms; int16 / int32 = "
                  f"{k3_ms / k3_32_ms:.3f})")
    log(f"{what}, one {chunk}-pair chunk: {k3} {k3_ms:.3f} ms "
        f"({cells / k3_ms / 1e6:.1f} GCUPS){beside}; row {k3} before the "
        f"chain of warps {K3_BEFORE_MS[k3]:.3f} ms, "
        f"{K3_BEFORE_MS[k3] / k3_ms:.2f}x this; K4 {k4_ms:.3f} ms "
        f"({moves} moves), each launch alone, CUDA events, best of 3; the "
        f"wrappers' outputs == the launches' == the plain versions' == the "
        f"aligner's scores and move counts; plain {k3} {k3_plain_ms:.1f} ms, "
        f"plain K4 {k4_plain_ms:.1f} ms")
    planes = 2 if affine else 1
    words = planes * chunk * (size // 16) * size
    # Letters, the word planes, scores and best cells.
    k3_bytes = chunk * 2 * size + 4 * words + 5 * 4 * chunk
    move_words = int((-(-walked[1].long() // 16)).sum())
    # A local walk reads one word a move; affine, see affine_walk_reads.
    # Then the moves written and 7 int32 a pair (ns, ms, starts, lengths,
    # final cursor).
    reads = (affine_walk_reads(walked[0], walked[1], dirs2, bis, bjs, tile)
             if affine else moves)
    k4_bytes = 4 * reads + 4 * move_words + 7 * 4 * chunk
    shape = (f"{chunk} pairs of {size} x {size} (one of {chunks} chunks), "
             f"local DNA" + (f", open {gap} extend {ext}" if affine else "")
             + (", int16 cells" if cell16 else ""))
    k3_ops = K3_AFFINE_DIRS_OPS_PER_CELL if affine else K3_DIRS_OPS_PER_CELL
    k4_ops = K4_AFFINE_OPS_PER_MOVE if affine else K4_OPS_PER_MOVE
    return {
        "wall_ms": wall_ms, "pairs_per_s": b / wall_ms * 1e3,
        "peak_bytes": peak, "counts": counts, "results": results,
        k3: bound(k3_bytes, cells * k3_ops, packed=cell16) | {
            "ms": k3_ms, "plain_ms": k3_plain_ms, "err": k3_err,
            "shape": shape},
        k4: bound(k4_bytes, moves * k4_ops) | {
            "ms": k4_ms, "plain_ms": k4_plain_ms, "err": k4_err,
            "shape": shape + f", {moves} moves, {reads} 4-byte reads",
            # A pair's words lie tile_pairs x 4 B apart: each read is a
            # 32-byte sector of its own.
            "floor_ms": reads * 32 / HBM_BYTES_PER_S * 1e3,
            "floor_by": "sectors"},
    }


def int16_real(got16, got32, ns, what):
    """K3-cell16 against the int32 K3 on the same inputs: every output
    equal, except the scores of padding pairs (ns = 0), NEG_16 where the
    int32 kernel gives NEG_INF (0 both for local)."""
    pad = ns == 0
    for i, (a, b) in enumerate(zip(got16, got32)):
        if i == 0:
            check(torch.equal(a[~pad], b[~pad]),
                  f"{what}: scores differ from the int32 K3's")
            check(bool(((a[pad] == batch_fill.NEG_16)
                        & (b[pad] == batch_fill.NEG_INF)
                        | (a[pad] == 0) & (b[pad] == 0)).all()),
                  f"{what}: padding scores are not NEG_16 / NEG_INF")
        else:
            check(torch.equal(a, b), f"{what}: output {i} differs from "
                                     f"the int32 K3's")


def phase_cell16_kernels(device="cuda", b=512, n=300, m=208):
    """Phase 23: K3-cell16 (score-only and with words, linear and affine)
    against its plain version and against the int32 K3, on phase 6's and
    19's cases (an odd batch score-only), then the near-cap case, then
    the wrapping pairs (``k3_wrap_checks``)."""
    rng = np.random.default_rng(2028)
    ids = ("K3-cell16-score", "K3-cell16-dirs", "K3-cell16-affine-score",
           "K3-cell16-affine-dirs")
    errs = dict.fromkeys(ids, 0)
    cases = []
    for k in (4, 23):
        sm = score_matrix(k)
        costs = (((5 if k == 4 else 10), None),
                 *BATCH_AFFINE_KERNEL_COSTS[k])
        for mode in MODES:
            for gap, ext in costs:
                cases.append((k, sm, mode, gap, ext, b, n, m))
    # +-127 at the largest shape the gate admits with gap 127 (the JAX
    # package's test_int16_near_cap_exact).
    near = np.where(np.eye(4, dtype=bool), 127, -127).astype(np.int32)
    cases += [(4, near, mode, 127, None, 256, 48, 32) for mode in MODES]
    for k, sm_np, mode, gap, ext, bb, nn, mm in cases:
        check(batch_fill.int16_cells_ok(nn, mm, sm_np, k, gap, ext),
              f"int16 case {k} {mode} {gap}/{ext} outside the gate")
        sm = torch.from_numpy(sm_np).to(device)
        kw = MODES[mode]
        kid_s, kid_d = ids[2:] if ext is not None else ids[:2]
        what = f"K3-cell16 {mode} k={k} {gap}/{ext} {mm} x {nn}"
        texts, patterns, ns, ms = batch_case(rng, bb, nn, mm, k, device)
        if bb == 256:  # near cap: every real pair whole
            ns[:bb - bb // 8] = nn
            ms[:bb - bb // 8] = mm
        # Score-only: an odd batch (one padding pair added on the card)
        # and a width that is not a multiple of 16.
        sargs = (texts[1:], patterns[1:, :mm - 3].contiguous(), ns[1:],
                 ms[1:].clamp(max=mm - 3))
        got = batch_fill.batch_score(*sargs, sm, gap, k, gap_extend=ext,
                                     cell16=True, **kw)
        torch.cuda.synchronize()
        plain = batch_fill.batch_score_plain(*sargs, sm, gap, k,
                                             gap_extend=ext, cell16=True,
                                             **kw)
        err = max_abs_err([got], [plain])
        check(err == 0, f"{what} score: max_abs_err {err}")
        errs[kid_s] = max(errs[kid_s], err)
        int16_real([got], [batch_fill.batch_score(
            *sargs, sm, gap, k, gap_extend=ext, **kw)], sargs[2],
            f"{what} score")
        for tile in (128, 256):
            if bb % tile:
                continue
            out = batch_fill.batch_fill_dirs(
                texts, patterns, ns, ms, sm, gap, k, tile_pairs=tile,
                gap_extend=ext, cell16=True, **kw)
            torch.cuda.synchronize()
            plain = batch_fill.batch_fill_dirs_plain(
                texts, patterns, ns, ms, sm, gap, k, tile_pairs=tile,
                gap_extend=ext, cell16=True, **kw)
            check(len(out) == len(plain) == (4 if ext is None else 5),
                  f"{what}: {len(out)} outputs")
            derr = max_abs_err(out, plain)
            check(derr == 0, f"{what} tile {tile}: max_abs_err {derr}")
            errs[kid_d] = max(errs[kid_d], derr)
            int16_real(out, batch_fill.batch_fill_dirs(
                texts, patterns, ns, ms, sm, gap, k, tile_pairs=tile,
                gap_extend=ext, **kw), ns, f"{what} tile {tile}")
        log(f"{what}: {bb} pairs, scores (odd batch), best cells, words"
            f"{' and run bits' if ext is not None else ''} == the plain "
            f"version's and the int32 K3's (padding scores NEG_16)")
    for kids, costs in ((ids[:2], K3_WRAP_COSTS["23"][:1]),
                        (ids[2:], K3_WRAP_COSTS["23"][1:])):
        wrap = k3_wrap_checks(rng, costs, kids, device, cell16=True)
        for kid, err in wrap.items():
            errs[kid] = max(errs[kid], err)
    return errs


def int16_routes():
    """A spy on the batch fills' launches: (function, n_cols, m_rows,
    cell16) of every K3 launch the wrappers prepare in the block (through
    ``batch_fill.kernel_launch``, so the wrappers and their counters stay
    as they are).  Returns (routes, restore)."""
    routes = []
    real = batch_fill.kernel_launch

    def spy(texts, patterns, *args, **kwargs):
        routes.append(("batch_fill_dirs" if kwargs["with_dirs"]
                       else "batch_score", texts.shape[1], patterns.shape[1],
                       kwargs.get("cell16", False)))
        return real(texts, patterns, *args, **kwargs)

    batch_fill.kernel_launch = spy

    def restore():
        batch_fill.kernel_launch = real

    return routes, restore


def align_pad(length):
    return max(128, -(-length // 128) * 128)


def phase_cell16_main_path(cases, oracle, device="cuda", costs=None):
    """Phase 24, the mix: BatchAligner.score and .align on phase 7's mix
    (phase 20's with the affine ``costs``) under SEQALIGN_INT16_CELLS=1,
    which must refuse the buckets int16_cells_ok does not admit with the
    JAX ValueError, then under auto: each bucket takes K3-cell16 exactly
    when the gate admits its padded shape (a spy on the wrappers, and the
    launch counters), and every score and alignment equals the oracle's,
    as the int32 run's of phase 7 (20) do.  Returns the launches."""
    expected = oracle()
    message = ("SEQALIGN_INT16_CELLS=1 but the padded shapes/scores exceed "
               "the int16 value cap (int16_cells_ok is False)")
    reset_batch_launches()
    for (k, mode), (texts, patterns) in cases.items():
        gap, ext = costs or (5 if k == 4 else 10, None)
        sm = score_matrix(k)
        what = f"int16 batch {mode:6s} k={k:2d} {gap}/{ext}"
        aligner = BatchAligner(sm, k, gap, gap_extend=ext, device=device,
                               **MODES[mode])
        # The gate on each bucket's padded shape: score's (the swapped
        # pair's padded_width - 1 x padded_rows) and align's (both
        # lengths to 128).
        admits = {"batch_score": {}, "batch_fill_dirs": {}}
        for t, p in zip(texts, patterns):
            if not (len(t) and len(p)):
                continue
            st, sp = (p, t) if len(t) < len(p) else (t, p)
            for fn, shape in (("batch_score",
                               (layout.padded_width(len(st)) - 1,
                                layout.padded_rows(len(sp)))),
                              ("batch_fill_dirs",
                               (align_pad(len(t)), align_pad(len(p))))):
                admits[fn][shape] = batch_fill.int16_cells_ok(
                    *shape, sm, k, gap, ext)
        with environment(SEQALIGN_INT16_CELLS="1"):
            for fn, gate in ((aligner.score, admits["batch_score"]),
                             (aligner.align, admits["batch_fill_dirs"])):
                try:
                    fn(texts, patterns)
                    refused = None
                except ValueError as e:
                    refused = str(e)
                check(refused == (None if all(gate.values()) else message),
                      f"{what}: {fn.__name__} under 1 gave {refused!r}")
        before = batch_launches()
        routes, restore = int16_routes()
        try:
            with plain_versions_forbidden(), environment(
                    SEQALIGN_INT16_CELLS="auto"):
                t0 = time.time()
                scores = aligner.score(texts, patterns)
                t1 = time.time()
                results = aligner.align(texts, patterns)
                t2 = time.time()
        finally:
            restore()
        delta = {kid: v - before[kid] for kid, v in batch_launches().items()}
        check(all(c == admits[f][n, m] for f, n, m, c in routes),
              f"{what}: routes {routes} differ from the gate")
        took = {(f, c): sum(1 for r in routes if r[0] == f and r[3] == c)
                for f in ("batch_score", "batch_fill_dirs")
                for c in (False, True)}
        check(delta == {"K3-score": took["batch_score", False],
                        "K3-cell16-score": took["batch_score", True],
                        "K3-dirs": took["batch_fill_dirs", False],
                        "K3-cell16-dirs": took["batch_fill_dirs", True],
                        "K4": took["batch_fill_dirs", False]
                        + took["batch_fill_dirs", True]},
              f"{what}: launches {delta}, routes {took}")
        want_scores, want_aligned = expected[k, mode]
        check(list(scores) == want_scores, f"{what}: scores differ")
        bad = [i for i, (r, w) in enumerate(zip(results, want_aligned))
               if not same_alignment(r, w)]
        check(not bad, f"{what}: pairs {bad[:10]} differ from the oracle")
        shapes = {f: f"{sum(g.values())} of {len(g)}"
                  for f, g in admits.items()}
        log(f"{what}: the gate admits {shapes['batch_score']} score and "
            f"{shapes['batch_fill_dirs']} align bucket shapes (under 1 the "
            f"rest refused); under auto score {t1 - t0:.2f} s, align "
            f"{t2 - t1:.2f} s, launches {delta}; scores and alignments == "
            f"the oracle's")
    return batch_launches()


def phase_dpx16():
    """Phase 25: P2, every variant of probes/dpx16.py: the apply kernel
    on 2^24 random words and the rate kernel against their plain
    versions, and the rate kernel timed.  Returns its kernels-line row."""
    dpx16.apply.launches = 0
    dpx16.rate_launch.launches = 0
    results = dpx16.run()
    launches = dpx16.apply.launches + dpx16.rate_launch.launches
    for line in dpx16.report(results):
        log(line)
    # The rate kernels' loop instructions: a one-instruction op shows
    # about 1.09 an op (the loop's counter, compare and branch besides).
    for line in dpx16.sass_report(dpx16.sass_counts()):
        log(line)
    by_name = {r["name"]: r for r in results}
    dpx_ops = 2 * by_name["viaddmax_s32"]["gops"] * 1e9
    log(f"P2: __viaddmax_s32 (two operations an instruction) runs "
        f"{dpx_ops / 1e12:.2f} T int32 operations a second, "
        f"{100 * dpx_ops / INT32_OPS_PER_S:.1f} % of the bounds' "
        f"{INT32_OPS_PER_S / 1e12:.2f} T")
    fails = [r["name"] for r in results if not r["exact"]]
    # The apply kernels' work: three words read and one written a word.
    nbytes = sum(4 * 4 * r["words"] for r in results)
    row = bound(nbytes, 0) | {
        "ms": sum(r["apply_ms"] for r in results),
        "plain_ms": sum(r["plain_ms"] for r in results),
        "err": len(fails), "launches": launches,
        "shape": f"{len(results)} variants x {results[0]['words']} words "
                 f"(apply kernels, summed)"}
    log(json.dumps({"dpx16": [{key: r[key] for key in (
        "name", "exact", "bad", "gops", "rate_ms", "apply_ms", "plain_ms")}
        for r in results]}))
    return row, fails


def phase_chase():
    """Phase 26: P1, the dependent chain over each table of
    probes/walk_costs.py against its plain version, timed.  Returns its
    kernels-line row (the 32 KiB shared-memory table, the K2 design
    question) and the results."""
    walk_costs.chase.launches = 0
    results = walk_costs.run()
    for r in results:
        log(f"P1 chase, {r['name']}: {r['ns_per_step']:.1f} ns a step "
            f"({r['ms']:.3f} ms for {r['steps']} steps, CUDA events, best "
            f"of 3), acc {r['acc']} {'==' if r['exact'] else '!='} the "
            f"plain version's {r['want']} ({r['plain_ms']:.0f} ms)")
        check(r["exact"], f"P1 {r['name']}: acc differs from the plain "
                          f"version's")
    first = results[0]
    # The table read once, acc written; six integer operations a step
    # (the load's address, the add, the two masks and shift, the count).
    row = bound(first["bytes"] + 4, 6 * first["steps"]) | {
        "ms": first["ms"], "plain_ms": first["plain_ms"], "err": 0,
        "launches": walk_costs.chase.launches,
        "shape": f"{first['steps']} steps over a {first['name']} table",
        "shared_ns_per_step": first["ns_per_step"]}
    log(json.dumps({"chase": [{key: r[key] for key in (
        "name", "bytes", "steps", "ms", "ns_per_step", "plain_ms")}
        for r in results]}))
    return row


def strip_bytes(steps, rps, slots, k, num_ckpts=0, left=False,
                words=False):
    """Bytes a K1 launch must move: its inputs read once (text, top row,
    pattern, matrix, left column), its outputs written once (bottom row,
    trackers, snap, checkpoints, 2-bit words)."""
    rows = rps * slots
    inputs = 4 * (2 * steps + rows + k * k + (rows + slots if left else 0))
    outputs = 4 * (steps + 2 * rows + slots + num_ckpts * rows)
    return inputs + outputs + (steps * rows // 4 if words else 0)


def phase_ckpt_kernels(device="cuda"):
    """Phase 10: K1's checkpoint-engine variants against their plain
    versions: score-only with checkpoints, and with words from a left
    column on tiles of a real phase-1 fill (K2 walking each of them)."""
    rng = np.random.default_rng(2027)
    k1_err = k2_err = 0
    for rps, slots, every, n in CKPT_GEOMETRIES:
        for k in (4, 23):
            for mode in MODES:
                local, semi = mode == "local", mode == "semi"
                m = rps * slots - 3
                gap, args = strip_case(rng, n, m, k, rps, slots, local,
                                       semi, device)
                kw = dict(local=local, with_dirs=False, rps=rps,
                          ckpt_every=every, slots=slots, semi=semi)
                t0 = time.time()
                out = wavefront.wavefront_strip(*args, gap, n, m, 0, k, **kw)
                torch.cuda.synchronize()
                t1 = time.time()
                plain = wavefront.wavefront_strip_plain(*args, gap, n, m, 0,
                                                        k, **kw)
                torch.cuda.synchronize()
                # Every output, each checkpoint entry included (0 where a
                # slot does not reach the column within the steps).
                err = max_abs_err(out, plain)
                check(err == 0 and out[0] is None and out[5] is not None,
                      f"K1 score-only {mode} k={k} rps={rps} slots={slots}:"
                      f" max_abs_err {err}")
                k1_err = max(k1_err, err)
                if (rps, slots, k, mode) == (16, 4096, 4, "global"):
                    repeat_launches(f"K1 score-only, rps {rps} x {slots}",
                                    plain, *args, gap, n, m, 0, k, **kw)
                log(f"K1 score-only, checkpoints every {every}, {mode:6s} "
                    f"k={k:2d} rps={rps:2d} slots={slots}: exact "
                    f"({out[5].shape[0] // rps} columns), kernel "
                    f"{t1 - t0:.3f} s, plain {time.time() - t1:.2f} s")
    # Tiles of a phase-1 fill at rps 4 x 1024 slots, 2048 columns: 2
    # strips x 3 column tiles.
    n, m, cols = 5000, 6000, 2048
    for k in (4, 23):
        for mode, kw in MODES.items():
            text = rng.integers(0, k, n).astype(np.int32)
            pattern = rng.integers(0, k, m).astype(np.int32)
            sm = score_matrix(k)
            gap = 5 if k == 4 else 10
            ck = checkpoint.checkpointed_fill(
                text, pattern, sm, k, gap, ckpt_cols=cols, rps=4, slots=1024,
                device=device, **kw)
            tiles = checkpoint.Tiles(ck, text, pattern, sm, k)
            for b, c, where in ((0, 1, "row 0"), (1, 0, "column 0"),
                                (1, 1, "interior")):
                args, tkw = tiles.strip_args(b, c)
                t0 = time.time()
                out = wavefront.wavefront_strip(*args, **tkw)
                torch.cuda.synchronize()
                t1 = time.time()
                plain = wavefront.wavefront_strip_plain(*args, **tkw)
                torch.cuda.synchronize()
                err = max_abs_err(out, plain)
                check(err == 0, f"K1 tile {where} {mode} k={k}: max_abs_err "
                                f"{err}")
                k1_err = max(k1_err, err)
                if (k, mode, where) == (4, "global", "interior"):
                    repeat_launches("K1 tile, left column, rps 4 x 1024",
                                    plain, *args, **tkw)
                i0, j0 = tile_walk_start(out, b, c, tiles.rows, cols,
                                         tiles.slots, n, m, mode == "local")
                werr, res = compare_walk(out[0], 4, i0, j0, mode == "local",
                                         tiles.rows + cols + 1,
                                         b * tiles.rows, c * cols)
                check(werr == 0, f"K2 tile {where} {mode} k={k}: "
                                 f"max_abs_err {werr}")
                k2_err = max(k2_err, werr)
                log(f"K1 tile ({b}, {c}) in {where:8s} {mode:6s} k={k:2d}, "
                    f"left column and words: exact, kernel {t1 - t0:.3f} "
                    f"s, plain {time.time() - t1:.2f} s; K2 from ({i0}, "
                    f"{j0}): exact, {res[0]} moves")
    return k1_err, k2_err


def ckpt_oracle(cases):
    return {key: bindings.oracle_align(ALGO[key[1]], *case[:5])
            for key, case in cases.items()}


def ckpt_cases():
    """Phase 11's alignments: (argv index, mode) -> (text, pattern,
    matrix, k, gap, geometry)."""
    cases = {}
    for idx, (argv, geom) in enumerate(CKPT_MAIN_PATH):
        request = read_request(argv)
        k = request.alphabet_size
        for mode in MODES:
            cases[idx, mode] = (
                np.asarray(request.text, dtype=np.int32),
                np.asarray(request.pattern, dtype=np.int32),
                layout.pack_score_matrix(request.score_matrix, k), k,
                request.gap_penalty, geom)
    return cases


def phase_ckpt_main_path(cases, oracle, device="cuda"):
    """Phase 11: checkpointed_align at forced small geometries against
    oracle_align; returns the launches of the phase."""
    expected = oracle()
    reset_launches()
    with plain_versions_forbidden(PAIR_PLAIN):
        for key, (text, pattern, sm, k, gap, geom) in cases.items():
            mode = key[1]
            before = launches()
            t0 = time.time()
            score, bi, bj, at, ap, st, sp = checkpoint.checkpointed_align(
                text, pattern, sm, k, gap, device=device, **geom,
                **MODES[mode])
            torch.cuda.synchronize()
            wall = time.time() - t0
            delta = {kid: v - before[kid] for kid, v in launches().items()}
            wat, wap, wst, wsp, wscore = expected[key]
            check(score == wscore and (st, sp) == (wst, wsp)
                  and np.array_equal(at, wat) and np.array_equal(ap, wap),
                  f"checkpoint engine {CKPT_MAIN_PATH[key[0]][0]} {mode}: "
                  f"differs from oracle_align")
            strips = -(-len(pattern) // (geom["rps"] * geom["slots"]))
            check(delta["K2"] >= 2 and delta["K1"] == strips + delta["K2"],
                  f"checkpoint engine {mode}: launches {delta}, {strips} "
                  f"strips")
            log(f"checkpoint engine {len(pattern)} x {len(text)} {mode:6s} "
                f"k={k:2d} {geom}: {wall:.2f} s, Score {score}, {strips} "
                f"strips, {delta['K2']} path tiles, launches {delta}; "
                f"byte-identical to oracle_align")
    return launches()


def phase_long_pair(oracle_score, device="cuda"):
    """Phase 12: the checkpoint engine at full width through -g, then a
    phase-1 strip and a path tile of its fill timed and held against
    their plain versions."""
    request = read_request(["-g", *LONG_PAIR])
    text = np.asarray(request.text, dtype=np.int32)
    pattern = np.asarray(request.pattern, dtype=np.int32)
    n, m, k, gap = len(text), len(pattern), request.alphabet_size, \
        request.gap_penalty
    sm = layout.pack_score_matrix(request.score_matrix, k)
    rps, slots = checkpoint._pick_geometry(m, None, None)
    rows, cols = rps * slots, checkpoint.DEFAULT_CKPT_COLS
    strips = -(-m // rows)
    check(not direct.fits_direct(n, m), f"{m} x {n} fits the direct route")

    # The two phases' times, and the fill for the kernel timings below.
    seen = {}
    real_fill = checkpoint.checkpointed_fill
    real_traceback = checkpoint.checkpointed_traceback

    def fill(*args, **kwargs):
        t0 = time.time()
        seen["ck"] = real_fill(*args, **kwargs)
        torch.cuda.synchronize()
        seen["phase1_s"] = time.time() - t0
        return seen["ck"]

    def traceback(*args, **kwargs):
        t0 = time.time()
        out = real_traceback(*args, **kwargs)
        torch.cuda.synchronize()
        seen["phase2_s"] = time.time() - t0
        return out

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    checkpoint.checkpointed_fill = fill
    checkpoint.checkpointed_traceback = traceback
    try:
        with plain_versions_forbidden(PAIR_PLAIN):
            t0 = time.time()
            rc, out = run_cli(["-g", *LONG_PAIR])
            wall = time.time() - t0
    finally:
        checkpoint.checkpointed_fill = real_fill
        checkpoint.checkpointed_traceback = real_traceback
    counts = launches()
    peak = torch.cuda.max_memory_allocated()
    check(rc == 0, f"-g on the long pair: rc {rc}")
    tiles_crossed = counts["K2"]
    check(tiles_crossed >= 1 and counts["K1"] == strips + tiles_crossed,
          f"long pair: launches {counts}, {strips} strips")
    score = int(out.rstrip("\n").rsplit("\t", 1)[-1])
    aligned_text, aligned_pattern = parse_alignment(out)
    rescored = rescore(aligned_text, aligned_pattern, request.alphabet, sm,
                       gap)
    expected = oracle_score()
    check(score == expected == rescored,
          f"long pair: -g Score {score}, oracle {expected}, rescored "
          f"{rescored}")
    log(f"long pair {m} x {n} (rps {rps}, slots {slots}, {cols} columns a "
        f"tile): -g wall {wall:.2f} s, phase 1 {seen['phase1_s']:.2f} s "
        f"({strips} strips), phase 2 {seen['phase2_s']:.2f} s "
        f"({tiles_crossed} path tiles), Score {score} == oracle score-only "
        f"fill == rescored alignment of {len(aligned_text)} columns; "
        f"launches {counts}; max_memory_allocated {peak} B")

    # One phase-1 strip (strip 1, below the bottom row of strip 0): its
    # launch alone, then its plain version.
    ck = seen.pop("ck")
    steps = layout.steps_padded(n, slots)
    pat_pad = np.zeros(strips * rows, dtype=np.int32)
    pat_pad[:m] = pattern
    args = (torch.as_tensor(layout.text_steps(text, steps)).to(device),
            ck.boundaries[0][:steps].reshape(-1, layout.STEPS),
            torch.as_tensor(layout.pattern_slots(pat_pad[rows:2 * rows], rps,
                                                 slots)).to(device),
            torch.as_tensor(sm).to(device), gap, n, m, rows, k)
    kw = dict(local=False, with_dirs=False, rps=rps, ckpt_every=cols,
              slots=slots, semi=False)
    launch, strip_out = wavefront.kernel_launch(*args, False, rps, cols,
                                                slots, False, None)
    _, ckpt_ms = cuda_ms_best(launch, reps=2)
    check(torch.equal(strip_out[5].reshape(-1, rps, slots).transpose(1, 2)
                      .reshape(-1, rows), ck.colvals[1])
          and torch.equal(strip_out[1].reshape(-1)[slots - 1:],
                          ck.boundaries[1][:steps - slots + 1]),
          "long pair: strip 1 differs from the run's own fill")
    # The plain version at a smaller depth: the strip's first cols +
    # slots text letters, past its first checkpoint column (the whole
    # strip takes it 42-47 s).
    depth = cols + slots
    steps_s = layout.steps_padded(depth, slots)
    args_s = (args[0][:steps_s // layout.STEPS],
              args[1][:steps_s // layout.STEPS], *args[2:5], depth,
              *args[6:])
    launch, small = wavefront.kernel_launch(*args_s, False, rps, cols, slots,
                                            False, None)
    launch()
    plain, ckpt_plain_ms = timed(wavefront.wavefront_strip_plain, *args_s,
                                 **kw)
    ckpt_err = max_abs_err(small, plain)
    check(ckpt_err == 0, f"long pair: K1 score-only max_abs_err {ckpt_err}")
    del plain, small
    ckpt_plain_shape = (f"strip 1, {rows} x {steps_s} steps (the text's "
                        f"first {depth} letters)")
    log(f"long pair, one phase-1 strip ({rows} x {steps} steps): K1 "
        f"score-only with checkpoints {ckpt_ms:.3f} ms (its launch alone, "
        f"CUDA events, best of 2); plain {ckpt_plain_ms:.1f} ms at a "
        f"smaller depth, {ckpt_plain_shape}; exact")

    # One full-size interior tile of the path's band (strip 1, column
    # tile 2), re-filled from the run's checkpoints: K1 with the left
    # column and words, then K2 from the middle of the tile.
    tiles = checkpoint.Tiles(ck, text, pattern, sm, k)
    b, c = 1, 2
    targs, tkw = tiles.strip_args(b, c)
    launch, tile_out = wavefront.kernel_launch(*targs, False, rps, 0, slots,
                                               False, tkw["left_in"])
    _, tile_ms = cuda_ms_best(launch, reps=2)
    i0, j0 = b * rows + rows // 2, c * cols + cols // 2
    max_moves = rows + cols + 1
    launch, (mv, res) = walk.kernel_launch(tile_out[0], rps, b * rows,
                                           c * cols, i0, j0, False, max_moves)
    _, walk_ms = cuda_ms(launch)
    plain, tile_plain_ms = timed(wavefront.wavefront_strip_plain, *targs,
                                 **tkw)
    tile_err = max_abs_err(tile_out, plain)
    check(tile_err == 0, f"long pair: K1 tile max_abs_err {tile_err}")
    del plain
    # The tile's bottom row is the one phase 1 computed score-only at its
    # columns: through the tile, the plain version holds strip 1 there.
    check(torch.equal(tile_out[1].reshape(-1)[slots - 1:slots - 1 + cols],
                      ck.boundaries[b][c * cols:(c + 1) * cols]),
          "long pair: the tile's bottom row differs from phase 1's")
    werr, wres = compare_walk(tile_out[0], rps, i0, j0, False, max_moves,
                              b * rows, c * cols)
    check(werr == 0 and [int(x) for x in res.cpu()] == wres,
          f"long pair: K2 in the tile max_abs_err {werr}")
    log(f"long pair, one path tile ({rows} x {tiles.tile_steps} steps, tile "
        f"({b}, {c})): K1 with the left column and words {tile_ms:.3f} ms, "
        f"K2 from ({i0}, {j0}) {walk_ms:.3f} ms ({wres[0]} moves), each "
        f"launch alone, CUDA events; plain K1 {tile_plain_ms:.1f} ms; both "
        f"exact, and the tile's bottom row equal to phase 1's strip {b} at "
        f"the columns {c * cols + 1}-{(c + 1) * cols}")

    # The host's share of a path tile: Tiles.walk from the same cell (the
    # tile's inputs, both launches, the read-back of K2's result and
    # moves, the unpacking) on the host's clock, less the two launches'
    # CUDA-event times; then the read-back and unpacking alone.
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        moves, _, _, _, _ = tiles.walk(i0, j0)
        walls.append((time.perf_counter() - t0) * 1e3)
    check(len(moves) == wres[0], f"long pair: Tiles.walk made {len(moves)} "
          f"moves, K2 alone {wres[0]}")
    tile_wall_ms = min(walls)
    host_ms = tile_wall_ms - tile_ms - walk_ms
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    count = res.tolist()[0]
    walk.unpack_moves(mv[:-(-count // 16)].cpu().numpy(), count)
    readback_ms = (time.perf_counter() - t0) * 1e3
    phase2_rest_ms = seen["phase2_s"] * 1e3 - tiles_crossed * tile_ms
    log(f"long pair, host share of a path tile: Tiles.walk {tile_wall_ms:.3f} "
        f"ms (host clock, best of 2) - K1 {tile_ms:.3f} ms - K2 "
        f"{walk_ms:.3f} ms = {host_ms:.3f} ms; K2's result and "
        f"{count} moves read back and unpacked in {readback_ms:.3f} ms; "
        f"phase 2 less {tiles_crossed} x K1 tile = {phase2_rest_ms:.1f} ms "
        f"(its K2 walks, Tiles set-up, host work)")

    real_cells = rows * n
    tile_cells = min(rows, m - b * rows) * min(cols, n - c * cols)
    return {
        "out": out, "wall_s": wall, "phase1_s": seen["phase1_s"],
        "phase2_s": seen["phase2_s"], "strips": strips, "strip_steps": steps,
        "tiles": tiles_crossed, "peak_bytes": peak, "counts": counts,
        "tile_host_ms": host_ms, "readback_ms": readback_ms,
        "phase2_rest_ms": phase2_rest_ms, "k2_tile_ms": walk_ms,
        "k2_tile_moves": wres[0],
        "K1-ckpt": bound(strip_bytes(steps, rps, slots, k,
                                     ck.colvals[1].shape[0]),
                         real_cells * K1_SCORE_OPS_PER_CELL) | {
            "ms": ckpt_ms, "plain_ms": ckpt_plain_ms, "err": ckpt_err,
            "plain_shape": ckpt_plain_shape,
            "shape": f"one strip of {rows} x {steps} steps of {m} x {n}, "
                     f"checkpoints every {cols}, global"},
        "K1-tile": bound(strip_bytes(tiles.tile_steps, rps, slots, k,
                                     left=True, words=True),
                         tile_cells * K1_OPS_PER_CELL) | {
            "ms": tile_ms, "plain_ms": tile_plain_ms, "err": tile_err,
            "shape": f"one tile of {rows} x {tiles.tile_steps} steps of "
                     f"{m} x {n}, left column and words, global"},
    }


def affine_costs(k, mode):
    """(open, extend) of phase 13's cases: extend == open (the linear
    costs) in semi-global DNA, extend < open elsewhere."""
    if k == 4:
        return (5, 5) if mode == "semi" else (8, 2)
    return 11, 1


def affine_strip_case(rng, n, m, k, rps, slots, local, semi, gap, ext,
                      device):
    """Random one-strip inputs from row 0 with the affine top rows of H
    and F, as tensors on ``device``: (args, fbot_in)."""
    text = rng.integers(0, k, n).astype(np.int32)
    pattern = rng.integers(0, k, m).astype(np.int32)
    steps = layout.steps_padded(n, slots)
    pat_pad = np.zeros(rps * slots, dtype=np.int32)
    pat_pad[:m] = pattern
    bottom = layout.top_row(steps, gap, local or semi, "cpu", ext=ext).numpy()
    args = layout.from_reference_arrays(
        layout.text_steps(text, steps), bottom,
        layout.pattern_slots(pat_pad, rps, slots), score_matrix(k), k,
        device)
    fbot = torch.full_like(args[1], wavefront.NEG_HALF)
    return args, fbot


def compare_affine_walks(words, words2, rps, i0, j0, local, max_moves,
                         row_lo=0, col_lo=0):
    """Affine K2 against its plain version from (i0, j0) in the three gap
    states, and from state 0 with a buffer of 64 moves: (max_abs_err,
    moves of the state-0 walk)."""
    moves = None
    for state0 in (0, 1, 2):
        err, res = compare_walk(words, rps, i0, j0, local, max_moves,
                                row_lo, col_lo, words2, state0)
        check(err == 0, f"K2 affine from ({i0}, {j0}) state {state0}: "
                        f"max_abs_err {err}")
        moves = res[0] if moves is None else moves
    # A buffer of 64 moves: the walk stops there, done = 0.
    err, res = compare_walk(words, rps, i0, j0, local, 64, row_lo, col_lo,
                            words2, 0)
    check(err == 0 and (moves <= 64 or res[0] == 64 and res[4] == 0),
          f"K2 affine from ({i0}, {j0}): short buffer {res}")
    return err, moves


def phase_affine_kernels(device="cuda"):
    """Phase 13: affine K1 (with words, score-only with checkpoints, with
    a left column) and affine K2 against their plain versions.  Returns
    the errors and, at rps 16 x 4096 and on the first tile, the plain
    versions' times."""
    rng = np.random.default_rng(2028)
    errs = dict.fromkeys(("K1-affine", "K1-affine-ckpt", "K1-affine-tile",
                          "K2-affine"), 0)
    plain = {}
    for rps, slots, every, n_words, n_ckpt in AFFINE_GEOMETRIES:
        for k, mode in AFFINE_WORD_CASES:
            local, semi = mode == "local", mode == "semi"
            gap, ext = affine_costs(k, mode)
            m = rps * slots - 3
            tag = (f"{mode:6s} k={k:2d} rps={rps:2d} slots={slots} "
                   f"open {gap} extend {ext}")
            args, fbot = affine_strip_case(rng, n_words, m, k, rps, slots,
                                           local, semi, gap, ext, device)
            kw = dict(local=local, rps=rps, slots=slots, semi=semi,
                      affine=True, ext=ext, fbot_in=fbot)
            out, ms = timed(wavefront.wavefront_strip, *args, gap,
                            n_words, m, 0, k, **kw)
            want, plain_ms = timed(wavefront.wavefront_strip_plain,
                                   *args, gap, n_words, m, 0, k, **kw)
            err = max_abs_err(out, want)
            check(err == 0 and out[6] is not None,
                  f"K1 affine {tag}: max_abs_err {err}")
            if (rps, k, mode) == (16, 4, "global"):
                repeat_launches(f"K1 affine with words, rps {rps} x "
                                f"{slots}", want, *args, gap, n_words, m,
                                0, k, **kw)
            del want
            i0, j0 = walk_start(out[:6], n_words, m, rps, slots, local,
                                semi)
            max_moves = -(-(n_words + m + 1) // 16) * 16
            t0 = time.time()
            werr, moves = compare_affine_walks(out[0], out[6], rps, i0,
                                               j0, local, max_moves)
            walks_s = time.time() - t0
            errs["K1-affine"] = max(errs["K1-affine"], err)
            errs["K2-affine"] = max(errs["K2-affine"], werr)
            if rps == 16 and "K1-affine" not in plain:
                # The plain walk's time: one walk from state 0.
                _, walk_ms = timed(walk.walk_skewed_window_plain, out[0],
                                   rps, 0, 0, i0, j0, local, max_moves,
                                   out[6], 0)
                shape = f"{m} x {n_words}, rps {rps}, slots {slots}"
                plain["K1-affine"] = (plain_ms, f"{shape}, {mode}")
                plain["K2-affine"] = (walk_ms, f"{moves} moves of the "
                                               f"words of {shape}")
            log(f"K1 affine with words {tag}: exact (kernel {ms:.1f} "
                f"ms, plain {plain_ms:.0f} ms); K2 from ({i0}, {j0}) in "
                f"states 0-2 and with 64 moves: exact, {moves} moves "
                f"({walks_s:.1f} s)")

            if (k, mode) not in AFFINE_SCORE_CASES:
                continue
            args, fbot = affine_strip_case(rng, n_ckpt, m, k, rps, slots,
                                           local, semi, gap, ext, device)
            kw.update(with_dirs=False, ckpt_every=every, fbot_in=fbot)
            out, ms = timed(wavefront.wavefront_strip, *args, gap,
                            n_ckpt, m, 0, k, **kw)
            want, plain_ms = timed(wavefront.wavefront_strip_plain,
                                   *args, gap, n_ckpt, m, 0, k, **kw)
            # Every output, each checkpoint entry of H and E included
            # (0 where a slot does not reach the column).
            err = max_abs_err(out, want)
            check(err == 0 and out[0] is None and out[6] is None
                  and out[8] is not None,
                  f"K1 affine score-only {tag}: max_abs_err {err}")
            if (rps, k, mode) == (16, 4, "global"):
                repeat_launches(f"K1 affine score-only, rps {rps} x "
                                f"{slots}", want, *args, gap, n_ckpt, m,
                                0, k, **kw)
            del want
            errs["K1-affine-ckpt"] = max(errs["K1-affine-ckpt"], err)
            if rps == 16 and "K1-affine-ckpt" not in plain:
                plain["K1-affine-ckpt"] = (
                    plain_ms, f"{m} x {n_ckpt}, rps {rps}, slots "
                              f"{slots}, checkpoints every {every}, "
                              f"{mode}")
            log(f"K1 affine score-only, checkpoints every {every}, "
                f"{tag}: exact ({out[5].shape[0] // rps} columns of H "
                f"and E; kernel {ms:.1f} ms, plain {plain_ms:.0f} ms)")
    # Tiles of real affine phase-1 fills: row 0, column 0, interior.
    for rps, slots, cols, n, m, cases, positions in AFFINE_TILE_FILLS:
        rows = rps * slots
        for k, mode in cases:
            gap, ext = affine_costs(k, mode)
            text = rng.integers(0, k, n).astype(np.int32)
            pattern = rng.integers(0, k, m).astype(np.int32)
            sm = score_matrix(k)
            ck = checkpoint.checkpointed_fill(
                text, pattern, sm, k, gap, gap_extend=ext, ckpt_cols=cols,
                rps=rps, slots=slots, device=device, **MODES[mode])
            tiles = checkpoint.Tiles(ck, text, pattern, sm, k)
            for b, c, where in positions:
                args, tkw = tiles.strip_args(b, c)
                out, ms = timed(wavefront.wavefront_strip, *args, **tkw)
                want, plain_ms = timed(wavefront.wavefront_strip_plain, *args,
                                       **tkw)
                err = max_abs_err(out, want)
                check(err == 0, f"K1 affine tile {where} {mode} k={k}: "
                                f"max_abs_err {err}")
                if rps == 16 and where == "interior":
                    repeat_launches(f"K1 affine tile, left columns, rps {rps}"
                                    f" x {slots}", want, *args, **tkw)
                del want
                errs["K1-affine-tile"] = max(errs["K1-affine-tile"], err)
                if where == "interior" and "K1-affine-tile" not in plain:
                    plain["K1-affine-tile"] = (
                        plain_ms, f"interior tile ({b}, {c}) of {rows} x "
                                  f"{tiles.tile_steps} steps of {m} x {n}, "
                                  f"{mode}, rps {rps}, slots {slots}")
                i0, j0 = tile_walk_start(out, b, c, rows, cols, slots, n, m,
                                         mode == "local")
                werr, moves = compare_affine_walks(
                    out[0], out[6], rps, i0, j0, mode == "local",
                    rows + cols + 1, b * rows, c * cols)
                errs["K2-affine"] = max(errs["K2-affine"], werr)
                log(f"K1 affine tile ({b}, {c}) in {where:8s} {mode:6s} "
                    f"k={k:2d} rps={rps} slots={slots}, left columns of H "
                    f"and E, top rows of H and F: exact (kernel {ms:.1f} "
                    f"ms, plain {plain_ms:.0f} ms); K2 from ({i0}, {j0}) in "
                    f"states 0-2 and with 64 moves: exact, {moves} moves")
    return errs, plain


def affine_ckpt_cases():
    """Phase 14's checkpoint-engine alignments: (pair index, mode) ->
    (text, pattern, matrix, k, open, extend)."""
    cases = {}
    for idx, argv in enumerate(AFFINE_CKPT_PAIRS):
        request = read_request(argv)
        k = request.alphabet_size
        for mode in MODES:
            cases[idx, mode] = (
                np.asarray(request.text, dtype=np.int32),
                np.asarray(request.pattern, dtype=np.int32),
                layout.pack_score_matrix(request.score_matrix, k), k,
                request.gap_penalty, request.gap_extend)
    return cases


def affine_ckpt_oracle(cases):
    return {key: bindings.oracle_align_affine(ALGO[key[1]], *case)
            for key, case in cases.items()}


def phase_affine_main_path(oracle_outputs, cases, oracle, device="cuda"):
    """Phase 14: affine -g in process against the -c subprocess outputs
    (the direct route), then checkpointed_align(gap_extend=...) at a
    forced small geometry against oracle_align_affine.  Returns the
    launches of the two parts."""
    reset_launches()
    direct_counts = {"K1": 0, "K2": 0}
    for argv, want in zip(AFFINE_MAIN_PATH, oracle_outputs):
        before = launches()
        rc, out = run_cli(["-g", *argv])
        delta = {kid: v - before[kid] for kid, v in launches().items()}
        rc_c, out_c, err_c = want()
        check(rc == 0 and rc_c == 0, f"{argv}: rc -g {rc}, -c {rc_c} "
                                     f"{err_c}")
        check(out == out_c, f"{argv}: -g output differs from -c")
        check(delta == {"K1": 1, "K2": 1}, f"{argv}: launches {delta}, not "
                                           f"the direct route")
        for kid in delta:
            direct_counts[kid] += delta[kid]
        score = out.rstrip("\n").rsplit("\t", 1)[-1]
        log(f"-g {' '.join(argv)}: direct route, launches {delta}, Score "
            f"{score}, byte-identical to -c")

    expected = oracle()
    reset_launches()
    geom = AFFINE_CKPT_GEOMETRY
    with plain_versions_forbidden(PAIR_PLAIN):
        for key, (text, pattern, sm, k, gap, ext) in cases.items():
            mode = key[1]
            before = launches()
            t0 = time.time()
            score, bi, bj, at, ap, st, sp = checkpoint.checkpointed_align(
                text, pattern, sm, k, gap, gap_extend=ext, device=device,
                **geom, **MODES[mode])
            torch.cuda.synchronize()
            wall = time.time() - t0
            delta = {kid: v - before[kid] for kid, v in launches().items()}
            wat, wap, wst, wsp, wscore = expected[key]
            check(score == wscore and (st, sp) == (wst, wsp)
                  and np.array_equal(at, wat) and np.array_equal(ap, wap),
                  f"affine checkpoint engine {AFFINE_CKPT_PAIRS[key[0]]} "
                  f"{mode}: differs from oracle_align_affine")
            strips = -(-len(pattern) // (geom["rps"] * geom["slots"]))
            check(delta["K2"] >= 2 and delta["K1"] == strips + delta["K2"],
                  f"affine checkpoint engine {mode}: launches {delta}, "
                  f"{strips} strips")
            log(f"affine checkpoint engine {len(pattern)} x {len(text)} "
                f"{mode:6s} k={k:2d} open {gap} extend {ext} {geom}: "
                f"{wall:.2f} s, Score {score}, {strips} strips, "
                f"{delta['K2']} path tiles, launches {delta}; "
                f"byte-identical to oracle_align_affine")
    return direct_counts, launches()


def rescore_affine(aligned_text, aligned_pattern, alphabet, sm, gap, ext):
    """Affine score of an alignment: a run, a maximal stretch of gaps in
    one row, costs gap + (L-1)*ext."""
    table = np.full(256, -1, dtype=np.int64)
    for idx, letter in enumerate(alphabet):
        table[ord(letter)] = idx
    a = table[np.frombuffer(aligned_text.encode(), dtype=np.uint8)]
    b = table[np.frombuffer(aligned_pattern.encode(), dtype=np.uint8)]
    check((a >= 0).all() and (b >= 0).all(), "unknown letter in the output")
    k = len(alphabet) - 1
    gap_a, gap_b = a == k, b == k
    check(not (gap_a & gap_b).any(), "a column of two gaps")
    score = int(sm[a[~(gap_a | gap_b)], b[~(gap_a | gap_b)]].sum())
    for g in (gap_a, gap_b):
        runs = int((g & ~np.concatenate([[False], g[:-1]])).sum())
        score -= gap * runs + ext * (int(g.sum()) - runs)
    return score


def affine_cli_run(argv, oracle_score):
    """-g on a full-width pair with phase 15's costs: (wall, counts,
    peak bytes, score, columns, request); the score checked against the
    oracle's score-only fill and the rescored alignment."""
    request = read_request(["-g", *DNA_AFFINE, *argv])
    sm = layout.pack_score_matrix(request.score_matrix,
                                  request.alphabet_size)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with plain_versions_forbidden(PAIR_PLAIN):
        t0 = time.time()
        rc, out = run_cli(["-g", *DNA_AFFINE, *argv])
        wall = time.time() - t0
    counts = launches()
    peak = torch.cuda.max_memory_allocated()
    check(rc == 0, f"-g {argv}: rc {rc}")
    score = int(out.rstrip("\n").rsplit("\t", 1)[-1])
    aligned_text, aligned_pattern = parse_alignment(out)
    rescored = rescore_affine(aligned_text, aligned_pattern, request.alphabet,
                              sm, request.gap_penalty, request.gap_extend)
    expected = oracle_score()
    check(score == expected == rescored,
          f"affine {argv}: -g Score {score}, oracle {expected}, rescored "
          f"{rescored}")
    return wall, counts, peak, score, len(aligned_text), request, out


def phase_affine_full_width(direct_score, long_score, device="cuda"):
    """Phase 15: affine -g at full width on the direct route and through
    the checkpoint engine, then each affine kernel's launch alone timed at
    its full-width shape."""
    # The direct route: two word planes of the 280,482 x 48,632 pair.
    wall, counts, peak, score, columns, request, out = affine_cli_run(
        FULL_WIDTH, direct_score)
    text = np.asarray(request.text, dtype=np.int32)
    pattern = np.asarray(request.pattern, dtype=np.int32)
    n, m, k = len(text), len(pattern), request.alphabet_size
    gap, ext = request.gap_penalty, request.gap_extend
    rps, slots = direct._direct_geometry(m)
    check(direct.fits_direct(n, m, affine=True)
          and counts == {"K1": 1, "K2": 1},
          f"affine full width: launches {counts}, not the direct route")
    log(f"affine full width {m} x {n} (rps {rps}, slots {slots}, open {gap} "
        f"extend {ext}): -g wall {wall:.2f} s, Score {score} == oracle "
        f"score-only fill == rescored alignment of {columns} columns; "
        f"launches {counts}; max_memory_allocated {peak} B")
    result = {"direct_wall_s": wall, "direct_peak_bytes": peak,
              "direct_counts": counts}

    sm = layout.pack_score_matrix(request.score_matrix, k)
    ts, pat, sm_dev = direct.strip_inputs(text, pattern, sm, k, rps, slots,
                                          device)
    bottom = layout.top_row(ts.numel(), gap, False, device, ext=ext)
    fbot = torch.full_like(bottom, wavefront.NEG_HALF)
    launch, k1_out = wavefront.kernel_launch(
        ts, bottom, pat, sm_dev, gap, n, m, 0, k, False, rps, 0, slots, False,
        None, affine=True, ext=ext, fbot_in=fbot)
    _, k1_ms = cuda_ms(launch)
    max_moves = -(-(n + m + 1) // 16) * 16
    launch, (mv, res) = walk.kernel_launch(k1_out[0], rps, 0, 0, m, n, False,
                                           max_moves, k1_out[6], 0)
    _, k2_ms = cuda_ms(launch)
    direct_moves = int(res[0])
    log(f"affine full width: K1 with words {k1_ms:.3f} ms, K2 {k2_ms:.3f} ms "
        f"({direct_moves} moves), each launch alone, CUDA events")
    steps = ts.numel()
    cells = n * m
    k1_bytes = (4 * (3 * steps + rps * slots + k * k)       # inputs
                + cells // 2                                # two 2-bit planes
                + 4 * (2 * steps + 2 * rps * slots + slots))
    k2_bytes = 8 * direct_moves + 4 * -(-direct_moves // 16) + 4 * 5
    result["K1-affine"] = bound(k1_bytes, cells * K1_AFFINE_OPS_PER_CELL) | {
        "ms": k1_ms, "shape": f"{m} x {n}, rps {rps}, slots {slots}, global"}
    # Free the two word planes (K2's launch holds them too) before the
    # long pair's peak is read.
    del launch, k1_out, mv, res

    # The checkpoint engine: the long pair, both sequences past a strip.
    seen = {}
    real_fill = checkpoint.checkpointed_fill
    real_traceback = checkpoint.checkpointed_traceback

    def fill(*args, **kwargs):
        t0 = time.time()
        seen["ck"] = real_fill(*args, **kwargs)
        torch.cuda.synchronize()
        seen["phase1_s"] = time.time() - t0
        return seen["ck"]

    def traceback(*args, **kwargs):
        t0 = time.time()
        out = real_traceback(*args, **kwargs)
        torch.cuda.synchronize()
        seen["phase2_s"] = time.time() - t0
        return out

    checkpoint.checkpointed_fill = fill
    checkpoint.checkpointed_traceback = traceback
    try:
        wall, counts, peak, score, columns, request, out = affine_cli_run(
            LONG_PAIR, long_score)
    finally:
        checkpoint.checkpointed_fill = real_fill
        checkpoint.checkpointed_traceback = real_traceback
    text = np.asarray(request.text, dtype=np.int32)
    pattern = np.asarray(request.pattern, dtype=np.int32)
    n, m, k = len(text), len(pattern), request.alphabet_size
    sm = layout.pack_score_matrix(request.score_matrix, k)
    rps, slots = checkpoint._pick_geometry(m, None, None)
    rows, cols = rps * slots, checkpoint.DEFAULT_CKPT_COLS
    strips = -(-m // rows)
    tiles_crossed = counts["K2"]
    check(not direct.fits_direct(n, m, affine=True) and tiles_crossed >= 1
          and counts["K1"] == strips + tiles_crossed,
          f"affine long pair: launches {counts}, {strips} strips")
    log(f"affine long pair {m} x {n} (rps {rps}, slots {slots}, {cols} "
        f"columns a tile, open {gap} extend {ext}): -g wall {wall:.2f} s, "
        f"phase 1 {seen['phase1_s']:.2f} s ({strips} strips), phase 2 "
        f"{seen['phase2_s']:.2f} s ({tiles_crossed} path tiles), Score "
        f"{score} == oracle score-only fill == rescored alignment of "
        f"{columns} columns; launches {counts}; max_memory_allocated {peak} "
        f"B")
    result.update(long_out=out, long_wall_s=wall,
                  long_phase1_s=seen["phase1_s"],
                  long_phase2_s=seen["phase2_s"], long_strips=strips,
                  long_tiles=tiles_crossed, long_peak_bytes=peak,
                  long_counts=counts)

    # One phase-1 strip (strip 1, below strip 0's bottom rows of H and F).
    ck = seen.pop("ck")
    steps = layout.steps_padded(n, slots)
    pat_pad = np.zeros(strips * rows, dtype=np.int32)
    pat_pad[:m] = pattern
    launch, strip_out = wavefront.kernel_launch(
        torch.as_tensor(layout.text_steps(text, steps)).to(device),
        ck.boundaries[0][:steps].reshape(-1, layout.STEPS),
        torch.as_tensor(layout.pattern_slots(pat_pad[rows:2 * rows], rps,
                                             slots)).to(device),
        torch.as_tensor(sm).to(device), gap, n, m, rows, k, False, rps, cols,
        slots, False, None, affine=True, ext=ext,
        fbot_in=ck.boundaries_f[0][:steps].reshape(-1, layout.STEPS))
    _, ckpt_ms = cuda_ms(launch)

    def as_cols(x):
        return x.reshape(-1, rps, slots).transpose(1, 2).reshape(-1, rows)

    check(torch.equal(as_cols(strip_out[5]), ck.colvals[1])
          and torch.equal(as_cols(strip_out[8]), ck.colvals_e[1])
          and torch.equal(strip_out[1].reshape(-1)[slots - 1:],
                          ck.boundaries[1][:steps - slots + 1])
          and torch.equal(strip_out[7].reshape(-1)[slots - 1:],
                          ck.boundaries_f[1][:steps - slots + 1]),
          "affine long pair: strip 1 differs from the run's own fill")
    del strip_out

    # One full-size interior tile (strip 1, column tile 2), re-filled from
    # the run's boundaries; K2 from its middle, in state 0.
    tiles = checkpoint.Tiles(ck, text, pattern, sm, k)
    b, c = 1, 2
    targs, tkw = tiles.strip_args(b, c)
    launch, tile_out = wavefront.kernel_launch(
        *targs, False, rps, 0, slots, False, tkw["left_in"], affine=True,
        ext=ext, fbot_in=tkw["fbot_in"], left_e=tkw["left_e"])
    _, tile_ms = cuda_ms(launch)
    i0, j0 = b * rows + rows // 2, c * cols + cols // 2
    max_moves = rows + cols + 1
    launch, (mv, res) = walk.kernel_launch(tile_out[0], rps, b * rows,
                                           c * cols, i0, j0, False, max_moves,
                                           tile_out[6], 0)
    _, walk_ms = cuda_ms(launch)
    werr, wres = compare_walk(tile_out[0], rps, i0, j0, False, max_moves,
                              b * rows, c * cols, tile_out[6], 0)
    check(werr == 0 and [int(x) for x in res.cpu()] == wres,
          f"affine long pair: K2 in the tile max_abs_err {werr}")
    window = slice(slots - 1, slots - 1 + cols)
    check(torch.equal(tile_out[1].reshape(-1)[window],
                      ck.boundaries[b][c * cols:(c + 1) * cols])
          and torch.equal(tile_out[7].reshape(-1)[window],
                          ck.boundaries_f[b][c * cols:(c + 1) * cols]),
          "affine long pair: the tile's bottom rows differ from phase 1's")
    log(f"affine long pair: one phase-1 strip ({rows} x {steps} steps) K1 "
        f"score-only {ckpt_ms:.3f} ms, equal to the run's own strip; one "
        f"path tile ({rows} x {tiles.tile_steps} steps, tile ({b}, {c})) K1 "
        f"with the left columns and words {tile_ms:.3f} ms, its bottom rows "
        f"of H and F equal to phase 1's; K2 from ({i0}, {j0}) {walk_ms:.3f} "
        f"ms ({wres[0]} moves), each launch alone, CUDA events; K2 exact "
        f"against its plain version there; K1's variants held against "
        f"theirs at phase 13's shapes (a phase-1 strip of rps 16 x 4096 "
        f"slots at 8500 letters, tiles of rps 16 x 4096 slots at 8192 "
        f"columns)")
    real_cells = rows * n
    tile_cells = min(rows, m - b * rows) * min(cols, n - c * cols)
    num_ckpts = ck.colvals[1].shape[0]
    result["K1-affine-ckpt"] = bound(
        strip_bytes(steps, rps, slots, k, 2 * num_ckpts) + 8 * steps,
        real_cells * K1_AFFINE_SCORE_OPS_PER_CELL) | {
        "ms": ckpt_ms, "shape": f"one strip of {rows} x {steps} steps of "
                                f"{m} x {n}, checkpoints every {cols}, "
                                f"global"}
    result["K1-affine-tile"] = bound(
        strip_bytes(tiles.tile_steps, rps, slots, k, left=True, words=True)
        + 8 * tiles.tile_steps + 4 * (rows + slots)
        + tiles.tile_steps * rows // 4,
        tile_cells * K1_AFFINE_OPS_PER_CELL) | {
        "ms": tile_ms, "shape": f"one tile of {rows} x {tiles.tile_steps} "
                                f"steps of {m} x {n}, left columns and "
                                f"words, global"}
    result["K2-affine"] = bound(k2_bytes, direct_moves
                                * K2_AFFINE_OPS_PER_MOVE) | {
        "ms": k2_ms, "moves": direct_moves, "tile_ms": walk_ms,
        "tile_moves": wres[0],
        "shape": f"{direct_moves} moves at full width (tile: {walk_ms:.3f} "
                 f"ms for {wres[0]} moves)"}
    return result


def strip_tensors(device, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(x)).to(device)
            for x in arrays]


def strip_first_region(rng, k, w, rows, device):
    """K5's inputs of a pair's first region (row 0, column 0): n a
    seventh of the strip short of its end, m not a multiple of 16."""
    gap = 5 if k == 4 else 10
    n, m = w - w // 7, rows - 5
    text = rng.integers(0, k, n).astype(np.int32)
    pat = np.zeros(rows, np.int32)
    pat[:m] = rng.integers(0, k, m)
    return gap, n, m, 0, 0, strip_tensors(
        device, strip_fill.strip_letters(text, 0, w), score_matrix(k), pat)


def strip_interior(rng, k, w, rows, local, device):
    """K5's inputs of an interior region of a real tiled fill: strip 1
    (columns w+1.., padded past n) at rows rows+1..2 rows, its left column
    strip 0's right one, its row above and state from strip 1's first
    block, both filled by K5 here."""
    gap = 5 if k == 4 else 10
    n, m = w + (5 * w) // 8, rows + rows // 2 + 3
    text = rng.integers(0, k, n).astype(np.int32)
    pat = np.zeros(2 * rows, np.int32)
    pat[:m] = rng.integers(0, k, m)
    letters0, letters1, sm, pat = strip_tensors(
        device, strip_fill.strip_letters(text, 0, w),
        strip_fill.strip_letters(text, w, w), score_matrix(k), pat)
    state0 = strip_tensors(device, strip_fill.zeros_state())[0]
    left0, prev0 = strip_tensors(
        device, strip_fill.nw_boundary_col(0, 2 * rows, gap, local),
        strip_fill.init_prev_row(w, 0, gap, local))
    _, _, rcol, _ = strip_fill.strip_fill(letters0, sm, pat, gap, n, m, 0,
                                          0, left0, prev0, state0,
                                          local=local, with_dirs=False)
    top = torch.full((1,), 0 if local else -gap * w, dtype=torch.int32,
                     device=device)
    left1 = torch.cat([top, rcol])
    prev1 = strip_tensors(device, strip_fill.init_prev_row(w, w, gap,
                                                           local))[0]
    _, prev1, _, state1 = strip_fill.strip_fill(
        letters1, sm, pat[:rows], gap, n, m, 0, w, left1[:rows + 1], prev1,
        state0, local=local, with_dirs=False)
    return gap, n, m, rows, w, [letters1, sm, pat[rows:],
                                left1[rows:].contiguous(), prev1, state1]


def phase_strip_kernel(device="cuda"):
    """Phase 16: K5 against its plain version on the card, every output
    (words, last row, right column, state): global and local, with words
    and score-only, DNA and protein, a first region and an interior one
    of a real tiled fill, at every width of STRIP_WIDTHS."""
    rng = np.random.default_rng(2027)
    err = 0
    for w in STRIP_WIDTHS:
        ks = (4, 23) if w in (1024, 32768) else (4,)
        for k in ks:
            for mode in ("global", "local"):
                local = mode == "local"
                for where in ("first", "interior"):
                    if where == "first":
                        rows = 512 if w == 1024 else STRIP_PLAIN_ROWS
                        gap, n, m, row_base, strip_off, (letters, sm, pat) = \
                            strip_first_region(rng, k, w, rows, device)
                        left, prev, state = strip_tensors(
                            device,
                            strip_fill.nw_boundary_col(0, rows, gap, local),
                            strip_fill.init_prev_row(w, 0, gap, local),
                            strip_fill.zeros_state())
                        args = [letters, sm, pat, left, prev, state]
                    else:
                        gap, n, m, row_base, strip_off, args = \
                            strip_interior(rng, k, w, STRIP_PLAIN_ROWS,
                                           local, device)
                    letters, sm, pat, left, prev, state = args
                    for with_dirs in (True, False):
                        full = (letters, sm, pat, gap, n, m, row_base,
                                strip_off, left, prev, state)
                        got = strip_fill.strip_fill(*full, local=local,
                                                    with_dirs=with_dirs)
                        torch.cuda.synchronize()
                        want, plain_ms = timed(
                            strip_fill.strip_fill_plain, *full, local=local,
                            with_dirs=with_dirs)
                        e = max_abs_err(got, want)
                        check(e == 0, f"K5 {mode} k={k} width {w} {where} "
                                      f"words {with_dirs}: max_abs_err {e}")
                        err = max(err, e)
                        log(f"K5 {mode:6s} k={k:2d} width {w:5d} {where:8s} "
                            f"(rows {row_base + 1}-{row_base + pat.numel()},"
                            f" n {n}, m {m}) "
                            f"{'words' if with_dirs else 'score':5s}: exact, "
                            f"state {want[3].tolist()}, plain "
                            f"{plain_ms:.0f} ms")
    # Regions of many bands: m and n inside a band and a block.
    for rows, w in STRIP_BAND_REGIONS:
        for mode in ("global", "local"):
            local = mode == "local"
            gap, n, m = 5, w - 37, rows - 45
            text = rng.integers(0, 4, n).astype(np.int32)
            pat = np.zeros(rows, np.int32)
            pat[:m] = rng.integers(0, 4, m)
            full = (*strip_tensors(device, strip_fill.strip_letters(text, 0, w),
                                   score_matrix(4), pat),
                    gap, n, m, 0, 0, *strip_tensors(
                        device, strip_fill.nw_boundary_col(0, rows, gap, local),
                        strip_fill.init_prev_row(w, 0, gap, local),
                        strip_fill.zeros_state()))
            for with_dirs in (True, False):
                bands = rows // (32 * strip_fill.rows_per_lane(with_dirs))
                check(bands >= 16, f"K5 {rows} x {w}: {bands} bands")
                got = strip_fill.strip_fill(*full, local=local,
                                            with_dirs=with_dirs)
                torch.cuda.synchronize()
                want, plain_ms = timed(strip_fill.strip_fill_plain, *full,
                                       local=local, with_dirs=with_dirs)
                e = max_abs_err(got, want)
                check(e == 0, f"K5 {mode} {rows} x {w} words {with_dirs}: "
                              f"max_abs_err {e}")
                err = max(err, e)
                log(f"K5 {mode:6s} k= 4 {rows} x {w} ({bands} bands, n {n}, "
                    f"m {m}) {'words' if with_dirs else 'score':5s}: exact, "
                    f"state {want[3].tolist()}, plain {plain_ms:.0f} ms")
                if with_dirs != local:
                    repeat_strip_launches(
                        f"K5 {mode} {rows} x {w} "
                        f"{'words' if with_dirs else 'score-only'}",
                        want, full, local, with_dirs)
    return err


def repeat_strip_launches(what, want, full, local, with_dirs,
                          times=REPEATS):
    """K5's launch closure run ``times`` times on the same inputs (the
    arguments of ``strip_fill``), each run bitwise equal to ``want`` (the
    plain version's outputs).  Before each run the outputs are poisoned,
    and before each run after the first the values of the bands' streams
    (not their tags) too: a run that read a stale stream entry, a ticket
    or a candidate left from the run before would differ."""
    launch, out = strip_fill.kernel_launch(*full, local, with_dirs)
    streams = launch.scratch[strip_fill.SCRATCH_COUNTERS // 2:]
    for r in range(times):
        for x in out:
            if x is not None:
                x.fill_(-12345)
        if r:
            streams.bitwise_xor_(0x5A5A5)
        launch()
        torch.cuda.synchronize()
        err = max_abs_err(out, want)
        check(err == 0, f"{what}: run {r + 1} of {times} of one launch "
                        f"closure: max_abs_err {err}")
    sms = len(set(_build.launch_sms(launch)))
    STRIP_REPEATED.append((what, launch.ctas, sms))
    log(f"{what}: {times} runs of one launch closure, each exact; "
        f"{launch.ctas} CTAs on {sms} SMs")


# K5's repeat-launch checks (phase 16): (what, CTAs, SMs).
STRIP_REPEATED = []


def strip_launches():
    return {"K1": wavefront.wavefront_strip.launches,
            "K5": strip_fill.strip_fill.launches,
            "K4-packed": batch_traceback.walk_packed.launches}


def reset_strip_launches():
    wavefront.wavefront_strip.launches = 0
    strip_fill.strip_fill.launches = 0
    batch_traceback.walk_packed.launches = 0


STRIP_PLAIN = ((strip_fill, "strip_fill_plain"),
               (batch_traceback, "_walk_plain"))


@contextlib.contextmanager
def environment(**settings):
    """os.environ with ``settings`` within the block."""
    saved = {key: os.environ.get(key) for key in settings}
    os.environ.update(settings)
    try:
        yield
    finally:
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value


def strip_blocks(n, m, tiled_route):
    """K5 launches of the strip engine on an n x m pair."""
    if not tiled_route:
        return 1
    m_pad = strip_fill.pair_rows(m)
    rows = min(m_pad, strip_fill.MAX_CHUNK_ROWS, tiled.DEFAULT_BLOCK_ROWS)
    return -(-n // tiled.DEFAULT_STRIP_COLS) * -(-m_pad // rows)


def strip_route_is_tiled(n, m):
    return (strip_fill.pair_columns(n) > strip_fill.MAX_STRIP_COLS
            or strip_fill.pair_rows(m) > strip_fill.MAX_CHUNK_ROWS)


@contextlib.contextmanager
def captured_regions(keys, store):
    """Within the block, the first K5 launch of each key of ``keys``,
    (rows, width, row_base, strip_off, local, with_dirs), made through
    ``strip_fill.kernel_launch`` is kept in ``store[key]``: a copy of its
    arguments, and its outputs (written once the launch has run)."""
    real = strip_fill.kernel_launch

    def wrapped(*args):
        launch, out = real(*args)
        text, _, pattern, *_, row_base, strip_off = args[:8]
        key = (pattern.numel(), text.numel(), row_base, strip_off,
               *args[11:13])
        if key in keys and key not in store:
            store[key] = ([x.clone() if torch.is_tensor(x) else x
                           for x in args], out)
        return launch, out

    strip_fill.kernel_launch = wrapped
    try:
        yield
    finally:
        strip_fill.kernel_launch = real


def hold_region(what, key, store):
    """K5 through ``strip_fill.strip_fill`` on the card against
    ``strip_fill_plain`` on the arguments of the main-path launch kept at
    ``store[key]``, and the launch's own outputs against the plain ones,
    every output exact.  Call it after the phase's launches were read:
    the wrapper counts.  Returns (max_abs_err, plain ms)."""
    check(key in store, f"{what}: no K5 launch {key} on the main path")
    args, run_out = store.pop(key)
    full, (local, with_dirs) = args[:11], args[11:13]
    got = strip_fill.strip_fill(*full, local=local, with_dirs=with_dirs)
    torch.cuda.synchronize()
    want, plain_ms = timed(strip_fill.strip_fill_plain, *full, local=local,
                           with_dirs=with_dirs)
    err = max(max_abs_err(got, want), max_abs_err(run_out, want))
    check(err == 0, f"K5 {what} {key}: max_abs_err {err}")
    rows, w, row_base, strip_off = key[:4]
    n, m = full[4:6]
    log(f"K5 {what}, {'local' if local else 'global'}, rows "
        f"{row_base + 1}-{row_base + rows} x columns {strip_off + 1}-"
        f"{strip_off + w} (n {n}, m {m}), "
        f"{'words' if with_dirs else 'score-only'}: the wrapper and the "
        f"run's launch exact against the plain version, state "
        f"{want[3].tolist()}, plain {plain_ms:.0f} ms")
    return err, plain_ms


def phase_strip_main_path(main_outputs, affine_outputs, big_outputs):
    """Phase 17: -g with SEQALIGN_PAIR_ENGINE=strip in process, in both
    traceback modes, against the -c subprocess outputs: the main path's
    global and local pairs and STRIP_BIG through K5 (and K4 for the
    device walk), never K1; the semi-global and affine requests through
    K1, never K5.  Then the single region of SINGLE_REGION, whole, against
    the plain version.  Returns (the launches of the phase, max_abs_err
    of that comparison, the global single region's K5 arguments)."""
    strip_cases = [(argv, out) for (_, argv), out in zip(MAIN_PATH,
                                                         main_outputs)
                   if "--semi-global" not in argv]
    strip_cases += list(zip(STRIP_BIG, big_outputs))
    held = {}
    reset_strip_launches()
    with plain_versions_forbidden(STRIP_PLAIN), \
            captured_regions(HELD_SINGLE, held):
        for tb in ("host", "device"):
            for argv, want in strip_cases:
                request = read_request(argv)
                n, m = len(request.text), len(request.pattern)
                tiled_route = strip_route_is_tiled(n, m)
                before = strip_launches()
                with environment(SEQALIGN_PAIR_ENGINE="strip",
                                 SEQALIGN_TRACEBACK=tb):
                    t0 = time.time()
                    rc, out = run_cli(["-g", *argv])
                    wall = time.time() - t0
                delta = {kid: v - before[kid]
                         for kid, v in strip_launches().items()}
                rc_c, out_c, err_c = want()
                check(rc == 0 and rc_c == 0,
                      f"strip {argv}: rc -g {rc}, -c {rc_c} {err_c}")
                check(out == out_c, f"strip {tb} {argv}: -g output differs "
                                    f"from -c")
                expect = {"K1": 0, "K5": strip_blocks(n, m, tiled_route),
                          "K4-packed": 1 if tb == "device" else 0}
                check(delta == expect, f"strip {tb} {argv}: launches "
                                       f"{delta}, expected {expect}")
                score = out.rstrip("\n").rsplit("\t", 1)[-1]
                log(f"-g strip engine, {tb} walk, {' '.join(argv)} "
                    f"({m} x {n}, {'tiled' if tiled_route else 'one region'}"
                    f"): launches {delta}, {wall:.2f} s, Score {score}, "
                    f"byte-identical to -c")
        # Semi-global and affine requests keep their routes under the
        # setting: the direct route, K1 and K2.
        others = [(MAIN_PATH[-1][1], main_outputs[-1])]
        others += list(zip(AFFINE_MAIN_PATH, affine_outputs))
        for argv, want in others:
            before = strip_launches()
            with environment(SEQALIGN_PAIR_ENGINE="strip"):
                rc, out = run_cli(["-g", *argv])
            delta = {kid: v - before[kid]
                     for kid, v in strip_launches().items()}
            rc_c, out_c, _ = want()
            check(rc == 0 and rc_c == 0 and out == out_c,
                  f"strip setting, {argv}: -g output differs from -c")
            check(delta == {"K1": 1, "K5": 0, "K4-packed": 0},
                  f"strip setting, {argv}: launches {delta}")
            log(f"-g {' '.join(argv)} with SEQALIGN_PAIR_ENGINE=strip: "
                f"launches {delta} (the direct route), byte-identical to -c")
    counts = strip_launches()
    single_args = [x.clone() if torch.is_tensor(x) else x
                   for x in held[HELD_SINGLE[0]][0]]
    err = max(hold_region("single region of -g", key, held)[0]
              for key in HELD_SINGLE)
    return counts, err, single_args


@contextlib.contextmanager
def event_timed(module, name, store):
    """Within the block every launch made through ``module.name`` (a
    ``kernel_launch``-style function returning (launch, outputs)) is
    timed between CUDA events, appended to ``store``."""
    real = getattr(module, name)

    def wrapped(*args, **kwargs):
        launch, out = real(*args, **kwargs)

        def timed_launch():
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            launch()
            stop.record()
            store.append((start, stop))

        return timed_launch, out

    setattr(module, name, wrapped)
    try:
        yield
    finally:
        setattr(module, name, real)


@contextlib.contextmanager
def host_timed(module, name, store):
    """Within the block the host-clock time of each call of
    ``module.name`` is appended to ``store`` (seconds)."""
    real = getattr(module, name)

    def wrapped(*args, **kwargs):
        t0 = time.time()
        out = real(*args, **kwargs)
        store.append(time.time() - t0)
        return out

    setattr(module, name, wrapped)
    try:
        yield
    finally:
        setattr(module, name, real)


@contextlib.contextmanager
def staging_timed(wait_s, copy_s):
    """Within the block, each placing of a staged block of words into the
    tiled fill's host array (``tiled._Staging.flush``) is split on the
    host clock into the wait for its device-to-host copy (appended to
    ``wait_s``) and the copy into the host array (``copy_s``), seconds."""
    real = tiled._Staging.flush

    def flush(self):
        if self.pending is not None:
            t0 = time.perf_counter()
            self.pending[2].synchronize()
            t1 = time.perf_counter()
            real(self)
            wait_s.append(t1 - t0)
            copy_s.append(time.perf_counter() - t1)

    tiled._Staging.flush = flush
    try:
        yield
    finally:
        tiled._Staging.flush = real


def events_ms(store):
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in store]


def phase_strip_full_width(fw_out, oracle_score, long_score, single_args,
                           walk_lib, device="cuda"):
    """Phase 18: -g with the strip engine on the full-width pair (the
    tiled fill, 9 strips x 6 blocks) in both traceback modes, byte-
    identical to phase 5's output, its score the oracle's; the wall split
    into K5 (device time, under the host's copies), the host's waits for
    each block's D2H and its copies into the host array, the walk (K4 in
    device mode), the print and the rest; then ``tiled_fill_score`` of
    the long pair against phase 12's oracle score.  Last, whole blocks of
    these runs against the plain version on their own inputs (an interior
    block and the last one of the full-width run, an interior block of
    the long pair), the K5 launches alone of the interior block (its CTAs
    and SMs), the long pair's block and phase 17's single region
    (``single_args``), each beside its bound, and the interior block's
    words' D2H.  Then K4's single-pair walk (``walk_packed``) of the
    device-mode run alone, beside its bound, held equal to the run's own
    walk and to the plain version on the same words (timed there), and
    K4-packed on ``batch_walk_shapes``' window-edge set (the production
    window and the least, 2 word rows x 8 columns), exact against the
    plain version (``walk_lib``, the probe's build)."""
    request = read_request(["-g", *FULL_WIDTH])
    n, m, k = len(request.text), len(request.pattern), request.alphabet_size
    check(strip_route_is_tiled(n, m), "full width: not the tiled route")
    blocks = strip_blocks(n, m, True)
    expected = oracle_score()
    result = {"blocks": blocks}
    held = {}
    walked = []  # the device-mode walk: its arguments and outputs
    with plain_versions_forbidden(STRIP_PLAIN):
        for tb in ("host", "device"):
            k5_events, k4_events, walk_s = [], [], []
            wait_s, copy_s, print_s = [], [], []
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_strip_launches()
            walker = (host_timed(bindings, "traceback_packed", walk_s)
                      if tb == "host" else
                      host_timed(bindings, "emit_moves", walk_s))
            keep = (HELD_FULL_INTERIOR, HELD_FULL_LAST) if tb == "host" \
                else ()
            with environment(SEQALIGN_PAIR_ENGINE="strip",
                             SEQALIGN_TRACEBACK=tb), \
                    captured_regions(keep, held), \
                    event_timed(strip_fill, "kernel_launch", k5_events), \
                    event_timed(batch_traceback, "packed_launch",
                                k4_events), \
                    captured_calls(batch_traceback, "packed_launch",
                                   walked), \
                    staging_timed(wait_s, copy_s), \
                    host_timed(pretty, "pretty_alignment_print", print_s), \
                    walker:
                t0 = time.time()
                rc, out = run_cli(["-g", *FULL_WIDTH])
                wall = time.time() - t0
            counts = strip_launches()
            peak = torch.cuda.max_memory_allocated()
            k5_ms = events_ms(k5_events)
            k4_ms = events_ms(k4_events)
            check(rc == 0, f"strip full width {tb}: rc {rc}")
            score = int(out.rstrip("\n").rsplit("\t", 1)[-1])
            check(score == expected, f"strip full width {tb}: Score {score}, "
                                     f"oracle {expected}")
            check(out == fw_out, f"strip full width {tb}: output differs "
                                 f"from the direct route's (phase 5)")
            want = {"K1": 0, "K5": blocks,
                    "K4-packed": 1 if tb == "device" else 0}
            check(counts == want, f"strip full width {tb}: launches "
                                  f"{counts}, expected {want}")
            # Each block's K5 runs under the host's copy of the block
            # before it, so the rest leaves K5 in: the host clock's steps
            # not split out, and the first block's K5.
            rest = (wall - sum(wait_s) - sum(copy_s) - sum(print_s)
                    - sum(walk_s) - sum(k4_ms) / 1e3)
            result[tb] = {
                "wall_s": wall, "k5_s": sum(k5_ms) / 1e3,
                "k5_launch_ms": [min(k5_ms), max(k5_ms)],
                "walk_s": sum(walk_s), "k4_ms": sum(k4_ms),
                "stage_wait_s": sum(wait_s), "host_copy_s": sum(copy_s),
                "print_s": sum(print_s), "rest_s": rest, "peak_bytes": peak,
                "counts": counts}
            log(f"strip full width {m} x {n}, {tb} walk: -g wall {wall:.2f} "
                f"s, Score {score} == oracle score-only fill, output "
                f"byte-identical to the direct route's; K5 {len(k5_ms)} "
                f"launches {sum(k5_ms) / 1e3:.3f} s ({min(k5_ms):.1f}-"
                f"{max(k5_ms):.1f} ms each), "
                + (f"native walk {sum(walk_s):.3f} s"
                   if tb == "host" else
                   f"K4 {sum(k4_ms):.3f} ms, native emit "
                   f"{sum(walk_s):.3f} s")
                + f"; words into the host array: {len(copy_s)} waits for "
                f"their D2H {sum(wait_s):.3f} s, copies {sum(copy_s):.3f} s;"
                f" the print {sum(print_s):.3f} s; the rest {rest:.3f} s; "
                f"launches {counts}; "
                f"max_memory_allocated {peak} B")

    # The long pair, score only: 7 strips x 13 blocks of 16,384 rows.
    long_req = read_request(LONG_PAIR)
    lt = np.asarray(long_req.text, dtype=np.int32)
    lp = np.asarray(long_req.pattern, dtype=np.int32)
    lsm = layout.pack_score_matrix(long_req.score_matrix,
                                   long_req.alphabet_size)
    reset_strip_launches()
    with plain_versions_forbidden(STRIP_PLAIN), \
            captured_regions((HELD_LONG,), held):
        score, wall_ms = timed(tiled.tiled_fill_score, lt, lp, lsm,
                               long_req.alphabet_size, long_req.gap_penalty,
                               device=device)
    counts = strip_launches()
    want_blocks = (-(-len(lt) // tiled.DEFAULT_STRIP_COLS)
                   * -(-strip_fill.pair_rows(len(lp))
                       // strip_fill.MAX_CHUNK_ROWS))
    check(counts["K5"] == want_blocks,
          f"long pair score: launches {counts}, expected {want_blocks}")
    expected = long_score()
    check(score == expected, f"long pair: tiled_fill_score {score}, oracle "
                             f"{expected}")
    result["long_score_wall_s"] = wall_ms / 1e3
    result["long_counts"] = counts
    log(f"long pair {len(lp)} x {len(lt)}: tiled_fill_score {score} == "
        f"oracle score-only fill, {wall_ms / 1e3:.2f} s, {counts['K5']} K5 "
        f"launches")

    # The interior block of the full-width run: its K5 launch alone, where
    # its CTAs ran, and its words' D2H into pageable and into pinned
    # memory; the long pair's block and phase 17's single region alone.
    args, (words, *_) = held[HELD_FULL_INTERIOR]
    launch, _ = strip_fill.kernel_launch(*args)
    _, k5_ms = cuda_ms_best(launch)
    k5_ctas, k5_sms = launch.ctas, len(set(_build.launch_sms(launch)))
    check(k5_sms >= K5_MIN_SMS, f"K5 interior block: {k5_ctas} CTAs on "
                                f"{k5_sms} SMs, fewer than {K5_MIN_SMS}")
    del launch
    launch, _ = strip_fill.kernel_launch(*held[HELD_LONG][0])
    _, k5_long_ms = cuda_ms_best(launch)
    del launch
    launch, _ = strip_fill.kernel_launch(*single_args)
    _, k5_single_ms = cuda_ms_best(launch)
    del launch
    timed(words.cpu)  # the first copy pays for pages the second reuses
    _, d2h_ms = timed(words.cpu)
    pinned = torch.empty(words.shape, dtype=words.dtype, pin_memory=True)
    pinned.copy_(words)
    _, d2h_pinned_ms = timed(pinned.copy_, words)
    del words, pinned
    result["K4-packed"] = phase_packed_walk(walked, walk_lib)
    del walked
    # Whole blocks of the main path against the plain version.
    err, plain_ms = hold_region("interior block of the full-width -g",
                                HELD_FULL_INTERIOR, held)
    err_last, plain_last_ms = hold_region("last block of the full-width -g",
                                          HELD_FULL_LAST, held)
    err_long, plain_long_ms = hold_region("interior block of the long "
                                          "pair's tiled_fill_score",
                                          HELD_LONG, held)
    rows, w, row_base, strip_off = HELD_FULL_INTERIOR[:4]
    shape = (f"{rows} x {w} with words, global (the full-width run's "
             f"block at rows {row_base + 1}-{row_base + rows}, columns "
             f"{strip_off + 1}-{strip_off + w})")
    long_bound = k5_bound(*HELD_LONG[:2], k, False)
    single_bound = k5_bound(*HELD_SINGLE[0][:2], k, True)
    result["K5"] = k5_bound(rows, w, k, True) | {
        "ms": k5_ms, "plain_ms": plain_ms,
        "err": max(err, err_last, err_long), "shape": shape,
        "plain_shape": shape}
    result.update(d2h_block_ms=d2h_ms, d2h_pinned_ms=d2h_pinned_ms,
                  plain_last_ms=plain_last_ms, plain_long_ms=plain_long_ms,
                  k5_long_ms=k5_long_ms, k5_single_ms=k5_single_ms,
                  k5_long_bound_ms=long_bound["bound_ms"],
                  k5_single_bound_ms=single_bound["bound_ms"],
                  k5_ctas=k5_ctas, k5_sms=k5_sms)
    log(f"strip full width: K5 {k5_ms:.3f} ms for the {shape} (launch "
        f"alone, CUDA events, best of 3; {k5_ctas} CTAs on {k5_sms} SMs); "
        f"K5 {k5_long_ms:.3f} ms for the long pair's {HELD_LONG[0]} x "
        f"{HELD_LONG[1]} score-only block (bound "
        f"{long_bound['bound_ms']:.4f} ms, {long_bound['bound_by']}), "
        f"{k5_single_ms:.3f} ms for phase 17's {HELD_SINGLE[0][0]} x "
        f"{HELD_SINGLE[0][1]} single region with words (bound "
        f"{single_bound['bound_ms']:.4f} ms, {single_bound['bound_by']}); "
        f"its words' D2H {d2h_ms:.2f} ms "
        f"pageable, {d2h_pinned_ms:.2f} ms pinned ({rows // 4 * w} B); "
        f"plain K5 {plain_ms:.0f} ms on the same block, "
        f"{plain_last_ms:.0f} ms on the last block, {plain_long_ms:.0f} ms "
        f"on the long pair's, all exact; bound {result['K5']['bound_ms']:.4f}"
        f" ms ({result['K5']['bound_by']})")
    return result


def phase_packed_walk(walked, walk_lib):
    """K4-packed (phase 18): the device-mode full-width walk's launch
    alone (CUDA events, best of 3), its outputs equal to the run's; the
    run's walk held against the plain version (``walk_packed`` on a CPU
    copy of the same words) and the plain version timed there; the
    window-edge set and the refused words exact against the plain version
    and the wrapper's checks.  Returns the kernels line's row."""
    check(len(walked) == 1, f"K4-packed: {len(walked)} walks captured")
    args, kwargs, run_out = walked[0]
    launch, out = batch_traceback.packed_launch(*args, **kwargs)
    _, ms = cuda_ms_best(launch)
    check(all(torch.equal(x, y) for x, y in zip(out, run_out)),
          "K4-packed: the timed launch differs from the run's walk")
    words, n, m, bi, bj, local, max_len = args
    moves = int(out[1][0])
    row = packed_walk_bound(out[0].cpu().numpy(), moves,
                            *((bi, bj) if local else (m, n)))
    shape = (f"one pair's {moves} moves at full width ({m} x {n}, "
             f"{'local' if local else 'global'}, the strip engine's words)")
    del out, launch
    host_words = words.cpu()
    del words
    plain, plain_ms = timed(batch_traceback.walk_packed, host_words, n, m,
                            bi, bj, local, max_len)
    del host_words
    err = max_abs_err(run_out, [x.to(run_out[0].device) for x in plain])
    check(err == 0, f"K4-packed: the full-width walk's max_abs_err {err} "
                    f"against the plain version")
    del plain, run_out
    rows = batch_walk_shapes.check_packed(walk_lib, least_only=True)
    bad = [r for r in rows if not r[-1]]
    check(rows and not bad, f"K4-packed window-edge set differs: {bad}")
    plain_shape = f"the same walk on the CPU ({moves} moves)"
    log(f"K4-packed walk_packed: {ms:.3f} ms at full width ({moves} moves, "
        f"{row['words_read']} words read; launch alone, CUDA events, best of "
        f"3), == the device-mode run's walk; plain {plain_ms:.1f} ms on "
        f"{plain_shape}, max_abs_err {err}; bound {row['bound_ms']:.5f} ms "
        f"({row['bound_by']}); window-edge set: {len(rows)} walks and "
        f"refusals, {sum(r[2] for r in rows)} moves, production and least "
        f"window, each exact")
    return row | {"ms": ms, "plain_ms": plain_ms, "err": err, "shape": shape,
                  "plain_shape": plain_shape}


def packed_walk_bound(packed, count, i0, j0):
    """``bound`` of one single-pair walk of ``count`` moves from (i0, j0):
    the words its path reads, each once (a path that only goes up and
    left never returns to a word), its move words written once, and
    K4_OPS_PER_MOVE a move; with the moves and the words read."""
    idx = np.arange(count)
    d = (packed[idx // 16].astype(np.int64) >> (2 * (idx % 16))) & 3
    up, back = (d == 1) | (d == 2), (d == 0) | (d == 1)
    i = i0 - np.concatenate([[0], np.cumsum(up)[:-1]])
    j = j0 - np.concatenate([[0], np.cumsum(back)[:-1]])
    reads = (i > 0) & (j > 0)
    key = ((i[reads] - 1) // 16) * (1 << 32) + (j[reads] - 1)
    words_read = int(len(key) > 0) + int((np.diff(key) != 0).sum())
    nbytes = 4 * words_read + 4 * -(-count // 16) + 4 * 4 + 3 * 4
    return bound(nbytes, count * K4_OPS_PER_MOVE) | {
        "moves": count, "words_read": words_read}


@contextlib.contextmanager
def captured_calls(module, name, store):
    """Within the block every call of ``module.name`` (a launch builder
    returning (launch, outputs)) is kept in ``store`` as (args, kwargs,
    outputs)."""
    real = getattr(module, name)

    def wrapped(*args, **kwargs):
        launch, out = real(*args, **kwargs)
        store.append((args, kwargs, out))
        return launch, out

    setattr(module, name, wrapped)
    try:
        yield
    finally:
        setattr(module, name, real)


def k5_bound(rows, w, k, with_dirs):
    """``bound`` of one K5 launch of rows x w cells: each input read once
    (the letters, the pattern, the left column, the row above, the
    matrix, the state), each output written once (the words, the last
    row, the right column, the state)."""
    cells = rows * w
    nbytes = (w + 4 * (2 * rows + 1) + 4 * w + 4 * k * k + 16     # inputs
              + (cells // 4 if with_dirs else 0)                  # outputs
              + 4 * w + 4 * rows + 16)
    ops = cells * (K5_OPS_PER_CELL if with_dirs else K5_SCORE_OPS_PER_CELL)
    return bound(nbytes, ops)


def bound(nbytes, ops, packed=False):
    """The least time of the work on an H100: bytes over the memory rate
    or int32 operations over the int32 rate (``packed``: int16 lanes, two
    lanes an instruction, so twice that rate), whichever is larger."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / (INT32_OPS_PER_S * (2 if packed else 1)) * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


# The sequence-parallel chunk (K1 score-only with column checkpoints and
# a left column, phase 27): (mode, position) cases held against the plain
# version at the main path's geometry, one a mode, on the long pair's own
# fills; and the other cases at 16 x 1,024 slots, 2,048-column chunks,
# on a CHUNK_CUT_PAIR (n, m) pair of random DNA: 4 chunks (the last 700
# columns) by 2 strips.
CHUNK_FULL_CASES = (("global", "interior"), ("local", "first"),
                    ("semi", "last"), ("affine", "interior"),
                    ("global", "last"), ("affine", "last"))
# The cases run on four streams of the card at once: one a mode.
CHUNK_STREAM_CASES = CHUNK_FULL_CASES[:4]
CHUNK_CUT_GEOMETRY = dict(rps=16, slots=1024, ckpt_cols=2048)
CHUNK_CUT_PAIR = (3 * 2048 + 700, 16384 + 3000)
CHUNK_CUT_CASES = (("global", "first"), ("global", "last"),
                   ("local", "interior"), ("local", "last"),
                   ("semi", "first"), ("semi", "interior"),
                   ("affine", "first"), ("affine", "last"))
# The mesh of phases 27, 29 and 30: four entries, one card.
MESH_ENTRIES = 4
# K5 regions run at once on the mesh streams (phase 27): columns, rows.
K5_STREAM_REGION = (32768, 2048)
# sequence_parallel_fill's row blocks at full width (phase 30), and its
# words held against the plain version: n, m (4 strips of 2,048 columns,
# 3 blocks of 128 rows).
STRIP_PIPE_ROWS = 8192
STRIP_PIPE_WORDS = (8000, 300)
# The data-parallel BatchAligner (phase 31): mesh sizes.
BATCH_MESHES = (1, 2)
# The worker processes of phase 32 and each one's pairs.
WORKERS = 2
WORKER_PAIRS = 256


# The affine chunks' costs (open, extend): phase 15's.
CHUNK_AFFINE = (8, 2)


def chunk_fill_modes(mode, gap):
    """(keywords of checkpointed_fill, gap) of a chunk case's mode."""
    if mode == "affine":
        return dict(gap_extend=CHUNK_AFFINE[1]), CHUNK_AFFINE[0]
    return dict(MODES[mode]), gap


def chunk_position(position, chunks):
    """(strip, chunk) of a case: the first chunk of strip 0, an interior
    chunk of strip 1, or strip 1's last chunk (short)."""
    return {"first": (0, 0), "interior": (1, min(3, chunks - 2)),
            "last": (1, chunks - 1)}[position]


def chunk_case(ck, tiles, b, c):
    """``wavefront_strip``'s (args, kwargs) of the sequence-parallel
    chunk (strip b, chunk c) of the fill ``ck``: the path tile's inputs
    (``Tiles.strip_args``: the top row, the left column with its corner,
    affine their F and E) score-only with column checkpoints every chunk,
    n the chunk's own columns and m the pair's rows."""
    args, kwargs = tiles.strip_args(b, c)
    n_eff = min(max(ck.n - c * ck.ckpt_cols, 0), ck.ckpt_cols)
    kwargs.update(with_dirs=False, ckpt_every=ck.ckpt_cols, semi=ck.semi)
    return args[:5] + (n_eff, ck.m) + args[7:], kwargs


def chunk_launch(args, kwargs):
    """K1's launch closure and outputs on a chunk case."""
    return wavefront.kernel_launch(
        *args, kwargs["local"], kwargs["rps"], kwargs["ckpt_every"],
        kwargs["slots"], kwargs["semi"], kwargs["left_in"],
        affine=kwargs.get("affine", False), ext=kwargs.get("ext", 0),
        fbot_in=kwargs.get("fbot_in"), left_e=kwargs.get("left_e"))


def chunk_bound(args, kwargs, k):
    """The least time of a chunk case: bytes as ``strip_bytes`` (affine:
    the F rows in and out, E's left column and checkpoints besides) or
    its cells' operations (the chunk's own columns of its real rows)."""
    rps, slots = kwargs["rps"], kwargs["slots"]
    rows, steps = rps * slots, args[0].numel()
    n_eff, m, i0 = args[5], args[6], args[7]
    cells = max(0, min(rows, m - i0)) * n_eff
    ckpts = wavefront.num_checkpoints(steps, kwargs["ckpt_every"])
    if kwargs.get("affine"):
        return bound(strip_bytes(steps, rps, slots, k, 2 * ckpts, left=True)
                     + 8 * steps + 4 * (rows + slots),
                     cells * K1_AFFINE_SCORE_OPS_PER_CELL)
    return bound(strip_bytes(steps, rps, slots, k, ckpts, left=True),
                 cells * K1_SCORE_OPS_PER_CELL)


def chunk_cases(text, pattern, sm, k, gap, cases, geometry, device):
    """{(mode, position): (args, kwargs)} of ``cases`` on the fills of
    (text, pattern) at ``geometry`` (None: the default one)."""
    out = {}
    for mode in dict.fromkeys(mode for mode, _ in cases):
        kw, g = chunk_fill_modes(mode, gap)
        ck = checkpoint.checkpointed_fill(text, pattern, sm, k, g,
                                          device=device, **kw,
                                          **(geometry or {}))
        tiles = checkpoint.Tiles(ck, text, pattern, sm, k)
        chunks = -(-ck.n // ck.ckpt_cols)
        for m_, position in cases:
            if m_ == mode:
                out[mode, position] = chunk_case(
                    ck, tiles, *chunk_position(position, chunks))
    return out


def concurrent_runs(what, cases, kernel, times=REPEATS):
    """``cases`` [(launch, out, want)]: each launch closure on a stream of
    its own, all queued at once, ``times`` times, each output bitwise
    equal to ``want`` (the plain version's); before each run the outputs
    but the checkpoints are poisoned, and after the first the values of
    the bands' streams.  Returns (the last run's wall between its first
    start and last stop, the launches' times alone summed), in ms."""
    streams = [torch.cuda.Stream() for _ in cases]
    counters = (wavefront.SCRATCH_COUNTERS if kernel == "K1"
                else strip_fill.SCRATCH_COUNTERS) // 2
    for r in range(times):
        events = []
        for launch, out, _ in cases:
            for i, x in enumerate(out):
                if x is not None and not (kernel == "K1" and i in (5, 8)):
                    x.fill_(-12345)
            if r:
                launch.scratch[counters:].bitwise_xor_(0x5A5A5)
        for stream, (launch, _, _) in zip(streams, cases):
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                launch()
                stop.record()
                events.append((start, stop))
        torch.cuda.synchronize()
        for i, (_, out, want) in enumerate(cases):
            err = max_abs_err(out, want)
            check(err == 0, f"{what}: run {r + 1} of {times}, stream {i}: "
                            f"max_abs_err {err}")
    wall = max(events[0][0].elapsed_time(stop) for _, stop in events)
    alone = sum(cuda_ms(launch)[1] for launch, _, _ in cases)
    sms = [len(set(_build.launch_sms(launch))) for launch, _, _ in cases]
    log(f"{what}: {len(cases)} launches on {len(cases)} streams at once, "
        f"{times} runs, each output exact; the last run's wall "
        f"{wall:.3f} ms, the launches alone {alone:.3f} ms summed; SMs of "
        f"each launch {sms}")
    return wall, alone


def phase_mesh_kernels(device="cuda"):
    """Phase 27: K1's sequence-parallel chunk against its plain version,
    then K1 and K5 on four streams of the card at once."""
    request = read_request(["-g", *LONG_PAIR])
    text = np.asarray(request.text, dtype=np.int32)
    pattern = np.asarray(request.pattern, dtype=np.int32)
    k, gap = request.alphabet_size, request.gap_penalty
    sm = layout.pack_score_matrix(request.score_matrix, k)
    full = chunk_cases(text, pattern, sm, k, gap, CHUNK_FULL_CASES, None,
                       device)
    rng = np.random.default_rng(27)
    n, m = CHUNK_CUT_PAIR
    cut = chunk_cases(rng.integers(0, 4, n).astype(np.int32),
                      rng.integers(0, 4, m).astype(np.int32),
                      score_matrix(4), 4, 5, CHUNK_CUT_CASES,
                      CHUNK_CUT_GEOMETRY, device)
    rows = {}
    held = []
    for where, cases in (("main path's geometry", full),
                         ("16 x 1,024 slots", cut)):
        for (mode, position), (args, kwargs) in cases.items():
            launch, out = chunk_launch(args, kwargs)
            launch()
            plain, plain_ms = timed(wavefront.wavefront_strip_plain, *args,
                                    **kwargs)
            err = max_abs_err(out, plain)
            what = (f"K1 chunk {mode} {position} ({where}, n {args[5]}, "
                    f"strip at row {args[7]})")
            check(err == 0, f"{what}: max_abs_err {err}")
            if cases is full and (mode, position) in CHUNK_STREAM_CASES:
                held.append((launch, out, plain))
            kid = "K1-affine-chunk" if mode == "affine" else "K1-chunk"
            if cases is full and position == "interior":
                _, ms = cuda_ms_best(launch)
                steps = args[0].numel()
                steps = args[0].numel()
                chunk_steps = steps
                rows[kid] = chunk_bound(args, kwargs, k) | {
                    "ms": ms, "plain_ms": plain_ms, "err": err,
                    "shape": f"an interior chunk of {kwargs['rps']} x "
                             f"{kwargs['slots']} slots x {steps} steps, "
                             f"{args[5]} columns its own, of "
                             f"{len(pattern)} x {len(text)}, "
                             + (f"open {CHUNK_AFFINE[0]} extend "
                                f"{CHUNK_AFFINE[1]}" if mode == "affine"
                                else "global")}
                log(f"{what}: {ms:.3f} ms (its launch alone, CUDA events, "
                    f"best of 3), bound {rows[kid]['bound_ms']:.4f} ms "
                    f"({rows[kid]['bound_by']}); plain {plain_ms:.0f} ms; "
                    f"exact")
            else:
                log(f"{what}: exact against the plain version "
                    f"({plain_ms:.0f} ms)")
    del full, cut
    k1_wall, k1_alone = concurrent_runs(
        "K1 chunks (the four main-path-geometry cases)", held, "K1")
    del held
    k5 = []
    for local in (False, True):
        for with_dirs in (True, False):
            gap5, n5, m5, row_base, strip_off, inputs = strip_interior(
                rng, 4, *K5_STREAM_REGION, local, device)
            full5 = (*inputs[:3], gap5, n5, m5, row_base, strip_off,
                     *inputs[3:])
            want = strip_fill.strip_fill_plain(*full5, local=local,
                                               with_dirs=with_dirs)
            launch, out = strip_fill.kernel_launch(*full5, local, with_dirs)
            k5.append((launch, out, want))
    k5_wall, k5_alone = concurrent_runs(
        f"K5 interior regions of {K5_STREAM_REGION[1]} x "
        f"{K5_STREAM_REGION[0]} (global and local, words and score-only)",
        k5, "K5")
    return rows | {"chunk_steps": chunk_steps,
                   "k1_streams_ms": k1_wall, "k1_alone_ms": k1_alone,
                   "k5_streams_ms": k5_wall, "k5_alone_ms": k5_alone}


@contextlib.contextmanager
def default_mesh(devices):
    """``config.mesh_devices`` giving ``devices`` within the block: the
    default mesh of ``-g``'s long-pair route."""
    real = config.mesh_devices
    config.mesh_devices = lambda default=None: list(devices)
    try:
        yield
    finally:
        config.mesh_devices = real


@contextlib.contextmanager
def sequence_fill_spy(seen):
    """``sequence_parallel_checkpointed_fill`` (which the route imports
    at each call) counted in ``seen["calls"]`` within the block, its fill
    returned in ``seen["ck"]`` and timed, to its last kernel, in
    ``seen["fill_s"]``."""
    real = sequence.sequence_parallel_checkpointed_fill
    seen["calls"] = 0

    def fill(*args, **kwargs):
        seen["calls"] += 1
        t0 = time.time()
        seen["ck"] = real(*args, **kwargs)
        torch.cuda.synchronize()
        seen["fill_s"] = time.time() - t0
        return seen["ck"]

    sequence.sequence_parallel_checkpointed_fill = fill
    try:
        yield
    finally:
        sequence.sequence_parallel_checkpointed_fill = real


def phase_seqpar_one(fw):
    """Phase 28: -g on the full-width pair through the sequence-parallel
    route on the default mesh (this card), byte-identical to phase 5."""
    reset_launches()
    seen = {}
    check(config.mesh_devices() == ["cuda:0"],
          f"the default mesh is {config.mesh_devices()}, not one card")
    with environment(SEQALIGN_SEQUENCE_PARALLEL="1"), \
            sequence_fill_spy(seen), plain_versions_forbidden(PAIR_PLAIN):
        t0 = time.time()
        rc, out = run_cli(["-g", *FULL_WIDTH])
        wall = time.time() - t0
    counts = launches()
    request = read_request(FULL_WIDTH)
    chunks = -(-len(request.text) // checkpoint.DEFAULT_CKPT_COLS)
    check(rc == 0 and out == fw["out"],
          "full width through the sequence-parallel route: not phase 5's "
          "bytes")
    check(seen["calls"] == 1 and counts["K2"] >= 1
          and counts["K1"] == chunks + counts["K2"],
          f"full width, sequence parallel: launches {counts}, {chunks} "
          f"chunks")
    log(f"full width -g, sequence-parallel route on a mesh of 1 "
        f"({chunks} chunks of one strip): wall {wall:.2f} s (phase 5, the "
        f"direct route: {fw['wall_s']:.2f} s), byte-identical to phase 5; "
        f"launches {counts}")
    return {"wall_s": wall, "counts": counts, "chunks": chunks}


def phase_seqpar_mesh(lp, af, device="cuda"):
    """Phase 29: the long pair through the sequence-parallel route on
    ``["cuda:0"] * 4``, linear and affine, byte-identical to phases 12 and
    15; each strip's boundaries those of the single-card fill."""
    result = {}
    for name, costs, ref in (("linear", None, lp),
                             ("affine", CHUNK_AFFINE, af)):
        argv = LONG_PAIR if costs is None else [*DNA_AFFINE, *LONG_PAIR]
        ref_out = ref["out"] if costs is None else ref["long_out"]
        ref_wall = ref["wall_s"] if costs is None else ref["long_wall_s"]
        request = read_request(["-g", *argv])
        text = np.asarray(request.text, dtype=np.int32)
        pattern = np.asarray(request.pattern, dtype=np.int32)
        n, m, k = len(text), len(pattern), request.alphabet_size
        sm = layout.pack_score_matrix(request.score_matrix, k)
        seen = {}
        real_traceback = checkpoint.checkpointed_traceback

        def traceback(*args, **kwargs):
            t0 = time.time()
            out = real_traceback(*args, **kwargs)
            torch.cuda.synchronize()
            seen["traceback_s"] = time.time() - t0
            return out

        reset_launches()
        checkpoint.checkpointed_traceback = traceback
        try:
            with environment(SEQALIGN_SEQUENCE_PARALLEL="1"), \
                    default_mesh(["cuda:0"] * MESH_ENTRIES), \
                    sequence_fill_spy(seen), \
                    plain_versions_forbidden(PAIR_PLAIN):
                t0 = time.time()
                rc, out = run_cli(["-g", *argv])
                wall = time.time() - t0
        finally:
            checkpoint.checkpointed_traceback = real_traceback
        counts = launches()
        ck = seen.pop("ck")
        strips, cols = len(ck.colvals), ck.ckpt_cols
        chunks = -(-n // cols)
        check(rc == 0 and out == ref_out,
              f"{name} long pair on the mesh: not the bytes of phase "
              f"{12 if costs is None else 15}")
        check(seen["calls"] == 1 and counts["K2"] >= 1
              and counts["K1"] == strips * chunks + counts["K2"],
              f"{name} long pair on the mesh: launches {counts}")
        kw = {} if costs is None else dict(gap_extend=costs[1])
        single = checkpoint.checkpointed_fill(text, pattern, sm, k,
                                              request.gap_penalty,
                                              device=device, **kw)
        whole = n // cols
        pairs = [("colvals", "boundaries")] + (
            [("colvals_e", "boundaries_f")] if costs else [])
        for cname, bname in pairs:
            for b in range(strips):
                check(torch.equal(getattr(ck, cname)[b][:whole],
                                  getattr(single, cname)[b][:whole])
                      and torch.equal(getattr(ck, bname)[b][:n],
                                      getattr(single, bname)[b][:n]),
                      f"{name} long pair: strip {b}'s {cname}/{bname} "
                      f"differ from the single-card fill")
        check((ck.score, ck.best_i, ck.best_j)
              == (single.score, single.best_i, single.best_j),
              f"{name} long pair: best cell differs from the single card")
        del single, ck
        log(f"{name} long pair {m} x {n} on the mesh cuda:0 x "
            f"{MESH_ENTRIES} ({strips} strips, {chunks} chunks, "
            f"{strips + chunks - 1} supersteps): -g wall {wall:.2f} s "
            f"(phase {12 if costs is None else 15}, the checkpoint engine "
            f"on one card: {ref_wall:.2f} s), fill {seen['fill_s']:.2f} s, "
            f"traceback {seen['traceback_s']:.2f} s; byte-identical to "
            f"phase {12 if costs is None else 15}; each strip's colvals "
            f"and boundaries equal the single-card fill's; launches "
            f"{counts}")
        result[name] = {"wall_s": wall, "fill_s": seen["fill_s"],
                        "traceback_s": seen["traceback_s"],
                        "counts": counts, "chunks": strips * chunks,
                        "ref_wall_s": ref_wall}
    return result


def phase_strip_pipeline(oracle_score, local_best, device="cuda"):
    """Phase 30: sequence_parallel_fill (K5) on ``["cuda:0"] * 4``: the
    full-width pair's score and best cell against the oracle, global and
    local; its words on a small pair against the plain version's (the
    same pipeline on CPU entries)."""
    request = read_request(FULL_WIDTH)
    text = np.asarray(request.text, dtype=np.int32)
    pattern = np.asarray(request.pattern, dtype=np.int32)
    n, m, k, gap = len(text), len(pattern), request.alphabet_size, \
        request.gap_penalty
    sm = layout.pack_score_matrix(request.score_matrix, k)
    mesh = mesh_lib.DataMesh([device] * MESH_ENTRIES)
    result = {}
    for local in (False, True):
        strip_fill.strip_fill.launches = 0
        with plain_versions_forbidden(STRIP_PLAIN):
            (score, bi, bj, _), ms = timed(
                sequence.sequence_parallel_fill, text, pattern, sm, k, gap,
                local=local, mesh=mesh, block_rows=STRIP_PIPE_ROWS)
        count = strip_fill.strip_fill.launches
        if local:
            best, flat = local_best()
            want = (best, flat // (n + 1), flat % (n + 1))
        else:
            want = (oracle_score(), m, n)
        check((score, bi, bj) == want,
              f"sequence_parallel_fill {'local' if local else 'global'}: "
              f"{(score, bi, bj)} != the oracle's {want}")
        mode = "local" if local else "global"
        log(f"sequence_parallel_fill {mode} at full width on cuda:0 x "
            f"{MESH_ENTRIES} ({STRIP_PIPE_ROWS}-row blocks): wall "
            f"{ms:.1f} ms, {count} K5 launches; score and best cell == the "
            f"oracle's")
        result[mode] = {"wall_ms": ms, "launches": count}
    rng = np.random.default_rng(30)
    n, m = STRIP_PIPE_WORDS
    text = rng.integers(0, 4, n).astype(np.int32)
    pattern = rng.integers(0, 4, m).astype(np.int32)
    for local in (False, True):
        got = sequence.sequence_parallel_fill(text, pattern, DNA_5_4, 4, 5,
                                              local=local, with_dirs=True,
                                              mesh=mesh)
        want = sequence.sequence_parallel_fill(
            text, pattern, DNA_5_4, 4, 5, local=local, with_dirs=True,
            mesh=mesh_lib.DataMesh(["cpu"] * MESH_ENTRIES))
        mode = "local" if local else "global"
        check(got[:3] == want[:3] and np.array_equal(got[3], want[3]),
              f"sequence_parallel_fill words ({mode}): the card's differ "
              f"from the plain version's")
    log(f"sequence_parallel_fill with words, {m} x {n} on "
        f"{MESH_ENTRIES} x 2,048 columns: words, score and best cell equal "
        f"the plain version's, global and local")
    return result


def phase_batch_mesh(score_data, align_data, runs, device="cuda"):
    """Phase 31: BatchAligner(mesh=...) on meshes of 1 and 2 entries of
    the card: phases 8-9's and 21-22's workloads, every score and
    alignment equal to those phases' results."""
    texts_s, patterns_s, _ = score_data
    texts_a, patterns_a, _ = align_data
    result = {}
    for k in BATCH_MESHES:
        mesh = mesh_lib.DataMesh([device] * k)
        for costs, (sw_ref, aw_ref) in ((None, runs[0]),
                                        (BATCH_AFFINE, runs[1])):
            gap, ext = costs or (5, None)
            aligner = BatchAligner(DNA_5_4, 4, gap, local=True,
                                   gap_extend=ext, mesh=mesh)
            tile, chunk = aligner._dirs_tile_pairs(ALIGN_WIDTH[1],
                                                   ALIGN_WIDTH[1], k)
            chunks = -(-ALIGN_WIDTH[0] // chunk)
            reset_batch_launches()
            with plain_versions_forbidden(), environment(
                    SEQALIGN_INT16_CELLS="0"):
                scores, score_ms = timed(aligner.score, list(texts_s),
                                         list(patterns_s))
                results, align_ms = timed(aligner.align, texts_a,
                                          patterns_a)
            counts = batch_launches()
            what = (f"BatchAligner on cuda:0 x {k}"
                    + (f", open {gap} extend {ext}" if ext else ""))
            check(np.array_equal(scores, sw_ref["scores"]),
                  f"{what}: scores differ from phase {21 if ext else 8}")
            bad = [i for i, (r, w) in enumerate(zip(results,
                                                    aw_ref["results"]))
                   if not same_alignment(r, (w.aligned_text,
                                             w.aligned_pattern,
                                             w.start_in_aligned_text,
                                             w.start_in_aligned_pattern,
                                             w.score))]
            check(not bad, f"{what}: pairs {bad[:10]} differ from phase "
                           f"{22 if ext else 9}")
            check(counts["K3-score"] == k
                  and counts["K3-dirs"] == counts["K4"] == chunks * k,
                  f"{what}: launches {counts}, {chunks} chunks")
            log(f"{what}: .score {score_ms:.1f} ms (phase "
                f"{21 if ext else 8}: {sw_ref['wall_ms']:.1f} ms), .align "
                f"{align_ms:.1f} ms (phase {22 if ext else 9}: "
                f"{aw_ref['wall_ms']:.1f} ms); every score and alignment "
                f"equal to those phases'; launches {counts}")
            result[f"{k}{'-affine' if ext else ''}"] = {
                "score_wall_ms": score_ms, "align_wall_ms": align_ms,
                "counts": counts}
    return result


def phase_batch_processes(procs):
    """Phase 32: WORKERS processes of ``seqalign_torch.parallel.worker``
    sharing the card over gloo, two mesh entries each; each byte-checks
    its shard, and the all-gathered scores equal one process's."""
    with contextlib.closing(socket.socket()) as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.time()
    waits = [procs.start([sys.executable, "-m",
                          "seqalign_torch.parallel.worker", str(rank),
                          str(WORKERS), str(port), "2", str(WORKER_PAIRS),
                          "--device", "cuda"])
             for rank in range(WORKERS)]
    outs = [wait() for wait in waits]
    wall = time.time() - t0
    texts, patterns = worker.batch(WORKERS * WORKER_PAIRS)
    scores = BatchAligner(worker.SM, 4, worker.GAP, local=True).score(
        list(texts), list(patterns))
    digest = hashlib.sha1(scores.astype(np.int32).tobytes()).hexdigest()
    for rank, (rc, out, err) in enumerate(outs):
        line = [x for x in out.splitlines() if x.startswith("OK ")]
        check(rc == 0 and len(line) == 1,
              f"worker {rank}: rc {rc}\n{out}\n{err[-3000:]}")
        fields = line[0].split()
        check(fields[1:3] == [str(rank), str(WORKER_PAIRS)]
              and fields[5] == f"scores={digest}",
              f"worker {rank}: {line[0]} (one process: scores={digest})")
        log(f"worker {rank} of {WORKERS}: {line[0]}")
    log(f"{WORKERS} worker processes on the card over gloo: wall "
        f"{wall:.1f} s; the all-gathered scores equal one process's")
    return {"wall_s": wall}


# The pair models whose score() phase 33 runs, by mode.
SCORE_MODELS = {"global": NeedlemanWunsch(), "local": SmithWaterman(),
                "semi": SemiGlobal()}
# Phase 34: the suite verbs at reduced sizes (keyword arguments of each
# verb; maxlength and engines at their own defaults), then the headline.
BENCH_VERBS = (
    ("throughput", suite.throughput, dict(sizes=[(16384, 16384)])),
    ("throughput --local", suite.throughput,
     dict(local=True, sizes=[(32768, 4096)])),
    ("latency", suite.latency, dict(sizes=[(4096, 4096)])),
    ("batch --dna", suite.batch, dict(dna=True, pairs=[SCORE_WIDTH[0]])),
    ("batch --dna --affine-extend 2", suite.batch,
     dict(dna=True, pairs=[SCORE_WIDTH[0]], affine_extend=2)),
    ("batch-e2e --dna --local", suite.batch_e2e,
     dict(size=ALIGN_WIDTH[1], dna=True, local=True, pairs=[16384])),
    ("maxlength", suite.maxlength, {}),
    ("maxlength --engine tiled", suite.maxlength, dict(engine="tiled")),
    ("engines", suite.engines, {}),
)


def score_pairs():
    """Phase 4's bundled pairs, once each (the mode flags dropped):
    (argv, request)."""
    pairs = {}
    for _, argv in MAIN_PATH:
        argv = [a for a in argv
                if a not in ("--global", "--local", "--semi-global")]
        pairs.setdefault(tuple(argv), read_request(argv))
    return list(pairs.items())


def score_oracle(pairs):
    """``oracle_fill``'s score of each pair in each mode."""
    return {(argv, mode): bindings.oracle_fill(
                ALGO[mode], req.text, req.pattern, req.score_matrix,
                req.alphabet_size, req.gap_penalty)[1]
            for argv, req in pairs for mode in SCORE_MODELS}


def kernel_ms_since(start):
    """Device ms of the ledger's launches from index ``start`` on."""
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for _, _, a, b in LEDGER[start:])


def phase_score(pairs, oracle, wide, device="cuda"):
    """Phase 33: the models' score() (K1 score-only, the checkpoint
    engine's phase 1) on the card.  ``pairs`` and ``oracle`` are phase 4's
    pairs and their oracle_fill scores; ``wide`` is (name, argv, mode,
    the oracle's score-only fill, the same pair's align() wall or None)
    for the full-width pairs.  Every score equal to the oracle's, K1
    launched a strip a call and no plain version run.  Returns the walls
    and kernel times of the wide pairs."""
    reset_launches()
    with plain_versions_forbidden(PAIR_PLAIN):
        for argv, req in pairs:
            for mode, model in SCORE_MODELS.items():
                got = model.score(req.text, req.pattern, req.score_matrix,
                                  req.alphabet_size, req.gap_penalty,
                                  device=device)
                want = oracle[argv, mode]
                check(got == want, f"score() {mode} {' '.join(argv)}: {got}, "
                                   f"oracle_fill {want}")
            log(f"score() of {' '.join(argv)} ({len(req.text)} x "
                f"{len(req.pattern)}): global, local and semi-global each "
                f"equal to oracle_fill's")
        small = launches()
        check(small["K1"] >= 3 * len(pairs) and small["K2"] == 0,
              f"score() on phase 4's pairs: launches {small}")
        rows = {}
        for name, argv, mode, want, align_wall in wide:
            req = read_request(argv)
            m = len(req.pattern)
            rps, slots = checkpoint._pick_geometry(m, None, None)
            strips = -(-m // (rps * slots))
            before, first = launches(), len(LEDGER)
            torch.cuda.synchronize()
            t0 = time.time()
            got = SCORE_MODELS[mode].score(
                req.text, req.pattern, req.score_matrix, req.alphabet_size,
                req.gap_penalty, device=device)
            torch.cuda.synchronize()
            wall = time.time() - t0
            kernel_ms = kernel_ms_since(first)
            delta = {k: v - before[k] for k, v in launches().items()}
            want = want()
            want = want[0] if isinstance(want, tuple) else want
            check(got == want, f"score() {mode} on the {name}: {got}, the "
                               f"oracle's score-only fill {want}")
            check(delta == {"K1": strips, "K2": 0},
                  f"score() {mode} on the {name}: launches {delta}, not "
                  f"{strips} K1 strips")
            beside = (f"; align() of the pair through -g, global, "
                      f"{align_wall:.3f} s" if align_wall else "")
            log(f"score() {mode} on the {name} ({m} x {len(req.text)}, rps "
                f"{rps} x {slots} slots): {got} == the oracle's score-only "
                f"fill; wall {wall:.3f} s, {strips} K1 strips, "
                f"{kernel_ms:.2f} ms of K1{beside}")
            rows[f"{name} {mode}"] = {"wall_s": wall, "kernel_ms": kernel_ms,
                                      "strips": strips, "score": got}
    return rows


def phase_bench(procs, sw):
    """Phase 34: each suite verb at a reduced size on the card (the
    kernels' launches counted, no plain version run), maxlength's two
    engines and score() on one pair, then the headline in a process of
    its own, its last line parsed, beside phase 8's K3."""
    counters = (("K1", wavefront.wavefront_strip),
                ("K2", walk.walk_skewed_window),
                ("K3-score", batch_fill.batch_score),
                ("K3-dirs", batch_fill.batch_fill_dirs),
                ("K4", batch_traceback.batch_walk),
                ("K5", strip_fill.strip_fill))
    wanted = {"throughput": {"K1"}, "latency": {"K1", "K2"},
              "batch": {"K3-score"}, "batch-e2e": {"K3-dirs", "K4"},
              "maxlength": {"K1"}, "maxlength --engine tiled": {"K5"},
              "engines": {"K1", "K5"}}
    rows = {}
    with plain_versions_forbidden(PAIR_PLAIN + BATCH_PLAIN + STRIP_PLAIN):
        for label, verb, kwargs in BENCH_VERBS:
            before = {name: fn.launches for name, fn in counters}
            t0 = time.time()
            rows[label] = verb(**kwargs)
            wall = time.time() - t0
            delta = {name: fn.launches - before[name]
                     for name, fn in counters}
            need = wanted.get(label, wanted[label.split(" --")[0]])
            check(all(delta[name] > 0 for name in need),
                  f"suite {label}: launches {delta}, not {sorted(need)}")
            log(f"suite {label}: {wall:.1f} s, launches "
                f"{json.dumps({k: v for k, v in delta.items() if v})}")
        length = rows["maxlength"][0]["length"]
        (_, text, pattern), = suite.maxlength_pairs([length])
        scores = {row[0]["engine"]: row[0]["score"] for row in (
            rows["maxlength"], rows["maxlength --engine tiled"])}
        model = SmithWaterman().score(text, pattern, DNA_5_4, 4, suite.GAP)
        check(scores["wavefront"] == scores["tiled"] == model,
              f"maxlength {length}: K1 {scores['wavefront']}, K5 "
              f"{scores['tiled']}, score() {model}")
        log(f"maxlength {length} x {length}: K1 (wavefront_fill, score "
            f"only) and K5 (tiled_fill_score) both score {model}, as "
            f"SmithWaterman.score()")
    t0 = time.time()
    rc, out, err = procs.start([sys.executable, "-m",
                                "seqalign_torch.bench.headline"])()
    wall = time.time() - t0
    check(rc == 0, f"headline: rc {rc}\n{err[-3000:]}")
    record = json.loads(out.strip().splitlines()[-1])
    check(set(record) == {"metric", "value", "unit", "vs_baseline"}
          and record["metric"] == "sw_batch_fill"
          and record["unit"] == "GCUPS" and record["value"] > 0,
          f"headline: last line {record}")
    b, n, m, _ = SCORE_WIDTH
    k3_ms = sw["K3-score"]["ms"]
    log(f"headline (python -m seqalign_torch.bench.headline, {wall:.1f} s): "
        f"{json.dumps(record)}; {err.strip().splitlines()[-1]}; phase 8's "
        f"K3 on the 512 x 639 bucket: {k3_ms:.3f} ms, "
        f"{b * n * m / k3_ms / 1e6:.1f} GCUPS of the workload's cells")
    rows["headline"] = record
    rows["headline_wall_s"] = wall
    return rows


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    os.chdir(REPO)
    procs = Subprocesses()
    try:
        return run(procs)
    finally:
        procs.stop()


def run(procs):
    t_start = time.time()
    # 1. Build: one nvcc per kernel source and g++ for the oracle, at once.
    oracle_lib = in_thread(ensure_built)
    walk_lib = in_thread(walk_shapes.library)
    batch_walk_lib = in_thread(batch_walk_shapes.library)
    kernels = _build.build_all()
    oracle_lib()
    install_ledger()
    # The longest host work first: the oracle's score-only fill of the
    # long pair for phase 12 (ctypes releases the GIL).
    long_pair = read_request(LONG_PAIR)
    long_score = in_thread(
        lambda: bindings.oracle_fill_affine(
            0, long_pair.text, long_pair.pattern,
            layout.pack_score_matrix(long_pair.score_matrix,
                                     long_pair.alphabet_size),
            long_pair.alphabet_size, long_pair.gap_penalty,
            long_pair.gap_penalty)[0])
    # Its local score for phase 33.
    long_local = in_thread(
        lambda: bindings.oracle_fill_affine(
            1, long_pair.text, long_pair.pattern,
            layout.pack_score_matrix(long_pair.score_matrix,
                                     long_pair.alphabet_size),
            long_pair.alphabet_size, long_pair.gap_penalty,
            long_pair.gap_penalty)[0])
    # And the affine score-only fills of phase 15's two pairs.
    affine_scores = {}
    for name, argv in (("direct", FULL_WIDTH), ("long", LONG_PAIR)):
        req = read_request([*DNA_AFFINE, *argv])
        affine_scores[name] = in_thread(
            lambda req=req: bindings.oracle_fill_affine(
                0, req.text, req.pattern,
                layout.pack_score_matrix(req.score_matrix,
                                         req.alphabet_size),
                req.alphabet_size, req.gap_penalty, req.gap_extend)[0])
    log(f"build: {time.time() - t_start:.1f} s "
        f"({', '.join(sorted(kernels))} and the native oracle)")
    for path in kernels.values():
        for line in ptxas_summary(path):
            log(line)
    # K1 keeps its state in registers: no instance may spill.
    k1_lines = [line for line in ptxas_summary(kernels["wavefront"])
                if "wavefront_strip_kernel" in line]
    spilled = [line for line in k1_lines if "spill stores 0 B" not in line]
    check(k1_lines and not spilled, f"K1 spills: {spilled or 'no lines'}")
    log(f"K1: {len(k1_lines)} instances, none spills")
    # K5 too.
    k5_lines = [line for line in ptxas_summary(kernels["strip"])
                if "strip_band_kernel" in line]
    spilled = [line for line in k5_lines if "spill stores 0 B" not in line]
    check(k5_lines and not spilled, f"K5 spills: {spilled or 'no lines'}")
    log(f"K5: {len(k5_lines)} instances, none spills")
    # K2's move loop keeps its state in registers too; its window shape in
    # code is the one ops/walk.py names.
    k2_lines = [line for line in ptxas_summary(kernels["walk"])
                if "walk_window_kernel" in line]
    spilled = [line for line in k2_lines if "spill stores 0 B" not in line]
    check(k2_lines and not spilled, f"K2 spills: {spilled or 'no lines'}")
    shapes = {(rps, affine): walk.library_window_shape(
        _build.library("walk"), rps, affine)
        for rps in walk.WINDOW_SHAPES for affine in (False, True)}
    check(all(shape == walk.window_shape(*key)
              for key, shape in shapes.items()),
          f"K2's window shapes {shapes} differ from ops/walk.py's")
    log(f"K2: {len(k2_lines)} instances, none spills; windows (slots, "
        f"groups) by rps, linear/affine, as ops/walk.py names them: "
        + ", ".join(f"{rps}: {shapes[rps, False]}/{shapes[rps, True]}"
                    for rps in walk.WINDOW_SHAPES))
    # K3 and K3-cell16 keep a stripe's rows in registers too.
    k3_lines = [line for name in ("interpair", "interpair16")
                for line in ptxas_summary(kernels[name])
                if "interpair" in line]
    spilled = [line for line in k3_lines if "spill stores 0 B" not in line]
    check(len(k3_lines) == 24 and not spilled,
          f"K3 spills: {spilled or k3_lines or 'no lines'}")
    log(f"K3, K3-cell16: {len(k3_lines)} instances, none spills")
    # K4's walks keep their state in registers too; its shapes in code are
    # the ones ops/batch_traceback.py names.
    k4_lines = [line for line in ptxas_summary(kernels["batch_walk"])
                if "walk_kernel" in line]
    spilled = [line for line in k4_lines if "spill stores 0 B" not in line]
    check(len(k4_lines) == 8 and not spilled,
          f"K4 spills: {spilled or k4_lines or 'no lines'}")
    k4_shapes = batch_traceback.library_shapes(_build.library("batch_walk"))
    want_shapes = {"run": batch_traceback.RUN,
                   "threads": batch_traceback.BATCH_THREADS,
                   "window": batch_traceback.PACKED_WINDOW}
    check(k4_shapes == want_shapes, f"K4's shapes {k4_shapes} differ from "
                                    f"ops/batch_traceback.py's")
    log(f"K4: {len(k4_lines)} instances, none spills; shapes as "
        f"ops/batch_traceback.py names them: {k4_shapes}")
    t1 = time.time()
    walk_lib = walk_lib()
    batch_walk_lib = batch_walk_lib()
    log(f"K2's and K4's all-shapes builds (probes/walk_shapes.py, "
        f"probes/batch_walk_shapes.py): ready {time.time() - t1:.1f} s "
        f"after the kernels")

    # Host work beside the device phases: the oracle's outputs for
    # phase 4, a fresh-process -g run, and the score-only fill for
    # phase 5 (ctypes releases the GIL).
    oracle_outputs = [procs.start(port_cli("-c", argv))
                      for _, argv in MAIN_PATH]
    module_g = procs.start(port_cli("-g", [*DNA]))
    full = Request()
    check(cli.parse_arguments(["alignSequence", *FULL_WIDTH], full) == 0,
          "cannot read the full-width pair")
    oracle_score = in_thread(
        lambda: bindings.oracle_fill_affine(
            0, full.text, full.pattern,
            layout.pack_score_matrix(full.score_matrix, full.alphabet_size),
            full.alphabet_size, full.gap_penalty, full.gap_penalty)[0])
    # Its local best cell, for phase 30.
    local_best = in_thread(
        lambda: bindings.oracle_fill_affine(
            1, full.text, full.pattern,
            layout.pack_score_matrix(full.score_matrix, full.alphabet_size),
            full.alphabet_size, full.gap_penalty, full.gap_penalty))
    # The batch phases' inputs, and their oracle results in threads.
    cases = {(k, mode): batch_mix(k, 90 + k)
             for k in (4, 23) for mode in MODES}
    batch_expected = in_thread(batch_oracle, cases)
    score_data = score_width_data()
    oracle_scores = in_thread(lambda: [
        bindings.oracle_fill(1, score_data[0][i], score_data[1][i], DNA_5_4,
                             4, 5)[1] for i in score_data[2]])
    align_data = align_width_data()
    oracle_aligned = in_thread(lambda: [
        bindings.oracle_align(1, align_data[0][i], align_data[1][i],
                              DNA_5_4, 4, 5) for i in align_data[2]])
    # The affine batch phases' oracle results (phases 20-22).
    affine_expected = in_thread(batch_oracle, cases, BATCH_AFFINE)
    oracle_scores_affine = in_thread(lambda: [
        bindings.oracle_fill_affine(1, score_data[0][i], score_data[1][i],
                                    DNA_5_4, 4, *BATCH_AFFINE)[0]
        for i in score_data[2]])
    oracle_aligned_affine = in_thread(lambda: [
        bindings.oracle_align_affine(1, align_data[0][i], align_data[1][i],
                                     DNA_5_4, 4, *BATCH_AFFINE)
        for i in align_data[2]])
    ck_cases = ckpt_cases()
    ck_expected = in_thread(ckpt_oracle, ck_cases)
    affine_outputs = [procs.start(port_cli("-c", argv))
                      for argv in AFFINE_MAIN_PATH]
    strip_outputs = [procs.start(port_cli("-c", argv)) for argv in STRIP_BIG]
    aff_cases = affine_ckpt_cases()
    aff_expected = in_thread(affine_ckpt_oracle, aff_cases)
    score_ps = score_pairs()
    score_expected = in_thread(score_oracle, score_ps)

    t0 = begin_phase("2-3")
    k1_err, k2_err = phase_kernels()
    walk_window_check(walk_lib, affine=False)
    log(f"phases 2-3 (K1, K2 against their plain versions): "
        f"{time.time() - t0:.1f} s")

    t0 = begin_phase("4")
    by_route = phase_main_path(oracle_outputs)
    rc_m, out_m, err_m = module_g()
    check(rc_m == 0 and out_m == oracle_outputs[0]()[1],
          f"python -m seqalign_torch -g: rc {rc_m}, {err_m}")
    log("python -m seqalign_torch -g " + " ".join(DNA)
        + ": byte-identical to -c")
    log(f"phase 4 (main path): {time.time() - t0:.1f} s, launches by "
        f"route {json.dumps(by_route)}")

    t0 = begin_phase("5")
    fw = phase_full_width(oracle_score)
    log(f"phase 5 (full width): {time.time() - t0:.1f} s")

    t0 = begin_phase("6")
    batch_errs = phase_batch_kernels(batch_walk_lib)
    log(f"phase 6 (K3, K4 against their plain versions): "
        f"{time.time() - t0:.1f} s")
    t0 = begin_phase("7")
    batch_counts = phase_batch_main_path(cases, batch_expected)
    log(f"phase 7 (batch main path): {time.time() - t0:.1f} s, launches "
        f"{json.dumps(batch_counts)}")
    t0 = begin_phase("8")
    sw = phase_score_width(score_data, oracle_scores)
    log(f"phase 8 (full width, scores): {time.time() - t0:.1f} s")
    t0 = begin_phase("9")
    aw = phase_align_width(align_data, oracle_aligned)
    log(f"phase 9 (full width, alignments): {time.time() - t0:.1f} s")
    t0 = begin_phase("10")
    ck_k1_err, ck_k2_err = phase_ckpt_kernels()
    log(f"phase 10 (K1's checkpoint variants against their plain "
        f"versions): {time.time() - t0:.1f} s")
    t0 = begin_phase("11")
    ck_counts = phase_ckpt_main_path(ck_cases, ck_expected)
    log(f"phase 11 (checkpoint engine, small tiles): "
        f"{time.time() - t0:.1f} s, launches {json.dumps(ck_counts)}")
    t0 = begin_phase("12")
    lp = phase_long_pair(long_score)
    log(f"phase 12 (checkpoint engine, full width): "
        f"{time.time() - t0:.1f} s")
    t0 = begin_phase("13")
    aff_errs, aff_plain = phase_affine_kernels()
    walk_window_check(walk_lib, affine=True)
    log(f"phase 13 (affine K1, K2 against their plain versions): "
        f"{time.time() - t0:.1f} s")
    t0 = begin_phase("14")
    aff_direct, aff_ck = phase_affine_main_path(affine_outputs, aff_cases,
                                                aff_expected)
    log(f"phase 14 (affine main path): {time.time() - t0:.1f} s, launches "
        f"direct {json.dumps(aff_direct)}, checkpoint engine "
        f"{json.dumps(aff_ck)}")
    t0 = begin_phase("15")
    af = phase_affine_full_width(affine_scores["direct"],
                                 affine_scores["long"])
    log(f"phase 15 (affine, full width): {time.time() - t0:.1f} s")
    t0 = begin_phase("16")
    k5_err = phase_strip_kernel()
    log(f"phase 16 (K5 against its plain version): "
        f"{time.time() - t0:.1f} s")
    t0 = begin_phase("17")
    strip_counts, k5_single_err, single_args = phase_strip_main_path(
        oracle_outputs, affine_outputs, strip_outputs)
    log(f"phase 17 (the strip engine through -g): {time.time() - t0:.1f} s, "
        f"launches {json.dumps(strip_counts)}")
    t0 = begin_phase("18")
    sf = phase_strip_full_width(fw["out"], oracle_score, long_score,
                                single_args, batch_walk_lib)
    del single_args
    log(f"phase 18 (the strip engine, full width): "
        f"{time.time() - t0:.1f} s")
    t0 = begin_phase("19")
    aff_batch_errs = phase_batch_kernels(batch_walk_lib, affine=True)
    log(f"phase 19 (affine K3, K4 against their plain versions): "
        f"{time.time() - t0:.1f} s")
    t0 = begin_phase("20")
    aff_batch_counts = phase_batch_main_path(cases, affine_expected,
                                             costs=BATCH_AFFINE)
    log(f"phase 20 (affine batch main path): {time.time() - t0:.1f} s, "
        f"launches {json.dumps(aff_batch_counts)}")
    t0 = begin_phase("21")
    asw = phase_score_width(score_data, oracle_scores_affine,
                            costs=BATCH_AFFINE, linear=sw)
    log(f"phase 21 (affine, full width, scores): {time.time() - t0:.1f} s")
    t0 = begin_phase("22")
    aaw = phase_align_width(align_data, oracle_aligned_affine,
                            costs=BATCH_AFFINE, linear=aw)
    log(f"phase 22 (affine, full width, alignments): "
        f"{time.time() - t0:.1f} s")
    t0 = begin_phase("23")
    c16_errs = phase_cell16_kernels()
    log(f"phase 23 (K3-cell16 against its plain version and the int32 K3): "
        f"{time.time() - t0:.1f} s")
    t0 = begin_phase("24 mixes")
    c16_counts = phase_cell16_main_path(cases, batch_expected)
    c16_aff_counts = phase_cell16_main_path(cases, affine_expected,
                                            costs=BATCH_AFFINE)
    begin_phase("24 width")
    c16_sw = phase_score_width(score_data, oracle_scores, int32=sw)
    c16_aw = phase_align_width(align_data, oracle_aligned, int32=aw)
    c16_asw = phase_score_width(score_data, oracle_scores_affine,
                                costs=BATCH_AFFINE, int32=asw)
    c16_aaw = phase_align_width(align_data, oracle_aligned_affine,
                                costs=BATCH_AFFINE, int32=aaw)
    log(f"phase 24 (the int16 batch path): {time.time() - t0:.1f} s, "
        f"launches {json.dumps(c16_counts)}, affine "
        f"{json.dumps(c16_aff_counts)}")
    t0 = begin_phase("25")
    p2_row, p2_fails = phase_dpx16()
    log(f"phase 25 (P2, packed int16 operations): {time.time() - t0:.1f} s"
        + (f"; not exact: {', '.join(p2_fails)}" if p2_fails else ""))
    check(not p2_fails, f"P2: {p2_fails} differ from their plain versions")
    t0 = begin_phase("26")
    p1_row = phase_chase()
    log(f"phase 26 (P1, the dependent chain of loads): "
        f"{time.time() - t0:.1f} s")
    t0 = begin_phase("27")
    mk = phase_mesh_kernels()
    log(f"phase 27 (K1's sequence-parallel chunk against its plain "
        f"version; K1 and K5 on four streams at once): "
        f"{time.time() - t0:.1f} s")
    t0 = begin_phase("28")
    sp1 = phase_seqpar_one(fw)
    log(f"phase 28 (sequence parallel, a mesh of 1): "
        f"{time.time() - t0:.1f} s")
    t0 = begin_phase("29")
    sp4 = phase_seqpar_mesh(lp, af)
    log(f"phase 29 (sequence parallel, cuda:0 x {MESH_ENTRIES}): "
        f"{time.time() - t0:.1f} s")
    t0 = begin_phase("30")
    spf = phase_strip_pipeline(oracle_score, local_best)
    log(f"phase 30 (K5 pipeline, cuda:0 x {MESH_ENTRIES}): "
        f"{time.time() - t0:.1f} s")
    t0 = begin_phase("31")
    bm = phase_batch_mesh(score_data, align_data, ((sw, aw), (asw, aaw)))
    log(f"phase 31 (data parallel in one process): "
        f"{time.time() - t0:.1f} s")
    t0 = begin_phase("32")
    bp = phase_batch_processes(procs)
    log(f"phase 32 (data parallel across {WORKERS} processes): "
        f"{time.time() - t0:.1f} s")
    t0 = begin_phase("33")
    sc = phase_score(score_ps, score_expected(), (
        ("full-width pair", FULL_WIDTH, "global", oracle_score,
         fw["wall_s"]),
        ("full-width pair", FULL_WIDTH, "local", local_best, None),
        ("long pair", LONG_PAIR, "global", long_score, lp["wall_s"]),
        ("long pair", LONG_PAIR, "local", long_local, None)))
    log(f"phase 33 (score() on the card): {time.time() - t0:.1f} s")
    t0 = begin_phase("34")
    bench = phase_bench(procs, sw)
    log(f"phase 34 (the suite verbs and the headline): "
        f"{time.time() - t0:.1f} s")

    # K1 with words from column 0 (phases 4-5); K2 wherever it walks
    # (phases 4-5 and the path tiles of phases 11-12); K1's checkpoint
    # variants: a phase-1 strip per strip, a tile per path tile (11-12).
    # The sequence-parallel route (phases 28-29): K1 = chunks + path
    # tiles, K2 = path tiles.
    ck_tiles = ck_counts["K2"] + lp["counts"]["K2"]
    sp_tiles = sp1["counts"]["K2"] + sp4["linear"]["counts"]["K2"]
    pair_launches = {
        "K1": (by_route["wavefront"]["K1"] + by_route["direct"]["K1"]
               + fw["counts"]["K1"]),
        "K2": (by_route["wavefront"]["K2"] + by_route["direct"]["K2"]
               + fw["counts"]["K2"] + ck_tiles + sp_tiles),
        "K1-ckpt": ck_counts["K1"] + lp["counts"]["K1"] - ck_tiles,
        "K1-tile": ck_tiles + sp_tiles,
        "K1-chunk": sp1["chunks"] + sp4["linear"]["chunks"],
    }
    aff_tiles = aff_ck["K2"] + af["long_counts"]["K2"]
    sp_aff_tiles = sp4["affine"]["counts"]["K2"]
    pair_launches.update({
        "K1-affine": aff_direct["K1"] + af["direct_counts"]["K1"],
        "K2-affine": (aff_direct["K2"] + af["direct_counts"]["K2"]
                      + aff_tiles + sp_aff_tiles),
        "K1-affine-ckpt": aff_ck["K1"] + af["long_counts"]["K1"] - aff_tiles,
        "K1-affine-tile": aff_tiles + sp_aff_tiles,
        "K1-affine-chunk": sp4["affine"]["chunks"],
    })
    # K2's chain floor: its moves, each one dependent load from shared
    # memory at P1's cost in this run (the 32 KiB table).
    chain_ns = p1_row["shared_ns_per_step"]
    fw["K2"].update(tile_ms=lp["k2_tile_ms"], tile_moves=lp["k2_tile_moves"])
    summary = []
    for name, kid, replaces, row, err in (
        ("K1 wavefront_strip", "K1", "seqalign_tpu/ops/wavefront.py:71",
         fw["K1"] | {"shape": fw["shape"]}, k1_err),
        ("K2 walk_skewed_window", "K2", "seqalign_tpu/ops/pallas_walk.py:37",
         fw["K2"] | {"shape": fw["shape"]}, max(k2_err, ck_k2_err)),
        ("K1-ckpt wavefront_strip (score-only, column checkpoints)",
         "K1-ckpt", "seqalign_tpu/ops/wavefront.py:71", lp["K1-ckpt"],
         ck_k1_err),
        ("K1-tile wavefront_strip (left column, words)", "K1-tile",
         "seqalign_tpu/ops/wavefront.py:71", lp["K1-tile"], ck_k1_err),
        ("K1-chunk wavefront_strip (score-only, column checkpoints, left "
         "column: the sequence-parallel chunk)", "K1-chunk",
         "seqalign_tpu/ops/wavefront.py:71", mk["K1-chunk"], 0),
        ("K1-affine-chunk wavefront_strip (affine, score-only, column "
         "checkpoints, left columns: the sequence-parallel chunk)",
         "K1-affine-chunk", "seqalign_tpu/ops/wavefront.py:71",
         mk["K1-affine-chunk"], 0),
    ) + tuple(
        (name, kid, replaces,
         af[kid] | dict(zip(("plain_ms", "plain_shape"), aff_plain[kid]),
                        err=0),
         aff_errs[kid])
        for name, kid, replaces in (
            ("K1-affine wavefront_strip (affine, words)", "K1-affine",
             "seqalign_tpu/ops/wavefront.py:71"),
            ("K1-affine-ckpt wavefront_strip (affine, score-only, "
             "column checkpoints)", "K1-affine-ckpt",
             "seqalign_tpu/ops/wavefront.py:71"),
            ("K1-affine-tile wavefront_strip (affine, left columns, words)",
             "K1-affine-tile", "seqalign_tpu/ops/wavefront.py:71"),
            ("K2-affine walk_skewed_window (three-state walk)", "K2-affine",
             "seqalign_tpu/ops/pallas_walk.py:37"),
        )
    ):
        err = max(row["err"], err)
        source = ("seqalign_torch/csrc/walk.cu" if kid.startswith("K2")
                  else "seqalign_torch/csrc/wavefront.cu")
        summary.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": pair_launches[kid],
            "max_abs_err": err, "exact": err == 0,
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None, "shape": row["shape"],
            "plain_shape": row.get("plain_shape", row["shape"]),
        })
        if kid.startswith("K2"):
            summary[-1].update(
                moves=row["moves"], tile_ms=row["tile_ms"],
                tile_moves=row["tile_moves"],
                chain_ns_per_move=chain_ns,
                chain_floor_ms=row["moves"] * chain_ns / 1e6,
                tile_chain_floor_ms=row["tile_moves"] * chain_ns / 1e6)
            log(f"{kid}: {row['ms']:.3f} ms for {row['moves']} moves at "
                f"full width, {row['tile_ms']:.3f} ms for "
                f"{row['tile_moves']} in a path tile; chain floor (a "
                f"dependent shared-memory load a move, P1 {chain_ns:.1f} "
                f"ns): {row['moves'] * chain_ns / 1e6:.3f} and "
                f"{row['tile_moves'] * chain_ns / 1e6:.3f} ms, "
                f"{100 * row['moves'] * chain_ns / 1e6 / row['ms']:.0f} % "
                f"and {100 * row['tile_moves'] * chain_ns / 1e6 / row['tile_ms']:.0f}"
                f" % of it; bound {row['bound_ms']:.5f} ms ({row['bound_by']})")
    # The batch kernels: linear (phases 6-9) and affine (phases 19-22).
    # Each wrapper counts both instances: a phase's counts are its own.
    interpair = ("seqalign_torch/csrc/interpair.cu",
                 "seqalign_tpu/ops/pallas_fill.py:222")
    batch_walk = ("seqalign_torch/csrc/batch_walk.cu",
                  "seqalign_tpu/ops/batch_traceback.py:187")
    # Phase 31's launches, the data-parallel runs, by the row's costs.
    mesh_counts = {costs: {kid: sum(bm[f"{k}{costs}"]["counts"][kid]
                                    for k in BATCH_MESHES)
                           for kid in ("K3-score", "K3-dirs", "K4")}
                   for costs in ("", "-affine")}
    for name, (source, replaces), counter, width, main, errs, more in (
        ("K3-score batch_score", interpair, "K3-score", sw, batch_counts,
         batch_errs, mesh_counts[""]),
        ("K3-dirs batch_fill_dirs", interpair, "K3-dirs", aw, batch_counts,
         batch_errs, mesh_counts[""]),
        ("K4 batch_walk", batch_walk, "K4", aw, batch_counts, batch_errs,
         mesh_counts[""]),
        ("K3-affine-score batch_score (affine)", interpair, "K3-score", asw,
         aff_batch_counts, aff_batch_errs, mesh_counts["-affine"]),
        ("K3-affine-dirs batch_fill_dirs (affine, run bits)", interpair,
         "K3-dirs", aaw, aff_batch_counts, aff_batch_errs,
         mesh_counts["-affine"]),
        ("K4-affine batch_walk (three-state walk)", batch_walk, "K4", aaw,
         aff_batch_counts, aff_batch_errs, mesh_counts["-affine"]),
    ):
        kid = name.split()[0]
        row = width[kid]
        err = max(row["err"], errs[kid])
        summary.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": (main[counter] + width["counts"][counter]
                         + more[counter]),
            "max_abs_err": err, "exact": err == 0,
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None, "shape": row.get("shape", width.get("shape")),
        })
        if kid.startswith("K4"):
            summary[-1].update(floor_ms=row["floor_ms"],
                               floor_by=row["floor_by"])
    # K4's single-pair walk: the strip engine's device walks (phases
    # 17-18); its floor is its moves' chain, a dependent shared-memory
    # load a move at P1's cost in this run.
    row = sf["K4-packed"]
    launched = (strip_counts["K4-packed"] + sf["host"]["counts"]["K4-packed"]
                + sf["device"]["counts"]["K4-packed"])
    check(launched >= 1, "K4-packed: no launch on the main path")
    summary.append({
        "name": "K4-packed walk_packed (single-pair walk, strip engine)",
        "route": "cuda", "source": "seqalign_torch/csrc/batch_walk.cu",
        "replaces": "seqalign_tpu/ops/batch_traceback.py:187",
        "launches": launched, "max_abs_err": row["err"],
        "exact": row["err"] == 0, "ms": row["ms"],
        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": None,
        "shape": row["shape"], "plain_shape": row["plain_shape"],
        "moves": row["moves"], "chain_ns_per_move": chain_ns,
        "floor_ms": row["moves"] * chain_ns / 1e6, "floor_by": "chain"})
    log(f"K4-packed: {row['ms']:.3f} ms for {row['moves']} moves at full "
        f"width, {row['ms'] * 1e6 / row['moves']:.1f} ns a move; chain floor "
        f"(a dependent shared-memory load a move, P1 {chain_ns:.1f} ns): "
        f"{summary[-1]['floor_ms']:.3f} ms, "
        f"{100 * summary[-1]['floor_ms'] / row['ms']:.0f} % of it")
    for entry in summary:
        if entry["name"].split()[0] in ("K4", "K4-affine"):
            log(f"{entry['name'].split()[0]}: {entry['ms']:.4f} ms a chunk; "
                f"sector floor {entry['floor_ms']:.4f} ms "
                f"({100 * entry['floor_ms'] / entry['ms']:.0f} % of it), "
                f"bound {entry['bound_ms']:.5f} ms ({entry['bound_by']})")
    row = sf["K5"]
    err = max(row["err"], k5_err, k5_single_err)
    summary.append({
        "name": "K5 strip_fill", "route": "cuda",
        "source": "seqalign_torch/csrc/strip.cu",
        "replaces": "seqalign_tpu/ops/pallas_fill.py:908",
        "launches": (strip_counts["K5"] + sf["host"]["counts"]["K5"]
                     + sf["device"]["counts"]["K5"]
                     + sf["long_counts"]["K5"]
                     + spf["global"]["launches"]
                     + spf["local"]["launches"]),
        "max_abs_err": err, "exact": err == 0,
        "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": None, "shape": row["shape"],
        "plain_shape": row["plain_shape"],
    })
    # K3-cell16 (phase 24): the mixes and the full-width workloads under
    # SEQALIGN_INT16_CELLS; the probes (phases 25-26): their own runs.
    for name, kid, counter, width, main in (
        ("K3-cell16-score batch_score (int16 cells)", "K3-cell16-score",
         "K3-cell16-score", c16_sw, c16_counts),
        ("K3-cell16-dirs batch_fill_dirs (int16 cells)", "K3-cell16-dirs",
         "K3-cell16-dirs", c16_aw, c16_counts),
        ("K3-cell16-affine-score batch_score (affine, int16 cells)",
         "K3-cell16-affine-score", "K3-cell16-score", c16_asw,
         c16_aff_counts),
        ("K3-cell16-affine-dirs batch_fill_dirs (affine, int16 cells, run "
         "bits)", "K3-cell16-affine-dirs", "K3-cell16-dirs", c16_aaw,
         c16_aff_counts),
    ):
        row = width[kid]
        err = max(row["err"], c16_errs[kid])
        launched = main[counter] + width["counts"][counter]
        check(launched >= 1, f"{kid}: no launch on the main path")
        summary.append({
            "name": name, "route": "cuda",
            "source": "seqalign_torch/csrc/interpair16.cu",
            "replaces": "seqalign_tpu/ops/pallas_fill.py:222",
            "launches": launched, "max_abs_err": err, "exact": err == 0,
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None,
            "shape": row.get("shape", width.get("shape")),
        })
    for name, source, replaces, row in (
        ("P2 dpx16 (packed int16 operations: apply and rate kernels)",
         "seqalign_torch/csrc/probe_dpx16.cu",
         "scripts/mosaic_micro_probe.py:35", p2_row),
        ("P1 chase (dependent chain of loads)",
         "seqalign_torch/csrc/probe_chase.cu",
         "scripts/probe_walk_costs.py:59", p1_row),
    ):
        check(row["launches"] >= 1, f"{name}: no launch")
        summary.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": row["launches"],
            "max_abs_err": row["err"], "exact": row["err"] == 0,
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None, "shape": row["shape"],
        })
    log(json.dumps({"batch_int16": {
        "score_wall_ms": c16_sw["wall_ms"],
        "score_gcups_kernel": c16_sw["gcups_kernel"],
        "align_wall_ms": c16_aw["wall_ms"],
        "align_pairs_per_s": c16_aw["pairs_per_s"],
        "affine_score_wall_ms": c16_asw["wall_ms"],
        "affine_score_gcups_kernel": c16_asw["gcups_kernel"],
        "affine_align_wall_ms": c16_aaw["wall_ms"],
        "affine_align_pairs_per_s": c16_aaw["pairs_per_s"]}}))
    log(json.dumps({"strip": {
        "host": {key: v for key, v in sf["host"].items() if key != "counts"},
        "device": {key: v for key, v in sf["device"].items()
                   if key != "counts"},
        "d2h_block_ms": sf["d2h_block_ms"],
        "d2h_pinned_ms": sf["d2h_pinned_ms"], "blocks": sf["blocks"],
        "plain_last_ms": sf["plain_last_ms"],
        "plain_long_ms": sf["plain_long_ms"],
        "long_score_wall_s": sf["long_score_wall_s"],
        "k5_interior_ms": sf["K5"]["ms"], "k5_interior_ctas": sf["k5_ctas"],
        "k5_interior_sms": sf["k5_sms"],
        "k5_interior_bound_ms": sf["K5"]["bound_ms"],
        "k5_long_ms": sf["k5_long_ms"],
        "k5_long_bound_ms": sf["k5_long_bound_ms"],
        "k5_single_ms": sf["k5_single_ms"],
        "k5_single_bound_ms": sf["k5_single_bound_ms"]}}))
    log(json.dumps({"batch": {
        "score_wall_ms": sw["wall_ms"], "score_gcups_wall": sw["gcups_wall"],
        "score_gcups_kernel": sw["gcups_kernel"],
        "align_wall_ms": aw["wall_ms"], "align_pairs_per_s": aw["pairs_per_s"],
        "align_peak_bytes": aw["peak_bytes"]}}))
    log(json.dumps({"batch_affine": {
        "score_wall_ms": asw["wall_ms"],
        "score_gcups_wall": asw["gcups_wall"],
        "score_gcups_kernel": asw["gcups_kernel"],
        "align_wall_ms": aaw["wall_ms"],
        "align_pairs_per_s": aaw["pairs_per_s"],
        "align_peak_bytes": aaw["peak_bytes"]}}))
    log(json.dumps({"long_pair": {
        key: lp[key] for key in ("wall_s", "phase1_s", "phase2_s", "strips",
                                 "tiles", "peak_bytes", "tile_host_ms",
                                 "readback_ms", "phase2_rest_ms")}}))
    log(json.dumps({"affine": {
        key: af[key] for key in ("direct_wall_s", "direct_peak_bytes",
                                 "long_wall_s", "long_phase1_s",
                                 "long_phase2_s", "long_strips", "long_tiles",
                                 "long_peak_bytes")}}))
    # The mesh phases (27-32), host-clock walls beside the single-card
    # routes of the same run.  The mesh repeats one card: these measure
    # the pipeline's overhead, not scaling across cards.
    log(json.dumps({"mesh": {
        "k1_streams_ms": mk["k1_streams_ms"],
        "k1_alone_ms": mk["k1_alone_ms"],
        "k5_streams_ms": mk["k5_streams_ms"],
        "k5_alone_ms": mk["k5_alone_ms"],
        "seqpar_1_wall_s": sp1["wall_s"], "direct_wall_s": fw["wall_s"],
        # A chunk's cost beyond its steps, in steps at the long pair's
        # phase-1 strip rate (K1-ckpt), beside the gate's constant.
        "chunk_overhead_steps": (
            mk["K1-chunk"]["ms"] * lp["strip_steps"] / lp["K1-ckpt"]["ms"]
            - mk["chunk_steps"]),
        "gate_overhead_steps": sequence.PIPE_CHUNK_OVERHEAD_STEPS,
        "seqpar_4": {name: {key: v for key, v in run.items()
                            if key != "counts"}
                     for name, run in sp4.items()},
        "strip_pipeline": spf,
        "batch": {name: {key: v for key, v in run.items()
                         if key != "counts"}
                  for name, run in bm.items()},
        "batch_single": {"score_wall_ms": sw["wall_ms"],
                         "align_wall_ms": aw["wall_ms"],
                         "affine_score_wall_ms": asw["wall_ms"],
                         "affine_align_wall_ms": aaw["wall_ms"]},
        "workers_wall_s": bp["wall_s"]}}))
    log(json.dumps({"score": sc}))
    log(json.dumps({"bench": bench}))
    check(len(REPEATED) == 6, f"K1 repeat checks: {REPEATED}")
    log(json.dumps({"k1_repeats": [
        {"what": what, "runs": REPEATS, "ctas": ctas, "sms": sms}
        for what, ctas, sms in REPEATED]}))
    check(len(STRIP_REPEATED) == 2, f"K5 repeat checks: {STRIP_REPEATED}")
    log(json.dumps({"k5_repeats": [
        {"what": what, "runs": REPEATS, "ctas": ctas, "sms": sms}
        for what, ctas, sms in STRIP_REPEATED]}))
    # Each row's device time on the main path, every launch's own, by
    # phase; then over one run of each workload (WORKLOAD_PHASES), the
    # rows in order of their longest launch.
    ledger = ledger_sums()
    workload = ledger_sums(WORKLOAD_PHASES)
    for entry in summary:
        kid = entry["name"].split()[0]
        # score() and the suite verbs (phases 33-34) by the ledger's rows.
        entry["launches"] += sum(
            ledger.get(kid, {}).get("phases", {}).get(p, [0])[0]
            for p in ("33", "34"))
        entry["main_path_ms"] = ledger.get(kid, {}).get("ms")
        entry["workload_ms"] = workload.get(kid, {}).get("ms")
    log(json.dumps({"launch_ledger": ledger}))
    # The longest K3 launch of the ragged mixes (phases 7, 20, 24).
    ragged = max((w["phases"][ph][2], row, ph)
                 for row, w in ledger.items() if row.startswith("K3")
                 for ph in ("7", "20", "24 mixes") if ph in w["phases"])
    log(f"longest K3 launch of the ragged mixes: {ragged[0]:.3f} ms "
        f"({ragged[1]}, phase {ragged[2]}; before the chain of warps "
        f"{K3_RAGGED_BEFORE_MS} ms)")
    log(json.dumps({"k3_ragged_longest": {
        "ms": ragged[0], "row": ragged[1], "phase": ragged[2],
        "before_ms": K3_RAGGED_BEFORE_MS}}))
    check(len(K3_REPEATED) == 24, f"K3 repeat checks: {K3_REPEATED}")
    log(json.dumps({"k3_repeats": [
        {"what": what, "runs": REPEATS, "ctas": ctas, "warps": warps}
        for what, ctas, warps in K3_REPEATED]}))
    log(json.dumps({"workload_ledger": [
        {"row": row, "launches": w["launches"], "ms": w["ms"],
         "max_ms": w["max_ms"], "phases": w["phases"]}
        for row, w in sorted(workload.items(),
                             key=lambda x: -x[1]["max_ms"])]}))
    log(f"total: {time.time() - t_start:.1f} s")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(json.dumps({"kernels": summary}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
