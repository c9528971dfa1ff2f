"""Benchmark suite of the GPU engine: the reference's grids
(tests/benchmarks.cu), as ``seqalign_tpu/bench/suite.py`` runs them, with
the same verbs, arguments and defaults:

  * fill throughput (MCUPS) over square global and rectangular local
    sizes (benchmarks.cu:102-189), K1 with its words beside the native
    oracle's fill;
  * end-to-end latency incl. traceback (benchmarks.cu:191-269), through
    ``api.align`` on the GPU engine and the native oracle;
  * batch throughput, K3's scores (benchmarks.cu:271-332), and the batch
    end to end, ``BatchAligner.align``;
  * the max-length probe (benchmarks.cu:335-363), a score-only local fill
    through K1 or the tiled fill (K5);
  * the engines on one fill: K5's single-region fill and K1 at three
    strip geometries.

Random protein requests mirror fillDummyRequest (benchmarks.cu:21-42).
Every verb is a function of its sizes (the JAX defaults) on
``config.device()``, the card unless ``SEQALIGN_TORCH_DEVICE=cpu`` asks
for the plain versions; it prints its table and returns its rows.

  python -m seqalign_torch.bench.suite throughput [--local] [--sizes 4096x4096 ...] [--cpu-max N]
  python -m seqalign_torch.bench.suite latency
  python -m seqalign_torch.bench.suite batch [--size 512] [--dna] [--pairs B ...] [--semi] [--affine-extend E]
  python -m seqalign_torch.bench.suite batch-e2e [--size 512] [--dna] [--local] [--pairs B ...]
  python -m seqalign_torch.bench.suite maxlength [--lengths L ...] [--engine wavefront|tiled]
  python -m seqalign_torch.bench.suite engines [--size 4096]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from .. import config, constants
from .timing import device_seconds_per_call, wall_seconds

NUM_REPEATS = 5  # best-of, like the reference (benchmarks.cu:5)
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DNA_5_4 = np.where(np.eye(4, dtype=bool), 5, -4).astype(np.int32)
GAP = 5
# 65536^2 is the reference's headline latency size
# (benchmark_latency_tesla.out: 3702 ms global on a V100).
LATENCY_SIZES = ((4096, 4096), (16384, 16384), (65536, 65536))
BATCH_PAIRS = (1024, 2048, 4096, 8192)
BATCH_E2E_PAIRS = (1, 8, 32, 256, 1024)
# The engines verb's K1 geometries (rows a slot, slots): the wavefront
# route's strip, the 4,096-slot strip and the deep strip.
K1_GEOMETRIES = (("wavefront route", 8, 1024), ("4096-slot", 4, 4096),
                 ("deep-strip", 16, 4096))


def _random_protein(rng, n):
    return rng.integers(0, constants.NUM_PROTEIN_CHARS, n).astype(np.int32)


def _blosum50():
    from ..io import parse_score_matrix_file

    k = constants.NUM_PROTEIN_CHARS
    sm = np.zeros((k, k), dtype=np.int32)
    path = os.path.join(REPO, constants.DEFAULT_PROTEIN_SCORE_MATRIX_FILE)
    if not os.path.exists(path) or parse_score_matrix_file(path, k, sm):
        raise FileNotFoundError(f"cannot read {path}")
    return sm


def k1_strip_call(text, pattern, sm, k, rps, slots, local, device):
    """A call of K1 with its words over the first strip of (rps, slots)
    of text x pattern (the pattern's first rps*slots letters), on tensors
    already on ``device``; and the strips the whole pattern takes."""
    from ..ops import layout, wavefront

    n, m = len(text), len(pattern)
    steps_pad = layout.steps_padded(n, slots)
    pat = np.zeros(rps * slots, dtype=np.int32)
    pat[:min(m, rps * slots)] = pattern[:rps * slots]
    ts = torch.from_numpy(layout.text_steps(text, steps_pad)).to(device)
    bottom = torch.zeros_like(ts)
    slots_in = torch.from_numpy(layout.pattern_slots(pat, rps, slots)).to(
        device)
    sm_d = torch.from_numpy(layout.pack_score_matrix(sm, k)).to(device)

    def call():
        return wavefront.wavefront_strip(
            ts, bottom, slots_in, sm_d, GAP, n, m, 0, k, local=local,
            with_dirs=True, rps=rps, slots=slots)

    return call, -(-m // (rps * slots))


def throughput(local=False, sizes=None, cpu_max=16384, reps=NUM_REPEATS,
               timings=3):
    """Fill throughput of one pair, words included: K1 at the direct
    route's geometry for the pattern (``ops/direct.py``), a strip's time
    times the strips; the native oracle's fill beside it up to
    ``cpu_max``."""
    from ..native import bindings
    from ..ops import direct

    device = torch.device(config.device())
    rng = np.random.default_rng(0)
    sm = _blosum50()
    if sizes is None:
        # Reference grid: {256..16384} x 32768 local (benchmarks.cu:104-126).
        sizes = ([(32768, 2 ** e) for e in range(8, 15)] if local
                 else [(2 ** e, 2 ** e) for e in range(8, 17)])
    print(f"Fill throughput ({'local' if local else 'global'}), direction "
          f"matrix included, CUDA-event timing")
    print(f"{'size':>16} {'gpu ms':>10} {'gpu MCUPS':>10} {'cpu ms':>10} "
          f"{'cpu MCUPS':>10}")
    rows = []
    for n, m in sizes:
        rps, slots = direct._direct_geometry(m)
        call, strips = k1_strip_call(_random_protein(rng, n),
                                     _random_protein(rng, m), sm, 23, rps,
                                     slots, local, device)
        sec = device_seconds_per_call(call, reps, timings, device) * strips
        row = {"n": n, "m": m, "gpu_ms": sec * 1e3,
               "gpu_mcups": n * m / sec / 1e6, "cpu_ms": None,
               "cpu_mcups": None}
        cpu_str = f"{'-':>10} {'-':>10}"
        if max(n, m) <= cpu_max:
            text, pattern = _random_protein(rng, n), _random_protein(rng, m)
            cpu_sec = wall_seconds(lambda: bindings.oracle_fill(
                1 if local else 0, text, pattern, sm, 23, GAP), repeats=1)
            row.update(cpu_ms=cpu_sec * 1e3,
                       cpu_mcups=n * m / cpu_sec / 1e6)
            cpu_str = f"{cpu_sec * 1e3:>10.1f} {row['cpu_mcups']:>10.0f}"
        print(f"{n:>8}x{m:<7} {sec * 1e3:>10.1f} {row['gpu_mcups']:>10.0f} "
              f"{cpu_str}", flush=True)
        rows.append(row)
    return rows


def latency(sizes=LATENCY_SIZES, cpu_max=16384, repeats=3):
    """End-to-end latency of one alignment, ``api.align`` through
    ``Device.GPU`` (``config.device()``) and ``Device.CPU`` (the oracle,
    up to ``cpu_max``); where both run, their alignments must agree."""
    from .. import api
    from ..constants import AlignmentType, Device
    from ..types import Request, Response

    rng = np.random.default_rng(1)
    sm = _blosum50()
    print(f"End-to-end latency (fill + transfer + traceback), best of "
          f"{repeats}")
    print(f"{'size':>16} {'algo':>8} {'gpu ms':>10} {'cpu ms':>12}")
    rows = []
    for n, m in sizes:
        for algo in (AlignmentType.GLOBAL, AlignmentType.LOCAL):
            request = Request()
            request.set_sequence_type(constants.SequenceType.PROTEIN)
            request.alignment_type = algo
            request.gap_penalty = GAP
            request.text = _random_protein(rng, n).astype(np.int8)
            request.pattern = _random_protein(rng, m).astype(np.int8)
            request.score_matrix[:23, :23] = sm
            responses = {}

            def run(device_type):
                request.device_type = device_type
                response = Response()
                if api.align(request, response):
                    raise RuntimeError(f"{device_type.value} align of "
                                       f"{n}x{m} {algo.value} failed")
                responses[device_type] = response

            t_gpu = wall_seconds(lambda: run(Device.GPU), repeats)
            t_cpu = float("nan")
            if n <= cpu_max:
                t_cpu = wall_seconds(lambda: run(Device.CPU), repeats=1)
                got, want = responses[Device.GPU], responses[Device.CPU]
                if vars(got) != vars(want):
                    raise AssertionError(f"{n}x{m} {algo.value}: the GPU "
                                         f"engine's alignment differs")
            rows.append({"n": n, "m": m, "algo": algo.value,
                         "gpu_ms": t_gpu * 1e3, "cpu_ms": t_cpu * 1e3})
            print(f"{n:>8}x{m:<7} {algo.value:>8} {t_gpu * 1e3:>10.0f} "
                  f"{t_cpu * 1e3:>12.0f}", flush=True)
    return rows


def batch(size=512, dna=False, pairs=None, semi=False, affine_extend=None,
          timings=3):
    """Scores of batches of size x size pairs through K3 (its affine
    instance with ``affine_extend``, K3-cell16 where ``config.int16_cells``
    and the gate say so, as on the batch path), on tensors already on the
    device.  Protein global pairs like the reference's fillDummyRequest
    batches; ``dna`` runs local DNA pairs, bench.py's workload."""
    from ..ops import batch_fill
    from ..parallel.batch import cell16_for

    device = torch.device(config.device())
    rng = np.random.default_rng(2)
    k = 4 if dna else 23
    sm = DNA_5_4 if dna else _blosum50()
    n = m = size
    mode = "semi" if semi else ("local" if dna else "global")
    affine = (f", affine extend {affine_extend}"
              if affine_extend is not None else "")
    cell16 = cell16_for(n, m, sm, k, GAP, affine_extend)
    print(f"Batch throughput, {n}x{m} {mode} {'DNA' if dna else 'protein'} "
          f"pairs (scores{affine}{', int16 cells' if cell16 else ''})")
    print(f"{'batch':>8} {'ms':>10} {'pairs/s':>12} {'GCUPS':>8}")
    sm_d = torch.from_numpy(sm).to(device)
    rows = []
    for b in pairs or BATCH_PAIRS:
        texts = torch.from_numpy(
            rng.integers(0, k, (b, n)).astype(np.int32)).to(device)
        patterns = torch.from_numpy(
            rng.integers(0, k, (b, m)).astype(np.int32)).to(device)
        ns = torch.full((b,), n, dtype=torch.int32, device=device)
        ms = torch.full((b,), m, dtype=torch.int32, device=device)

        def call():
            return batch_fill.batch_score(
                texts, patterns, ns, ms, sm_d, GAP, k,
                local=dna and not semi, semi=semi, gap_extend=affine_extend,
                cell16=cell16)

        # Small batches take well under a millisecond; more calls a
        # window keep the events' resolution out of the figure.
        reps = max(3, min(16, (1 << 24) // max(1, b)))
        sec = device_seconds_per_call(call, reps, timings, device)
        rows.append({"pairs": b, "ms": sec * 1e3, "pairs_per_s": b / sec,
                     "gcups": b * n * m / sec / 1e9, "cell16": cell16})
        print(f"{b:>8} {sec * 1e3:>10.3f} {b / sec:>12.0f} "
              f"{b * n * m / sec / 1e9:>8.1f}", flush=True)
    return rows


def batch_e2e(size=512, dna=False, local=False, pairs=None, repeats=2):
    """End-to-end batch alignment (K3 with words, K4, the host's replay),
    the analog of the reference's batch benchmark, which could only loop
    full requests one at a time (tests/benchmarks.cu:271-332, 32x 8192^2
    global in 7205 ms on a GT 750M).  ``BatchAligner.align`` on the
    default mesh (every visible card, or the CPU under
    ``SEQALIGN_TORCH_DEVICE=cpu``), best of ``repeats``."""
    from ..parallel.batch import BatchAligner

    rng = np.random.default_rng(5)
    k = 4 if dna else 23
    sm = DNA_5_4 if dna else _blosum50()
    n = m = size
    aligner = BatchAligner(sm, k, GAP, local=local)
    print(f"End-to-end batch alignment, {n}x{m} "
          f"{'local' if local else 'global'} {'DNA' if dna else 'protein'} "
          f"pairs, wall time best of {repeats}")
    print(f"{'batch':>8} {'ms':>10} {'pairs/s':>10} {'GCUPS e2e':>10}")
    rows = []
    for b in pairs or BATCH_E2E_PAIRS:
        texts = [rng.integers(0, k, n).astype(np.int32) for _ in range(b)]
        patterns = [rng.integers(0, k, m).astype(np.int32) for _ in range(b)]
        box = {}

        def run():
            box["results"] = aligner.align(texts, patterns)

        sec = wall_seconds(run, repeats)
        if len(box["results"]) != b:
            raise AssertionError(f"{len(box['results'])} results for {b} "
                                 f"pairs")
        rows.append({"pairs": b, "ms": sec * 1e3, "pairs_per_s": b / sec,
                     "gcups_e2e": b * n * m / sec / 1e9})
        print(f"{b:>8} {sec * 1e3:>10.0f} {b / sec:>10.0f} "
              f"{b * n * m / sec / 1e9:>10.2f}", flush=True)
    return rows


def maxlength_pairs(lengths):
    """The maxlength verb's random DNA pairs, (length, text, pattern)
    for each length in turn (seed 3)."""
    rng = np.random.default_rng(3)
    for size in lengths:
        yield (size, rng.integers(0, 4, size).astype(np.int32),
               rng.integers(0, 4, size).astype(np.int32))


def maxlength(lengths=(120000,), engine="wavefront", repeats=2):
    """Max-length probe (reference benchmarkMaxLength,
    benchmarks.cu:335-363).  The reference's 500k x 500k demo runs under
    the BENCHMARK macro, which skips traceback
    (alignSequenceGPU.cu:555-626), so the fair comparison is a score-only
    local fill: K1 score-only over strips of 4 x 4096 slots
    (``wavefront_fill(with_dirs=False)``, engine ``wavefront``) or the
    tiled fill's score (K5, engine ``tiled``).  Wall, best of
    ``repeats``."""
    from ..ops import tiled, wavefront

    device = torch.device(config.device())
    rows = []
    for size, text, pattern in maxlength_pairs(lengths):
        box = {}

        def run():
            if engine == "wavefront":
                box["score"] = wavefront.wavefront_fill(
                    text, pattern, DNA_5_4, 4, GAP, local=True,
                    with_dirs=False, rps=4, slots=4096, device=device)[0]
            else:
                box["score"] = tiled.tiled_fill_score(
                    text, pattern, DNA_5_4, 4, GAP, local=True,
                    device=device)

        sec = wall_seconds(run, repeats)
        rows.append({"length": size, "engine": engine, "ms": sec * 1e3,
                     "mcups": size * size / sec / 1e6,
                     "score": int(box["score"])})
        print(f"{size}x{size} ({engine}): {sec * 1e3:.0f} ms "
              f"({size * size / sec / 1e6:.0f} MCUPS), score={box['score']}",
              flush=True)
    return rows


def engines(size=4096, reps=3, timings=3):
    """The engines on one local DNA fill with its words, the analog of the
    reference's diagonal-vs-horizontal kernel benchmark
    (benchmarks.cu:56-100): K5's fill of one region (``pair_fill``, which
    reads its state back to the host inside the window) and K1 at
    K1_GEOMETRIES (a strip's time times the strips).  The JAX suite's
    first row, its XLA scan engine, has no counterpart."""
    from ..ops import strip_fill

    device = torch.device(config.device())
    rng = np.random.default_rng(4)
    n = m = size
    text = rng.integers(0, 4, n).astype(np.int32)
    pattern = rng.integers(0, 4, m).astype(np.int32)
    cells = n * m
    print(f"{'xla scan engine:':22s} not ported (ops/scan_engine.py)",
          flush=True)
    rows = [{"engine": "xla scan engine", "ms": None, "mcups": None}]

    def report(name, sec):
        rows.append({"engine": name, "ms": sec * 1e3,
                     "mcups": cells / sec / 1e6})
        print(f"{name + ':':22s} {sec * 1e3:9.1f} ms  "
              f"{cells / sec / 1e6:9.0f} MCUPS", flush=True)

    pat = np.zeros(strip_fill.pair_rows(m), dtype=np.int32)
    pat[:m] = pattern
    region = [torch.from_numpy(x).to(device) for x in (
        strip_fill.strip_letters(text, 0, strip_fill.pair_columns(n)),
        DNA_5_4, pat)]
    report("K5 strip fill", device_seconds_per_call(
        lambda: strip_fill.pair_fill(*region, GAP, n, m, local=True), reps,
        timings, device))
    for name, rps, slots in K1_GEOMETRIES:
        call, strips = k1_strip_call(text, pattern, DNA_5_4, 4, rps, slots,
                                     True, device)
        report(f"K1 {name} {rps}x{slots}",
               device_seconds_per_call(call, reps, timings, device) * strips)
    return rows


def main(argv=None) -> int:
    # Multi-host runs: join the process group before any device use
    # (a no-op otherwise; see parallel/mesh.py).
    from ..parallel.mesh import maybe_initialize_distributed

    maybe_initialize_distributed()
    parser = argparse.ArgumentParser(prog="python -m seqalign_torch.bench.suite")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("throughput")
    p.add_argument("--local", action="store_true")
    p.add_argument("--sizes", nargs="*", help="e.g. 4096x4096")
    p.add_argument("--cpu-max", type=int, default=16384, dest="cpu_max",
                   help="skip the CPU column above this size")
    p = sub.add_parser("latency")
    p = sub.add_parser("batch")
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--dna", action="store_true")
    p.add_argument("--pairs", nargs="*", type=int)
    p.add_argument("--semi", action="store_true")
    p.add_argument("--affine-extend", type=int, default=None,
                   dest="affine_extend")
    p = sub.add_parser("batch-e2e")
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--dna", action="store_true")
    p.add_argument("--local", action="store_true")
    p.add_argument("--pairs", nargs="*", type=int)
    p = sub.add_parser("maxlength")
    p.add_argument("--lengths", nargs="*", type=int, default=[120000])
    p.add_argument("--engine", choices=("tiled", "wavefront"),
                   default="wavefront")
    p = sub.add_parser("engines")
    p.add_argument("--size", type=int, default=4096)
    args = parser.parse_args(argv)
    if args.cmd == "throughput":
        sizes = args.sizes and [tuple(map(int, s.split("x")))
                                for s in args.sizes]
        throughput(local=args.local, sizes=sizes, cpu_max=args.cpu_max)
    elif args.cmd == "latency":
        latency()
    elif args.cmd == "batch":
        batch(size=args.size, dna=args.dna, pairs=args.pairs, semi=args.semi,
              affine_extend=args.affine_extend)
    elif args.cmd == "batch-e2e":
        batch_e2e(size=args.size, dna=args.dna, local=args.local,
                  pairs=args.pairs)
    elif args.cmd == "maxlength":
        maxlength(lengths=args.lengths, engine=args.engine)
    else:
        engines(size=args.size)
    return 0


if __name__ == "__main__":
    sys.exit(main())
