"""The 64k-pair batch workload end to end, as one JSON record.

  python -m seqalign_torch.bench.batch_e2e [--pairs 65536] [--size 256]
      [--warm-reps 4] [--out PATH]

Runs BASELINE.json's batch (65,536 local DNA pairs of 256 x 256, match 5,
mismatch -4, gap 5, seed 9) through ``BatchAligner.align`` (K3 with
words, K4, the host's replay) on ``config.device()``: one cold run (it
builds the kernels) and ``--warm-reps`` warm ones, each wall printed;
then three pairs are checked against the native oracle, byte for byte.
The record (the role of ``scripts/bench_batch_e2e_metric.py``'s: pairs/s
of the best warm wall) is the last line on stdout, and is written to
``--out`` when given (nowhere else).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

PAIRS, SIZE, SEED = 65536, 256, 9
GAP = 5


def run(pairs=PAIRS, size=SIZE, warm_reps=4, out=None, seed=SEED) -> dict:
    """Run the workload, print each wall and the record, write the
    record to ``out`` if given; return it."""
    from ..native import bindings
    from ..parallel.batch import BatchAligner

    rng = np.random.default_rng(seed)
    sm = np.where(np.eye(4, dtype=bool), 5, -4).astype(np.int32)
    texts = [rng.integers(0, 4, size).astype(np.int32) for _ in range(pairs)]
    patterns = [rng.integers(0, 4, size).astype(np.int32)
                for _ in range(pairs)]
    aligner = BatchAligner(sm, 4, GAP, local=True)
    walls = []
    for label in ["cold"] + [f"warm{r}" for r in range(warm_reps)]:
        t0 = time.perf_counter()
        results = aligner.align(texts, patterns)
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if len(results) != pairs:
            raise AssertionError(f"{len(results)} results for {pairs} pairs")
        print(f"[batch-e2e:{label}] {pairs} pairs {size}x{size}: "
              f"{walls[-1]:.3f} s, {pairs / walls[-1]:,.0f} pairs/s",
              flush=True)
    # A few pairs against the oracle: the record certifies a correct run.
    for i in sorted({0, pairs // 2, pairs - 1}):
        at, ap, st, sp, score = bindings.oracle_align(
            1, texts[i].astype(np.int8), patterns[i].astype(np.int8), sm, 4,
            GAP)
        r = results[i]
        if not (r.score == score and np.array_equal(r.aligned_text, at)
                and np.array_equal(r.aligned_pattern, ap)
                and (r.start_in_aligned_text, r.start_in_aligned_pattern)
                == (st, sp)):
            raise AssertionError(f"pair {i} differs from the oracle")
    print(f"[batch-e2e] oracle spot check OK "
          f"({len({0, pairs // 2, pairs - 1})} pairs)", flush=True)
    warm = min(walls[1:]) if len(walls) > 1 else walls[0]
    record = {
        "metric": "dna_batch_e2e", "pairs": pairs, "size": size,
        "value": round(pairs / warm, 1), "unit": "pairs/s",
        "gcups_e2e": round(pairs * size * size / warm / 1e9, 2),
        "cold_wall_s": round(walls[0], 3), "warm_wall_s": round(warm, 3),
        "warm_walls_s": [round(w, 3) for w in walls[1:]],
        "device": (torch.cuda.get_device_name(0)
                   if torch.cuda.is_initialized() else "cpu"),
    }
    line = json.dumps(record)
    print(line, flush=True)
    if out:
        with open(out, "w") as f:
            f.write(line + "\n")
    return record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m seqalign_torch.bench.batch_e2e")
    ap.add_argument("--pairs", type=int, default=PAIRS)
    ap.add_argument("--size", type=int, default=SIZE)
    ap.add_argument("--warm-reps", type=int, default=4, dest="warm_reps")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    run(pairs=args.pairs, size=args.size, warm_reps=args.warm_reps,
        out=args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
