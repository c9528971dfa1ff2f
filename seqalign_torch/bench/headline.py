"""Headline benchmark: batched Smith-Waterman fill throughput (GCUPS).

  python -m seqalign_torch.bench.headline

Prints ONE JSON line on stdout, the last:

  {"metric": "sw_batch_fill", "value": <GCUPS>, "unit": "GCUPS",
   "vs_baseline": <value / 14.354>}

and its details before it on stderr.  The workload is bench.py's: 8,192
local DNA pairs of 512 x 512 (match 5, mismatch -4, gap 5, seed 42), 2.1
G cells, scored by K3 (``ops/batch_fill.batch_score``; K3-cell16 when
``SEQALIGN_INT16_CELLS`` and the int16 gate say so, as on the batch path)
on tensors already on the card, timed with ``device_seconds_per_call``
(16 calls a window, median of 5).  Baseline: the reference's best
single-device fill throughput, 14,354 MCUPS (Smith-Waterman 16384x32768
on a V100-SXM2, reference
tests/benchmarkResults/benchmark_throughput_tesla.out:64-66).

There is one candidate: if K3 fails to build or launch, the exception
ends the process with a non-zero code and no JSON line.  The plain
version runs only under ``SEQALIGN_TORCH_DEVICE=cpu``.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from .. import config
from .timing import device_seconds_per_call

BASELINE_GCUPS = 14.354
PAIRS, SIZE, SEED = 8192, 512, 42
GAP = 5


def run(pairs=PAIRS, size=SIZE, seed=SEED, reps=16, timings=5) -> dict:
    """Measure the workload on ``config.device()``, print the details on
    stderr and the JSON line on stdout; return the record."""
    from ..ops import batch_fill
    from ..parallel.batch import cell16_for

    device = torch.device(config.device())
    rng = np.random.default_rng(seed)
    k = 4
    sm = np.where(np.eye(k, dtype=bool), 5, -4).astype(np.int32)
    texts = torch.from_numpy(
        rng.integers(0, k, (pairs, size)).astype(np.int32)).to(device)
    patterns = torch.from_numpy(
        rng.integers(0, k, (pairs, size)).astype(np.int32)).to(device)
    lengths = torch.full((pairs,), size, dtype=torch.int32, device=device)
    sm_d = torch.from_numpy(sm).to(device)
    cell16 = cell16_for(size, size, sm, k, GAP)

    def call():
        return batch_fill.batch_score(texts, patterns, lengths, lengths,
                                      sm_d, GAP, k, local=True,
                                      cell16=cell16)

    per_batch = device_seconds_per_call(call, reps=reps, timings=timings,
                                        device=device)
    gcups = pairs * size * size / per_batch / 1e9
    kernel = "K3-cell16" if cell16 else "K3"
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"[headline:{kernel}] {pairs} pairs {size}x{size} on {name}: "
          f"{per_batch * 1e3:.3f} ms/batch, {pairs / per_batch:,.0f} "
          f"pairs/s, {gcups:.2f} GCUPS", file=sys.stderr, flush=True)
    record = {"metric": "sw_batch_fill", "value": round(gcups, 3),
              "unit": "GCUPS",
              "vs_baseline": round(gcups / BASELINE_GCUPS, 4)}
    print(json.dumps(record), flush=True)
    return record


def main() -> int:
    run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
