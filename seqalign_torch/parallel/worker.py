"""One process of a multi-process run of the port's batch path (the
counterpart of ``scripts/distributed_worker.py``).

Run N of them under torchrun::

    torchrun --nproc-per-node N -m seqalign_torch.parallel.worker \\
        [--local-devices 2] [--pairs 64] [--device cuda|cpu]

or by hand with the JAX worker's positional arguments, which set
torchrun's variables (the group's address is ``127.0.0.1:<port>``)::

    python -m seqalign_torch.parallel.worker <rank> <world_size> <port> \\
        [local_devices] [pairs_per_process] [--device cuda|cpu]

Each process joins the group (``mesh.maybe_initialize_distributed``),
brings ``local_devices`` mesh entries on its device (on CUDA its torchrun
LOCAL_RANK's card, repeated), and builds the same global batch from one
seed.  Then:

* ``sharded_batch_score`` in the five modes (linear global, local and
  semi-global, affine global and semi-global): this process's rows
  against the native oracle, every row against the oracle too, since the
  scores are all-gathered;
* ``BatchAligner.score``: the whole array equal to the oracle's;
* ``BatchAligner.align``, linear local and affine semi-global, on one
  tile (128 pairs) an entry with ragged patterns: this process's pairs
  byte-identical to the oracle, the others None, and every pair aligned
  by exactly one process.

It prints ``OK <rank> <pairs> <seconds> aligned=<n> scores=<sha1>`` (the
digest of the all-gathered ``.score`` array) and exits 0, or raises.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import sys
import time

import numpy as np
import torch

SM = np.where(np.eye(4, dtype=bool), 5, -4).astype(np.int32)
GAP, EXTEND = 5, 2
LENGTH = 64
SEED = 17


def batch(pairs: int):
    """The global batch every process builds: texts and patterns (pairs,
    LENGTH) DNA letters."""
    rng = np.random.default_rng(SEED)
    texts = rng.integers(0, 4, (pairs, LENGTH)).astype(np.int32)
    patterns = rng.integers(0, 4, (pairs, LENGTH)).astype(np.int32)
    return texts, patterns


def oracle_score(algo, text, pattern, ext):
    from ..native import bindings

    if ext is not None:
        return bindings.oracle_fill_affine(algo, text, pattern, SM, 4, GAP,
                                           ext)[0]
    return bindings.oracle_fill(algo, text, pattern, SM, 4, GAP)[1]


def oracle_alignment(algo, text, pattern, ext):
    from ..native import bindings

    if ext is not None:
        return bindings.oracle_align_affine(algo, text, pattern, SM, 4, GAP,
                                            ext)
    return bindings.oracle_align(algo, text, pattern, SM, 4, GAP)


def run(mesh, pairs_per_process: int):
    """The checks above on ``mesh``; returns (rows checked, pairs aligned
    here, the digest of the all-gathered scores)."""
    from ..ops import batch_fill
    from .batch import BatchAligner, sharded_batch_score

    b = pairs_per_process * mesh.world_size
    texts, patterns = batch(b)
    mine = mesh.local_rows(b)
    checked = 0
    for kw in (dict(local=True), dict(), dict(semi=True),
               dict(gap_extend=EXTEND), dict(semi=True, gap_extend=EXTEND)):
        algo = 2 if kw.get("semi") else (1 if kw.get("local") else 0)
        ext = kw.get("gap_extend")
        scores = sharded_batch_score(
            mesh, texts, patterns, np.full(b, LENGTH, np.int32),
            np.full(b, LENGTH, np.int32), SM, GAP, **kw)
        want = [oracle_score(algo, t, p, ext) for t, p in zip(texts, patterns)]
        assert scores.shape == (b,), (kw, scores.shape)
        assert scores[mine].tolist() == want[mine], (kw, "this process")
        assert scores.tolist() == want, (kw, "the gathered scores")
        checked = mine.stop - mine.start

    aligner = BatchAligner(SM, 4, GAP, local=True, mesh=mesh)
    gathered = aligner.score(list(texts), list(patterns))
    assert gathered.tolist() == [oracle_score(1, t, p, None)
                                 for t, p in zip(texts, patterns)]
    digest = hashlib.sha1(gathered.astype(np.int32).tobytes()).hexdigest()

    # One tile of pairs an entry, so that every process owns some.
    count = batch_fill.TILE_QUANTUM * mesh.size
    a_texts, a_pats = batch(count)
    a_pats = [p[:32 + i % 17] for i, p in enumerate(a_pats)]
    aligned = 0
    for kw in (dict(local=True), dict(semi=True, gap_extend=EXTEND)):
        algo = 2 if kw.get("semi") else 1
        results = BatchAligner(SM, 4, GAP, mesh=mesh, **kw).align(a_texts,
                                                                  a_pats)
        owned = torch.tensor([r is not None for r in results],
                             dtype=torch.int32)
        per_pair = mesh.all_gather(owned).reshape(mesh.world_size, -1)
        assert per_pair.sum(0).tolist() == [1] * count, (kw, "owners")
        for i, r in enumerate(results):
            if r is None:
                continue
            at, ap, st, sp, score = oracle_alignment(
                algo, a_texts[i], a_pats[i], kw.get("gap_extend"))
            assert r.score == score, (kw, i, r.score, score)
            assert np.array_equal(r.aligned_text, at), (kw, i)
            assert np.array_equal(r.aligned_pattern, ap), (kw, i)
            assert (r.start_in_aligned_text,
                    r.start_in_aligned_pattern) == (st, sp), (kw, i)
            aligned += 1
    assert aligned > 0, "no pairs owned by this process"
    return checked, aligned, digest


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("positional", nargs="*", type=int,
                        help="rank world_size port [local_devices] "
                             "[pairs_per_process]")
    parser.add_argument("--local-devices", type=int, default=None)
    parser.add_argument("--pairs", type=int, default=None)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    pos = args.positional
    if pos and not 3 <= len(pos) <= 5:
        parser.error("positional arguments: rank world_size port "
                     "[local_devices] [pairs_per_process]")
    if pos:
        os.environ.update(RANK=str(pos[0]), WORLD_SIZE=str(pos[1]),
                          MASTER_ADDR="127.0.0.1", MASTER_PORT=str(pos[2]))
    local_devices = args.local_devices or (pos[3] if len(pos) > 3 else 2)
    pairs = args.pairs or (pos[4] if len(pos) > 4 else 256)
    torch.set_num_threads(1)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("worker: no CUDA device", file=sys.stderr)
        return 1

    import torch.distributed as dist

    from . import mesh as mesh_lib

    if not mesh_lib.maybe_initialize_distributed():
        parser.error("no process group: run under torchrun or give "
                     "rank world_size port")
    try:
        device = "cpu"
        if args.device == "cuda":
            card = int(os.environ.get("LOCAL_RANK", 0))
            device = f"cuda:{card % torch.cuda.device_count()}"
        mesh = mesh_lib.make_data_mesh(devices=[device] * local_devices)
        t0 = time.time()
        checked, aligned, digest = run(mesh, pairs)
        print(f"OK {mesh.rank} {checked} {time.time() - t0:.2f} "
              f"aligned={aligned} scores={digest}", flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
