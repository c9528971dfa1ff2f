"""The database search on the card: ``BatchAligner.search`` held exact,
and timed at a Swiss-Prot-sized database against the tail threshold.

* ``--check``: a ragged database (empty sequences, one-letter ones,
  sequences above the tail threshold) against queries of 1 to 1,100
  letters, in local, global and semi-global mode, linear and affine
  gaps, int32 cells and under ``SEQALIGN_INT16_CELLS=auto``, on a mesh of
  one entry and of ``cuda:0`` twice: every score equal to the native
  oracle's; then the local int16 gate's edge under BLOSUM62 (max|sub|
  11, W-W): a run of 1,436 W's (15,796) in a group of width 1,436 and of
  1,437 W's in one of 1,437, against a query of 1,440 W's, linear and
  affine: the first group in int16 cells, the second in int32, every
  score equal to the int32 kernel's, the plain version's (a CPU entry)
  and the oracle's;
* ``--time``: 570,000 sequences of log-normal lengths (median 290, sigma
  0.66, 2 to 35,213 letters, one of 35,213) packed once a threshold
  (``search.TAIL_LETTERS``, set for the probe's process),
  queries of 144, 1,000 and 5,147 letters, best of 3 a request after a
  warm one (host clock around the whole call), and the program's spans of
  the last: the host's time in dispatch, the tail's K1 pairs and the
  read-back.

``python -m seqalign_torch.probes.search [--check] [--time]
[--thresholds 2048,4096,...]`` (``--check --time`` without
arguments); exits 1 without a CUDA device or when a score differs.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from .. import tracing
from ..native import bindings
from ..ops import _build
from ..parallel import BatchAligner, make_data_mesh
from ..parallel import search as search_lib

BLOSUM62 = "scoreMatrices/protein/blosum62.txt"
K = 23
MODES = {"local": {"local": True}, "global": {}, "semi": {"semi": True}}


def blosum62() -> np.ndarray:
    with open(BLOSUM62) as f:
        values = [int(x) for x in f.read().split()]
    return np.array(values[:K * K], dtype=np.int32).reshape(K, K)


def lengths_like_swissprot(rng, count: int) -> np.ndarray:
    n = np.clip(np.rint(rng.lognormal(np.log(290), 0.66, count)), 2, 35213)
    n[rng.integers(count)] = 35213
    return n.astype(np.int64)


def database(rng, lengths) -> list:
    flat = rng.integers(0, 20, size=int(lengths.sum()), dtype=np.int8)
    return np.split(flat, np.cumsum(lengths)[:-1])


def oracle(seqs, query, sm, mode, gap, ext) -> np.ndarray:
    algo = {"global": 0, "local": 1, "semi": 2}[mode]
    out = np.empty(len(seqs), dtype=np.int64)
    for i, s in enumerate(seqs):
        if ext is None:
            out[i] = bindings.oracle_fill(algo, s, query, sm, K, gap)[1]
        else:
            out[i] = bindings.oracle_fill_affine(algo, s, query, sm, K, gap,
                                                 ext)[0]
    return out


def check(device="cuda:0", count=2000, longest=3000,
          long=(4500, 5200, 6100, 9000), tail=4096,
          queries=(1, 37, 300, 1100)) -> bool:
    rng = np.random.default_rng(20)
    sm = blosum62()
    lengths = np.clip(np.rint(rng.lognormal(np.log(200), 0.8, count)), 1,
                      longest).astype(np.int64)
    lengths[:3] = (0, 1, 0)
    lengths[3:3 + len(long)] = long
    seqs = database(rng, lengths)
    ok = True
    meshes = {"1": make_data_mesh(devices=[device]),
              "2": make_data_mesh(devices=[device, device])}
    search_lib.TAIL_LETTERS = tail
    dbs = {name: BatchAligner(sm, K, 12, mesh=mesh).database(seqs)
           for name, mesh in meshes.items()}
    for mode, kw in MODES.items():
        for gap, ext in ((12, 2), (6, None)):
            for m in queries:
                query = rng.integers(0, 20, size=m, dtype=np.int8)
                want = oracle(seqs, query, sm, mode, gap, ext)
                for cells in ("0", "auto"):
                    os.environ["SEQALIGN_INT16_CELLS"] = cells
                    for name, mesh in meshes.items():
                        aligner = BatchAligner(sm, K, gap, gap_extend=ext,
                                               mesh=mesh, **kw)
                        got = aligner.search(query, dbs[name])
                        good = np.array_equal(got, want)
                        ok &= good
                        print(f"SEARCH_CHECK {mode} gap={gap} ext={ext} "
                              f"m={m} int16={cells} mesh={name}: "
                              f"{'ok' if good else 'DIFFERS'} "
                              f"({int((got != want).sum())} of {len(seqs)}"
                              f" differ)", flush=True)
    os.environ.pop("SEQALIGN_INT16_CELLS", None)
    return ok & check_edge(device)


def check_edge(device="cuda:0", edge=1436) -> bool:
    """The local int16 gate's edge (``batch_fill.int16_local_ok``): under
    BLOSUM62, 11 * min(width, 1,440 rows) <= 15,800 admits a width of
    1,436 and refuses 1,437."""
    rng = np.random.default_rng(22)
    sm = blosum62()
    w = int(np.argmax(np.diag(sm)))  # W, 11 against itself
    query = np.full(edge + 4, w, dtype=np.int8)
    seqs = [np.full(edge + 1, w, dtype=np.int8),
            np.full(edge, w, dtype=np.int8)]
    seqs += [rng.integers(0, 20, size=edge + 1, dtype=np.int8)
             for _ in range(63)]
    seqs += [rng.integers(0, 20, size=int(n), dtype=np.int8)
             for n in rng.integers(1, edge + 1, size=70)]
    ok = True
    for ext in (2, None):
        want = oracle(seqs, query, sm, "local", 12, ext)
        ok &= int(want[0]) == 11 * (edge + 1) and int(want[1]) == 11 * edge
        got = {}
        for name, device_ in (("card", device), ("plain", "cpu")):
            aligner = BatchAligner(sm, K, 12, gap_extend=ext, local=True,
                                   device=device_)
            db = aligner.database(seqs)
            widths = [int(x) for x in db.shares[0].widths[:2]]
            g16 = search_lib._first_cell16(aligner, db.shares[0].widths,
                                           query.shape[0])
            with tracing.recording() as rec:
                got[name] = aligner.search(query, db)
            if name == "card":
                first = search_lib._first_cell16
                search_lib._first_cell16 = lambda al, ws, rows: ws.shape[0]
                try:
                    got["int32"] = aligner.search(query, db)
                finally:
                    search_lib._first_cell16 = first
            routed = (widths == [edge + 1, edge] and g16 == 1
                      and rec.counters["search.buckets"] == 2
                      and 0 < rec.counters["search.cells16"]
                      < rec.counters["search.cells"])
            ok &= routed
            print(f"SEARCH_EDGE {name} ext={ext}: widths {widths}, int16 "
                  f"from group {g16}, buckets "
                  f"{rec.counters['search.buckets']}, cells16 "
                  f"{rec.counters['search.cells16']} of "
                  f"{rec.counters['search.cells']}: "
                  f"{'ok' if routed else 'ROUTED WRONG'}", flush=True)
        for name, scores in got.items():
            good = np.array_equal(scores, want)
            ok &= good
            print(f"SEARCH_EDGE ext={ext} {name}: scores {scores[0]} "
                  f"(width {edge + 1}, int32) and {scores[1]} (width "
                  f"{edge}, int16) of oracle {want[0]} and {want[1]}: "
                  f"{'ok' if good else 'DIFFERS'} "
                  f"({int((scores != want).sum())} of {len(seqs)} differ)",
                  flush=True)
    return ok


def time_search(thresholds) -> None:
    rng = np.random.default_rng(21)
    lengths = lengths_like_swissprot(rng, 570_000)
    seqs = database(rng, lengths)
    aligner = BatchAligner(blosum62(), K, 12, local=True, gap_extend=2,
                           device="cuda:0")
    queries = {m: rng.integers(0, 20, size=m, dtype=np.int8)
               for m in (144, 1000, 5147)}
    print(f"SEARCH_DB {len(seqs)} sequences, {int(lengths.sum())} "
          f"residues", flush=True)
    for t in thresholds:
        t0 = time.perf_counter()
        search_lib.TAIL_LETTERS = t
        db = aligner.database(seqs)
        torch.cuda.synchronize()
        print(f"SEARCH_PACK threshold={t}: {time.perf_counter() - t0:.2f} s,"
              f" padding {100 * db.padding:.3f} % of {db.residues} "
              f"residues, tail {len(db.tail)} sequences, peak "
              f"{torch.cuda.max_memory_allocated()} B", flush=True)
        for m, query in queries.items():
            aligner.search(query, db)
            best = None
            for _ in range(3):
                with tracing.recording() as rec:
                    t0 = time.perf_counter()
                    aligner.search(query, db)
                    s = time.perf_counter() - t0
                best = s if best is None else min(best, s)
            spans = {x.name: (x.end - x.start) / 1e6 for x in rec.spans}
            print(f"SEARCH_TIME threshold={t} m={m}: {1e3 * best:.2f} ms, "
                  f"{m * db.residues / best / 1e9:.1f} GCUPS; last: "
                  f"dispatch {spans['search.dispatch']:.2f} ms, tail "
                  f"{spans['search.tail']:.2f} ms "
                  f"({rec.counters.get('search.tail_pairs', 0)} pairs), "
                  f"collect {spans['search.collect']:.2f} ms", flush=True)
        del db
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--check", action="store_true")
    p.add_argument("--time", action="store_true")
    p.add_argument("--thresholds", default=f"{search_lib.TAIL_LETTERS}")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("search probe: no CUDA device", file=sys.stderr)
        return 1
    if not (args.check or args.time):
        args.check = args.time = True
    _build.build_all(("interpair", "interpair16", "wavefront"))
    ok = check() if args.check else True
    if args.time:
        time_search([int(x) for x in args.thresholds.split(",")])
    print(f"SEARCH_PROBE {'ok' if ok else 'FAILED'} "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
