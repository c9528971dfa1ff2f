"""Dry run of the port over an N-entry mesh (the role of the JAX
package's ``__graft_entry__.py::dryrun_multichip``)::

    python -m seqalign_torch.parallel.dryrun N [--device cuda|cpu]

The mesh has N entries on the device: on CUDA the visible cards in turn
(``["cuda:0"] * N`` on one card), on the CPU ``["cpu"] * N`` (the plain
versions).  Small shapes, every mode the engines claim on a mesh:

* ``sharded_batch_score``, linear and affine, global, local and
  semi-global;
* ``BatchAligner.align``, linear local and affine semi-global, on ragged
  pairs;
* ``sequence_parallel_fill``, global and local;
* ``sequence_parallel_checkpointed_fill`` with ``checkpointed_traceback``,
  linear global and affine semi-global.

Unlike the JAX dry run, each result is held against the native oracle.
Prints ``dryrun ok`` and exits 0, or raises.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

SM = np.where(np.eye(4, dtype=bool), 5, -4).astype(np.int32)
GAP = 5


def mesh_devices(count: int, device: str) -> list[str]:
    if device == "cpu":
        return ["cpu"] * count
    cards = torch.cuda.device_count()
    if cards == 0:
        raise RuntimeError("CUDA is unavailable: no card for the mesh")
    return [f"cuda:{i % cards}" for i in range(count)]


def dryrun(count: int, device: str = "cuda") -> None:
    from ..native import bindings
    from ..ops.checkpoint import checkpointed_traceback
    from .batch import BatchAligner, sharded_batch_score
    from .mesh import make_data_mesh
    from .sequence import (sequence_parallel_checkpointed_fill,
                           sequence_parallel_fill)

    mesh = make_data_mesh(devices=mesh_devices(count, device))
    rng = np.random.default_rng(1)

    b, n, m = 2 * mesh.size, 128, 128
    texts = rng.integers(0, 4, (b, n)).astype(np.int32)
    patterns = rng.integers(0, 4, (b, m)).astype(np.int32)
    lengths = np.full(b, n, np.int32)
    for ext in (None, 2):
        for algo, mode in ((0, {}), (1, {"local": True}),
                           (2, {"semi": True})):
            scores = sharded_batch_score(mesh, texts, patterns, lengths,
                                         lengths, SM, GAP, gap_extend=ext,
                                         **mode)
            want = [bindings.oracle_fill_affine(algo, t, p, SM, 4, GAP,
                                                ext)[0] if ext else
                    bindings.oracle_fill(algo, t, p, SM, 4, GAP)[1]
                    for t, p in zip(texts, patterns)]
            assert scores.tolist() == want, (ext, mode)

    pairs = 24
    a_texts = [rng.integers(0, 4, int(rng.integers(20, 300)))
               .astype(np.int32) for _ in range(pairs)]
    a_pats = [rng.integers(0, 4, int(rng.integers(20, 300)))
              .astype(np.int32) for _ in range(pairs)]
    for algo, ext, mode in ((1, None, {"local": True}),
                            (2, 2, {"semi": True})):
        aligner = BatchAligner(SM, 4, GAP, gap_extend=ext, mesh=mesh, **mode)
        for r, t, p in zip(aligner.align(a_texts, a_pats), a_texts, a_pats):
            want = (bindings.oracle_align_affine(algo, t, p, SM, 4, GAP, ext)
                    if ext else bindings.oracle_align(algo, t, p, SM, 4, GAP))
            assert (r.score, r.start_in_aligned_text,
                    r.start_in_aligned_pattern) == (want[4], want[2], want[3])
            assert np.array_equal(r.aligned_text, want[0])
            assert np.array_equal(r.aligned_pattern, want[1])

    n, m = 1024 * mesh.size + 300, 200
    text = rng.integers(0, 4, n).astype(np.int32)
    pattern = rng.integers(0, 4, m).astype(np.int32)
    for local in (False, True):
        score, bi, bj, _ = sequence_parallel_fill(text, pattern, SM, 4, GAP,
                                                  local=local, mesh=mesh)
        _, want, best = bindings.oracle_fill(int(local), text, pattern, SM,
                                             4, GAP)
        assert score == want, (local, score, want)
        if local:
            assert (bi, bj) == (best // (n + 1), best % (n + 1))

    # A strip of 128 rows an entry, chunks of 512 columns.
    n, m = 1500, 128 * mesh.size - 20
    text = rng.integers(0, 4, n).astype(np.int32)
    pattern = rng.integers(0, 4, m).astype(np.int32)
    for algo, ext, mode in ((0, None, {}), (2, 2, {"semi": True})):
        ck = sequence_parallel_checkpointed_fill(
            text, pattern, SM, 4, GAP, gap_extend=ext, ckpt_cols=512, rps=1,
            slots=128, mesh=mesh, **mode)
        at, ap, st, sp = checkpointed_traceback(ck, text, pattern, SM, 4)
        want = (bindings.oracle_align_affine(algo, text, pattern, SM, 4, GAP,
                                             ext) if ext else
                bindings.oracle_align(algo, text, pattern, SM, 4, GAP))
        assert (ck.score, st, sp) == (want[4], want[2], want[3]), mode
        assert np.array_equal(at, want[0]) and np.array_equal(ap, want[1])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("count", type=int, help="mesh entries")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("dryrun: no CUDA device", file=sys.stderr)
        return 1
    dryrun(args.count, args.device)
    print("dryrun ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
