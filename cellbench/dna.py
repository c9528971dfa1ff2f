"""Frozen traffic pieces: the loader of the bundled DNA files and the
mutation model.

Both are copies, kept here so that a change to the port cannot move the
benchmark's traffic:

- ``load`` normalises a sequence file as ``seqalign_torch/io.py``'s
  ``validate_and_transform`` does (the reference's utilities.cpp:31-63): a
  ``>`` outside a header starts a header that runs to the next newline,
  any byte above ``Z`` has 32 subtracted, bytes outside ``A``-``Z`` are
  dropped, and ``ATCG`` become 0-3.
- ``mutate`` is ``tools/mutate.py``'s per-letter model (each letter is
  deleted, followed by an inserted random letter, substituted by another
  letter, or kept, in that order of the draw), vectorised over numpy and
  driven by a seeded ``numpy.random.Generator``.
"""

from __future__ import annotations

import numpy as np

ALPHABET = "ATCG"
GAP = len(ALPHABET)  # the gap symbol in aligned index arrays

_TABLE = np.full(256, -1, dtype=np.int8)
for _i, _c in enumerate(ALPHABET):
    _TABLE[ord(_c)] = _i


def load(path: str) -> np.ndarray:
    """The letters of a bundled DNA file as int8 indices 0-3."""
    with open(path, "rb") as f:
        data = np.frombuffer(f.read(), dtype=np.uint8)
    keep = np.ones(data.shape[0], dtype=bool)
    newlines = np.flatnonzero(data == ord("\n"))
    pos = 0
    for gt in np.flatnonzero(data == ord(">")):
        if gt < pos:
            continue  # inside a header already
        after = newlines[np.searchsorted(newlines, gt):]
        end = int(after[0]) if after.size else data.shape[0]
        keep[gt + 1:end] = False
        pos = end
    upper = data[keep].astype(np.int32)
    upper[upper > 90] -= 32
    letters = upper[(upper >= 65) & (upper <= 90)]
    idx = _TABLE[letters]
    if (idx < 0).any():
        raise ValueError(f"{path}: a letter outside {ALPHABET}")
    return idx


def mutate(seq: np.ndarray, rng: np.random.Generator, delete: float,
           insert: float, substitute: float) -> np.ndarray:
    """A mutated copy of ``seq`` (int8 indices 0-3).

    Each letter is deleted with probability ``delete``, kept and followed
    by a uniformly drawn letter with probability ``insert``, replaced by
    one of the three other letters with probability ``substitute``, and
    kept otherwise.
    """
    seq = np.asarray(seq, dtype=np.int8)
    r = rng.random(seq.shape[0])
    is_del = r < delete
    is_ins = (r >= delete) & (r < delete + insert)
    is_sub = (r >= delete + insert) & (r < delete + insert + substitute)
    count = np.where(is_del, 0, np.where(is_ins, 2, 1))
    ends = np.cumsum(count)
    starts = ends - count
    out = np.empty(int(ends[-1]) if ends.size else 0, dtype=np.int8)
    first = seq.copy()
    shift = rng.integers(1, 4, size=int(is_sub.sum()), dtype=np.int8)
    first[is_sub] = (first[is_sub] + shift) % 4
    kept = ~is_del
    out[starts[kept]] = first[kept]
    out[starts[is_ins] + 1] = rng.integers(0, 4, size=int(is_ins.sum()),
                                           dtype=np.int8)
    return out
