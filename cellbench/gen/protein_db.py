"""One query protein against a whole database a request: the database
made from the seed at the configuration's scale, the queries read from
the checkout.

Configuration keys read: ``queries`` (``id``, ``file``, ``letters``),
``alphabet`` (the letters, in index order), ``database`` (``sequences``;
``lengths``: a log-normal's ``median`` and ``sigma``, clipped to
``shortest`` .. ``longest``, with one sequence of exactly ``longest``;
``composition``: % of each amino acid), ``homologs`` (``per_query``
mutated copies of each query, ``mutation``: ``delete``, ``insert`` and
``substitute`` rates a letter, the reference's mutate.py model).

Traffic keys: ``check`` (``sample``: requests judged, ``sequences``:
database sequences drawn a judged request, ``longest``: how many of them
from the longest ``longest_share`` of the database).

A request is one query against every database sequence: ``cells`` the
query's length times the database's residues, ``pairs`` the database's
sequences.  A block of the window is every query once, in an order drawn
from the seed.  Set-up warms with the request of most cells.  Every item
holds the one ``ProteinDatabase``.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from ..pool import Pool, seeded


@dataclasses.dataclass
class ProteinDatabase:
    """The database: ``letters`` (int8 alphabet indices, back to back),
    ``starts`` and ``lengths`` (int64) of each sequence, ``homologs``
    (query id -> the indices of its mutated copies), and the ``seed`` it
    was made from."""

    letters: np.ndarray
    starts: np.ndarray
    lengths: np.ndarray
    homologs: dict
    seed: int

    def sequences(self) -> list:
        """The sequences as views of ``letters``."""
        return np.split(self.letters, self.starts[1:])

    def sequence(self, i: int) -> np.ndarray:
        return self.letters[self.starts[i]:self.starts[i] + self.lengths[i]]


def load(path: str, alphabet: str) -> np.ndarray:
    """A FASTA file's letters as int8 indices into ``alphabet``, read as
    the reference program reads a file (utilities.cpp:31-63): header
    lines skipped, lower case folded, other bytes dropped."""
    with open(path, "rb") as f:
        lines = f.read().split(b"\n")
    data = np.frombuffer(b"".join(x for x in lines if not x.startswith(b">")),
                         dtype=np.uint8).astype(np.int32)
    data[data > 90] -= 32
    data = data[(data >= 65) & (data <= 90)]
    table = np.full(256, -1, dtype=np.int8)
    for i, c in enumerate(alphabet):
        table[ord(c)] = i
    idx = table[data]
    if (idx < 0).any():
        raise ValueError(f"{path}: a letter outside {alphabet}")
    return idx


def mutate(seq: np.ndarray, rng, alphabet_size: int, delete: float,
           insert: float, substitute: float) -> np.ndarray:
    """A mutated copy of ``seq`` under mutate.py's per-letter model: each
    letter deleted, kept and followed by a uniformly drawn letter,
    replaced by one of the other letters, or kept, by one draw."""
    seq = np.asarray(seq, dtype=np.int8)
    r = rng.random(seq.shape[0])
    is_del = r < delete
    is_ins = (r >= delete) & (r < delete + insert)
    is_sub = (r >= delete + insert) & (r < delete + insert + substitute)
    count = np.where(is_del, 0, np.where(is_ins, 2, 1))
    ends = np.cumsum(count)
    out = np.empty(int(ends[-1]) if ends.size else 0, dtype=np.int8)
    first = seq.copy()
    shift = rng.integers(1, alphabet_size, size=int(is_sub.sum()))
    first[is_sub] = (first[is_sub] + shift) % alphabet_size
    kept = ~is_del
    out[(ends - count)[kept]] = first[kept]
    out[(ends - count)[is_ins] + 1] = rng.integers(
        0, alphabet_size, size=int(is_ins.sum()))
    return out


def residues(rng, count: int, composition: dict, alphabet: str) -> np.ndarray:
    """``count`` letters drawn from ``composition`` (letter -> share),
    through a table of 2^16 entries (each share to within 2^-16)."""
    letters = list(composition)
    p = np.array([composition[c] for c in letters], dtype=np.float64)
    bounds = np.rint(np.cumsum(p / p.sum()) * (1 << 16)).astype(np.int64)
    table = np.repeat(np.array([alphabet.index(c) for c in letters],
                               dtype=np.int8),
                      np.diff(np.concatenate([[0], bounds])))
    return table[rng.integers(0, 1 << 16, size=count, dtype=np.uint16)]


def make(traffic: dict, config: dict, seed: int, root: str) -> Pool:
    rng = seeded(seed, 1)
    alphabet = config["alphabet"]
    queries = []
    for q in config["queries"]:
        letters = load(os.path.join(root, q["file"]), alphabet)
        if len(letters) != q["letters"]:
            raise ValueError(f"{q['id']}: {len(letters)} letters, the "
                             f"configuration states {q['letters']}")
        queries.append((q["id"], letters))
    spec = config["database"]
    size = int(spec["sequences"])
    shape = spec["lengths"]
    lengths = np.clip(np.rint(rng.lognormal(np.log(shape["median"]),
                                            shape["sigma"], size)),
                      shape["shortest"], shape["longest"]).astype(np.int64)
    places = rng.choice(size, size=1 + len(queries) * int(
        config["homologs"]["per_query"]), replace=False)
    lengths[places[0]] = shape["longest"]
    mut = config["homologs"]["mutation"]
    planted, homologs = {}, {}
    for qi, (qid, letters) in enumerate(queries):
        per = int(config["homologs"]["per_query"])
        at = places[1 + qi * per:1 + (qi + 1) * per]
        homologs[qid] = at
        for i in at:
            copy = mutate(letters, rng, len(alphabet), mut["delete"],
                          mut["insert"], mut["substitute"])
            planted[int(i)] = copy
            lengths[i] = len(copy)
    flat = residues(rng, int(lengths.sum()), spec["composition"], alphabet)
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.int64)
    for i, copy in planted.items():
        flat[starts[i]:starts[i] + lengths[i]] = copy
    db = ProteinDatabase(flat, starts, lengths, homologs, int(seed))
    total = int(lengths.sum())
    items = [{"id": qid, "query": letters, "db": db, "pairs": size,
              "cells": len(letters) * total} for qid, letters in queries]

    def order(block: int) -> list:
        return [int(i) for i in seeded(seed, 2, block).permutation(
            len(items))]

    warm = [max(range(len(items)), key=lambda i: items[i]["cells"])]
    return Pool(items=items, order=order, warm=warm)
