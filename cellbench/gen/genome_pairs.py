"""One genome pair a request: a genome against a mutated copy of it or of
a window of it.

Traffic keys:

- ``genomes``: ids of the configuration's genomes the pairs come from.
- ``pattern``: ``"whole"`` (the pattern is a mutated copy of the whole
  genome) or ``{"lengths": [l1, l2, ...]}`` (a mutated copy of a window
  of each of these lengths, at a place in the genome drawn from the seed).
- ``mutation``: ``delete``, ``insert`` and ``substitute`` rates a letter
  (``cellbench.dna.mutate``).
- ``variants``: distinct pairs made for each (genome, stratum).

The text is the longer sequence, as the reference program orders them.
A stratum is one of the pattern lengths (``"whole"`` is one stratum).
A block of the window is every (genome, stratum) once, in an order drawn
from the seed; block b sends variant b mod ``variants`` of each, so every
seed sends the same mix of sizes.  Set-up warms with the pair of most
cells in each stratum.
"""

from __future__ import annotations

from ..dna import mutate
from ..pool import Pool, genome, seeded


def make(traffic: dict, config: dict, seed: int, root: str) -> Pool:
    rng = seeded(seed, 1)
    mut = traffic["mutation"]
    pattern = traffic["pattern"]
    strata = [None] if pattern == "whole" else [
        int(n) for n in pattern["lengths"]]
    items, keys = [], []
    for gid in traffic["genomes"]:
        seq = genome(config, gid, root)
        for s_idx, length in enumerate(strata):
            variants = []
            for _ in range(int(traffic["variants"])):
                if length is None:
                    source = seq
                else:
                    start = int(rng.integers(0, len(seq) - length + 1))
                    source = seq[start:start + length]
                pat = mutate(source, rng, mut["delete"], mut["insert"],
                             mut["substitute"])
                text = seq
                if len(pat) > len(text):
                    text, pat = pat, text
                variants.append(len(items))
                items.append({"text": text, "pattern": pat, "genome": gid,
                              "stratum": s_idx, "pairs": 1,
                              "cells": len(text) * len(pat)})
            keys.append(variants)
    n_var = int(traffic["variants"])

    def order(block: int) -> list:
        perm = seeded(seed, 2, block).permutation(len(keys))
        return [keys[k][block % n_var] for k in perm]

    warm = [max((i for i in range(len(items))
                 if items[i]["stratum"] == s_idx),
                key=lambda i: items[i]["cells"])
            for s_idx in range(len(strata))]
    return Pool(items=items, order=order, warm=warm)
