"""The work a cell's traffic is made of: a pool of items made in set-up,
the order the window sends them in, and the items set-up warms with."""

from __future__ import annotations

import dataclasses
import itertools
import os
from typing import Callable, Iterator

import numpy as np

from . import dna


@dataclasses.dataclass
class Pool:
    """``items``: what one request sends (a dict the entry reads, with its
    ``cells`` and ``pairs``); ``order(block)``: the item indices of the
    window's block ``block`` (0, 1, ...), sent one block after another;
    ``warm``: the indices set-up sends once."""

    items: list
    order: Callable[[int], list]
    warm: list

    def schedule(self) -> Iterator[int]:
        """Item indices in the order the window sends them, without end."""
        for block in itertools.count():
            yield from self.order(block)


def seeded(seed: int, *salt: int) -> np.random.Generator:
    """A generator from ``seed`` (any whole number) and a salt."""
    return np.random.default_rng([int(seed) & (2**64 - 1), *salt])


def genome(config: dict, genome_id: str, root: str) -> np.ndarray:
    """The letters of one of the configuration's genomes, checked against
    the count the configuration states."""
    for g in config["genomes"]:
        if g["id"] == genome_id:
            seq = dna.load(os.path.join(root, g["file"]))
            if len(seq) != g["letters"]:
                raise ValueError(f"{genome_id}: {len(seq)} letters, the "
                                 f"configuration states {g['letters']}")
            return seq
    raise KeyError(f"genome {genome_id} is not in the configuration")
