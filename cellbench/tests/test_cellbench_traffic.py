"""The generators and the frozen traffic pieces."""

import collections
import json
import os

import numpy as np
import pytest

from cellbench import dna, pool
from cellbench.gen import genome_pairs

from .conftest import REPO


def _config(name):
    with open(os.path.join(REPO, "cellbench", "configs", f"{name}.json")) as f:
        return json.load(f)


def _traffic(name, **changes):
    with open(os.path.join(REPO, "cellbench", "traffic", f"{name}.json")) as f:
        traffic = json.load(f)
    traffic.update(changes)
    return traffic


def _make(kind, seed):
    if kind == "long":
        return genome_pairs.make(_traffic("genome.long", variants=1,
                                          genomes=["NC_004002.1",
                                                   "AbHV_ORF111"]),
                                 _config("dna_genome_pair"), seed, REPO)
    return genome_pairs.make(_traffic("genome.direct", variants=1),
                             _config("dna_genome_pair"), seed, REPO)


def _flat(p):
    out = []
    for item in p.items:
        out.extend(item[key].tobytes() for key in ("text", "pattern"))
    return out


@pytest.mark.parametrize("kind", ["long", "direct"])
def test_a_seed_repeats_exactly(kind):
    seed = 2**31 + 12345
    a, b = _make(kind, seed), _make(kind, seed)
    assert _flat(a) == _flat(b)
    assert [a.order(k) for k in range(3)] == [b.order(k) for k in range(3)]
    assert a.warm == b.warm
    assert _flat(_make(kind, seed + 1)) != _flat(a)


def test_every_seed_sends_the_same_mix():
    """A block sends each (genome, length stratum) once, whatever the
    seed."""
    for seed in (1, 99, 2**33):
        p = _make("direct", seed)
        for block in range(2):
            idx = p.order(block)
            keys = collections.Counter(
                (p.items[i]["genome"], p.items[i]["stratum"]) for i in idx)
            assert len(idx) == 15 and len(keys) == 15


def test_genome_windows_take_the_reference_local_sizes():
    """Each pattern is a mutated window of 8,192, 16,384 or 32,768 letters
    (about 3 % shorter after the mutation), one strip of the direct
    route."""
    p = _make("direct", 7)
    for item in p.items:
        want = (8192, 16384, 32768)[item["stratum"]]
        assert abs(len(item["pattern"]) / want - 0.97) < 0.02
        assert len(item["text"]) >= 149955


def test_whole_genome_patterns_exceed_a_strip():
    p = _make("long", 3)
    for item in p.items:
        assert len(item["pattern"]) > 65536
        assert len(item["text"]) >= len(item["pattern"])


def test_loader_matches_the_port_io():
    from seqalign_torch import constants, io

    for g in _config("dna_genome_pair")["genomes"]:
        path = os.path.join(REPO, g["file"])
        with open(path, "rb") as f:
            want = io.validate_and_transform(f.read(), constants.DNA_ALPHABET,
                                             constants.NUM_DNA_CHARS)
        got = dna.load(path)
        assert len(got) == g["letters"]
        assert np.array_equal(got, want)


def test_mutation_rates():
    rng = np.random.default_rng(0)
    seq = rng.integers(0, 4, 400_000).astype(np.int8)
    out = dna.mutate(seq, rng, 0.05, 0.02, 0.05)
    assert abs(len(out) / len(seq) - 0.97) < 0.003
    same = dna.mutate(seq, np.random.default_rng(1), 0.0, 0.0, 0.0)
    assert np.array_equal(same, seq)
    subs = dna.mutate(seq, np.random.default_rng(2), 0.0, 0.0, 1.0)
    assert len(subs) == len(seq) and not (subs == seq).any()


def test_seeds_of_any_size():
    for seed in (0, 1, 2**31 + 7, 2**40, -5):
        assert pool.seeded(seed, 1).integers(0, 10) >= 0
