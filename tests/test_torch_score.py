"""The port models' ``score()`` (K1's score-only fill, the checkpoint
engine's phase 1) against the JAX models' ``score()`` (its XLA scan
engine on the CPU) and the native oracle's fill, exactly: the bundled
short pairs at the default geometry, and random DNA and protein pairs at
a small one (1 row a slot x 128 slots, a checkpoint column every 256) so
that they cross strips and checkpoint columns, with n != m and length 1
on either side."""

import numpy as np
import pytest
import torch

from seqalign_torch import cli
from seqalign_torch.models import NeedlemanWunsch, SemiGlobal, SmithWaterman
from seqalign_torch.native import bindings
from seqalign_torch.ops import checkpoint, wavefront
from seqalign_torch.types import Request
from seqalign_tpu import models as jax_models

from .torch_support import one_torch_thread, score_matrix  # noqa: F401

# (port model, JAX model, oracle algo)
MODELS = {
    "global": (NeedlemanWunsch, jax_models.NeedlemanWunsch, 0),
    "local": (SmithWaterman, jax_models.SmithWaterman, 1),
    "semi": (SemiGlobal, jax_models.SemiGlobal, 2),
}
BUNDLED = {
    "dna": ["data/dna/dna_01.txt", "data/dna/dna_02.txt"],
    "protein": ["-p", "--gap-penalty", "10", "data/protein/P04775.fasta",
                "data/protein/P10635.fasta"],
}
# (n, m): strips of 128 rows, checkpoint columns every 256.
SHAPES = [(700, 300), (300, 129), (1, 40), (40, 1), (1, 1), (513, 128)]


@pytest.fixture
def small_geometry(monkeypatch):
    monkeypatch.setattr(checkpoint, "DEFAULT_CKPT_RPS", 1)
    monkeypatch.setattr(checkpoint, "DEFAULT_CKPT_SLOTS", 128)
    monkeypatch.setattr(checkpoint, "DEFAULT_CKPT_COLS", 256)


def expect_all_equal(mode, text, pattern, sm, k, gap):
    port, ref, algo = MODELS[mode]
    got = port().score(text, pattern, sm, k, gap, device="cpu")
    want = ref().score(text, pattern, sm, k, gap)
    _, oracle, _ = bindings.oracle_fill(algo, text.astype(np.int8),
                                        pattern.astype(np.int8), sm, k, gap)
    assert isinstance(got, int)
    assert got == want == oracle, (mode, got, want, oracle)


@pytest.mark.parametrize("mode", list(MODELS))
@pytest.mark.parametrize("pair", list(BUNDLED))
def test_bundled_pair_score_matches_jax_and_oracle(pair, mode):
    request = Request()
    assert cli.parse_arguments(["alignSequence", *BUNDLED[pair]],
                               request) == 0
    expect_all_equal(mode, np.asarray(request.text, dtype=np.int32),
                     np.asarray(request.pattern, dtype=np.int32),
                     request.score_matrix, request.alphabet_size,
                     request.gap_penalty)


@pytest.mark.parametrize("mode", list(MODELS))
@pytest.mark.parametrize("n,m", SHAPES)
@pytest.mark.parametrize("k", [4, 23])
def test_random_pair_score_matches_jax_and_oracle(small_geometry, k, n, m,
                                                  mode):
    rng = np.random.default_rng(1000 * k + 7 * n + m)
    text = rng.integers(0, k, n).astype(np.int32)
    pattern = rng.integers(0, k, m).astype(np.int32)
    expect_all_equal(mode, text, pattern, score_matrix(k), k,
                     5 if k == 4 else 10)


def test_score_runs_k1_score_only(small_geometry, monkeypatch):
    """Every strip of the fill is K1 score-only with checkpoints (no
    words), and the random pairs above cross strips and checkpoint
    columns."""
    calls = []
    real = wavefront.wavefront_strip

    def spy(*args, **kwargs):
        calls.append(kwargs)
        return real(*args, **kwargs)

    monkeypatch.setattr(wavefront, "wavefront_strip", spy)
    rng = np.random.default_rng(5)
    text = rng.integers(0, 4, 700).astype(np.int32)
    pattern = rng.integers(0, 4, 300).astype(np.int32)
    SmithWaterman().score(text, pattern, score_matrix(4), 4, 5, device="cpu")
    assert len(calls) == 3  # 300 rows in strips of 128
    assert all(not c["with_dirs"] and c["ckpt_every"] == 256 for c in calls)
    ck = checkpoint.checkpointed_fill(
        text, pattern, score_matrix(4), 4, 5, local=True,
        ckpt_cols=checkpoint.DEFAULT_CKPT_COLS, device="cpu")
    assert len(ck.colvals) == 3
    assert ck.colvals[0].shape[0] >= 2  # checkpoint columns 256 and 512


def test_score_device_follows_the_setting(small_geometry, monkeypatch):
    """No device given: ``config.device()``, the card unless
    SEQALIGN_TORCH_DEVICE=cpu asks for the plain versions."""
    rng = np.random.default_rng(6)
    text = rng.integers(0, 4, 50).astype(np.int32)
    pattern = rng.integers(0, 4, 30).astype(np.int32)
    monkeypatch.setenv("SEQALIGN_TORCH_DEVICE", "cpu")
    got = NeedlemanWunsch().score(text, pattern, score_matrix(4), 4, 5)
    assert got == bindings.oracle_fill(0, text, pattern, score_matrix(4), 4,
                                       5)[1]
    if not torch.cuda.is_available():
        monkeypatch.delenv("SEQALIGN_TORCH_DEVICE")
        with pytest.raises((RuntimeError, AssertionError)):
            NeedlemanWunsch().score(text, pattern, score_matrix(4), 4, 5)
