"""The port's K3 plain versions (seqalign_torch.ops.batch_fill) against the
JAX inter-pair kernel in interpreter mode, on the same inputs.  Every
output is an integer: the comparisons are exact."""

import numpy as np
import pytest
import torch

from seqalign_torch.ops import batch_fill
from seqalign_tpu.ops.pallas_fill import (batch_fill_dirs_pallas,
                                          batch_score_pallas)

from .torch_support import one_torch_thread, score_matrix  # noqa: F401

MODES = {"global": {}, "local": {"local": True}, "semi": {"semi": True}}
TILE = 128
B, N, M = 256, 100, 48  # two tiles; N not a multiple of 128
PAD = 20                # padding pairs (ns = ms = 0) at the end


def make_batch(rng, k, kind="random", m_rows=M):
    """Ragged pair-major letters and lengths, padding pairs last.
    ``ties``: two letters a sequence, so the local and semi best value
    recurs in many rows and columns; ``equal``: every letter 0."""
    if kind == "random":
        texts = rng.integers(0, k, (B, N))
        patterns = rng.integers(0, k, (B, m_rows))
    elif kind == "ties":
        texts = rng.integers(0, 2, (B, N))
        patterns = rng.integers(0, 2, (B, m_rows))
    else:
        texts = np.zeros((B, N))
        patterns = np.zeros((B, m_rows))
    ns = rng.integers(1, N + 1, B)
    ms = rng.integers(1, m_rows + 1, B)
    ns[-PAD:] = 0
    ms[-PAD:] = 0
    return [np.asarray(x, dtype=np.int32) for x in (texts, patterns, ns, ms)]


def tensors(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def ties_sm():
    # Matches 2, mismatches -1: local and semi maxima tie often.
    return np.where(np.eye(4, dtype=bool), 2, -1).astype(np.int32)


def compare_dirs(texts, patterns, ns, ms, sm, k, gap, mode):
    ref = [np.asarray(x) for x in batch_fill_dirs_pallas(
        texts, patterns, ns, ms, sm, gap, k_alpha=k, tile_pairs=TILE,
        interpret=True, **MODES[mode])[:4]]
    got = [x.numpy() for x in batch_fill.batch_fill_dirs_plain(
        *tensors(texts, patterns, ns, ms, sm), gap, k, tile_pairs=TILE,
        **MODES[mode])]
    real = ns > 0
    np.testing.assert_array_equal(got[0][real], ref[0][real])
    if mode != "global":  # global's best cell is (m, n), not reported
        np.testing.assert_array_equal(got[1][real], ref[1][real])
        np.testing.assert_array_equal(got[2][real], ref[2][real])
    assert got[3].shape == ref[3].shape == (B // TILE, M // 16, N, 1, 128)
    np.testing.assert_array_equal(got[3], ref[3])  # every word
    return got


@pytest.mark.parametrize("k", [4, 23])
@pytest.mark.parametrize("mode", ["global", "local", "semi"])
def test_batch_fill_dirs_plain_matches_jax(mode, k):
    rng = np.random.default_rng(101 + k + len(mode))
    gap = int(rng.integers(1, 9))
    compare_dirs(*make_batch(rng, k), score_matrix(k), k, gap, mode)


@pytest.mark.parametrize("k", [4, 23])
@pytest.mark.parametrize("mode", ["global", "local", "semi"])
def test_batch_score_plain_matches_jax(mode, k):
    rng = np.random.default_rng(201 + k + len(mode))
    gap = int(rng.integers(1, 9))
    # M not a multiple of 16: the score-only fill takes any width.
    texts, patterns, ns, ms = make_batch(rng, k, m_rows=M + 5)
    sm = score_matrix(k)
    ref = np.asarray(batch_score_pallas(
        texts, patterns, ns, ms, sm, gap, k_alpha=k, tile_pairs=TILE,
        interpret=True, **MODES[mode]))
    got = batch_fill.batch_score_plain(*tensors(texts, patterns, ns, ms, sm),
                                       gap, k, **MODES[mode]).numpy()
    real = ns > 0
    np.testing.assert_array_equal(got[real], ref[real])


@pytest.mark.parametrize("kind", ["ties", "equal"])
@pytest.mark.parametrize("mode", ["local", "semi"])
def test_batch_fill_best_cell_ties(mode, kind):
    # Many cells share the best value: the best cell is the first in
    # row-major order, as on the TPU.
    rng = np.random.default_rng(301 + len(kind) + len(mode))
    got = compare_dirs(*make_batch(rng, 4, kind), ties_sm(), 4, 1, mode)
    assert (got[1][:-PAD] > 0).all()


def test_wrappers_on_cpu_run_the_plain_versions():
    rng = np.random.default_rng(401)
    args = tensors(*make_batch(rng, 4), score_matrix(4))
    launches = (batch_fill.batch_score.launches,
                batch_fill.batch_fill_dirs.launches)
    for mode in MODES:
        got = batch_fill.batch_fill_dirs(*args, 3, 4, tile_pairs=TILE,
                                         **MODES[mode])
        want = batch_fill.batch_fill_dirs_plain(*args, 3, 4, tile_pairs=TILE,
                                                **MODES[mode])
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        assert torch.equal(
            batch_fill.batch_score(*args, 3, 4, **MODES[mode]),
            batch_fill.batch_score_plain(*args, 3, 4, **MODES[mode]))
    assert (batch_fill.batch_score.launches,
            batch_fill.batch_fill_dirs.launches) == launches


def test_wrappers_check_their_inputs():
    rng = np.random.default_rng(402)
    texts, patterns, ns, ms = tensors(*make_batch(rng, 4))
    sm = torch.from_numpy(score_matrix(4))
    with pytest.raises(ValueError, match="exclusive"):
        batch_fill.batch_score(texts, patterns, ns, ms, sm, 3, 4, local=True,
                               semi=True)
    with pytest.raises(ValueError, match="multiple of 16"):
        batch_fill.batch_fill_dirs(texts, patterns[:, :40], ns, ms, sm, 3, 4)
    with pytest.raises(ValueError, match="tile_pairs"):
        batch_fill.batch_fill_dirs(texts, patterns, ns, ms, sm, 3, 4,
                                   tile_pairs=512)
    with pytest.raises(ValueError, match="int32"):
        batch_fill.batch_score(texts, patterns, ns.long(), ms, sm, 3, 4)
