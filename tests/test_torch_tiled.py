"""The port's tiled long-pair fill (seqalign_torch.ops.tiled) against the
JAX one under SEQALIGN_ENGINE=pallas_interpret, with strips of 1,024
columns and blocks of 128 rows so that every path crosses many strips
and blocks; the words through the native walk against the oracle.
Exact."""

import numpy as np
import pytest
import torch

from seqalign_torch.native import bindings as port_bindings
from seqalign_torch.ops import strip_fill
from seqalign_torch.ops import tiled as port_tiled
from seqalign_tpu.native import bindings
from seqalign_tpu.ops import tiled

from .torch_support import one_torch_thread, score_matrix  # noqa: F401

SMALL = dict(strip_cols=1024, block_rows=128)


@pytest.fixture(autouse=True, scope="module")
def _fresh_caches():
    # As tests/test_tiled.py: drop the jit caches before this file's
    # interpret-mode strip programs (an XLA:CPU compile segfault late in
    # a long run).
    import jax

    jax.clear_caches()


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("SEQALIGN_ENGINE", "pallas_interpret")


def pair(seed, k, n, m, related=True):
    """A pattern that is a mutated window of the text (a long path
    through many strips and blocks), or an unrelated one."""
    rng = np.random.default_rng(seed)
    text = rng.integers(0, k, n).astype(np.int32)
    if related:
        start = int(rng.integers(0, n - m))
        pattern = text[start:start + m].copy()
        flip = rng.random(m) < 0.15
        pattern[flip] = rng.integers(0, k, int(flip.sum()))
    else:
        pattern = rng.integers(0, k, m).astype(np.int32)
    return text, pattern


def compare(text, pattern, sm, k, gap, local, **kw):
    want = tiled.tiled_fill(text, pattern, sm, k, gap, local=local, **kw)
    got = port_tiled.tiled_fill(text, pattern, sm, k, gap, local=local,
                                device="cpu", **kw)
    assert (got.score, got.best_i, got.best_j, got.p_cols) == (
        want.score, want.best_i, want.best_j, want.p_cols)
    np.testing.assert_array_equal(got.words, want.words)  # every word
    return got


@pytest.mark.parametrize("k", [4, 23])
@pytest.mark.parametrize("local", [False, True], ids=["global", "local"])
def test_tiled_fill_matches_jax_and_oracle(local, k):
    sm, gap = score_matrix(k), 5 if k == 4 else 10
    n, m = 2500, 300  # 3 strips of 1024 x 3 blocks of 128 rows
    text, pattern = pair(7 + k + local, k, n, m)
    got = compare(text, pattern, sm, k, gap, local, **SMALL)
    assert got.words.shape == (384 // 16, 3 * 1024)
    t8, p8 = text.astype(np.int8), pattern.astype(np.int8)
    odirs, oscore, obest = bindings.oracle_fill(1 if local else 0, t8, p8,
                                                sm, k, gap)
    assert got.score == oscore
    if local:
        assert (got.best_i, got.best_j) == (obest // (n + 1),
                                            obest % (n + 1))
    rows = np.arange(1, m + 1)
    w = got.words[(rows - 1) // 16]
    dirs = (w >> (2 * ((rows - 1) % 16))[:, None]) & 3
    np.testing.assert_array_equal(dirs[:, :n], odirs[1:, 1:])
    at, ap, st, sp = port_bindings.traceback_packed(
        1 if local else 0, got.words, text, pattern, k, best_i=got.best_i,
        best_j=got.best_j)
    oat, oap, ost, osp, _ = bindings.oracle_align(1 if local else 0, t8, p8,
                                                  sm, k, gap)
    np.testing.assert_array_equal(at, oat)
    np.testing.assert_array_equal(ap, oap)
    assert (st, sp) == (ost, osp)


@pytest.mark.parametrize("local", [False, True], ids=["global", "local"])
def test_tiled_fill_score_matches_jax(local):
    sm, gap = score_matrix(4), 5
    text, pattern = pair(8 + local, 4, 2300, 200, related=False)
    want = tiled.tiled_fill_score(text, pattern, sm, 4, gap, local=local,
                                  strip_cols=1024)
    got = port_tiled.tiled_fill_score(text, pattern, sm, 4, gap,
                                      local=local, strip_cols=1024,
                                      device="cpu")
    assert got == want == bindings.oracle_fill(
        1 if local else 0, text.astype(np.int8), pattern.astype(np.int8),
        sm, 4, gap)[1]
    full = port_tiled.tiled_fill(text, pattern, sm, 4, gap, local=local,
                                 with_dirs=False, device="cpu", **SMALL)
    assert full.words is None and full.score == got


def test_local_ties_across_strips_take_the_first_cell():
    # Two copies of the pattern in the text, one a strip after the other:
    # the same best in two strips; the merge keeps the smaller row, then
    # the smaller column (the reference's row-major first occurrence).
    rng = np.random.default_rng(12)
    sm, gap = np.where(np.eye(4, dtype=bool), 2, -1).astype(np.int32), 1
    pattern = rng.integers(0, 4, 150).astype(np.int32)
    text = rng.integers(0, 4, 2400).astype(np.int32)
    text[300:450] = pattern
    text[1500:1650] = pattern
    got = compare(text, pattern, sm, 4, gap, True, **SMALL)
    assert (got.best_i, got.best_j) == (150, 450)
    _, oscore, obest = bindings.oracle_fill(
        1, text.astype(np.int8), pattern.astype(np.int8), sm, 4, gap)
    assert (got.score, got.best_i * 2401 + got.best_j) == (oscore, obest)


def test_one_strip_one_block():
    # The defaults' shape at a small size: the whole pair in one region,
    # the same words as pair_fill's.
    sm, gap = score_matrix(4), 5
    text, pattern = pair(13, 4, 900, 200)
    got = compare(text, pattern, sm, 4, gap, False, strip_cols=1024,
                  block_rows=8192)
    words, score, _, _ = strip_fill.pair_fill(
        *(torch.from_numpy(x) for x in (
            strip_fill.strip_letters(text, 0, 1024), sm,
            np.pad(pattern, (0, 56)))), gap, 900, 200)
    np.testing.assert_array_equal(got.words, words.numpy())
    assert got.score == score
