"""The port's K5 plain version (seqalign_torch.ops.strip_fill) against the
JAX strip kernel in interpreter mode, and the single-pair device walk
(walk_packed / run_device_traceback) against the JAX walk and the native
one, on the same inputs.  Every output is an integer: the comparisons
are exact."""

import numpy as np
import pytest
import torch

from seqalign_torch.native import bindings as port_bindings
from seqalign_torch.ops import batch_traceback, strip_fill
from seqalign_torch.ops import traceback as port_traceback
from seqalign_tpu.native import bindings
from seqalign_tpu.ops import pallas_fill
from seqalign_tpu.ops.traceback import pack_words, run_device_traceback

from .torch_support import one_torch_thread, score_matrix  # noqa: F401

NEG_INF = -(1 << 30)


@pytest.fixture(autouse=True, scope="module")
def _fresh_caches():
    # This file compiles interpret-mode strip programs, which have hit an
    # XLA:CPU compile segfault late in a long run (see tests/test_tiled.py).
    import jax

    jax.clear_caches()


def jax_profile(text, sm, k, strip_off, strip_cols, n):
    """The JAX kernel's (K, 8, L) profile of the strip, PAD_SCORE past n."""
    chunk = np.asarray(text, np.int32)[strip_off:min(strip_off + strip_cols,
                                                     n)]
    prof = np.full((k, strip_cols), pallas_fill.PAD_SCORE, np.int32)
    prof[:, :chunk.shape[0]] = sm[:k][:, chunk]
    return prof.reshape(k, 8, strip_cols // 8)


def region(rng, k, w, rows, row_base, strip_off, gap, local):
    """Random region inputs: the text of the whole pair, the pattern
    letters of the region's rows, a left column, the row above and a
    carried state, as the JAX wrapper takes them."""
    text = rng.integers(0, k, strip_off + w).astype(np.int32)
    pattern = rng.integers(0, k, rows).astype(np.int32)
    if row_base == 0 and strip_off == 0:
        left = strip_fill.nw_boundary_col(0, rows, gap, local)
        prev = strip_fill.init_prev_row(w, 0, gap, local)
        state = strip_fill.zeros_state()
    else:
        # An interior region: the boundaries of a real fill are a few gaps
        # apart from cell to cell, below the best so far.
        left = (np.cumsum(rng.integers(-gap, gap + 1, rows + 1))
                - gap * row_base // 4).astype(np.int32)
        prev = (np.cumsum(rng.integers(-gap, gap + 1, w))
                - gap * row_base // 4).astype(np.int32)
        if local:
            left, prev = np.maximum(left, 0), np.maximum(prev, 0)
        state = np.array([9, row_base - 3, strip_off - 5, NEG_INF],
                         np.int32)
    return text, pattern, left, prev, state


def compare_region(text, pattern, left, prev, state, sm, k, gap, n, m,
                   row_base, strip_off, w, local, with_dirs):
    ref = pallas_fill.strip_fill_pallas(
        jax_profile(text, sm, k, strip_off, w, n), pattern, gap, n, m,
        row_base, strip_off, left, prev.reshape(8, w // 8),
        state.reshape(1, 4), local=local, with_dirs=with_dirs,
        interpret=True)
    want = strip_fill.from_reference_outputs(*ref, with_dirs=with_dirs)
    args = strip_fill.from_reference_strip(
        text, sm, k, strip_off, w, pattern, left, prev.reshape(8, w // 8),
        state.reshape(1, 4), "cpu")
    got = strip_fill.strip_fill(args[0], args[1], args[2], gap, n, m,
                                row_base, strip_off, *args[3:], local=local,
                                with_dirs=with_dirs)
    if with_dirs:
        assert got[0].shape == want[0].shape == (pattern.shape[0] // 16, w)
        np.testing.assert_array_equal(got[0].numpy(), want[0])  # every word
    else:
        assert got[0] is None and want[0] is None
    for g, x in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), x)
    return want


@pytest.mark.parametrize("with_dirs", [True, False], ids=["words", "score"])
@pytest.mark.parametrize("k", [4, 23])
@pytest.mark.parametrize("local", [False, True], ids=["global", "local"])
def test_first_region_matches_jax(local, k, with_dirs):
    # Row 0 and column 0 of the pair; n < W (padded columns) and m not a
    # multiple of 16 (rows past m, letter 0, are filled too).
    rng = np.random.default_rng(10 + k + 2 * local + with_dirs)
    w, rows, gap = 2048, 256, 5 if k == 4 else 10
    n, m = 1777, 203
    text, pattern, left, prev, state = region(rng, k, w, rows, 0, 0, gap,
                                              local)
    pattern[m:] = 0
    want = compare_region(text, pattern, left, prev, state, score_matrix(k),
                          k, gap, n, m, 0, 0, w, local, with_dirs)
    if local:
        assert want[3][0] > 0 and 0 < want[3][1] <= m and \
            0 < want[3][2] <= n
    else:
        assert want[3][3] > NEG_INF  # S[m, n] captured


@pytest.mark.parametrize("with_dirs", [True, False], ids=["words", "score"])
@pytest.mark.parametrize("local", [False, True], ids=["global", "local"])
@pytest.mark.parametrize("k", [4, 23])
def test_interior_region_matches_jax(k, local, with_dirs):
    # row_base > 0 and strip_off > 0 with a carried state; the strip
    # holds column n and the rows hold row m.
    rng = np.random.default_rng(30 + k + 2 * local + with_dirs)
    w, rows, gap = 1024, 384, 5 if k == 4 else 10
    row_base, strip_off = 256, 3072
    n, m = strip_off + 700, row_base + 301
    text, pattern, left, prev, state = region(rng, k, w, rows, row_base,
                                              strip_off, gap, local)
    compare_region(text, pattern, left, prev, state, score_matrix(k), k,
                   gap, n, m, row_base, strip_off, w, local, with_dirs)


@pytest.mark.parametrize("case", ["no-improvement", "past-m", "past-n"])
def test_carried_state_stands(case):
    # Local: a carried best that no row beats keeps its (i, j); rows past
    # m never move it; a strip wholly past n never moves it either.
    rng = np.random.default_rng(50)
    k, w, rows, gap = 4, 1024, 128, 5
    row_base, strip_off = 128, 1024
    n, m = strip_off + 900, row_base + 100
    best = 10 ** 6 if case == "no-improvement" else 9
    if case == "past-m":
        m = row_base
    elif case == "past-n":
        n = strip_off
    text, pattern, left, prev, state = region(rng, k, w, rows, row_base,
                                              strip_off, gap, True)
    state[0] = best
    want = compare_region(text, pattern, left, prev, state, score_matrix(k),
                          k, gap, n, m, row_base, strip_off, w, True, True)
    np.testing.assert_array_equal(want[3], state)


def test_ties_take_the_first_column():
    # Matches 2, mismatches -1 over two letters: the row maxima recur in
    # many columns and rows; the best cell is the first in row-major order.
    rng = np.random.default_rng(60)
    sm = np.where(np.eye(4, dtype=bool), 2, -1).astype(np.int32)
    w, rows, gap = 1024, 256, 1
    text = rng.integers(0, 2, w).astype(np.int32)
    pattern = rng.integers(0, 2, rows).astype(np.int32)
    for local in (False, True):
        compare_region(text, pattern,
                       strip_fill.nw_boundary_col(0, rows, gap, local),
                       strip_fill.init_prev_row(w, 0, gap, local),
                       strip_fill.zeros_state(), sm, 4, gap, 1000, 250, 0,
                       0, w, local, True)


@pytest.mark.parametrize("k", [4, 23])
@pytest.mark.parametrize("local", [False, True], ids=["global", "local"])
def test_pair_fill_matches_jax(local, k):
    rng = np.random.default_rng(70 + k + local)
    sm, gap = score_matrix(k), 5 if k == 4 else 10
    n, m = 1500, 333
    text = rng.integers(0, k, n).astype(np.int32)
    pattern = rng.integers(0, k, m).astype(np.int32)
    profile, p_cols = pallas_fill.build_pair_profile(text, sm, k)
    m_pad = strip_fill.pair_rows(m)
    assert p_cols == strip_fill.pair_columns(n) == 2048 and m_pad == 384
    pat = np.zeros(m_pad, np.int32)
    pat[:m] = pattern
    dirs, score, bi, bj = pallas_fill.pair_fill_pallas(
        profile, pat, gap, n, m, local=local, interpret=True)
    words, got_score, got_bi, got_bj = strip_fill.pair_fill(
        torch.from_numpy(strip_fill.strip_letters(text, 0, p_cols)),
        torch.from_numpy(sm), torch.from_numpy(pat), gap, n, m,
        local=local)
    np.testing.assert_array_equal(
        words.numpy(), np.asarray(dirs).reshape(m_pad // 16, p_cols))
    assert (got_score, got_bi, got_bj) == (int(score), int(bi), int(bj))
    # And the oracle's score and best cell.
    _, oscore, obest = bindings.oracle_fill(
        1 if local else 0, text.astype(np.int8), pattern.astype(np.int8),
        sm, k, gap)
    assert got_score == oscore
    if local:
        assert (got_bi, got_bj) == (obest // (n + 1), obest % (n + 1))


def _small_args(**change):
    w, rows = 1024, 128
    args = dict(
        text=torch.zeros(w, dtype=torch.int32),
        score_matrix=torch.eye(4, dtype=torch.int32),
        pattern=torch.zeros(rows, dtype=torch.int32), gap=5, n=900, m=100,
        row_base=0, strip_off=0,
        left_col=torch.zeros(rows + 1, dtype=torch.int32),
        prev_row=torch.zeros(w, dtype=torch.int32),
        state=torch.from_numpy(strip_fill.zeros_state()))
    args.update(change)
    return args


@pytest.mark.parametrize("change,match", [
    (dict(text=torch.zeros(1000, dtype=torch.int32)), "multiple of 1024"),
    (dict(text=torch.zeros(66560, dtype=torch.int32),
          prev_row=torch.zeros(66560, dtype=torch.int32)), "up to 65536"),
    (dict(pattern=torch.zeros(100, dtype=torch.int32),
          left_col=torch.zeros(101, dtype=torch.int32)), "multiple of 128"),
    (dict(left_col=torch.zeros(128, dtype=torch.int32)), "left_col"),
    (dict(prev_row=torch.zeros(1024, dtype=torch.int64)), "int32"),
    (dict(state=torch.zeros((1, 4), dtype=torch.int32)), "state"),
    (dict(text=torch.full((1024,), 4, dtype=torch.int32)), "outside 0..3"),
    (dict(pattern=torch.full((128,), -1, dtype=torch.int32)),
     "outside 0..3"),
    (dict(text=torch.zeros(1024, dtype=torch.int64)), "int8 or int32"),
    (dict(score_matrix=torch.zeros((4, 5), dtype=torch.int32)), "(k, k)"),
    (dict(row_base=-1), ">= 0"),
    (dict(prev_row=torch.zeros(1024, dtype=torch.int32, device="meta")),
     "is on meta"),
], ids=["width", "too-wide", "rows", "left-col", "dtype", "state-shape",
        "text-letters", "pattern-letters", "text-dtype", "matrix", "origin",
        "device"])
def test_wrapper_checks_its_inputs(change, match):
    with pytest.raises(ValueError, match=match.replace("(", r"\(")
                       .replace(")", r"\)")):
        strip_fill.strip_fill(**_small_args(**change))


def test_cpu_tensors_run_the_plain_version(monkeypatch):
    calls = []
    real = strip_fill.strip_fill_plain

    def spy(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(strip_fill, "strip_fill_plain", spy)
    before = strip_fill.strip_fill.launches
    out = strip_fill.strip_fill(**_small_args())
    assert calls == [1] and strip_fill.strip_fill.launches == before
    assert out[0].shape == (8, 1024) and out[2].shape == (128,)


# ----------------------------------------------------------------------
# The single-pair device walk (K4 through walk_packed), on CPU tensors.

def _dna_sm():
    return np.where(np.eye(4, dtype=bool), 5, -4).astype(np.int32)


@pytest.mark.parametrize("local", [False, True], ids=["global", "local"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_device_walk_matches_jax_and_native(local, seed):
    rng = np.random.default_rng(seed)
    sm = _dna_sm()
    n = int(rng.integers(2, 200))
    m = int(rng.integers(1, n + 1))
    text = rng.integers(0, 4, n).astype(np.int8)
    pattern = rng.integers(0, 4, m).astype(np.int8)
    dirs, _, best = bindings.oracle_fill(1 if local else 0, text, pattern,
                                         sm, 4, 5)
    words = pack_words(dirs)
    bi, bj = best // (n + 1), best % (n + 1)

    got = port_traceback.run_device_traceback(
        torch.from_numpy(words), text, pattern, n, m, bi, bj, 4, local)
    want = run_device_traceback(words, text, pattern, n, m, bi, bj, 4, local)
    host = port_bindings.traceback_packed(1 if local else 0, words, text,
                                          pattern, 4, best_i=bi, best_j=bj)
    jax_host = bindings.traceback_packed(1 if local else 0, words, text,
                                         pattern, 4, best_i=bi, best_j=bj)
    oracle = bindings.oracle_align(1 if local else 0, text, pattern, sm, 4,
                                   5)[:4]
    for other in (want, host, jax_host, oracle):
        np.testing.assert_array_equal(got[0], other[0])
        np.testing.assert_array_equal(got[1], other[1])
        assert got[2:] == tuple(other[2:])
    # From numpy words (the tiled fill's host array), uploaded to the CPU.
    again = port_traceback.run_device_traceback(
        words, text, pattern, n, m, bi, bj, 4, local, device="cpu")
    np.testing.assert_array_equal(again[0], got[0])
    assert again[2:] == got[2:]


def test_walk_packed_moves_and_buffer():
    # The packed moves are the native walk's, word for word; a buffer
    # shorter than the path stops the walk there.
    rng = np.random.default_rng(9)
    n, m = 150, 120
    text = rng.integers(0, 4, n).astype(np.int8)
    pattern = rng.integers(0, 4, m).astype(np.int8)
    dirs, _, _ = bindings.oracle_fill(0, text, pattern, _dna_sm(), 4, 5)
    words = torch.from_numpy(pack_words(dirs))
    packed, stats = batch_traceback.walk_packed(words, n, m, 0, 0, False,
                                                272)
    count, i, j = stats.tolist()
    assert (i, j) == (0, 0) and max(n, m) <= count <= n + m
    at, ap, _, _ = port_bindings.traceback_packed(0, words.numpy(), text,
                                                  pattern, 4)
    assert count == len(at)
    short, short_stats = batch_traceback.walk_packed(words, n, m, 0, 0,
                                                     False, 64)
    assert short_stats[0] == 64 and (short_stats[1] > 0
                                     or short_stats[2] > 0)
    np.testing.assert_array_equal(short.numpy(), packed[:4].numpy())


@pytest.mark.parametrize("change,match", [
    (dict(words=torch.zeros((4, 64), dtype=torch.int64)), "int32"),
    (dict(words=torch.zeros((4, 8, 8), dtype=torch.int32)), "int32"),
    (dict(words=torch.zeros((64, 4), dtype=torch.int32).t()), "contiguous"),
    (dict(n=65), "outside"),
    (dict(m=65), "outside"),
    (dict(local=True, bi=3, bj=-1), "outside"),
    (dict(max_len=40), "multiple of 16"),
], ids=["dtype", "dims", "layout", "past-n", "past-m", "local-start",
        "max-len"])
def test_walk_packed_checks_its_inputs(change, match):
    args = dict(words=torch.zeros((4, 64), dtype=torch.int32), n=64, m=64,
                bi=0, bj=0, local=False, max_len=128)
    args.update(change)
    with pytest.raises(ValueError, match=match):
        batch_traceback.walk_packed(**args)


@pytest.mark.parametrize("cols,offset,match", [
    (1003, 0, "multiple of 4"),
    (1000, 1, "16-byte aligned"),
    (1000, 2, "16-byte aligned"),
    (1024, 0, None),
    (1004, 4, None),
], ids=["odd-width", "offset-4B", "offset-8B", "strip-width", "offset-16B"])
def test_walk_packed_kernel_takes_16_byte_chunks(cols, offset, match):
    # On a CUDA device the single-pair walk's loaders read 16-byte chunks:
    # the wrapper refuses a width that is not a multiple of 4 or words off
    # a 16-byte boundary; the plain version on the CPU walks them all.
    flat = torch.zeros(16 * cols + offset, dtype=torch.int32)
    words = flat[offset:].view(16, cols)
    assert words.data_ptr() % 16 == (4 * offset) % 16  # CPU storage aligned
    if match is None:
        batch_traceback.check_kernel_words(words)
    else:
        with pytest.raises(ValueError, match=match):
            batch_traceback.check_kernel_words(words)
    packed, stats = batch_traceback.walk_packed(words, cols, 16, 0, 0,
                                                False, 1040)
    # All LEFT along row 16, then the forced TOP moves of column 0.
    assert stats.tolist() == [cols + 16, 0, 0]
