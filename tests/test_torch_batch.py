"""The port's BatchAligner (seqalign_torch.parallel.batch) on the CPU
against the JAX BatchAligner with its Pallas kernels in interpreter mode,
and against the native oracle.  Exact comparisons."""

import numpy as np
import pytest

from seqalign_torch.native import bindings as port_bindings
from seqalign_torch.ops import batch_fill, batch_traceback
from seqalign_torch.parallel import BatchAligner
from seqalign_torch.parallel import batch as port_batch
from seqalign_tpu.native import bindings as jax_bindings
from seqalign_tpu.parallel import mesh as mesh_lib
from seqalign_tpu.parallel.batch import BatchAligner as JaxBatchAligner

from .torch_support import one_torch_thread, score_matrix  # noqa: F401

MODES = {"global": {}, "local": {"local": True}, "semi": {"semi": True}}
ALGO = {"global": 0, "local": 1, "semi": 2}


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("SEQALIGN_ENGINE", "pallas_interpret")


def ragged_pairs(rng, k, count, lo=3, hi=150):
    texts = [rng.integers(0, k, int(rng.integers(lo, hi))).astype(np.int32)
             for _ in range(count)]
    patterns = [rng.integers(0, k, int(rng.integers(lo, hi)))
                .astype(np.int32) for _ in range(count)]
    return texts, patterns


def aligners(k, gap, mode):
    sm = score_matrix(k)
    port = BatchAligner(sm, k, gap, device="cpu", **MODES[mode])
    ref = JaxBatchAligner(sm, k, gap, mesh=mesh_lib.make_data_mesh(1),
                          **MODES[mode])
    return sm, port, ref


def assert_same_result(got, want):
    assert got.score == want.score
    np.testing.assert_array_equal(got.aligned_text, want.aligned_text)
    np.testing.assert_array_equal(got.aligned_pattern, want.aligned_pattern)
    assert (got.start_in_aligned_text, got.start_in_aligned_pattern) == (
        want.start_in_aligned_text, want.start_in_aligned_pattern)


def check_align(port, ref, sm, k, gap, mode, texts, patterns):
    got = port.align(texts, patterns)
    want = ref.align(texts, patterns)
    assert len(got) == len(texts)
    for i, (t, p) in enumerate(zip(texts, patterns)):
        assert_same_result(got[i], want[i])
        oracle = port_bindings.oracle_align(ALGO[mode], t, p, sm, k, gap)
        assert got[i].score == oracle[4], i
        np.testing.assert_array_equal(got[i].aligned_text, oracle[0])
        np.testing.assert_array_equal(got[i].aligned_pattern, oracle[1])
        assert (got[i].start_in_aligned_text,
                got[i].start_in_aligned_pattern) == (oracle[2], oracle[3])
    return got


@pytest.mark.parametrize("k", [4, 23])
@pytest.mark.parametrize("mode", ["global", "local", "semi"])
def test_align_matches_jax_and_oracle(mode, k):
    rng = np.random.default_rng(601 + k + len(mode))
    gap = int(rng.integers(1, 9))
    sm, port, ref = aligners(k, gap, mode)
    # Two buckets (lengths across 128), degenerate pairs among them.
    texts, patterns = ragged_pairs(rng, k, 10)
    texts[3] = np.zeros(0, np.int32)
    patterns[7] = np.zeros(0, np.int32)
    check_align(port, ref, sm, k, gap, mode, texts, patterns)


@pytest.mark.parametrize("mode", ["global", "local", "semi"])
def test_score_matches_jax_and_oracle(mode):
    rng = np.random.default_rng(611 + len(mode))
    sm, port, ref = aligners(4, 5, mode)
    texts, patterns = ragged_pairs(rng, 4, 12)
    texts[5] = np.zeros(0, np.int32)
    for swap in (True, False):
        got = port.score(texts, patterns, swap=swap)
        np.testing.assert_array_equal(got, ref.score(texts, patterns,
                                                     swap=swap))
        for i, (t, p) in enumerate(zip(texts, patterns)):
            if swap and len(t) < len(p):
                t, p = p, t
            _, want, _ = jax_bindings.oracle_fill(ALGO[mode], t, p, sm, 4, 5)
            assert got[i] == want, (swap, i)


def test_score_protein_matches_oracle():
    rng = np.random.default_rng(621)
    sm, port, ref = aligners(23, 10, "local")
    texts, patterns = ragged_pairs(rng, 23, 8, hi=140)
    got = port.score(texts, patterns)
    np.testing.assert_array_equal(got, ref.score(texts, patterns))
    for i, (t, p) in enumerate(zip(texts, patterns)):
        if len(t) < len(p):
            t, p = p, t
        assert got[i] == port_bindings.oracle_fill(1, t, p, sm, 23, 10)[1]


def test_local_no_match():
    # Every substitution negative: empty alignments with the reference's
    # cursor sentinels, score 0.
    sm = np.full((4, 4), -4, dtype=np.int32)
    texts = [np.zeros(40, np.int32), np.zeros(7, np.int32)]
    patterns = [np.ones(20, np.int32), np.full(9, 2, np.int32)]
    port = BatchAligner(sm, 4, 5, local=True, device="cpu")
    got = port.align(texts, patterns)
    for r, t, p in zip(got, texts, patterns):
        want = port_bindings.oracle_align(1, t, p, sm, 4, 5)
        assert r.score == 0 and r.aligned_text.shape == (0,)
        assert (r.start_in_aligned_text, r.start_in_aligned_pattern) == (
            want[2], want[3])
    np.testing.assert_array_equal(port.score(texts, patterns), [0, 0])


def test_align_in_chunks_matches_one_chunk(monkeypatch):
    # A chunk of 128 pairs: 300 pairs of one bucket run as 3 chunks, the
    # pipeline holding at most two of them.
    rng = np.random.default_rng(631)
    texts, patterns = ragged_pairs(rng, 4, 300, lo=20, hi=60)
    port = BatchAligner(score_matrix(4), 4, 3, local=True, device="cpu")
    whole = port.align(texts, patterns)
    monkeypatch.setattr(port_batch, "PIPELINE_PAIRS", 1)
    assert port._dirs_tile_pairs(128, 128) == (128, 128)
    for a, b in zip(port.align(texts, patterns), whole):
        assert_same_result(a, b)


def test_results_own_their_arrays():
    rng = np.random.default_rng(641)
    texts, patterns = ragged_pairs(rng, 4, 3, lo=30, hi=50)
    got = BatchAligner(score_matrix(4), 4, 5, device="cpu").align(texts,
                                                                  patterns)
    for r in got:
        assert r.aligned_text.base is None and r.aligned_pattern.base is None


def test_cpu_device_launches_no_kernel():
    rng = np.random.default_rng(651)
    texts, patterns = ragged_pairs(rng, 4, 4)
    port = BatchAligner(score_matrix(4), 4, 5, semi=True, device="cpu")
    before = (batch_fill.batch_score.launches,
              batch_fill.batch_fill_dirs.launches,
              batch_traceback.batch_walk.launches)
    port.score(texts, patterns)
    port.align(texts, patterns)
    assert (batch_fill.batch_score.launches,
            batch_fill.batch_fill_dirs.launches,
            batch_traceback.batch_walk.launches) == before


def test_refuses_what_it_cannot_run():
    sm = score_matrix(4)
    with pytest.raises(ValueError, match="gap_penalty >= gap_extend"):
        BatchAligner(sm, 4, 1, gap_extend=2, device="cpu")
    with pytest.raises(ValueError, match="exclusive"):
        BatchAligner(sm, 4, 5, local=True, semi=True, device="cpu")
    with pytest.raises(ValueError, match="127"):
        BatchAligner(np.full((4, 4), 200, np.int32), 4, 5, device="cpu")
    port = BatchAligner(sm, 4, 5, device="cpu")
    bad = [np.array([0, 1, 4], np.int32)]
    good = [np.array([0, 1, 2], np.int32)]
    with pytest.raises(ValueError, match="0..3"):
        port.score(bad, good)
    with pytest.raises(ValueError, match="0..3"):
        port.align(good, [np.array([-1, 2])])
