"""The port's K4 plain version (seqalign_torch.ops.batch_traceback) against
the JAX lockstep walk and the JAX per-pair walker in interpreter mode, on
the same direction words.  Exact comparisons."""

import numpy as np
import pytest
import torch

from seqalign_torch.ops import batch_traceback as port_walk
from seqalign_tpu.ops.batch_traceback import (batch_device_traceback,
                                              batch_pallas_traceback)
from seqalign_tpu.ops.pallas_fill import batch_fill_dirs_pallas

from .torch_support import one_torch_thread, score_matrix  # noqa: F401

MODES = {"global": {}, "local": {"local": True}, "semi": {"semi": True}}
B, N, M = 128, 90, 64


def filled(mode, seed):
    """JAX-filled words of a ragged batch (a few padding pairs) and the
    walk starts BatchAligner gives them."""
    rng = np.random.default_rng(seed)
    texts = rng.integers(0, 4, (B, N)).astype(np.int32)
    patterns = rng.integers(0, 4, (B, M)).astype(np.int32)
    ns = rng.integers(1, N + 1, B).astype(np.int32)
    ms = rng.integers(1, M + 1, B).astype(np.int32)
    ns[-8:] = 0
    ms[-8:] = 0
    scores, bis, bjs, dirs, _ = batch_fill_dirs_pallas(
        texts, patterns, ns, ms, score_matrix(4), 4, k_alpha=4,
        tile_pairs=B, interpret=True, **MODES[mode])
    scores, bis, bjs, dirs = (np.array(x) for x in (scores, bis, bjs, dirs))
    if mode == "local":
        bis = np.where(scores > 0, bis, 0).astype(np.int32)
        bjs = np.where(scores > 0, bjs, 0).astype(np.int32)
    return dirs, ns, ms, bis, bjs


def port(dirs, ns, ms, bis, bjs, mode, max_len):
    out = port_walk.batch_walk_plain(
        *(torch.from_numpy(np.ascontiguousarray(x))
          for x in (dirs, ns, ms, bis, bjs)),
        mode == "local", mode == "semi", max_len)
    return [x.numpy() for x in out]


def moves_only(packed, lengths):
    """The (max_len/16, B) move words with every bit past each pair's
    last move cleared."""
    move = (np.arange(packed.shape[0])[:, None, None] * 16
            + np.arange(16)[None, None, :])            # (words, 1, 16)
    kept = move < lengths[None, :, None]                # (words, B, 16)
    mask = (kept.astype(np.int64) << (2 * np.arange(16))).sum(-1) * 3
    return packed & mask.astype(np.uint32).view(np.int32)


def assert_same_walks(got, ref):
    packed, lengths, fi, fj = got
    np.testing.assert_array_equal(lengths, ref[1])
    np.testing.assert_array_equal(fi, ref[2])
    np.testing.assert_array_equal(fj, ref[3])
    # The same moves, and nothing past the last one in the port's words.
    np.testing.assert_array_equal(packed, moves_only(packed, lengths))
    np.testing.assert_array_equal(packed,
                                  moves_only(np.asarray(ref[0]), lengths))


@pytest.mark.parametrize("mode", ["global", "local", "semi"])
def test_batch_walk_plain_matches_lockstep(mode):
    dirs, ns, ms, bis, bjs = filled(mode, 501 + len(mode))
    max_len = -(-(N + M) // 16) * 16
    ref = batch_device_traceback(dirs, ns, ms, bis, bjs, max_len=max_len,
                                 **{"local": False, "semi": False,
                                    **MODES[mode]})
    got = port(dirs, ns, ms, bis, bjs, mode, max_len)
    assert got[1].max() > 16  # walks span several move words
    assert_same_walks(got, [np.asarray(x) for x in ref])


@pytest.mark.parametrize("mode", ["global", "local", "semi"])
def test_batch_walk_plain_matches_pallas_walker_short_buffer(mode):
    # A 32-move buffer: longer walks stop there, as the TPU walker does.
    dirs, ns, ms, bis, bjs = filled(mode, 511 + len(mode))
    ref = batch_pallas_traceback(dirs, ns, ms, bis, bjs, max_len=32,
                                 interpret=True,
                                 **{"local": False, "semi": False,
                                    **MODES[mode]})
    got = port(dirs, ns, ms, bis, bjs, mode, 32)
    assert (got[1] == 32).any()
    assert_same_walks(got, [np.asarray(x) for x in ref])


def test_batch_walk_start_outside_the_words_walks_nothing():
    dirs, ns, ms, bis, bjs = filled("global", 521)
    ms = ms.copy()
    ms[0] = M + 1
    got = port(dirs, ns, ms, bis, bjs, "global", 160)
    assert (got[1][0], got[2][0], got[3][0]) == (0, M + 1, ns[0])


def test_batch_walk_on_cpu_runs_the_plain_version():
    dirs, ns, ms, bis, bjs = filled("local", 531)
    args = [torch.from_numpy(np.ascontiguousarray(x))
            for x in (dirs, ns, ms, bis, bjs)]
    before = port_walk.batch_walk.launches
    got = port_walk.batch_walk(*args, True, False, 160)
    want = port_walk.batch_walk_plain(*args, True, False, 160)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert port_walk.batch_walk.launches == before
    with pytest.raises(ValueError, match="multiple of 16"):
        port_walk.batch_walk(*args, True, False, 100)
