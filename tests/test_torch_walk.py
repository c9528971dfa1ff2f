"""The port's K2 (seqalign_torch.ops.walk) against the JAX walker in
interpreter mode, on the same skewed words.  Exact comparisons."""

import numpy as np
import pytest
import torch

from seqalign_torch.ops import walk as port_walk
from seqalign_tpu.ops.pallas_walk import pallas_walk_skewed_window, unpack_moves
from seqalign_tpu.ops.traceback import pack_words_skewed

from .torch_support import one_torch_thread  # noqa: F401

RPS, SLOTS = 2, 128
ROWS, COLS = RPS * SLOTS, 300


def random_words(rng, local):
    hi = 4 if local else 3  # global words never hold STOP
    dirs = rng.integers(0, hi, (ROWS + 1, COLS + 1)).astype(np.uint8)
    return np.asarray(pack_words_skewed(dirs, RPS, SLOTS))


@pytest.mark.parametrize("mode", ["global", "local", "semi"])
def test_walk_plain_matches_jax_walker(mode):
    # Semi-global walks with the global rules from its best last-row
    # cell; the walker has no mode of its own for it.
    local = mode == "local"
    rng = np.random.default_rng({"global": 61, "local": 62, "semi": 63}[mode])
    words = random_words(rng, local)
    words_t = torch.as_tensor(words)
    for _ in range(4):
        i = ROWS if mode == "semi" else int(rng.integers(1, ROWS + 1))
        j = int(rng.integers(1, COLS + 1))
        mv, k, ri, rj, _, rdone = pallas_walk_skewed_window(
            words, None, RPS, 0, 0, i, j, 0, local, False, ROWS + COLS + 1,
            interpret=True,
        )
        moves, result = port_walk.walk_skewed_window_plain(
            words_t, RPS, 0, 0, i, j, local, ROWS + COLS + 1,
        )
        count, pi, pj, state, done = result.tolist()
        assert count == int(k)
        np.testing.assert_array_equal(
            port_walk.unpack_moves(moves.numpy(), count),
            unpack_moves(mv, int(k)),
        )
        assert (pi, pj, state, done) == (int(ri), int(rj), 0, int(rdone))


@pytest.mark.parametrize("local", [False, True])
def test_walk_stops_at_the_end_of_the_move_buffer(local):
    rng = np.random.default_rng(64)
    words = random_words(rng, False)  # no STOP: the path runs to an edge
    words_t = torch.as_tensor(words)
    i, j = ROWS, COLS
    mv, k, _, _, _, _ = pallas_walk_skewed_window(
        words, None, RPS, 0, 0, i, j, 0, local, False, ROWS + COLS + 1,
        interpret=True,
    )
    full = unpack_moves(mv, int(k))
    cap = 32
    assert full.shape[0] > cap
    moves, result = port_walk.walk_skewed_window(
        words_t, RPS, 0, 0, i, j, local, cap,
    )
    count, pi, pj, _, done = result.tolist()
    assert (count, done) == (cap, 0)
    assert moves.shape == (cap // 16,)
    np.testing.assert_array_equal(
        port_walk.unpack_moves(moves.numpy(), count), full[:cap]
    )
    # The cursor stands where the full walk was after `cap` moves.
    took_i = np.isin(full[:cap], (1, 2)).sum()
    took_j = np.isin(full[:cap], (0, 1)).sum()
    assert (pi, pj) == (i - took_i, j - took_j)


def test_walk_wrapper_checks_start():
    words = torch.zeros((16 * RPS, SLOTS // 128, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="outside"):
        port_walk.walk_skewed_window(words, RPS, 0, 0, 5, 400, False, 64)
    with pytest.raises(ValueError, match="int32"):
        port_walk.walk_skewed_window(words.long(), RPS, 0, 0, 5, 4, False,
                                     64)
