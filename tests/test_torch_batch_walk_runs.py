"""A CPU model of K4's batch walk schedule (``csrc/batch_walk.cu``, the
run of column words a lane) against the plain walk and the JAX walkers.

The kernel walks one pair a lane, 32 lanes a warp.  Each lane keeps a
run of the next R column words of its word row, (w, jc), (w, jc-1), ...,
in a ring of R slots that 4-byte asynchronous copies fill (an affine
lane copies the run-bit word beside each).  Every iteration each live
lane makes at most one move, then its run follows the new cell (a new
word row restarts it there; a column to the left consumes its head) and
it issues at most one copy, the next column; the warp commits one group
of copies and waits until at most R-1 are in flight.  A restarted lane
makes no move until its new head's copy is R iterations old.

``run_walk`` runs that schedule iteration for iteration in numpy, warp
by warp.  A copy issued at iteration u lands at u + a latency drawn from
1..``latency`` (the wait allows at most R), so copies land out of order;
a read raises ``RunReadError`` if its slot holds another column's word,
a word no copy wrote, or a copy that has not landed.  The tests hold its
moves, lengths and final cursors equal to ``batch_walk_plain`` and to
the JAX walkers (the lockstep ``batch_device_traceback`` and the per-pair
``batch_pallas_traceback`` in interpret mode) on words the JAX package
filled, and to the plain walk on words packed from numpy: random,
all-LEFT, all-TOP (a restart every 16 moves), all-DIAG and zig-zag
paths, starts outside the words, 64-move buffers, at the least run (1),
a middle one and the production run.  A copy goes to the slot of the
copy R before it, issued at least R iterations earlier and so landed; a
ring of fewer slots than the run overwrites words the run still holds,
and the model catches it.
Every value is an integer: the tolerance is exact.
"""

import numpy as np
import pytest
import torch

from seqalign_torch.ops import batch_traceback as port_walk
from seqalign_torch.probes.batch_walk_shapes import (pack_batch_words,
                                                     path_cells)
from seqalign_tpu.ops.batch_traceback import (batch_device_traceback,
                                              batch_pallas_traceback)
from seqalign_tpu.ops.pallas_fill import batch_fill_dirs_pallas

from .test_torch_batch_traceback import assert_same_walks
from .torch_support import one_torch_thread, score_matrix  # noqa: F401

LEFT, DIAG, TOP, STOP = 0, 1, 2, 3
GLOBAL, LOCAL_, SEMI = 0, 1, 2
MODES = {"global": {}, "local": {"local": True}, "semi": {"semi": True}}


class RunReadError(AssertionError):
    pass


def alive_at(mode, i, j):
    if mode == LOCAL_:
        return i > 0 and j > 0
    if mode == SEMI:
        return i > 0
    return i > 0 or j > 0


def run_walk(dirs, ns, ms, bis, bjs, local, semi, max_len, dirs2=None,
             run=port_walk.RUN, latency=None, ring=None, seed=0):
    """K4's batch walk by its run schedule.  Returns ((packed, lengths,
    fi, fj), log): the outputs as the kernel writes them, and counts of
    copies, restarts, lane iterations waiting for a head and warp
    iterations."""
    dirs = np.asarray(dirs)
    tiles, num_w, n_cols, sub, _ = dirs.shape
    tile_pairs = sub * 128
    b = tiles * tile_pairs
    flat = dirs.reshape(-1).astype(np.int64)
    flat2 = None if dirs2 is None else np.asarray(dirs2).reshape(-1)
    affine = flat2 is not None
    mode = LOCAL_ if local else (SEMI if semi else GLOBAL)
    slots = ring or run
    latency = latency or run
    rng = np.random.default_rng(seed)
    packed = np.zeros((max_len // 16, b), np.uint32)
    lengths = np.zeros(b, np.int32)
    fi = np.zeros(b, np.int32)
    fj = np.zeros(b, np.int32)
    log = dict(copies=0, restarts=0, waiting=0, iterations=0)
    ns, ms, bis, bjs = (np.asarray(x) for x in (ns, ms, bis, bjs))

    def reads_at(i, j):
        return affine or mode == LOCAL_ or (i > 0 and j > 0)

    for first in range(0, b, 32):
        lanes = range(first, min(first + 32, b))
        st = {}
        for p in lanes:
            base = (p // tile_pairs) * num_w * n_cols * tile_pairs \
                + p % tile_pairs
            i, j = (int(ms[p]), int(ns[p])) if mode == GLOBAL \
                else (int(bis[p]), int(bjs[p]))
            inside = 0 <= i <= num_w * 16 and 0 <= j <= n_cols
            st[p] = dict(base=base, i=i, j=j, k=0, word=0, state=0,
                         alive=inside and alive_at(mode, i, j),
                         run_w=-1, run_c=0, run_n=0, cnt=0, ready=1 << 60,
                         ring=[None] * slots)
        in_flight = []  # (lands, order, lane, slot, (w, col))
        it = 0
        while any(s["alive"] for s in st.values()):
            # Copies that have landed by this iteration, in landing order.
            in_flight.sort()
            while in_flight and in_flight[0][0] <= it:
                _, _, p, slot, tag = in_flight.pop(0)
                st[p]["ring"][slot] = tag
            for p, s in st.items():
                if not s["alive"]:
                    continue
                i, j = s["i"], s["j"]
                reads = reads_at(i, j)
                if reads and it < s["ready"]:
                    log["waiting"] += 1
                    continue
                d = bits = 0
                if reads:
                    ic, jc = max(i, 1) - 1, max(j, 1) - 1
                    slot = (s["cnt"] - s["run_n"]) % slots
                    tag = s["ring"][slot]
                    if tag != (ic >> 4, jc) or (s["run_w"], s["run_c"]) != tag:
                        raise RunReadError(
                            f"pair {p} at ({i}, {j}), iteration {it}: slot "
                            f"{slot} holds {tag}, the run is "
                            f"({s['run_w']}, {s['run_c']})")
                    at = s["base"] + ((ic >> 4) * n_cols + jc) * tile_pairs
                    shift = 2 * (ic & 15)
                    d = (int(flat[at]) >> shift) & 3
                    if affine:
                        bits = (int(flat2[at]) >> shift) & 3
                if affine:
                    d = LEFT if s["state"] == 1 else (
                        TOP if s["state"] == 2 else d)
                    if mode == LOCAL_:
                        if s["state"] == 0 and d == STOP:
                            s["alive"] = False
                    elif j == 0:
                        d = TOP
                    elif i == 0:
                        d = LEFT
                elif mode != LOCAL_ and j == 0:
                    d = TOP
                elif mode != LOCAL_ and i == 0:
                    d = LEFT
                elif mode == LOCAL_ and d == STOP:
                    s["alive"] = False
                if not s["alive"]:
                    continue
                k = s["k"]
                s["word"] |= d << (2 * (k & 15))
                if k & 15 == 15:
                    packed[k >> 4, p] = s["word"]
                    s["word"] = 0
                s["k"] = k + 1
                if affine:
                    s["state"] = (1 if d == LEFT and bits & 1 else
                                  2 if d == TOP and bits & 2 else 0)
                s["i"] -= d in (DIAG, TOP)
                s["j"] -= d in (DIAG, LEFT)
                s["alive"] = (alive_at(mode, s["i"], s["j"])
                              and s["k"] < max_len)
            # Each live lane's run follows its cell; one copy.
            for p, s in st.items():
                if not (s["alive"] and reads_at(s["i"], s["j"])):
                    continue
                ic, jc = max(s["i"], 1) - 1, max(s["j"], 1) - 1
                w = ic >> 4
                if w != s["run_w"]:
                    s.update(run_w=w, run_c=jc, run_n=0, ready=it + run)
                    log["restarts"] += 1
                elif jc != s["run_c"]:
                    assert jc == s["run_c"] - 1
                    s["run_c"] = jc
                    s["run_n"] -= 1
                col = s["run_c"] - s["run_n"]
                if s["run_n"] < run and col >= 0:
                    slot = s["cnt"] % slots
                    lands = it + int(rng.integers(1, latency + 1))
                    in_flight.append((lands, float(rng.random()), p, slot,
                                      (w, col)))
                    s["ring"][slot] = "copy in flight"
                    s["cnt"] += 1
                    s["run_n"] += 1
                    log["copies"] += 1
            it += 1
        log["iterations"] += it
        for p, s in st.items():
            if s["k"] & 15:
                packed[s["k"] >> 4, p] = s["word"]
            lengths[p], fi[p], fj[p] = s["k"], s["i"], s["j"]
    return (packed.view(np.int32), lengths, fi, fj), log


def plain(dirs, ns, ms, bis, bjs, local, semi, max_len, dirs2=None):
    out = port_walk.batch_walk_plain(
        *(torch.from_numpy(np.ascontiguousarray(x))
          for x in (dirs, ns, ms, bis, bjs)), local, semi, max_len,
        dirs2=None if dirs2 is None else torch.from_numpy(dirs2))
    return [x.numpy() for x in out]


def same(got, want):
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


B, N, M = 128, 90, 64


def jax_filled(mode, seed, affine):
    """JAX-filled words of a ragged batch (padding pairs last) and the
    walk's starts, as the test of the plain walk makes them."""
    rng = np.random.default_rng(seed)
    texts = rng.integers(0, 4, (B, N)).astype(np.int32)
    patterns = rng.integers(0, 4, (B, M)).astype(np.int32)
    ns = rng.integers(1, N + 1, B).astype(np.int32)
    ms = rng.integers(1, M + 1, B).astype(np.int32)
    ns[-8:] = 0
    ms[-8:] = 0
    gap, ext = (8, 2) if affine else (5, None)
    out = batch_fill_dirs_pallas(
        texts, patterns, ns, ms, score_matrix(4), gap, k_alpha=4,
        tile_pairs=B, gap_extend=ext, interpret=True, **MODES[mode])
    scores, bis, bjs, dirs = (np.array(x) for x in out[:4])
    dirs2 = np.array(out[4]) if affine else None
    if mode == "local":
        bis = np.where(scores > 0, bis, 0).astype(np.int32)
        bjs = np.where(scores > 0, bjs, 0).astype(np.int32)
    return dirs, dirs2, ns, ms, bis, bjs


@pytest.mark.parametrize("affine", [False, True], ids=["linear", "affine"])
@pytest.mark.parametrize("mode", ["global", "local", "semi"])
def test_runs_match_plain_and_jax_on_jax_words(mode, affine):
    dirs, dirs2, ns, ms, bis, bjs = jax_filled(mode, 601 + len(mode),
                                               affine)
    local, semi = mode == "local", mode == "semi"
    full = -(-(N + M) // 16) * 16
    args = (dirs, ns, ms, bis, bjs, local, semi)
    want = plain(*args, full, dirs2)
    assert want[1].max() > 16 and (want[1] == 0).sum() >= 8  # padding
    ref = batch_device_traceback(*args, max_len=full, dirs2=dirs2)
    assert_same_walks(want, [np.asarray(x) for x in ref])
    for run in (1, 4, port_walk.RUN):
        got, log = run_walk(*args, full, dirs2, run=run, seed=run)
        same(got, want)
        assert log["restarts"] >= int((want[1] > 0).sum())
    # A 64-move buffer, against the TPU walker's stop.
    short = plain(*args, 64, dirs2)
    ref = batch_pallas_traceback(*args, max_len=64, dirs2=dirs2,
                                 interpret=True)
    assert_same_walks(short, [np.asarray(x) for x in ref])
    got, _ = run_walk(*args, 64, dirs2, run=2, seed=5)
    same(got, short)


SB, ROWS, COLS = 64, 70, 100
PAST_ROWS = -(-ROWS // 16) * 16 + 1  # the first row past the words


def synthetic(kind, mode, seed, affine):
    """Words packed from numpy of one path shape for every pair, random
    run bits, starts at the last cell, inside, and outside the words."""
    rng = np.random.default_rng(seed)
    local = mode == "local"
    cells = path_cells(kind, (SB * 2, ROWS + 1, COLS + 1), rng, local)
    dirs = pack_batch_words(cells, 128)
    dirs2 = pack_batch_words(rng.integers(0, 4, cells.shape).astype(np.uint8),
                             128) if affine else None
    ms = rng.integers(0, ROWS + 1, 2 * SB).astype(np.int32)
    ns = rng.integers(0, COLS + 1, 2 * SB).astype(np.int32)
    ms[:4], ns[:4] = ROWS, COLS
    ms[4], ns[5], ms[6], ns[7] = PAST_ROWS, COLS + 1, -1, -1  # outside
    return dirs, dirs2, ns, ms, ms.copy(), ns.copy()


@pytest.mark.parametrize("kind", ["random", "left", "top", "diag", "zigzag"])
@pytest.mark.parametrize("mode", ["global", "local", "semi"])
def test_runs_match_plain_on_every_path_shape(mode, kind):
    local, semi = mode == "local", mode == "semi"
    for affine in (False, True):
        seed = 700 + 7 * len(kind) + len(mode) + affine
        dirs, dirs2, ns, ms, bis, bjs = synthetic(kind, mode, seed, affine)
        args = (dirs, ns, ms, bis, bjs, local, semi)
        full = -(-(ROWS + COLS + 2) // 16) * 16
        for max_len, run in ((full, 1), (full, port_walk.RUN), (full, 16),
                             (64, 4)):
            want = plain(*args, max_len, dirs2)
            got, log = run_walk(*args, max_len, dirs2, run=run, seed=seed)
            same(got, want)
            # Starts outside the words walk nothing.
            out = (ms >= PAST_ROWS) | (ns > COLS) | (ms < 0) | (ns < 0)
            assert (got[1][out] == 0).all()
            if kind == "top" and mode != "local" and max_len == full:
                # A walk up a column restarts its run at every word row.
                up = (got[1] > 0) & (ms > 0) & (ns > 0)
                assert log["restarts"] >= int(((ms[up] - 1) // 16 + 1).sum())


def test_least_run_restarts_at_every_row_and_waits_only_there():
    # Run 1: one word ahead.  A lane waits only after a restart (R - 1
    # iterations, and its first iteration).
    dirs, _, ns, ms, bis, bjs = synthetic("diag", "global", 801, False)
    args = (dirs, ns, ms, bis, bjs, False, False, 192)
    want = plain(*args)
    for run in (1, 8):
        got, log = run_walk(*args, run=run, seed=3)
        same(got, want)
        assert log["waiting"] <= log["restarts"] * run


@pytest.mark.parametrize("run", [4, 8])
def test_a_ring_smaller_than_the_run_is_caught(run):
    # R slots hold the run, and copies landing out of order never land on
    # a slot a newer copy took; with R/2 slots a copy overwrites a word
    # the run still holds, and the read that needs it raises.
    dirs, _, ns, ms, bis, bjs = synthetic("left", "global", 811, False)
    args = (dirs, ns, ms, bis, bjs, False, False, 192)
    with pytest.raises(RunReadError):
        run_walk(*args, run=run, ring=run // 2, seed=1)
    for seed in range(3):
        same(run_walk(*args, run=run, seed=seed)[0], plain(*args))
