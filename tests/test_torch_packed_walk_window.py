"""A CPU model of K4's single-pair walk schedule (``csrc/batch_walk.cu``,
``walk_packed``'s window) against the plain walk and the JAX walk.

One warp walks the strip engine's words (W, P), cell (i, j) at bits
2*((i-1)%16) of word ((i-1)//16, j-1), and reads every word from a
window of WR word rows x WC columns staged in shared memory, row-major,
behind kGuard words.  A window is anchored at a cell of the walk: its
top word row is the cell's, its low column c0 the multiple of 4 that
leaves the cell's column among its four rightmost; nothing outside the
words is loaded.  The walker requests the next window, anchored at its
current cell, once it has gone half the rows or half the columns from
the resident window's anchor to that window's low edges (never, where
the edge is row 0 or column 0); it polls the load every 16 rows or
kPollCols columns after that and switches when it has landed, or waits
for it at the resident window's edge, and loads one at its cell if it
has left the requested window too (a miss).  Inside a window, in a
step lane q reads the word of column jc - q of the cell's
word row, the warp makes the LEFT moves at the head of those at once,
then the move of the first word that is not LEFT; a move into the word
row below moves on in the window.  Forced moves along row 0 and column 0
read nothing.

``window_walk`` runs that schedule move for move in numpy, a load landing
``latency`` moves after its request, and raises ``WindowReadError`` if a
read falls outside the shared memory of the two buffers and their guard
words, or if the word a move uses is not the cell's (a column no load
wrote, or a register that holds another cell's word).  The tests hold
its moves, count and final cursor equal to ``walk_packed``'s plain
version, its alignments to the JAX ``run_device_traceback`` on words the
JAX package packed (``pack_words`` of the oracle's fill), and check that
between a window's anchor and the next request the walk makes at least
half the window's span of moves.  Every value is an integer: the
tolerance is exact.
"""

import numpy as np
import pytest
import torch

from seqalign_torch.native import bindings as port_bindings
from seqalign_torch.ops import batch_traceback
from seqalign_torch.ops.walk import unpack_moves
from seqalign_torch.probes.batch_walk_shapes import (pack_packed_words,
                                                     path_cells)
from seqalign_tpu.native import bindings
from seqalign_tpu.ops.traceback import pack_words, run_device_traceback

from .torch_support import one_torch_thread  # noqa: F401

LEFT, DIAG, TOP, STOP = 0, 1, 2, 3
# csrc/batch_walk.cu's kGuard and kPollCols; a step reads a warp's 32
# columns.
GUARD, POLL_COLS, LOOK = 32, 32, 32
NEVER = -(1 << 30)
UNLOADED = -1
SMALLEST = (2, 8)


class WindowReadError(AssertionError):
    pass


def window_walk(words, n, m, bi, bj, local, max_len, shape=None,
                latency=0):
    """K4's single-pair walk by its window schedule.  Returns (packed,
    stats, log): the moves and [count, i, j] as the kernel writes them,
    and the windows the walk entered (anchor move, span) with the counts
    of loads, waits, misses, polls, early switches, crossings into a word
    row below and steps."""
    wr, wc = shape or batch_traceback.PACKED_WINDOW
    words = np.asarray(words)
    num_w, p_cols = words.shape
    flat = words.reshape(-1).astype(np.int64)
    kbuf = GUARD + wr * wc
    smem = np.full(2 * kbuf, UNLOADED, np.int64)  # the word index held
    cap = max_len
    moves = []
    log = dict(windows=[], loads=0, waits=0, misses=0, polls=0, early=0,
               crossings=0, steps=0)
    i, j = (bi, bj) if local else (m, n)
    stopped = False

    def read(at):
        if not 0 <= at < 2 * kbuf:
            raise WindowReadError(f"shared read at {at} of {2 * kbuf}")
        return int(smem[at])

    if i > 0 and j > 0 and cap > 0:
        cell = {}

        def request(buf):
            ic, jc = cell["ic"], cell["jc"]
            w0 = (ic >> 4) - wr + 1
            c0 = (jc - wc + 4) & ~3
            assert c0 % 4 == 0 and wc - 4 <= jc - c0 <= wc - 1
            # C's division truncates; both numerators are positive.
            mid_i = ic - (ic - w0 * 16 + 2) // 2 + 1 if w0 > 0 else NEVER
            mid_c = jc - (jc - c0 + 2) // 2 + 1 if c0 > 0 else NEVER
            dst = buf * kbuf + GUARD
            for r in range(wr):
                row = w0 + r
                for x in range(wc):
                    col = c0 + x
                    ok = 0 <= row < num_w and 0 <= col < p_cols
                    smem[dst + r * wc + x] = row * p_cols + col if ok \
                        else UNLOADED
            log["loads"] += 1
            rows = ic - w0 * 16 + 1 if w0 > 0 else None
            cols = jc - c0 + 1 if c0 > 0 else None
            span = min(x for x in (rows, cols, 1 << 30) if x is not None)
            return dict(w0=w0, c0=c0, mid_i=mid_i, mid_c=mid_c,
                        at=len(moves), span=span)

        def inside(w):
            return cell["ic"] >= w["w0"] * 16 and cell["jc"] >= w["c0"]

        def enter(w):
            log["windows"].append((w["at"], w["span"]))
            return w

        cell.update(ic=i - 1, jc=j - 1)
        cur = 0
        res, nxt_win = enter(request(0)), None
        ev_i = ev_c = 0
        event = True
        while i > 0 and j > 0 and len(moves) < cap:
            cell.update(ic=i - 1, jc=j - 1)
            ic, jc = i - 1, j - 1
            if event:
                fresh = False
                if nxt_win is None and (ic < res["mid_i"]
                                        or jc < res["mid_c"]):
                    nxt_win, fresh = request(cur ^ 1), True
                if nxt_win is not None:
                    landed = len(moves) >= nxt_win["at"] + latency
                    if not inside(res) or (not fresh and landed):
                        log["waits" if not inside(res) else "early"] += 1
                        cur ^= 1
                        res, nxt_win = nxt_win, None
                        if not inside(res):
                            log["misses"] += 1
                            res = request(cur)
                        enter(res)
                        if ic < res["mid_i"] or jc < res["mid_c"]:
                            nxt_win = request(cur ^ 1)
                    elif not fresh:
                        log["polls"] += 1
                if nxt_win is not None:
                    ev_i = max(res["w0"] * 16, ic - 15)
                    ev_c = max(res["c0"], jc - POLL_COLS)
                else:
                    ev_i, ev_c = res["mid_i"], res["mid_c"]
            base = cur * kbuf + GUARD
            off = ((ic >> 4) - res["w0"]) * wc + (jc - res["c0"])
            sh = 2 * (ic & 15)
            k = max(min(ic - ev_i, jc - ev_c, i, j, cap - len(moves)), 1)
            while k > 0:
                # A step: the cell's word and the LOOK - 1 to its left.
                held = [read(base + off - q) for q in range(LOOK)]
                row, jc = (i - 1) >> 4, j - 1

                def use(q):
                    want = row * p_cols + jc - q
                    if held[q] != want:
                        raise WindowReadError(
                            f"move {len(moves)} at ({i}, {jc - q + 1}) "
                            f"uses word {held[q]}, the cell's is {want}")
                    return (int(flat[held[q]]) >> sh) & 3

                left = 0
                while left < min(LOOK, k) and use(left) == LEFT:
                    left += 1
                moves += [LEFT] * left
                off -= left
                j -= left
                k -= left
                log["steps"] += 1
                if left == LOOK or k == 0:
                    continue
                d = use(left)
                if local and d == STOP:
                    stopped = True
                    break
                moves.append(d)
                k -= 1
                if d == STOP:  # global words hold none: no move
                    continue
                i -= 1
                j -= d == DIAG
                off -= d == DIAG
                if sh == 0:  # into the word row below, inside the window
                    off -= wc
                    sh = 30
                    log["crossings"] += 1
                else:
                    sh -= 2
            if stopped:
                break
            event = i - 1 < ev_i or j - 1 < ev_c
    if not local and not stopped and len(moves) < cap:
        if j == 0 and i > 0:
            forced = min(i, cap - len(moves))
            moves += [TOP] * forced
            i -= forced
        elif i == 0 and j > 0:
            forced = min(j, cap - len(moves))
            moves += [LEFT] * forced
            j -= forced
    packed = np.zeros(max_len // 16, np.uint32)
    for x, d in enumerate(moves):
        packed[x >> 4] |= np.uint32(d << (2 * (x & 15)))
    return packed.view(np.int32), [len(moves), i, j], log


def plain(words, n, m, bi, bj, local, max_len):
    packed, stats = batch_traceback.walk_packed(torch.as_tensor(words), n, m,
                                                bi, bj, local, max_len)
    return packed.numpy(), stats.tolist()


def same_walk(got, want):
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[0], want[0])


def check_spans(log):
    """Between a window's anchor and the next window's request the walk
    makes at least half the window's span of moves."""
    windows = log["windows"]
    for (at, span), (nxt, _) in zip(windows, windows[1:]):
        assert nxt - at >= -(-span // 2), (at, span, nxt, windows)


def full(n, m):
    return -(-(n + m + 1) // 16) * 16


@pytest.mark.parametrize("local", [False, True], ids=["global", "local"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_window_walks_match_plain_and_jax(local, seed):
    # The oracle's fill, packed by the JAX package; the walk's moves
    # replayed by the native emit equal the JAX device walk's alignment.
    rng = np.random.default_rng(40 + seed)
    sm = np.where(np.eye(4, dtype=bool), 5, -4).astype(np.int32)
    n = int(rng.integers(300, 700))
    m = int(rng.integers(100, 300))
    text = rng.integers(0, 4, n).astype(np.int8)
    pattern = rng.integers(0, 4, m).astype(np.int8)
    dirs, _, best = bindings.oracle_fill(1 if local else 0, text, pattern,
                                         sm, 4, 5)
    words = pack_words(dirs)
    bi, bj = (best // (n + 1), best % (n + 1)) if local else (0, 0)
    args = (words, n, m, bi, bj, local, full(n, m))
    want = plain(*args)
    for shape in (SMALLEST, (4, 64), None):
        for latency in (0, 7):
            got = window_walk(*args, shape=shape, latency=latency)
            same_walk(got[:2], want)
            check_spans(got[2])
    count = want[1][0]
    start_i, start_j = (bi, bj) if local else (m, n)
    ours = port_bindings.emit_moves(unpack_moves(want[0], count), start_i,
                                    start_j, local, text, pattern, 4)
    jax = run_device_traceback(words, text, pattern, n, m, bi, bj, 4, local)
    np.testing.assert_array_equal(ours[0], jax[0])
    np.testing.assert_array_equal(ours[1], jax[1])
    assert tuple(ours[2:]) == tuple(jax[2:])


def test_packer_matches_jax_pack_words():
    rng = np.random.default_rng(44)
    for rows, cols in ((1, 5), (16, 9), (37, 130)):
        cells = rng.integers(0, 4, (rows + 1, cols + 1)).astype(np.uint8)
        np.testing.assert_array_equal(pack_packed_words(cells),
                                      pack_words(cells))


@pytest.mark.parametrize("kind", ["random", "left", "top", "diag", "zigzag"])
@pytest.mark.parametrize("local", [False, True], ids=["global", "local"])
def test_every_path_shape_crosses_windows(local, kind):
    # Paths that cross every word row (all TOP, all DIAG), stay in one
    # (all LEFT) or zig-zag; the least window makes a walk cross dozens.
    rng = np.random.default_rng(50 + len(kind) + local)
    rows, cols = 160, 420
    words = pack_packed_words(path_cells(kind, (rows + 1, cols + 1), rng,
                                         local))
    starts = [(rows, cols), (rows - 21, cols - 37)] if local else [(0, 0)]
    for bi, bj in starts:
        args = (words, cols, rows, bi, bj, local, full(cols, rows))
        want = plain(*args)
        for shape, latency in ((SMALLEST, 0), (SMALLEST, 5), ((4, 32), 3),
                               (None, 0)):
            got = window_walk(*args, shape=shape, latency=latency)
            same_walk(got[:2], want)
            check_spans(got[2])
            if shape == SMALLEST and kind != "top" and not local:
                # 8 columns a window along 420 columns, 2 word rows down
                # 160 rows.
                assert len(got[2]["windows"]) >= 24, got[2]
            if kind in ("top", "diag") and not local:
                assert got[2]["crossings"] >= min(rows, cols) // 16 - 1


@pytest.mark.parametrize("cap", [16, 64, 160])
def test_buffer_end_stops_mid_window(cap):
    rng = np.random.default_rng(60 + cap)
    rows, cols = 120, 300
    words = pack_packed_words(path_cells("random", (rows + 1, cols + 1),
                                         rng, False))
    args = (words, cols, rows, 0, 0, False, cap)
    want = plain(*args)
    got = window_walk(*args, shape=SMALLEST, latency=2)
    same_walk(got[:2], want)
    assert got[1][0] == cap and (got[1][1] > 0 or got[1][2] > 0)


@pytest.mark.parametrize("start", [(0, 0), (0, 90), (70, 0), (1, 1)])
def test_starts_on_the_edges_make_forced_moves(start):
    # Global walks from row 0 or column 0 read nothing; their forced
    # moves are whole words of LEFT (0) or TOP (0xAAAAAAAA).
    m, n = start
    rng = np.random.default_rng(70)
    words = pack_packed_words(path_cells("random", (81, 101), rng, False))
    args = (words, n, m, 0, 0, False, full(n, m) + 32)
    want = plain(*args)
    got = window_walk(*args, shape=SMALLEST)
    same_walk(got[:2], want)
    assert got[2]["loads"] == (1 if min(start) > 0 else 0)
    assert got[1] == [m + n - (1 if min(start) > 0 and (want[0][0] & 3) == 1
                               else 0), 0, 0]


def test_reads_stay_inside_the_guard():
    # A step at column c0 of a window's first row reads 31 columns to its
    # left, before the window: the guard words hold them.
    rng = np.random.default_rng(80)
    rows, cols = 40, 64
    cells = path_cells("left", (rows + 1, cols + 1), rng, False)
    words = pack_packed_words(cells)
    args = (words, cols, rows, 0, 0, False, full(cols, rows))
    got = window_walk(*args, shape=SMALLEST)
    same_walk(got[:2], plain(*args))
