"""A CPU model of K2's window schedule (``csrc/walk.cu``) against the
plain walk and the JAX walker.

K2 walks the path on one thread and reads every word, and every run bit,
from a window of the skewed words staged in shared memory: S slots x G
word groups (16 sweep steps a group), all rps rows of each slot, laid
out [G][rps][S].  A window is anchored at a cell of the walk: its low
slot s0 is the least multiple of 4 at or above the cell's slot - S + 1
(so the cell's slot is among its top four), its top group is the cell's
and its low group b0 the cell's group - G + 1; nothing below slot 0 or
group 0 is loaded.  The walker requests the next window, anchored at its
current cell, once it has gone down half the rows or half the steps from
the resident window's anchor to that window's low edge (never, where the
edge is row 0 or step 0); it polls the load every 16 rows or one group of
steps after that and switches when it has landed, or waits for it at
the resident window's edge, and loads one at its cell if it has left the
requested window too (a miss).  Inside a window the walker keeps the
cell's offset incrementally: the offsets of the three moves from the
cell, selected by the word's bits.

``window_walk`` runs that schedule move for move in numpy, a load landing
``latency`` moves after its request, and raises ``WindowReadError`` if a
read falls outside the resident buffer, finds an entry no load wrote, or
the incremental offset differs from ((t/16 - b0) * rps + r) * S +
(slot - s0).  The tests hold its moves and result equal to
``walk_skewed_window_plain`` and to the JAX walker in interpret mode on
the same words (packed by the JAX package's ``pack_words_skewed``), and
check in the model that between a window's anchor and the next window's
request the walk makes at least half the window's span of moves (the
least number of moves from the anchor out of the window).  Every value
is an integer: the tolerance is exact.
"""

import numpy as np
import pytest
import torch

from seqalign_torch.ops import walk as port_walk
from seqalign_torch.probes.walk_shapes import pack_words_skewed as pack
from seqalign_torch.probes.walk_shapes import path_dirs
from seqalign_tpu.ops.pallas_walk import pallas_walk_skewed_window, unpack_moves
from seqalign_tpu.ops.traceback import pack_words_skewed

from .torch_support import one_torch_thread  # noqa: F401

LEFT, DIAG, TOP, STOP = 0, 1, 2, 3
UNLOADED = 1 << 40  # not an int32: what a buffer holds where no load wrote
SMALLEST = (8, 2)   # the least window the all-shapes build takes
RPS_ALL = (1, 2, 4, 8, 16)
SLOTS = 128


class WindowReadError(AssertionError):
    pass


def load(flat, rps, slots, word_rows, shape, s0, b0):
    """The loaders' copy of the window at (s0, b0): [G][rps][S] as one
    flat int64 array, UNLOADED where no chunk was copied."""
    S, G = shape
    buf = np.full((G, rps, S), UNLOADED, np.int64)
    words = flat.reshape(-1, slots)
    for g in range(G):
        for r in range(rps):
            row = (b0 + g) * rps + r
            if row < 0 or row >= word_rows:
                continue
            # 16-byte chunks of 4 slots, each whole inside [0, slots) or
            # whole outside, as s0 and slots are multiples of 4.
            lo, hi = max(s0, 0), min(s0 + S, slots)
            buf[g, r, lo - s0:hi - s0] = words[row, lo:hi]
    return buf.reshape(-1)


def anchor(a, t, rps, shape):
    """The window anchored at row a (tile rows from 0), step t: s0, b0
    and the row and step below which the walk has passed its middle."""
    S, G = shape
    s = a // rps
    s0 = (s - S + 4) & ~3
    b0 = (t >> 4) - G + 1
    never = -(1 << 30)
    mid_a = a - (a - s0 * rps + 2) // 2 + 1 if s0 > 0 else never
    mid_t = t - (t - b0 * 16 + 2) // 2 + 1 if b0 > 0 else never
    return s0, b0, mid_a, mid_t


def window_walk(words, rps, row_lo, col_lo, i0, j0, local, max_moves,
                words2=None, state0=0, shape=None, latency=0):
    """K2's walk by its window schedule.  Returns (moves, result, log):
    moves packed like the plain walk's, result [count, i, j, state,
    done], log the windows the walk entered (anchor move, span) and the
    counts of loads, waits, misses, polls and early switches."""
    affine = words2 is not None
    shape = shape or port_walk.window_shape(rps, affine)
    S, G = shape
    lr = rps.bit_length() - 1
    slots = words.shape[1] * 128
    flat = np.asarray(words).reshape(-1).astype(np.int64)
    flat2 = None if words2 is None else np.asarray(words2).reshape(-1)
    group, plane = rps * S, G * rps * S
    cap = -(-max_moves // 16) * 16
    moves = np.zeros(max(cap // 16, 1), np.uint32)
    a, c, st = i0 - row_lo - 1, j0 - col_lo - 1, state0
    count = done = 0
    log = dict(windows=[], loads=0, waits=0, misses=0, polls=0, early=0)
    if a >= 0 and c >= 0 and cap > 0:
        word_rows = ((c + (a >> lr)) // 16 + 1) * rps
        s, t = a >> lr, c + (a >> lr)

        def request():
            s0, b0, mid_a, mid_t = anchor(a, t, rps, shape)
            assert s0 % 4 == 0 and S - 4 <= s - s0 <= S - 1
            assert s0 + S <= slots and b0 + G - 1 == t >> 4
            planes = [load(flat, rps, slots, word_rows, shape, s0, b0)]
            if affine:
                planes.append(load(flat2, rps, slots, word_rows, shape, s0,
                                   b0))
            log["loads"] += 1
            rows = a - s0 * rps + 1 if s0 > 0 else None
            steps = t - b0 * 16 + 1 if b0 > 0 else None
            span = min(x for x in (rows, None if steps is None
                                   else -(-steps // 2), 1 << 30)
                       if x is not None)
            return dict(s0=s0, b0=b0, mid_a=mid_a, mid_t=mid_t,
                        planes=planes, at=count, span=span)

        def inside(w):
            return s >= w["s0"] and t >= w["b0"] * 16

        def enter(w):
            log["windows"].append((w["at"], w["span"]))
            return w

        res, nxt = enter(request()), None
        r = a & (rps - 1)
        off = ((t >> 4) - res["b0"]) * group + r * S + (s - res["s0"])
        ev_a = ev_t = 0
        event = True
        while True:
            if a < 0 or c < 0:
                if local:
                    done = int(a + row_lo + 1 == 0 or c + col_lo + 1 == 0)
                break
            if count >= cap:
                break
            if event:
                s = a >> lr
                fresh = False
                if nxt is None and (a < res["mid_a"] or t < res["mid_t"]):
                    nxt, fresh = request(), True
                if nxt is not None:
                    landed = count >= nxt["at"] + latency
                    if not inside(res) or (not fresh and landed):
                        if not inside(res):
                            log["waits"] += 1
                        else:
                            log["early"] += 1
                        res, nxt = nxt, None
                        if not inside(res):
                            log["misses"] += 1
                            res = request()
                        enter(res)
                        off = (((t >> 4) - res["b0"]) * group + r * S
                               + (s - res["s0"]))
                        if a < res["mid_a"] or t < res["mid_t"]:
                            nxt = request()
                    elif not fresh:
                        log["polls"] += 1
                lo = res["s0"] * rps if res["s0"] > 0 else 0
                if nxt is not None:
                    ev_a = max(lo, a - 15)
                    ev_t = max(res["b0"] * 16, t & ~15)
                else:
                    ev_a, ev_t = max(res["mid_a"], 0), res["mid_t"]
            tl = t & 15
            while True:
                s = a >> lr
                want = ((t >> 4) - res["b0"]) * group + r * S + (s - res["s0"])
                if off != want or not 0 <= off < plane:
                    raise WindowReadError(f"offset {off} at ({a}, {t}), "
                                          f"want {want} of {plane}")
                idx = ((t >> 4) * rps + r) * slots + s
                w = int(res["planes"][0][off])
                w2 = int(res["planes"][1][off]) if affine else 0
                if w == UNLOADED or w != flat[idx] or (
                        affine and w2 != flat2[idx]):
                    raise WindowReadError(f"read of cell ({a}, {t}) at "
                                          f"{off}: {w}, word {flat[idx]}")
                r0 = rps == 1 or r == 0
                cross = group if tl == 0 else 0
                off_l = off - cross
                off_t = off + (rps - 1) * S - 1 - cross if r0 else off - S
                off_d = off_t - (group if tl == int(r0) else 0)
                r_next = rps - 1 if r0 else r - 1
                if st == 0:
                    d = (w >> (2 * tl)) & 3
                else:
                    d = LEFT if st == 1 else TOP
                if local and d == STOP:
                    done = 1
                    break
                moves[count >> 4] |= np.uint32(d << (2 * (count & 15)))
                count += 1
                if affine:
                    bits = (w2 >> (2 * tl)) & 3
                    st = (1 if d == LEFT and bits & 1
                          else 2 if d == TOP and bits & 2 else 0)
                b0, b1 = d & 1, d & 2
                di = int(bool(b0) != bool(b1))
                off = (off if b0 else off_t) if b1 else (off_d if b0 else off_l)
                t -= (0 if b0 else int(r0)) if b1 else (1 + r0 if b0 else 1)
                r = r_next if di else r
                a -= di
                c -= 0 if b1 else 1
                tl = t & 15
                if a < ev_a or t < ev_t or c < 0 or count >= cap:
                    break
            if done:
                break
            event = a < ev_a or t < ev_t
    result = [count, a + row_lo + 1, c + col_lo + 1, st, done]
    return moves.view(np.int32), result, log


def plain(words, rps, row_lo, col_lo, i0, j0, local, max_moves, words2=None,
          state0=0):
    mv, res = port_walk.walk_skewed_window_plain(
        torch.as_tensor(words), rps, row_lo, col_lo, i0, j0, local,
        max_moves, None if words2 is None else torch.as_tensor(words2),
        state0)
    return mv.numpy(), res.tolist()


def jax_walk(words, rps, row_lo, col_lo, i0, j0, local, max_moves,
             words2=None, state0=0):
    mv, k, ri, rj, rst, rdone = pallas_walk_skewed_window(
        words, words2, rps, row_lo, col_lo, i0, j0, state0, local,
        words2 is not None, max_moves, interpret=True)
    k = int(k)
    return unpack_moves(mv, k), [k, int(ri), int(rj), int(rst), int(rdone)]


def same_walk(got, want):
    """got/want = (packed moves, result): equal counts and cursors, equal
    moves up to the count."""
    (mv, res), (mv_w, res_w) = got, want
    assert res == res_w
    assert np.array_equal(port_walk.unpack_moves(mv, res[0]),
                          port_walk.unpack_moves(mv_w, res_w[0]))


def check_spans(log):
    """Between a window's anchor and the next window's request the walk
    makes at least half the window's span of moves."""
    windows = log["windows"]
    for (at, span), (nxt, _) in zip(windows, windows[1:]):
        assert nxt - at >= -(-span // 2), (at, span, nxt, windows)


def random_dirs(rng, rows, cols, local):
    hi = 4 if local else 3  # global words never hold STOP
    return rng.integers(0, hi, (rows + 1, cols + 1)).astype(np.uint8)


def test_pack_matches_jax_packer():
    # The probe's packer, which the larger cases below use.
    rng = np.random.default_rng(70)
    for rps, rows, cols in ((1, 100, 90), (4, 300, 50), (16, 700, 40)):
        dirs = random_dirs(rng, rows, cols, True)
        assert np.array_equal(pack(dirs, rps, SLOTS),
                              np.asarray(pack_words_skewed(dirs, rps, SLOTS)))


@pytest.mark.parametrize("rps", RPS_ALL)
def test_window_shape(rps):
    for affine in (False, True):
        S, G = port_walk.window_shape(rps, affine)
        planes = 2 if affine else 1
        # 512 rows linear, 256 affine; 512 steps; S whole 16-byte chunks
        # and at least 5 slots at or below an anchor; two buffers within
        # the 227 KB a CTA can have.
        assert S * rps == (256 if affine else 512) and 16 * G == 512
        assert S % 8 == 0 and G >= 2
        assert 2 * planes * S * G * rps * 4 <= 232_448
    with pytest.raises(ValueError, match="rps"):
        port_walk.window_shape(3, False)


@pytest.mark.parametrize("rps", RPS_ALL)
def test_window_layout_and_clipping(rps):
    # Every loaded entry of a window at (s0, b0) is the word of its (g, r,
    # slot) at ((g*rps + r)*S + slot - s0); exactly the entries below slot
    # 0 or group 0 are not loaded.
    rng = np.random.default_rng(71 + rps)
    slots = 256
    groups = 40
    words = rng.integers(-2**31, 2**31, (groups * rps, slots),
                         dtype=np.int64).astype(np.int32)
    flat = words.reshape(-1).astype(np.int64)
    for shape in (SMALLEST, port_walk.window_shape(rps, False), (16, 4)):
        S, G = shape
        for a, t in ((0, 0), (rps * slots - 1, groups * 16 - 1),
                     (rps * 37 + rps // 2, 300), (rps * 3, 5 * 16 + 3)):
            s0, b0, _, _ = anchor(a, t, rps, shape)
            s = a // rps
            assert s0 % 4 == 0 and s0 <= s <= s0 + S - 1
            assert s - s0 >= S - 4 and s0 + S <= slots
            assert b0 == (t >> 4) - G + 1
            buf = load(flat, rps, slots, groups * rps, shape, s0, b0)
            g, r, x = np.meshgrid(np.arange(G), np.arange(rps),
                                  np.arange(S), indexing="ij")
            slot, grp = s0 + x, b0 + g
            loaded = (slot >= 0) & (grp >= 0)
            off = (g * rps + r) * S + x
            assert np.array_equal(buf[off] != UNLOADED, loaded)
            idx = ((grp * rps + r) * slots + slot)[loaded]
            assert np.array_equal(buf[off[loaded]], flat[idx])


def walk_case(rng, rps, rows, cols, local, affine):
    dirs = random_dirs(rng, rows, cols, local)
    words = np.asarray(pack_words_skewed(dirs, rps, SLOTS))
    words2 = None
    if affine:
        bits = rng.integers(0, 4, dirs.shape).astype(np.uint8)
        words2 = np.asarray(pack_words_skewed(bits, rps, SLOTS))
    return words, words2


@pytest.mark.parametrize("mode", ["global", "local", "semi"])
@pytest.mark.parametrize("rps", RPS_ALL)
def test_linear_walks_match_plain_and_jax(rps, mode):
    # Semi-global walks with the global rules from a last-row cell.
    local = mode == "local"
    rng = np.random.default_rng(80 + rps + 10 * ("gls".index(mode[0])))
    rows, cols = min(rps * SLOTS, 220), 260
    words, _ = walk_case(rng, rps, rows, cols, local, False)
    for k in range(3):
        i = rows if mode == "semi" else int(rng.integers(rows // 2, rows + 1))
        j = int(rng.integers(cols // 2, cols + 1))
        args = (words, rps, 0, 0, i, j, local, rows + cols + 1)
        want = plain(*args)
        for shape in (SMALLEST, None):
            for latency in (0, 3):
                got = window_walk(*args, shape=shape, latency=latency)
                same_walk(got[:2], want)
                check_spans(got[2])
        if k == 0:
            jmv, jres = jax_walk(*args)
            assert want[1][:3] == jres[:3] and want[1][4] == jres[4]
            assert np.array_equal(port_walk.unpack_moves(want[0], jres[0]),
                                  jmv)


@pytest.mark.parametrize("local", [False, True])
@pytest.mark.parametrize("state0", [0, 1, 2])
@pytest.mark.parametrize("rps", [2, 16])
def test_affine_walks_match_plain_and_jax(rps, state0, local):
    rng = np.random.default_rng(90 + rps + state0 + 3 * local)
    rows, cols = min(rps * SLOTS, 200), 240
    words, words2 = walk_case(rng, rps, rows, cols, local, True)
    i, j = rows - int(rng.integers(0, 9)), cols - int(rng.integers(0, 9))
    args = (words, rps, 0, 0, i, j, local, rows + cols + 1)
    want = plain(*args, words2, state0)
    for shape in (SMALLEST, None):
        got = window_walk(*args, words2, state0, shape=shape, latency=2)
        same_walk(got[:2], want)
        check_spans(got[2])
    jmv, jres = jax_walk(*args, words2, state0)
    assert want[1] == jres
    assert np.array_equal(port_walk.unpack_moves(want[0], jres[0]), jmv)


@pytest.mark.parametrize("affine", [False, True])
@pytest.mark.parametrize("local", [False, True])
def test_tile_walks(local, affine):
    # A tile of the checkpoint engine: rows row_lo+1.., columns col_lo+1..
    rng = np.random.default_rng(100 + 2 * local + affine)
    rps, rows, cols, row_lo, col_lo = 4, 300, 280, 1200, 5000
    words, words2 = walk_case(rng, rps, rows, cols, local, affine)
    i0, j0 = row_lo + rows - 3, col_lo + cols - 11
    args = (words, rps, row_lo, col_lo, i0, j0, local, rows + cols + 1)
    state0 = 2 if affine else 0
    want = plain(*args, words2, state0)
    for shape in (SMALLEST, (16, 4), None):
        got = window_walk(*args, words2, state0, shape=shape, latency=1)
        same_walk(got[:2], want)
    jmv, jres = jax_walk(*args, words2, state0)
    assert want[1][:3] == jres[:3] and want[1][4] == jres[4]
    assert np.array_equal(port_walk.unpack_moves(want[0], jres[0]), jmv)


@pytest.mark.parametrize("affine", [False, True])
@pytest.mark.parametrize("cap", [40, 97])
def test_buffer_end_stops_mid_window(cap, affine):
    rng = np.random.default_rng(110 + cap + affine)
    rps, rows, cols = 16, 400, 300
    words, words2 = walk_case(rng, rps, rows, cols, False, affine)
    args = (words, rps, 0, 0, rows, cols, False, cap)
    want = plain(*args, words2, 1 if affine else 0)
    got = window_walk(*args, words2, 1 if affine else 0, shape=SMALLEST)
    same_walk(got[:2], want)
    count, _, _, _, done = got[1]
    assert count == -(-cap // 16) * 16 and done == 0
    assert len(got[2]["windows"]) >= 2  # the stop falls in a later window


@pytest.mark.parametrize("kind", ["left", "top", "diag", "zigzag"])
@pytest.mark.parametrize("rps", [1, 16])
def test_adversarial_paths_cross_dozens_of_windows(rps, kind):
    rng = np.random.default_rng(120 + rps)
    rows, cols = rps * SLOTS, 900
    words = pack(path_dirs(kind, rows, cols, rng), rps, SLOTS)
    args = (words, rps, 0, 0, rows, cols, False, rows + cols + 1)
    want = plain(*args)
    for latency in (0, 5):
        got = window_walk(*args, shape=SMALLEST, latency=latency)
        same_walk(got[:2], want)
        check_spans(got[2])
        assert len(got[2]["windows"]) >= 24, got[2]
    got = window_walk(*args)  # the production shape
    same_walk(got[:2], want)
    check_spans(got[2])

