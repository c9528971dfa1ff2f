"""A CPU model of K3's chain of warps (``csrc/interpair.cu``,
``csrc/interpair16.cu``, ``csrc/interpair_chain.cuh``) against the plain
versions and the JAX kernel.

The kernels give a CTA 32 pairs (64 in int16 cells, two a lane) and W
warps: warp w fills the stripes of 16 rows w, w + W, ... of all of them,
sweeping the columns in blocks of SB.  A stripe's bottom row (and F)
goes to the next warp through that warp's ring of 32 columns in shared
memory (column c of the warp's block g at entry g SB + c, modulo 32), or
from the last warp to warp 0 through the global scratch, one pass
later.  Each warp counts its finished blocks; a warp runs block g
of its stripe once its source has finished the same block (warp W - 1's
g - nblocks for warp 0), and overwrites a ring block only once the next
warp has finished the block that used those ring columns before.  At
the end the CTA merges its warps' trackers: the largest value, then the
smallest row.

``chain_fill`` runs that schedule in numpy, warp by warp and block by
block, in an order it is given (each warp a block in turn, or the
lowest warp that can run first, so that warp 0 runs as far ahead as the
counts let it), with the kernels' trackers, a column at once: local's
takes the column's largest tracked H, then its first row; semi's and
global's H in row m (K3-cell16's packed score-only trackers go cell by
cell).  Every value that crosses warps carries a tag (its
stripe and column), and a read of a ring or scratch entry that the
schedule has not written yet, or has overwritten, raises; so does a
schedule in which no warp can run.  The tests hold its outputs equal to
``batch_fill``'s plain versions in every output, for every mode,
variant and cell type, at a shape whose stripes wrap and one whose do
not, and once to the JAX kernel in interpret mode.  Every value is an
integer: the tolerance is exact.
"""

import numpy as np
import pytest
import torch

from seqalign_torch.ops import batch_fill
from seqalign_tpu.ops.pallas_fill import batch_fill_dirs_pallas

from .torch_support import one_torch_thread, score_matrix  # noqa: F401

ROWS = 16
WARP = 32
RING_COLS = 32
TILE = batch_fill.TILE_QUANTUM
MODES = {"global": {}, "local": {"local": True}, "semi": {"semi": True}}
DNA_5_4 = np.where(np.eye(4, dtype=bool), 5, -4).astype(np.int32)
# (warps, columns a block): 7 stripes wrap over 3 warps, in blocks that
# do not divide the columns; and 16 warps, more than the stripes.
WRAPS, NO_WRAP = (3, 4), (16, 8)


class Tagged:
    """Rows that cross warps, each entry tagged with the (stripe, column)
    of the value it holds; reading an entry whose tag is not the one
    expected raises."""

    def __init__(self, entries, pairs):
        self.h = np.zeros((entries, pairs), np.int64)
        self.f = np.zeros((entries, pairs), np.int64)
        self.tag = [None] * entries

    def put(self, at, tag, h, f):
        self.h[at], self.f[at], self.tag[at] = h, f, tag

    def get(self, at, tag):
        assert self.tag[at] == tag, (f"read {tag} at {at}, holds "
                                     f"{self.tag[at]}")
        return self.h[at].copy(), self.f[at].copy()


class Warp:
    """A warp's registers and place in its schedule."""

    def __init__(self, w, pairs):
        self.w, self.s, self.q, self.g = w, w, 0, 0
        self.acc = np.zeros(pairs, np.int64)
        self.bi = np.zeros(pairs, np.int64)
        self.bj = np.zeros(pairs, np.int64)


def chain_fill(texts, patterns, ns, ms, sm, gap, mode, with_dirs,
               gap_extend=None, cell16=False, warps=4, block=4,
               order="turns", slot_wait=True):
    """K3's outputs by the chain schedule, shaped as the plain versions':
    (scores, best_is, best_js, dirs, dirs2) with None where the variant
    has none.  ``order``: "turns" (each warp a block in turn) or
    "ahead" (the lowest warp that can run); ``slot_wait`` False drops the
    wait for a free ring block (a broken schedule)."""
    local, semi = mode == "local", mode == "semi"
    affine = gap_extend is not None
    ge = int(gap_extend) if affine else 0
    b, n_cols = texts.shape
    m_rows = patterns.shape[1]
    b2 = b + (b & 1) if cell16 else b
    text = np.zeros((b2, n_cols), np.int64)
    text[:b] = texts
    pat = np.zeros((b2, m_rows), np.int64)
    pat[:b] = patterns
    n_all = np.zeros(b2, np.int64)
    n_all[:b] = np.minimum(ns, n_cols)
    m_all = np.zeros(b2, np.int64)
    m_all[:b] = np.minimum(ms, m_rows)
    neg_run = batch_fill.NEG_16 if cell16 else batch_fill.NEG_HALF
    neg_acc = batch_fill.NEG_16 if cell16 else batch_fill.NEG_INF
    num_w = m_rows // ROWS
    scores = np.zeros(b2, np.int64)
    best_is = np.zeros(b2, np.int64)
    best_js = np.zeros(b2, np.int64)
    planes = np.zeros((2, num_w, n_cols, b2), np.int64) if with_dirs else None
    per_cta = 2 * WARP if cell16 else WARP

    def column0(i):  # H[i, 0]
        if local:
            return 0
        if affine:
            return 0 if i == 0 else -gap - ge * (i - 1)
        return -gap * i

    def row0(j):  # H[0, j+1]
        if mode != "global":
            return 0
        return -gap - ge * j if affine else -gap * (j + 1)

    for c0 in range(0, b2, per_cta):
        lanes = slice(c0, min(c0 + per_cta, b2))
        t_c, p_c = text[lanes], pat[lanes]
        n, m = n_all[lanes], m_all[lanes]
        pairs = n.size
        stripes = num_w if with_dirs else -(-int(m.max()) // ROWS)
        cols = n_cols if with_dirs else int(n.max())
        nblocks = -(-cols // block)
        slots = RING_COLS // block
        progress = np.zeros(warps, np.int64)
        rings = [Tagged(RING_COLS, pairs) for _ in range(warps)]
        scratch = Tagged(n_cols, pairs)
        team = [Warp(w, pairs) for w in range(warps)]
        for wp in team:
            wp.acc[:] = neg_acc

        def start_stripe(wp):
            i0 = wp.s * ROWS
            rows = i0 + 1 + np.arange(ROWS)
            if affine:
                h = [np.full(pairs, 0 if local else -gap - ge * (i - 1))
                     for i in rows]
            else:
                h = [np.full(pairs, column0(i)) for i in rows]
            wp.h = h
            wp.e = [np.full(pairs, neg_run) for _ in rows]
            wp.letters = [p_c[:, i - 1] if i - 1 < m_rows
                          else np.zeros(pairs, np.int64) for i in rows]
            wp.diag0 = np.full(pairs, column0(i0))

        def can_run(wp):
            if wp.s >= stripes or nblocks == 0:
                return False
            if wp.s > 0:
                src = warps - 1 if wp.w == 0 else wp.w - 1
                need = (wp.g - nblocks if wp.w == 0 else wp.g) + 1
                if progress[src] < need:
                    return False
            to_ring = wp.s + 1 < stripes and wp.w + 1 < warps
            return not (to_ring and slot_wait
                        and progress[wp.w + 1] < wp.g - slots + 1)

        def ring_at(wp, j):
            # Column j of the warp's block g: blocks g and g + slots share
            # ring entries, whatever their columns.
            return (wp.g * block + j - wp.q * block) % RING_COLS

        def run_block(wp):
            s, w = wp.s, wp.w
            if wp.q == 0:
                start_stripe(wp)
            i0 = s * ROWS
            to_next = s + 1 < stripes
            for j in range(wp.q * block, min((wp.q + 1) * block, cols)):
                if s == 0:
                    top = np.full(pairs, row0(j))
                    ftop = np.full(pairs, neg_run)
                elif w > 0:
                    top, ftop = rings[w - 1].get(ring_at(wp, j), (s - 1, j))
                else:
                    top, ftop = scratch.get(j, (s - 1, j))
                t = t_c[:, j]
                up, f, dg = top, ftop, wp.diag0
                word = np.zeros(pairs, np.int64)
                word2 = np.zeros(pairs, np.int64)
                column = []
                for r in range(ROWS):
                    i = i0 + r + 1
                    left = wp.h[r]
                    diag = dg + sm[wp.letters[r], t]
                    if affine:
                        e_ext, e_open = wp.e[r] - ge, left - gap
                        f_ext, f_open = f - ge, up - gap
                        wp.e[r] = np.maximum(e_ext, e_open)
                        f = np.maximum(f_ext, f_open)
                        gap_best = np.maximum(wp.e[r], f)
                        is_left = wp.e[r] >= f
                        word2 |= (((e_ext > e_open).astype(np.int64)
                                   | ((f_ext > f_open).astype(np.int64)
                                      << 1)) << (2 * r))
                    else:
                        gap_best = np.maximum(up, left) - gap
                        is_left = left >= up
                    best = np.maximum(diag, gap_best)
                    cur = np.maximum(best, 0) if local else best
                    d = np.where(diag > gap_best, 1, np.where(is_left, 0, 2))
                    if local:
                        d = np.where(best <= 0, 3, d)
                    word |= d << (2 * r)
                    if cell16 and not with_dirs and not local:
                        track_packed(wp, cur, i, j, n, m)
                    column.append(cur)
                    wp.h[r] = cur
                    dg = left
                    up = cur
                wp.diag0 = top
                if local:
                    track_column(wp, np.stack(column), i0, j, n, m)
                elif not (cell16 and not with_dirs):
                    track_row_m(wp, np.stack(column), i0, j, n, m)
                if to_next and w + 1 < warps:
                    rings[w].put(ring_at(wp, j), (s, j), up, f)
                elif to_next:
                    scratch.put(j, (s, j), up, f)
                if with_dirs:
                    planes[0, s, j, lanes] = word
                    planes[1, s, j, lanes] = word2
            wp.g += 1
            wp.q += 1
            progress[w] = wp.g
            if wp.q == nblocks:
                wp.s, wp.q = wp.s + warps, 0

        def track_packed(wp, cur, i, j, n, m):
            # K3-cell16's packed score-only trackers, semi and global,
            # cell by cell: a masked cell counts NEG_16 (semi) or leaves
            # the tracker (global).
            if semi:
                wp.acc = np.maximum(
                    wp.acc, np.where((i == m) & (j < n), cur, neg_acc))
            else:
                wp.acc = np.where((i == m) & (j == n - 1), cur, wp.acc)

        def track_row_m(wp, column, i0, j, n, m):
            # Semi's and global's trackers over a column: H in row m, when
            # the stripe holds it.
            row = m - i0 - 1
            held = (row >= 0) & (row < ROWS)
            hm = column[np.clip(row, 0, ROWS - 1), np.arange(row.size)]
            if semi:
                better = held & (j < n) & (hm > wp.acc)
                wp.acc = np.where(better, hm, wp.acc)
                if with_dirs:
                    wp.bi = np.where(better, m, wp.bi)
                    wp.bj = np.where(better, j + 1, wp.bj)
            else:
                wp.acc = np.where(held & (j == n - 1), hm, wp.acc)

        def track_column(wp, column, i0, j, n, m):
            # Local's tracker over a column of the stripe (16 rows x
            # pairs): the largest H of the tracked cells (H >= 0, so -1
            # tracks nothing), then with words its first row, which
            # beats the tracker when larger, or equal in an earlier row.
            ok = np.clip(m - i0, 0, ROWS)
            rows = np.arange(ROWS)[:, None]
            mine = rows < ok
            cmax = np.where(mine, column, -1).max(axis=0)
            cmax = np.where((j < n) & (ok > 0), cmax, -1)
            if not with_dirs:
                wp.acc = np.maximum(wp.acc, cmax)
                return
            i = i0 + 1 + np.argmax(mine & (column == cmax), axis=0)
            better = ((cmax >= 0) & (cmax >= wp.acc)
                      & ((cmax > wp.acc) | (i < wp.bi)))
            wp.acc = np.where(better, cmax, wp.acc)
            wp.bi = np.where(better, i, wp.bi)
            wp.bj = np.where(better, j + 1, wp.bj)

        while True:
            ready = [wp for wp in team if can_run(wp)]
            if not ready:
                break
            if order == "ahead":
                run_block(ready[0])
            else:
                for wp in ready:
                    if can_run(wp):
                        run_block(wp)
        assert all(wp.s >= stripes for wp in team) or nblocks == 0, \
            "no warp can run: the schedule is stuck"
        # The CTA's merge: the largest value, then the smallest row.
        acc, bi, bj = team[0].acc, team[0].bi, team[0].bj
        for wp in team[1:]:
            beats = (wp.acc > acc) | ((wp.acc == acc) & (wp.bi < bi))
            acc = np.where(beats, wp.acc, acc)
            bi = np.where(beats, wp.bi, bi)
            bj = np.where(beats, wp.bj, bj)
        scores[lanes] = np.maximum(acc, 0) if local else acc
        best_is[lanes], best_js[lanes] = bi, bj

    if not with_dirs:
        return scores[:b], None, None, None, None
    tiles = b // TILE

    def layout(plane):  # int32 words, as the kernels store them
        plane = plane.astype(np.uint32).view(np.int32)
        return (plane.reshape(num_w, n_cols, tiles, TILE)
                .transpose(2, 0, 1, 3)
                .reshape(tiles, num_w, n_cols, TILE // 128, 128))

    return (scores[:b], best_is[:b], best_js[:b], layout(planes[0]),
            layout(planes[1]) if affine else None)


def make_batch(rng, b, n, m, ties=False):
    k = 2 if ties else 4
    texts = rng.integers(0, k, (b, n))
    patterns = rng.integers(0, k, (b, m))
    ns = rng.integers(1, n + 1, b)
    ms = rng.integers(1, m + 1, b)
    ns[-b // 8:] = 0
    ms[-b // 8:] = 0
    return [np.asarray(x, dtype=np.int32) for x in (texts, patterns, ns, ms)]


def plain(batch, sm, gap, mode, with_dirs, gap_extend, cell16):
    args = [torch.from_numpy(np.ascontiguousarray(x)) for x in (*batch, sm)]
    kw = dict(gap_extend=gap_extend, cell16=cell16, **MODES[mode])
    if not with_dirs:
        return (batch_fill.batch_score_plain(*args, gap, sm.shape[0], **kw),
                None, None, None, None)
    out = batch_fill.batch_fill_dirs_plain(*args, gap, sm.shape[0],
                                           tile_pairs=TILE, **kw)
    return tuple(out) + (None,) * (5 - len(out))


def assert_same(got, want):
    for name, g, w in zip(("scores", "best_is", "best_js", "dirs", "dirs2"),
                          got, want):
        if w is None:
            assert g is None, name
            continue
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)


def case(seed, with_dirs, ties=False):
    """A ragged batch with padding pairs: with words 128 pairs (a tile) of
    7 stripes x 40 columns (past a ring's 32); score-only an odd batch of
    127 pairs, 109 pattern rows (not a multiple of 16) x 45 columns."""
    rng = np.random.default_rng(seed)
    if with_dirs:
        return make_batch(rng, TILE, 40, 7 * ROWS, ties)
    return make_batch(rng, 127, 45, 109, ties)


@pytest.mark.parametrize("shape", [WRAPS, NO_WRAP], ids=["wraps", "no-wrap"])
@pytest.mark.parametrize("cell16", [False, True], ids=["int32", "int16"])
@pytest.mark.parametrize("affine", [False, True], ids=["linear", "affine"])
@pytest.mark.parametrize("with_dirs", [False, True], ids=["score", "dirs"])
@pytest.mark.parametrize("mode", list(MODES))
def test_chain_matches_plain(mode, with_dirs, affine, cell16, shape):
    batch = case(700 + 4 * with_dirs + 2 * affine + cell16 + len(mode),
                 with_dirs)
    gap, ext = (8, 2) if affine else (5, None)
    got = chain_fill(*batch, DNA_5_4, gap, mode, with_dirs, ext, cell16,
                     *shape)
    assert_same(got, plain(batch, DNA_5_4, gap, mode, with_dirs, ext,
                           cell16))


@pytest.mark.parametrize("cell16", [False, True], ids=["int32", "int16"])
@pytest.mark.parametrize("mode", ["local", "semi"])
def test_chain_ties_across_stripes(mode, cell16):
    # Two letters and matches 2, mismatches -1: the best value recurs in
    # many rows of several stripes and warps; the first in row-major
    # order wins, as on the TPU.
    sm = np.where(np.eye(4, dtype=bool), 2, -1).astype(np.int32)
    batch = case(720 + cell16 + len(mode), True, ties=True)
    got = chain_fill(*batch, sm, 1, mode, True, None, cell16, *WRAPS)
    assert_same(got, plain(batch, sm, 1, mode, True, None, cell16))
    rows = got[1][got[0] > 0]
    assert len(set(rows // ROWS)) > 1, "every best cell in one stripe"


def test_chain_m_and_n_mid_stripe():
    # Every real pair ends mid-stripe and mid-block, global and semi's
    # tracked cells then lie inside one warp's stripe.
    rng = np.random.default_rng(730)
    texts, patterns, ns, ms = make_batch(rng, TILE, 40, 7 * ROWS)
    ns[:-16] = rng.choice([5, 13, 35], TILE - 16)
    ms[:-16] = rng.choice([7, 41, 90], TILE - 16)
    batch = (texts, patterns, ns, ms)
    for mode in MODES:
        got = chain_fill(*batch, DNA_5_4, 5, mode, True, None, False, *WRAPS)
        assert_same(got, plain(batch, DNA_5_4, 5, mode, True, None, False))


def test_chain_any_order_and_its_detector():
    # Warp 0 running as far ahead as the counts let it gives the same
    # outputs; without the wait for a free ring block it overwrites a
    # block the next warp has not read, and the model says so.
    batch = case(740, True)
    want = plain(batch, DNA_5_4, 5, "local", True, None, False)
    got = chain_fill(*batch, DNA_5_4, 5, "local", True, None, False,
                     *WRAPS, order="ahead")
    assert_same(got, want)
    with pytest.raises(AssertionError, match="read"):
        chain_fill(*batch, DNA_5_4, 5, "local", True, None, False, *WRAPS,
                   order="ahead", slot_wait=False)


def test_chain_matches_jax_interpret():
    # The JAX kernel itself, as tests/test_torch_batch_fill.py runs it:
    # every word, score and best cell of the real pairs.
    rng = np.random.default_rng(750)
    texts, patterns, ns, ms = make_batch(rng, TILE, 40, 3 * ROWS)
    sm = score_matrix(4)
    ref = [np.asarray(x) for x in batch_fill_dirs_pallas(
        texts, patterns, ns, ms, sm, 3, k_alpha=4, tile_pairs=TILE,
        interpret=True, local=True)[:4]]
    got = chain_fill(texts, patterns, ns, ms, sm, 3, "local", True, None,
                     False, *WRAPS)
    real = ns > 0
    for g, r in zip(got[:3], ref[:3]):
        np.testing.assert_array_equal(g[real], r[real])
    np.testing.assert_array_equal(got[3], ref[3])
