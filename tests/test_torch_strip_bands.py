"""A CPU model of K5's band schedule (``csrc/strip.cu``) against the plain
version of the whole region and the JAX kernel.

The kernel runs a region as a chain of bands: band b is one warp that
owns the 32*rpl rows [32 rpl b, 32 rpl (b+1)), lane g owning rpl of them
and running columns block by block (``block`` columns, block q at
iteration q + g), taking the last row of the lane above from that lane's
previous iteration; the band's last lane streams its last row out after
every column, and the next band's lane 0 reads it at the same column.
The words are built a byte at a time: a lane's rows of a column are
2*rpl bits of one byte, the 4/rpl lanes of a byte hand their bits down
like their rows and the last of them stores the byte.  ``band_fill``
runs that schedule lane for lane in numpy, band after band, each fed the
upper band's stream, assembles the words from the stored bytes, and
merges each band's local candidate as the last CTA does.  The tests
hold it equal to ``strip_fill_plain`` of the whole region in every
output, and once to the JAX kernel in interpret mode.  Every value is
an integer: the tolerance is exact.
"""

import numpy as np
import pytest
import torch

from seqalign_torch.ops import strip_fill
from seqalign_tpu.ops import pallas_fill

from .torch_support import one_torch_thread, score_matrix  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _fresh_caches():
    # This file compiles an interpret-mode strip program, which has hit an
    # XLA:CPU compile segfault late in a long run (see tests/test_tiled.py).
    import jax

    jax.clear_caches()


WARP = 32
NEG_INF = strip_fill.NEG_INF
PAD = strip_fill.PAD_SCORE


def band_plan(rows, rpl):
    """[(r0, r1)] of the bands of a region: 32*rpl rows each."""
    per = WARP * rpl
    return [(r0, r0 + per) for r0 in range(0, rows, per)]


def band_fill(letters, sm, pattern, gap, n, m, row_base, strip_off,
              left_col, prev_in, state, local, with_dirs, rpl, block):
    """K5's outputs by the band schedule at ``rpl`` rows a lane and
    ``block`` columns a lane's iteration, as numpy arrays shaped as
    ``strip_fill_plain``'s: (words or None, prev_out, rcol, state)."""
    w, rows = letters.size, pattern.size
    k = sm.shape[0]
    sub = np.concatenate([sm, np.full((k, 1), PAD)], axis=1).reshape(-1)
    sub = sub.astype(np.int64)
    left_col = left_col.astype(np.int64)
    group = 4 // rpl                     # lanes whose rows share a byte
    blocks = w // block
    climit = n - strip_off               # columns c < climit are <= n
    lane = np.arange(WARP)
    wbytes = np.zeros((rows // 16, w, 4), np.uint8) if with_dirs else None
    rcol = np.zeros(rows, np.int64)
    up = prev_in.astype(np.int64)        # band 0's row above
    cands, snap = [], None
    for band, (b0, _) in enumerate(band_plan(rows, rpl)):
        r0 = b0 + lane * rpl                                # (lanes,)
        rws = r0[None, :] + np.arange(rpl)[:, None]         # (rpl, lanes)
        H = left_col[rws + 1]
        pat = pattern[rws].astype(np.int64) * (k + 1)
        best_v = np.full((rpl, WARP), NEG_INF, np.int64)
        best_c = np.zeros((rpl, WARP), np.int64)
        topsh = left_col[r0]
        snap_rr = m - 1 - row_base - r0
        snap_mine = ((not local) & (snap_rr >= 0) & (snap_rr < rpl)
                     & (1 <= climit <= w))
        snap_v = np.zeros(WARP, np.int64)
        pub = np.zeros((block, WARP), np.int64)
        pbits = np.zeros((block, WARP), np.int64)   # a byte a column
        bshift = 2 * (r0 & 3)
        out = np.zeros(w, np.int64)
        for tau in range(blocks + WARP - 1):
            # __shfl_up_sync: lane g gets lane g-1's, lane 0 its own.
            topv = np.concatenate([pub[:, :1], pub[:, :-1]], axis=1)
            above = np.concatenate([pbits[:, :1], pbits[:, :-1]], axis=1)
            if tau < blocks:  # lane 0: the upper band's stream
                topv[:, 0] = up[tau * block:(tau + 1) * block]
            blk = tau - lane
            act = (blk >= 0) & (blk < blocks)
            if not act.any():
                continue
            bits = np.zeros((block, WARP), np.int64)
            for x in range(block):
                c = blk * block + x
                cc = np.clip(c, 0, w - 1)
                let = np.where(cc < climit, letters[cc], k)
                top = topv[x]
                diag_src = topsh if x == 0 else topv[x - 1]
                for rr in range(rpl):
                    diag = diag_src + sub[pat[rr] + let]
                    left = H[rr].copy()
                    gap_best = np.maximum(top, left) - gap
                    best = np.maximum(diag, gap_best)
                    cell = np.maximum(best, 0) if local else best
                    if with_dirs:
                        d = np.where(diag > gap_best, 1,
                                     np.where(left >= top, 0, 2))
                        if local:
                            d = np.where(best <= 0, 3, d)
                        bits[x] |= d << (2 * rr)
                    if local:
                        better = act & (c < climit) & (cell > best_v[rr])
                        best_v[rr] = np.where(better, cell, best_v[rr])
                        best_c[rr] = np.where(better, c, best_c[rr])
                    diag_src, top = left, cell
                    H[rr] = np.where(act, cell, left)
                if not local:
                    hit = act & snap_mine & (c == climit - 1)
                    for rr in range(rpl):
                        snap_v = np.where(hit & (snap_rr == rr), H[rr],
                                          snap_v)
                pub[x] = np.where(act, H[rpl - 1], pub[x])
                if act[WARP - 1]:
                    out[c[WARP - 1]] = pub[x, WARP - 1]
            topsh = np.where(act, topv[block - 1], topsh)
            if with_dirs:
                bits <<= bshift[None, :]
                if group > 1:
                    bits = np.where(lane % group != 0, bits | above, bits)
                pbits = np.where(act, bits, pbits)
                for g in np.flatnonzero(act & (lane % group == group - 1)):
                    cols = blk[g] * block + np.arange(block)
                    wbytes[r0[g] >> 4, cols, (r0[g] & 15) >> 2] = bits[:, g]
        rcol[rws] = H
        # The band's candidate: each lane's best row (larger value, then
        # smaller row), then the warp's.
        if local:
            lane_best = []
            for g in range(WARP):
                key = None
                for rr in range(rpl):
                    i = row_base + r0[g] + rr + 1
                    kk = (int(best_v[rr, g]), -i,
                          strip_off + int(best_c[rr, g]) + 1)
                    if i <= m and (key is None or kk[:2] > key[:2]):
                        key = kk
                if key is not None:
                    lane_best.append(key)
            if lane_best:
                cands.append(max(lane_best, key=lambda t: t[:2]))
        elif snap_mine.any():
            snap = int(snap_v[np.flatnonzero(snap_mine)[0]])
        up = out
    # The last CTA's merge.
    state_out = np.asarray(state, np.int64).copy()
    if local and cands:
        value, neg_i, j = max(cands, key=lambda t: t[:2])
        if value > state[0]:
            state_out[:3] = value, -neg_i, j
    if not local and snap is not None:
        state_out[3] = max(int(state[3]), snap)
    words = wbytes.view("<i4")[..., 0] if with_dirs else None
    return (words, up.astype(np.int32), rcol.astype(np.int32),
            state_out.astype(np.int32))


def region(rng, k, w, rows, where, local):
    """Random region inputs: (letters, sm, pattern, gap, n, m, row_base,
    strip_off, left_col, prev_in, state).  ``first``: row 0 and column 0,
    n and m inside the region off every block and band edge; ``interior``:
    row_base, strip_off > 0, boundaries a few gaps apart below a carried
    best, m inside the region, the strip before column n."""
    gap = 5 if k == 4 else 10
    pattern = rng.integers(0, k, rows).astype(np.int32)
    if where == "first":
        row_base, strip_off = 0, 0
        n, m = w - 37, rows - 45
        left = strip_fill.nw_boundary_col(0, rows, gap, local)
        prev = strip_fill.init_prev_row(w, 0, gap, local)
        state = strip_fill.zeros_state()
    else:
        row_base, strip_off = 3 * rows, 2 * w
        n, m = strip_off + w + 500, row_base + rows - 71
        left = (np.cumsum(rng.integers(-gap, gap + 1, rows + 1))
                - gap * row_base // 4).astype(np.int32)
        prev = (np.cumsum(rng.integers(-gap, gap + 1, w))
                - gap * row_base // 4).astype(np.int32)
        if local:
            left, prev = np.maximum(left, 0), np.maximum(prev, 0)
        state = np.array([9, row_base - 3, strip_off - 5, NEG_INF], np.int32)
    pattern[m - row_base:] = 0
    text = rng.integers(0, k, w).astype(np.int32)
    letters = strip_fill.strip_letters(text, 0, w)
    return (letters, score_matrix(k), pattern, gap, n, m, row_base,
            strip_off, left, prev, state)


def plain(args, local, with_dirs):
    """``strip_fill_plain`` of the whole region on the same inputs."""
    letters, sm, pattern, gap, n, m, row_base, strip_off, left, prev, \
        state = args
    out = strip_fill.strip_fill_plain(
        *(torch.from_numpy(np.ascontiguousarray(x, np.int32))
          for x in (letters, sm, pattern)), gap, n, m, row_base, strip_off,
        *(torch.from_numpy(np.ascontiguousarray(x, np.int32))
          for x in (left, prev, state)), local=local, with_dirs=with_dirs)
    return [None if x is None else x.numpy() for x in out]


def assert_same(got, want):
    assert len(got) == len(want) == 4
    for g, x in zip(got, want):
        assert (g is None) == (x is None)
        if g is not None:
            np.testing.assert_array_equal(g, x)


# (rows a lane, columns an iteration).
GEOMETRIES = [(1, 4), (2, 4), (4, 4), (2, 8), (4, 8), (2, 2), (4, 1)]


@pytest.mark.parametrize("rpl,block", GEOMETRIES)
@pytest.mark.parametrize("with_dirs", [True, False], ids=["words", "score"])
@pytest.mark.parametrize("where", ["first", "interior"])
@pytest.mark.parametrize("mode", ["global", "local"])
def test_bands_match_whole_region(mode, where, with_dirs, rpl, block):
    local = mode == "local"
    k = 4 if (rpl + block + len(where)) % 2 else 23
    rng = np.random.default_rng(100 * rpl + 10 * block + 2 * local
                                + with_dirs + len(where))
    args = region(rng, k, 1024, 256, where, local)
    want = plain(args, local, with_dirs)
    assert_same(band_fill(*args, local=local, with_dirs=with_dirs, rpl=rpl,
                          block=block), want)
    if where == "first" and not local:
        assert want[3][3] > NEG_INF      # S[m, n] seen mid-lane, mid-band
    if where == "first" and local:
        assert want[3][0] > 0 and want[3][1] <= args[5]


def tie_region(r1, r2, rows=256, w=1024):
    """Local, every substitution -1, prev_in 0 and the left column 0 but
    for a large value V at rows r1 and r2 (region rows, 0-based): each row
    below one of them has its maximum V - 1 at the strip's first column,
    the largest of the region, so rows r1+1 and r2+1 tie."""
    sm = np.full((4, 4), -1, np.int32)
    left = np.zeros(rows + 1, np.int32)
    left[[r1 + 1, r2 + 1]] = 1000
    letters = np.zeros(w, np.int32)
    pattern = np.zeros(rows, np.int32)
    return (letters, sm, pattern, 3, w, rows, 0, 0, left,
            np.zeros(w, np.int32), strip_fill.zeros_state())


@pytest.mark.parametrize("rpl,block", [(1, 4), (4, 4)])
def test_row_maximum_tie_across_bands(rpl, block):
    # Rows r1+1 (band 0) and r2+1 (band 1) both reach V - 1: the earlier
    # row wins, in the band's reduction and in the last CTA's merge.
    per = WARP * rpl
    r1, r2 = per // 2 + 1, per + per // 3
    args = tie_region(r1, r2)
    want = plain(args, True, True)
    assert tuple(want[3][:3]) == (999, r1 + 2, 1)
    alone = plain(tie_region(r2, r2), True, True)
    assert tuple(alone[3][:3]) == (999, r2 + 2, 1)   # the tie is real
    assert_same(band_fill(*args, local=True, with_dirs=True, rpl=rpl,
                          block=block), want)


@pytest.mark.parametrize("rpl,block", [(2, 4), (1, 2)])
def test_row_maximum_tie_within_a_row(rpl, block):
    # The row above (prev_in) holds U at columns c1 < c2 (0-based): the
    # region's first row reaches U - 1 at both c1 + 1 and c2 + 1; the
    # first column wins.
    w, rows = 1024, 128
    c1, c2 = 301, 702
    prev = np.zeros(w, np.int32)
    prev[[c1, c2]] = 500
    args = (np.zeros(w, np.int32), np.full((4, 4), -1, np.int32),
            np.zeros(rows, np.int32), 3, w, rows, 0, 0,
            np.zeros(rows + 1, np.int32), prev, strip_fill.zeros_state())
    want = plain(args, True, True)
    assert tuple(want[3][:3]) == (499, 1, c1 + 2)
    assert_same(band_fill(*args, local=True, with_dirs=True, rpl=rpl,
                          block=block), want)


@pytest.mark.parametrize("case", ["no-improvement", "past-m", "past-n"])
def test_carried_state_stands(case):
    # A carried best no row beats keeps its (i, j); rows past m and a
    # strip wholly past n never move it.
    rng = np.random.default_rng(50)
    args = list(region(rng, 4, 1024, 256, "interior", True))
    state = args[-1]
    if case == "no-improvement":
        state[0] = 10 ** 6
    elif case == "past-m":
        args[5] = args[6]          # m = row_base
    else:
        args[4] = args[7]          # n = strip_off
    want = plain(args, True, False)
    np.testing.assert_array_equal(want[3], state)
    assert_same(band_fill(*args, local=True, with_dirs=False, rpl=2,
                          block=4), want)


def test_bands_match_jax_kernel():
    """One case against the JAX kernel in interpret mode: local, an
    interior region, 2 rows a lane (4 bands of 64 rows), 4 columns an
    iteration, with words."""
    rng = np.random.default_rng(77)
    k, w, rows = 23, 1024, 256
    letters, sm, pattern, gap, n, m, row_base, strip_off, left, prev, \
        state = region(rng, k, w, rows, "interior", True)
    n = strip_off + 900            # the strip holds column n
    text = np.zeros(strip_off + w, np.int32)
    text[strip_off:] = letters
    prof = np.full((k, w), pallas_fill.PAD_SCORE, np.int32)
    prof[:, :n - strip_off] = sm[:, letters[:n - strip_off]]
    ref = pallas_fill.strip_fill_pallas(
        prof.reshape(k, 8, w // 8), pattern, gap, n, m, row_base, strip_off,
        left, prev.reshape(8, w // 8), state.reshape(1, 4), local=True,
        with_dirs=True, interpret=True)
    want = strip_fill.from_reference_outputs(*ref, with_dirs=True)
    got = band_fill(letters, sm, pattern, gap, n, m, row_base, strip_off,
                    left, prev, state, local=True, with_dirs=True, rpl=2,
                    block=4)
    assert_same(got, want)


@pytest.mark.parametrize("rpl", [1, 2, 4])
def test_every_row_in_one_band(rpl):
    """Every region ``_check`` admits (rows a multiple of 128 up to
    16,384): the bands own each row once, one CTA a band, at most the
    kernel's 512 bands; each word's 16 rows are 4 bytes of lanes of one
    band."""
    for rows in range(128, strip_fill.MAX_CHUNK_ROWS + 1, 128):
        plans = band_plan(rows, rpl)
        owned = np.concatenate([np.arange(a, b) for a, b in plans])
        np.testing.assert_array_equal(owned, np.arange(rows))
        assert len(plans) == rows // (WARP * rpl) <= 512
        assert all(a % 16 == 0 for a, _ in plans)
