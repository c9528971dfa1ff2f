"""A CPU model of K1's band schedule (``csrc/wavefront.cu``) against the
plain version of the whole strip and the JAX kernel.

The kernel runs a strip as a chain of bands: band b is one warp that
owns the 32/split slots [b*32/split, (b+1)*32/split), each slot's rps
rows split over ``split`` lanes, lane g running step t at iteration
t + d(g) and taking the last row of the lane above from that lane's
previous iteration; the band's last lane streams its last row (and F)
out after every step, and the next band's lane 0 reads the value after
step t-1 at step t.  ``band_fill`` runs that schedule lane for lane in
numpy, band after band, each fed the upper band's stream, and stacks
the bands' outputs; the tests hold it equal to ``wavefront_strip_plain``
of the whole strip in every output, and once to the JAX kernel in
interpret mode.  Every value is an integer: the tolerance is exact.
"""

import numpy as np
import pytest
import torch

from seqalign_torch.ops import layout
from seqalign_torch.ops import wavefront as port_wf
from seqalign_tpu.ops import wavefront as jax_wf

from .torch_support import one_torch_thread, score_matrix  # noqa: F401

WARP = 32
NEG_INF = port_wf.NEG_INF
NEG_HALF = port_wf.NEG_HALF


def band_plan(slots, split):
    """[(s0, s1)] of the bands of a strip: 32/split slots each."""
    spb = WARP // split
    return [(s0, s0 + spb) for s0 in range(0, slots, spb)]


def band_fill(text, bottom, pattern, sm, gap, n, m, i0, k, rps, slots,
              split, block=1, local=False, semi=False, ckpt_every=0,
              left_in=None, affine=False, ext=0, fbot=None, left_e=None):
    """K1's outputs by the band schedule at ``split`` lanes a slot and
    ``block`` steps a lane's iteration, as numpy arrays shaped as
    ``wavefront_strip_plain``'s: (dirs, stream, rowmax, argj, snap,
    ckpts[, dirs2, fstream, ckpts_e])."""
    steps = text.size
    sub = sm.reshape(-1).astype(np.int64)
    rt, spb = rps // split, WARP // split
    words = ckpt_every == 0
    track = local or semi
    dirs = np.zeros((steps // 16 * rps, slots), np.int64) if words else None
    dirs2 = np.zeros_like(dirs) if words and affine else None
    ckpts = ckpts_e = None
    if not words:
        ckpts = np.zeros((port_wf.num_checkpoints(steps, ckpt_every) * rps,
                          slots), np.int64)
        ckpts_e = np.zeros_like(ckpts) if affine else None
    rowmax = np.zeros((rps, slots), np.int64)
    argj = np.zeros((rps, slots), np.int64)
    snap = np.zeros(slots, np.int64)

    def boundary(i):
        if local:
            return np.zeros_like(i)
        if affine:
            return np.where(i == 0, 0, -(gap + (i - 1) * ext))
        return -gap * i

    def left(row, s):  # left_in entry (row, slot)
        return left_in[row, s].astype(np.int64)

    lane = np.arange(WARP)
    part = lane % split
    # Lane g runs block b at iteration b + d[g].
    d = (lane // split) * (split - 1) + part if block == 1 else lane
    shifted = (part == 0) if block > 1 else np.zeros(WARP, bool)
    r0 = part * rt
    blocks = steps // block
    iters = blocks + d[-1]
    up = up_f = None
    for band, (s0, _) in enumerate(band_plan(slots, split)):
        s = s0 + lane // split
        ibase = i0 + rps * s
        rows = r0[None, :] + np.arange(rt)[:, None]          # (rt, lanes)
        if left_in is not None:
            topsh = left(r0, s)
            H = left(rows + 1, s[None, :])
        else:
            topsh = boundary(ibase + r0)
            H = boundary(ibase[None, :] + rows + 1)
        E = (left_e[rows + 1, s[None, :]].astype(np.int64)
             if left_e is not None else np.full((rt, WARP), NEG_HALF))
        pat = pattern[rows, s[None, :]].astype(np.int64) * k
        word = np.zeros((rt, WARP), np.int64)
        word2 = np.zeros((rt, WARP), np.int64)
        best_v = np.full((rt, WARP), NEG_INF, np.int64)
        best_j = np.zeros((rt, WARP), np.int64)
        snap_v = np.full(WARP, NEG_INF, np.int64)
        # Each lane's last row (and F) after each step of its last block.
        pub = np.repeat(H[rt - 1][None, :], block, axis=0)
        pub_f = np.full((block, WARP), NEG_HALF, np.int64)
        carry, carry_f = pub[0].copy(), pub_f[0].copy()
        if band == 0:
            top0 = 0
        elif left_in is not None:
            top0 = int(left_in[rps, s0 - 1])
        else:
            top0 = int(boundary(np.int64(i0 + rps * s0)))
        out = np.zeros(steps, np.int64)
        out_f = np.zeros(steps, np.int64)
        for tau in range(iters):
            # __shfl_up_sync of each step's value: lane g gets lane g-1's.
            nb = np.concatenate([pub[:, :1], pub[:, :-1]], axis=1)
            nb_f = np.concatenate([pub_f[:, :1], pub_f[:, :-1]], axis=1)
            # A slot's first lane (block > 1) takes the step before.
            topv = np.where(shifted, np.concatenate([carry[None], nb[:-1]]),
                            nb)
            topf = np.where(shifted,
                            np.concatenate([carry_f[None], nb_f[:-1]]), nb_f)
            carry, carry_f = nb[-1].copy(), nb_f[-1].copy()
            if tau < blocks:  # lane 0: the upper band's stream
                for x in range(block):
                    t = tau * block + x
                    if band == 0:
                        topv[x, 0] = bottom[t]
                        topf[x, 0] = fbot[t] if affine else 0
                    elif t == 0:
                        topv[x, 0], topf[x, 0] = top0, NEG_HALF
                    else:
                        topv[x, 0], topf[x, 0] = up[t - 1], up_f[t - 1]
            blk = tau - d
            act = (blk >= 0) & (blk < blocks)
            if not act.any():
                continue
            for x in range(block):
                t = blk * block + x
                j = t - s + 1
                started = act & (j >= 1)
                w = np.where(t - s >= 0, text[np.clip(t - s, 0, steps - 1)],
                             0)
                top, f_above = topv[x], topf[x]
                diag_src = topsh if x == 0 else topv[x - 1]
                for rr in range(rt):
                    diag = diag_src + sub[pat[rr] + w]
                    lft = H[rr].copy()
                    if affine:
                        e_ext, e_open = E[rr] - ext, lft - gap
                        e_new = np.maximum(e_ext, e_open)
                        f_ext, f_open = f_above - ext, top - gap
                        f_new = np.maximum(f_ext, f_open)
                        gap_best = np.maximum(e_new, f_new)
                        left_wins = e_new >= f_new
                    else:
                        gap_best = np.maximum(top, lft) - gap
                        left_wins = lft >= top
                    best = np.maximum(diag, gap_best)
                    newval = np.maximum(best, 0) if local else best
                    cur = np.where(started, newval, lft)
                    if words:
                        dr = np.where(diag > gap_best, 1,
                                      np.where(left_wins, 0, 2))
                        if local:
                            dr = np.where(best <= 0, 3, dr)
                        u = t & 15
                        word[rr] = np.where(act, np.where(
                            u == 0, dr, word[rr] | (dr << (2 * u))), word[rr])
                        if affine:
                            d2 = (e_ext > e_open) | ((f_ext > f_open) << 1)
                            word2[rr] = np.where(act, np.where(
                                u == 0, d2, word2[rr] | (d2 << (2 * u))),
                                word2[rr])
                    if affine:
                        E[rr] = np.where(started, e_new, E[rr])
                        f_above = np.where(started, f_new, f_above)
                    i = ibase + r0 + rr + 1
                    if track:
                        row_ok = i <= m if local else i == m
                        better = (started & (j <= n) & row_ok
                                  & (newval > best_v[rr]))
                        best_v[rr] = np.where(better, newval, best_v[rr])
                        best_j[rr] = np.where(better, j, best_j[rr])
                    else:
                        snap_v = np.where(act & (i == m) & (j == n), newval,
                                          snap_v)
                    diag_src, top = lft, cur
                    H[rr] = np.where(act, cur, lft)
                pub[x] = np.where(act, H[rt - 1], pub[x])
                pub_f[x] = np.where(act, f_above, pub_f[x])
                if act[WARP - 1]:
                    out[t[WARP - 1]] = pub[x, WARP - 1]
                    out_f[t[WARP - 1]] = pub_f[x, WARP - 1]
                if not words:
                    hit = started & ((j & (ckpt_every - 1)) == 0)
                    for g in np.flatnonzero(hit):
                        q = j[g] // ckpt_every - 1
                        rws = q * rps + r0[g] + np.arange(rt)
                        ckpts[rws, s[g]] = H[:, g]
                        if affine:
                            ckpts_e[rws, s[g]] = E[:, g]
                else:
                    for g in np.flatnonzero(act & ((t & 15) == 15)):
                        rws = (t[g] >> 4) * rps + r0[g] + np.arange(rt)
                        dirs[rws, s[g]] = word[:, g]
                        if affine:
                            dirs2[rws, s[g]] = word2[:, g]
            topsh = np.where(act, topv[block - 1], topsh)
        up, up_f = out, out_f
        mrow = m - 1 - ibase
        owner = np.where((mrow >= 0) & (mrow < rps), mrow // rt, 0)
        mine = part == owner
        snap[s[mine]] = snap_v[mine]
        rowmax[rows, s[None, :]] = best_v if track else NEG_INF
        argj[rows, s[None, :]] = best_j if track else 0

    def i32(x):
        return None if x is None else x.astype(np.int32)

    res = (i32(dirs), i32(up), i32(rowmax), i32(argj), i32(snap), i32(ckpts))
    if affine:
        res += (i32(dirs2), i32(up_f), i32(ckpts_e))
    return res


def case(rng, k, rps, slots, n, m, mode, variant, affine):
    """Random one-strip inputs: (numpy inputs for band_fill, kwargs)."""
    local, semi = mode == "local", mode == "semi"
    gap, ext = (8, 2) if affine else (5 if k == 4 else 10, 0)
    steps = layout.steps_padded(n, slots)
    if variant == "ckpt":
        steps = max(steps, 512)  # past the first checkpoint column, 256
    text = np.zeros(steps, np.int32)
    text[:n] = rng.integers(0, k, n)
    pat = np.zeros(rps * slots, np.int32)
    pat[:m] = rng.integers(0, k, m)
    pattern = layout.pattern_slots(pat, rps, slots).reshape(rps, slots)
    kw = dict(local=local, semi=semi, affine=affine, ext=ext)
    if variant == "left":
        # An arbitrary left column: its corner row need not agree with the
        # upper slot's last row, so both reach the band's first lane.
        left = rng.integers(-60, 60, (rps + 1, slots)).astype(np.int32)
        kw["left_in"] = left
        if affine:
            kw["left_e"] = rng.integers(-80, 40, (rps + 1, slots)).astype(
                np.int32)
        bottom = rng.integers(-40, 40, steps).astype(np.int32)
        i0 = 3 * rps * slots
    else:
        bottom = layout.top_row(steps, gap, local or semi, "cpu",
                                ext=ext if affine else None).numpy()
        bottom = bottom.reshape(-1)
        i0 = 0
    if affine:
        kw["fbot"] = (rng.integers(-70, 10, steps).astype(np.int32)
                      if variant == "left"
                      else np.full(steps, NEG_HALF, np.int32))
    if variant == "ckpt":
        kw["ckpt_every"] = 256
    return (text, bottom, pattern, score_matrix(k), gap, n, m + i0, i0, k,
            rps, slots), kw


def plain(args, kw):
    """``wavefront_strip_plain`` of the whole strip on the same inputs."""
    text, bottom, pattern, sm, gap, n, m, i0, k, rps, slots = args

    def tensor(x, *shape):
        return torch.from_numpy(np.ascontiguousarray(x, np.int32)).reshape(
            shape)

    kw = dict(kw)
    ckpt_every = kw.pop("ckpt_every", 0)
    fbot = kw.pop("fbot", None)
    if fbot is not None:
        kw["fbot_in"] = tensor(fbot, -1, layout.STEPS)
    for name in ("left_in", "left_e"):
        if kw.get(name) is not None:
            kw[name] = tensor(kw[name], rps + 1, slots // 128, 128)
    out = port_wf.wavefront_strip_plain(
        tensor(text, -1, layout.STEPS), tensor(bottom, -1, layout.STEPS),
        tensor(pattern, rps, slots // 128, 128), tensor(sm, k, k), gap, n,
        m, i0, k, rps=rps, slots=slots, with_dirs=not ckpt_every,
        ckpt_every=ckpt_every, **kw)
    return [None if x is None else x.numpy() for x in out]


def assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_array_equal(g.reshape(-1), w.reshape(-1))


# (rps, split, block): rows a slot, lanes a slot's rows are split over,
# steps a lane runs an iteration.
GEOMETRIES = [(1, 1, 1), (4, 2, 2), (16, 4, 4)]


@pytest.mark.parametrize("rps,split,block", GEOMETRIES)
@pytest.mark.parametrize("variant", ["words", "ckpt", "left"])
@pytest.mark.parametrize("affine", [False, True])
@pytest.mark.parametrize("mode", ["global", "local", "semi"])
def test_bands_match_whole_strip(mode, affine, variant, rps, split, block):
    slots = 128
    k = 4 if (rps + len(mode)) % 2 else 23
    rng = np.random.default_rng(rps * 100 + split * 10 + block
                                + len(mode) + 7 * affine)
    n = 100 if variant != "ckpt" else 300
    m = rps * slots - rps // 2 - 1   # row m inside a slot, not its last
    args, kw = case(rng, k, rps, slots, n, m, mode, variant, affine)
    assert_same(band_fill(*args, split=split, block=block, **kw),
                plain(args, kw))


@pytest.mark.parametrize("rps,split,block", [
    (4, 1, 4), (4, 4, 1), (16, 1, 4), (16, 2, 1), (8, 2, 4), (2, 2, 2),
    (16, 4, 1), (1, 1, 4)])
def test_other_shapes_match_whole_strip(rps, split, block):
    """Other shapes the kernel may take, affine with words and left
    columns (the variant with the most state)."""
    rng = np.random.default_rng(rps + split + block)
    args, kw = case(rng, 4, rps, 128, 90, rps * 128 - 2, "local", "left",
                    True)
    assert_same(band_fill(*args, split=split, block=block, **kw),
                plain(args, kw))


def test_bands_match_jax_kernel():
    """One case against the JAX kernel in interpret mode: semi-global,
    rps 4 split over 2 lanes, 8 bands of 16 slots, 4 steps an
    iteration."""
    rng = np.random.default_rng(77)
    k, rps, slots, n = 23, 4, 128, 110
    m = rps * slots - 3
    args, kw = case(rng, k, rps, slots, n, m, "semi", "words", False)
    text, bottom, pattern, sm, gap = args[:5]
    got = band_fill(*args, split=2, block=4, **kw)
    ref = jax_wf.wavefront_strip(
        text.reshape(-1, layout.STEPS), bottom.reshape(-1, layout.STEPS),
        pattern.reshape(rps, slots // 128, 128), sm, gap, n, m, 0,
        k_alpha=k, local=False, with_dirs=True, rps=rps, slots=slots,
        semi=True, interpret=True)
    r_dirs, r_stream, r_rowmax, r_argj = (np.asarray(x) for x in ref[:4])
    np.testing.assert_array_equal(got[0].reshape(-1), r_dirs.reshape(-1))
    np.testing.assert_array_equal(got[1].reshape(-1), r_stream.reshape(-1))
    np.testing.assert_array_equal(got[2].reshape(-1), r_rowmax.reshape(-1))
    np.testing.assert_array_equal(got[3].reshape(-1), r_argj.reshape(-1))


@pytest.mark.parametrize("split", [1, 2, 4])
def test_every_slot_in_one_band(split):
    """Every geometry ``_check`` admits: the bands own each slot once, and
    the kernel's grid (one CTA of ``split`` bands for each 32 slots)
    covers them."""
    for slots in [*range(128, 1025, 128), 2048, 4096]:
        plans = band_plan(slots, split)
        owned = np.concatenate([np.arange(a, b) for a, b in plans])
        np.testing.assert_array_equal(owned, np.arange(slots))
        assert len(plans) == (slots // WARP) * split
