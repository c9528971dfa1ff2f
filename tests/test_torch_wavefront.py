"""The port's K1 (seqalign_torch.ops.wavefront) against the JAX kernel in
interpreter mode and against the oracle.  All values are integers, so
every comparison is exact (tolerance 0)."""

import numpy as np
import pytest
import torch

from seqalign_torch.native import bindings as port_bindings
from seqalign_torch.ops import layout
from seqalign_torch.ops import wavefront as port_wf
from seqalign_torch.probes import dpx16, wavefront_shapes
from seqalign_tpu.native import bindings as jax_bindings
from seqalign_tpu.ops import wavefront as jax_wf

from .torch_support import one_torch_thread, score_matrix  # noqa: F401

SLOTS = 1024


def strip_inputs(rng, n, m, k, rps, gap, local, semi):
    """One strip's inputs, as the JAX wrapper takes them (numpy)."""
    text = rng.integers(0, k, n).astype(np.int32)
    pattern = rng.integers(0, k, m).astype(np.int32)
    steps_pad = layout.steps_padded(n, SLOTS)
    pat_pad = np.zeros(rps * SLOTS, dtype=np.int32)
    pat_pad[:m] = pattern
    if local or semi:
        bottom = np.zeros(steps_pad, dtype=np.int32)
    else:
        bottom = (-gap * (np.arange(steps_pad) + 1)).astype(np.int32)
    return (layout.text_steps(text, steps_pad),
            bottom.reshape(-1, layout.STEPS),
            layout.pattern_slots(pat_pad, rps, SLOTS))


@pytest.mark.parametrize("rps,k", [(1, 4), (1, 23), (4, 4), (4, 23)])
@pytest.mark.parametrize("mode", ["global", "local", "semi"])
def test_strip_plain_matches_jax_kernel(mode, rps, k):
    local, semi = mode == "local", mode == "semi"
    rng = np.random.default_rng(100 + rps * 7 + k)
    n, gap = 300, 4
    m = rps * SLOTS - 3  # not a multiple of rps
    ts, bot, pat = strip_inputs(rng, n, m, k, rps, gap, local, semi)
    sm = score_matrix(k)

    ref = jax_wf.wavefront_strip(
        ts, bot, pat, sm, gap, n, m, 0, k_alpha=k, local=local,
        with_dirs=True, rps=rps, slots=SLOTS, semi=semi, interpret=True,
    )
    r_dirs, r_stream, r_rowmax, r_argj, r_snap, _ = (
        np.asarray(x) for x in ref
    )
    args = layout.from_reference_arrays(ts, bot, pat, sm, k, "cpu")
    dirs, stream, rowmax, argj, snap, ckpts = port_wf.wavefront_strip_plain(
        *args, gap, n, m, 0, k, local=local, rps=rps, slots=SLOTS,
        semi=semi,
    )
    assert ckpts is None
    dirs, stream, rowmax, argj, snap = (
        x.numpy() for x in (dirs, stream, rowmax, argj, snap))
    # Every word, readable by a walker or not, and the top-row stream.
    np.testing.assert_array_equal(dirs, r_dirs)
    np.testing.assert_array_equal(stream, r_stream)
    if local or semi:
        np.testing.assert_array_equal(rowmax, r_rowmax)
        np.testing.assert_array_equal(argj, r_argj)
    else:
        np.testing.assert_array_equal(snap, r_snap)


@pytest.mark.parametrize("local", [False, True])
def test_fill_two_strips_matches_jax_and_oracle(local):
    rng = np.random.default_rng(7)
    sm = score_matrix(4)
    n, m, gap = 700, 1100, 5  # two 1024-row strips at rps 1
    text = rng.integers(0, 4, n).astype(np.int32)
    pattern = rng.integers(0, 4, m).astype(np.int32)

    got = port_wf.wavefront_fill(text, pattern, sm, 4, gap, local=local,
                                 rps=1, slots=SLOTS, device="cpu")
    ref = jax_wf.wavefront_fill(text, pattern, sm, 4, gap, local=local,
                                with_dirs=True, rps=1, slots=SLOTS,
                                interpret=True)
    assert got[:3] == ref[:3]
    assert got[4] == ref[4]
    np.testing.assert_array_equal(got[3], ref[3])

    # The port's words through the port's native walker == the oracle.
    score, bi, bj, words, steps_pad = got
    at, ap, st, sp = port_bindings.traceback_skewed(
        1 if local else 0, words, steps_pad, text, pattern, 4,
        best_i=bi, best_j=bj, rps=1, slots=SLOTS,
    )
    oat, oap, ost, osp, oscore = jax_bindings.oracle_align(
        1 if local else 0, text, pattern, sm, 4, gap,
    )
    assert score == oscore
    np.testing.assert_array_equal(at, oat)
    np.testing.assert_array_equal(ap, oap)
    assert (st, sp) == (ost, osp)


def test_wrapper_runs_plain_version_on_cpu():
    rng = np.random.default_rng(3)
    ts, bot, pat = strip_inputs(rng, 200, 500, 4, 1, 5, False, False)
    args = layout.from_reference_arrays(ts, bot, pat, score_matrix(4), 4,
                                        "cpu")
    before = port_wf.wavefront_strip.launches
    out = port_wf.wavefront_strip(*args, 5, 200, 500, 0, 4, rps=1,
                                  slots=SLOTS)
    plain = port_wf.wavefront_strip_plain(*args, 5, 200, 500, 0, 4, rps=1,
                                          slots=SLOTS)
    assert port_wf.wavefront_strip.launches == before
    assert out[5] is None and plain[5] is None  # no checkpoints asked for
    for a, b in zip(out[:5], plain[:5]):
        assert a.device.type == "cpu"
        assert torch.equal(a, b)


def test_wrapper_checks_its_inputs():
    rng = np.random.default_rng(4)
    ts, bot, pat = strip_inputs(rng, 200, 500, 4, 1, 5, False, False)
    args = list(layout.from_reference_arrays(ts, bot, pat, score_matrix(4),
                                             4, "cpu"))
    args[0] = args[0].to(torch.int64)
    with pytest.raises(ValueError, match="int32"):
        port_wf.wavefront_strip(*args, 5, 200, 500, 0, 4, rps=1,
                                slots=SLOTS)
    args[0] = args[0].to(torch.int32)
    with pytest.raises(ValueError, match="rps"):
        port_wf.wavefront_strip(*args, 5, 200, 500, 0, 4, rps=3,
                                slots=SLOTS)
    for every in (SLOTS, 3 * SLOTS):  # too small; not a power of two
        with pytest.raises(ValueError, match="ckpt_every"):
            port_wf.wavefront_strip(*args, 5, 200, 500, 0, 4, rps=1,
                                    slots=SLOTS, with_dirs=False,
                                    ckpt_every=every)
    with pytest.raises(ValueError, match="score-only"):  # with words
        port_wf.wavefront_strip(*args, 5, 200, 500, 0, 4, rps=1,
                                slots=SLOTS, ckpt_every=2 * SLOTS)
    with pytest.raises(ValueError, match="score-only"):  # no checkpoints
        port_wf.wavefront_strip(*args, 5, 200, 500, 0, 4, rps=1,
                                slots=SLOTS, with_dirs=False)
    with pytest.raises(ValueError, match="left_in"):
        port_wf.wavefront_strip(*args, 5, 200, 500, 0, 4, rps=1,
                                slots=SLOTS,
                                left_in=torch.zeros((3, 8, 128),
                                                    dtype=torch.int32))


def test_score_contract_matches_jax():
    sm = np.where(np.eye(4, dtype=bool), 200, -4).astype(np.int32)
    with pytest.raises(ValueError):
        layout.pack_score_matrix(sm, 4)
    ok = score_matrix(23)
    np.testing.assert_array_equal(layout.pack_score_matrix(ok, 23), ok)


# The checkpoint engine's variants of K1: score-only with column
# checkpoints (phase 1) and words from a left boundary column (phase 2).
# Slots 128 and checkpoints every 256 columns.
CK_SLOTS, CK_EVERY = 128, 256


def small_strip(rng, n, m, k, rps, gap, i0, local, semi):
    """Inputs of one 128-slot strip starting at row i0 (numpy): a random
    top row unless it is strip 0's."""
    text = rng.integers(0, k, n).astype(np.int32)
    pattern = rng.integers(0, k, rps * CK_SLOTS).astype(np.int32)
    pattern[max(0, m - i0):] = 0
    steps = layout.steps_padded(n, CK_SLOTS)
    if i0 == 0:
        bottom = layout.top_row(steps, gap, local or semi, "cpu").numpy()
    else:
        bottom = rng.integers(-3000, 300, steps).astype(np.int32)
    return (layout.text_steps(text, steps), bottom.reshape(-1, layout.STEPS),
            layout.pattern_slots(pattern, rps, CK_SLOTS))


@pytest.mark.parametrize("k", [4, 23], ids=["dna", "protein"])
@pytest.mark.parametrize("mode", ["global", "local", "semi"])
def test_checkpoints_plain_matches_jax_kernel(mode, k):
    local, semi = mode == "local", mode == "semi"
    rng = np.random.default_rng(200 + k + len(mode))
    n, m, rps, gap = 700, 250, 2, 4
    ts, bot, pat = small_strip(rng, n, m, k, rps, gap, 0, local, semi)
    sm = score_matrix(k)
    ref = [np.asarray(x) for x in jax_wf.wavefront_strip(
        ts, bot, pat, sm, gap, n, m, 0, k_alpha=k, local=local,
        with_dirs=False, rps=rps, ckpt_every=CK_EVERY, slots=CK_SLOTS,
        semi=semi, interpret=True,
    )]
    args = layout.from_reference_arrays(ts, bot, pat, sm, k, "cpu")
    dirs, stream, rowmax, argj, snap, ckpts = port_wf.wavefront_strip(
        *args, gap, n, m, 0, k, local=local, with_dirs=False, rps=rps,
        ckpt_every=CK_EVERY, slots=CK_SLOTS, semi=semi,
    )
    assert dirs is None
    np.testing.assert_array_equal(stream.numpy(), ref[1])
    if local or semi:
        np.testing.assert_array_equal(rowmax.numpy(), ref[2])
        np.testing.assert_array_equal(argj.numpy(), ref[3])
    else:
        np.testing.assert_array_equal(snap.numpy(), ref[4])
    # Columns 256 and 512, every slot of which the sweep passes (< n).
    steps = ts.size
    assert ckpts.shape == ref[5].shape == (steps // CK_EVERY * rps, 1, 128)
    full = n // CK_EVERY * rps
    np.testing.assert_array_equal(ckpts.numpy()[:full], ref[5][:full])
    if mode == "global":
        # Column 256 holds the DP's values: S[i, 256] is the global score
        # of the first 256 text letters against the first i pattern ones.
        col = ckpts.numpy()[:rps].reshape(rps, CK_SLOTS).T.reshape(-1)
        text = ts.reshape(-1)[:CK_EVERY]
        pattern = pat.reshape(rps, CK_SLOTS).T.reshape(-1)
        for i in (1, 77, m):
            assert col[i - 1] == jax_bindings.oracle_fill_affine(
                0, text, pattern[:i], sm, k, gap, gap)[0]


@pytest.mark.parametrize("mode", ["global", "local", "semi"])
def test_left_column_plain_matches_jax_kernel(mode):
    # An interior tile: rows from i0 = 256, columns after col_lo, with a
    # left column and a top row as the checkpoint engine passes them.
    local = mode == "local"
    rng = np.random.default_rng(210 + len(mode))
    n, rps, gap, i0 = 500, 2, 3, 256
    rows = rps * CK_SLOTS
    ts, bot, pat = small_strip(rng, n, 10 ** 6, 4, rps, gap, i0, local,
                               False)
    lc_full = np.sort(rng.integers(-2000, 400, rows + 1))[::-1].astype(
        np.int32)
    if local:
        lc_full = np.maximum(lc_full, 0)
    left_ref = np.asarray(jax_wf.make_left_input(lc_full, rps, CK_SLOTS))
    sm = score_matrix(4)
    ref = [np.asarray(x) for x in jax_wf.wavefront_strip(
        ts, bot, pat, sm, gap, n, rows, i0, k_alpha=4, local=local,
        with_dirs=True, rps=rps, slots=CK_SLOTS, left_in=left_ref,
        interpret=True,
    )]
    args = layout.from_reference_arrays(ts, bot, pat, sm, 4, "cpu")
    left_in = port_wf.make_left_input(torch.from_numpy(lc_full), rps,
                                      CK_SLOTS)
    np.testing.assert_array_equal(left_in.numpy(), left_ref)
    out = port_wf.wavefront_strip(*args, gap, n, rows, i0, 4, local=local,
                                  rps=rps, slots=CK_SLOTS, left_in=left_in)
    # Every word bit for bit, and the bottom row.
    np.testing.assert_array_equal(out[0].numpy(), ref[0])
    np.testing.assert_array_equal(out[1].numpy(), ref[1])


@pytest.mark.parametrize("rps,slots", [(1, 128), (4, 256), (16, 128)])
def test_make_left_input_matches_jax(rps, slots):
    rng = np.random.default_rng(rps * slots)
    lc_full = rng.integers(-10 ** 6, 10 ** 6, rps * slots + 1).astype(
        np.int32)
    got = port_wf.make_left_input(torch.from_numpy(lc_full), rps, slots)
    assert got.dtype == torch.int32 and got.is_contiguous()
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_wf.make_left_input(lc_full, rps, slots)))


# K1's cell on the card (``cell()`` in csrc/wavefront.cu) runs on Hopper's
# DPX instructions.  Their definitions, in numpy: __viaddmax_s32(a, b, c)
# = max(a + b, c), its _relu form floored at 0, __vimax_s32_relu(a, b) =
# max(a, b, 0), and __vibmax_s32(a, b, &p) = max(a, b) with p = a >= b.
def viaddmax(a, b, c, relu=False):
    out = np.maximum(a + b, c)
    return np.maximum(out, 0) if relu else out


def vibmax(a, b):
    return np.maximum(a, b), a >= b


def dpx_cell(top, left, diag, s, gap, ext, e_in, f_in, local, words,
             affine):
    """K1's cell as the card computes it: (H, E, F, dir, run); dir and run
    None without words, E and F None linear."""
    e = f = d = run = None
    if not affine and not words:
        dl = viaddmax(left, -gap, diag + s)
        return viaddmax(top, -gap, dl, local), e, f, d, run
    if not affine:
        mx, is_left = vibmax(left, top)
        gap_best = mx - gap
    elif not words:
        e = viaddmax(left, -gap, e_in - ext)
        f = viaddmax(top, -gap, f_in - ext)
        de = viaddmax(diag, s, e)
        h = np.maximum(de, f)
        return (np.maximum(h, 0) if local else h), e, f, d, run
    else:
        e, e_opens = vibmax(left - gap, e_in - ext)
        f, f_opens = vibmax(top - gap, f_in - ext)
        gap_best, is_left = vibmax(e, f)
        run = (~e_opens).astype(np.int32) | ((~f_opens).astype(np.int32) << 1)
    h = viaddmax(diag, s, gap_best, local)
    d = np.where(h > gap_best, 1, np.where(is_left, 0, 2))
    if local:
        d = np.where(h == 0, 3, d)
    return h, e, f, d, run


def plain_cell(top, left, diag, s, gap, ext, e_in, f_in, local, affine):
    """The same cell by ``wavefront_strip_plain``'s rules: (H, E, F, dir,
    run)."""
    diag = diag + s
    e = f = run = None
    if affine:
        e_ext, e_open = e_in - ext, left - gap
        f_ext, f_open = f_in - ext, top - gap
        e, f = np.maximum(e_ext, e_open), np.maximum(f_ext, f_open)
        gap_best = np.maximum(e, f)
        left_wins = e >= f
        run = (e_ext > e_open).astype(np.int32) | (
            (f_ext > f_open).astype(np.int32) << 1)
    else:
        gap_best = np.maximum(top, left) - gap
        left_wins = left >= top
    best = np.maximum(diag, gap_best)
    h = np.maximum(best, 0) if local else best
    d = np.where(diag > gap_best, 1, np.where(left_wins, 0, 2))
    if local:
        d = np.where(best > 0, d, 3)
    return h, e, f, d, run


@pytest.mark.parametrize("words", [True, False], ids=["words", "score"])
@pytest.mark.parametrize("affine", [False, True], ids=["linear", "affine"])
@pytest.mark.parametrize("mode", ["global", "local", "semi"])
def test_dpx_cell_matches_plain_recurrence(mode, affine, words):
    """The DPX forms of K1's cell equal the plain recurrence on tie-heavy
    int32 inputs: H = max(diag + s, top - gap, left - gap), DIAG iff H >
    the best gap move, LEFT on ties, local STOP iff H == 0, the affine run
    bits; and the trackers' first-best column by __vibmax_s32 equals the
    plain version's strict greater-than."""
    local = mode == "local"  # semi-global runs the global recurrence
    rng = np.random.default_rng(
        ["global", "local", "semi"].index(mode) * 4 + 2 * affine + words)
    size = 200_000
    i32 = np.int32
    # Neighbours a few units apart around a common level, so that the
    # moves tie often; some levels near 0 (local's floor and STOP).
    level = np.where(rng.random(size) < 0.5, rng.integers(-12, 12, size),
                     rng.integers(-(1 << 20), 1 << 20, size)).astype(i32)
    gap = rng.integers(1, 7, size).astype(i32)
    ext = (rng.integers(0, 7, size) % gap).astype(i32) if affine else 0
    top, left, diag = (level + rng.integers(-6, 7, size).astype(i32)
                       for _ in range(3))
    s = rng.integers(-5, 6, size).astype(i32)
    e_in = f_in = 0
    if affine:
        e_in, f_in = (np.where(rng.random(size) < 0.1, i32(port_wf.NEG_HALF),
                               level + rng.integers(-9, 4, size)).astype(i32)
                      for _ in range(2))
    got = dpx_cell(top, left, diag, s, gap, ext, e_in, f_in, local, words,
                   affine)
    want = plain_cell(top, left, diag, s, gap, ext, e_in, f_in, local,
                      affine)
    np.testing.assert_array_equal(got[0], want[0])
    if affine:
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
    if words:
        np.testing.assert_array_equal(got[3], want[3])
        assert (got[3] == 1).any() and (got[3] == 0).any()
        assert (got[3] == 2).any() and (got[3] == 3).any() == local
        if affine:
            np.testing.assert_array_equal(got[4], want[4])
            assert set(np.unique(got[4])) == {0, 1, 2, 3}
    # The ties the test is for: a gap move equal to the diagonal's, and
    # LEFT's equal to TOP's.
    assert (diag + s == np.maximum(top, left) - gap).sum() > 1000
    assert (top == left).sum() > 1000
    if mode != "global":
        # A row's tracker over the cells of the block (every column
        # started, within the text): the first column of its maximum.
        h = got[0][:4096].reshape(64, 64)
        best_v = np.full(64, port_wf.NEG_INF, i32)
        best_j = np.zeros(64, i32)
        plain_v, plain_j = best_v.copy(), best_j.copy()
        for j in range(64):
            best_v, keep = vibmax(best_v, h[:, j])
            best_j = np.where(keep, best_j, j + 1)
            better = h[:, j] > plain_v
            plain_v = np.where(better, h[:, j], plain_v)
            plain_j = np.where(better, j + 1, plain_j)
        np.testing.assert_array_equal(best_v, plain_v)
        np.testing.assert_array_equal(best_j, plain_j)


# K1's iteration loop as ``cuobjdump -sass`` prints it, cut down: the lane
# skips its block (0x20), loads a letter, then runs the general path (the
# then-arm, 0x50-0x80, its selects) or the started path (0x90-0xc0, whose
# word-end branch skips 0xb0), and stores after both.
K1_SASS_SAMPLE = """
        /*0000*/                   SHFL.UP PT, R2, R3, 0x1, RZ ;
        /*0010*/                   ISETP.GE.AND P0, PT, R4, R5, PT ;
        /*0020*/               @P0 BRA 0xe0 ;
        /*0030*/                   LDG.E.CONSTANT R6, desc[UR4][R8.64] ;
        /*0040*/               @P1 BRA 0x90 ;
        /*0050*/                   VIADDMNMX R7, R7, R6, R2, !PT ;
        /*0060*/                   SEL R7, R7, R2, P2 ;
        /*0070*/                   SEL R11, R11, R7, P2 ;
        /*0080*/                   BRA 0xd0 ;
        /*0090*/                   VIADDMNMX R7, R7, R6, R2, !PT ;
        /*00a0*/              @!P3 BRA 0xc0 ;
        /*00b0*/                   MOV R9, R7 ;
        /*00c0*/                   SHF.R.W.U32 R10, R10, 0x2, R7 ;
        /*00d0*/                   STG.E desc[UR4][R12.64], R7 ;
        /*00e0*/                   IADD3 R4, R4, 0x1, RZ ;
        /*00f0*/               @P4 BRA 0x0 ;
        /*0100*/                   EXIT ;
"""


def test_sass_started_block_takes_the_started_path():
    """``--sass``'s count: the loop, and in a started block the letter
    load, the shorter arm with its rare branch skipped, and the store."""
    code = dpx16.loop_code(K1_SASS_SAMPLE)
    assert [x[0] for x in code] == list(range(0, 0x100, 0x10))
    got = [x[2] for x in wavefront_shapes.started_block(code)]
    assert got == ["LDG.E.CONSTANT", "BRA", "VIADDMNMX", "BRA",
                   "SHF.R.W.U32", "STG.E"]
