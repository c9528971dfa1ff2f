"""The port's K1 (seqalign_torch.ops.wavefront) against the JAX kernel in
interpreter mode and against the oracle.  All values are integers, so
every comparison is exact (tolerance 0)."""

import numpy as np
import pytest
import torch

from seqalign_torch.native import bindings as port_bindings
from seqalign_torch.ops import layout
from seqalign_torch.ops import wavefront as port_wf
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
