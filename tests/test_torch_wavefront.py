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
    dirs, stream, rowmax, argj, snap = (
        x.numpy() for x in port_wf.wavefront_strip_plain(
            *args, gap, n, m, 0, k, local=local, rps=rps, slots=SLOTS,
            semi=semi,
        )
    )
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
    for a, b in zip(out, plain):
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


def test_score_contract_matches_jax():
    sm = np.where(np.eye(4, dtype=bool), 200, -4).astype(np.int32)
    with pytest.raises(ValueError):
        layout.pack_score_matrix(sm, 4)
    ok = score_matrix(23)
    np.testing.assert_array_equal(layout.pack_score_matrix(ok, 23), ok)
