"""Affine (Gotoh) gaps on the port's single-pair path, on the CPU: K1's E/F
state and run bits, K2's three-state walk, the affine emission, the
direct route and the checkpoint engine, each against the JAX package (its
kernels in interpreter mode) and the native oracle's sa_align_affine.
All outputs are integers, so every comparison is exact (tolerance 0).

A run of L gaps costs open + (L-1)*extend; gap is the open cost."""

import numpy as np
import pytest
import torch

from seqalign_torch.models import aligner_for
from seqalign_torch.constants import AlignmentType
from seqalign_torch.ops import checkpoint as port_ck
from seqalign_torch.ops import direct as port_direct
from seqalign_torch.ops import layout
from seqalign_torch.ops import traceback as port_tb
from seqalign_torch.ops import walk as port_walk
from seqalign_torch.ops import wavefront as port_wf
from seqalign_tpu.native import bindings as jax_bindings
from seqalign_tpu.ops import checkpoint as jax_ck
from seqalign_tpu.ops import direct as jax_direct
from seqalign_tpu.ops import traceback as jax_tb
from seqalign_tpu.ops import wavefront as jax_wf
from seqalign_tpu.ops.pallas_walk import pallas_walk_skewed_window, unpack_moves

from .torch_support import one_torch_thread, score_matrix  # noqa: F401

MODES = {"global": {}, "local": {"local": True}, "semi": {"semi": True}}
ALGO = {"global": 0, "local": 1, "semi": 2}
OPEN, EXT = 8, 2
SLOTS, RPS = 128, 2
NEG_HALF = port_wf.NEG_HALF


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("SEQALIGN_ENGINE", "pallas_interpret")


def strip_inputs(rng, n, m, k, i0, local, semi, rps=RPS):
    """One 128-slot strip's inputs from row i0, as the JAX wrapper takes
    them (numpy): text steps, top rows of H and F, pattern slots.  Strip
    0 has the DP's top edges; a later strip random ones (F below H)."""
    text = rng.integers(0, k, n).astype(np.int32)
    pattern = rng.integers(0, k, rps * SLOTS).astype(np.int32)
    pattern[max(0, m - i0):] = 0
    steps = layout.steps_padded(n, SLOTS)
    if i0 == 0:
        bottom = layout.top_row(steps, OPEN, local or semi, "cpu",
                                ext=EXT).numpy()
        fbottom = np.full(steps, NEG_HALF, np.int32)
    else:
        bottom = rng.integers(-3000, 300, steps).astype(np.int32)
        fbottom = (bottom - rng.integers(0, 40, steps)).astype(np.int32)
    return (layout.text_steps(text, steps), bottom.reshape(-1, layout.STEPS),
            fbottom.reshape(-1, layout.STEPS),
            layout.pattern_slots(pattern, rps, SLOTS))


def port_strip(ts, bot, fbot, pat, k, n, m, i0, left_in=None, left_e=None,
               rps=RPS, **kw):
    """The port's K1 (its plain version, on the CPU) on the JAX inputs."""
    args = layout.from_reference_arrays(ts, bot, pat, score_matrix(k), k,
                                        "cpu")
    as_t = (lambda x: None if x is None
            else torch.from_numpy(np.ascontiguousarray(x)))
    return port_wf.wavefront_strip(
        *args, OPEN, n, m, i0, k, rps=rps, slots=SLOTS, affine=True, ext=EXT,
        fbot_in=as_t(fbot), left_in=as_t(left_in), left_e=as_t(left_e), **kw)


def jax_strip(ts, bot, fbot, pat, k, n, m, i0, rps=RPS, **kw):
    return [np.asarray(x) for x in jax_wf.wavefront_strip(
        ts, bot, pat, score_matrix(k), OPEN, n, m, i0, k_alpha=k, rps=rps,
        slots=SLOTS, affine=True, ext=EXT, fbot_in=fbot, interpret=True,
        **kw)]


def assert_trackers(got, ref, mode):
    if mode == "global":
        np.testing.assert_array_equal(got[4].numpy(), ref[4])
    else:
        np.testing.assert_array_equal(got[2].numpy(), ref[2])
        np.testing.assert_array_equal(got[3].numpy(), ref[3])


@pytest.mark.parametrize("k,rps", [(4, 2), (23, 1)], ids=["dna", "protein"])
@pytest.mark.parametrize("mode", MODES)
def test_strip_plain_matches_jax_kernel(mode, k, rps):
    local, semi = mode == "local", mode == "semi"
    rng = np.random.default_rng(400 + ALGO[mode] + k)
    n, m = 300, rps * SLOTS - 3
    ts, bot, fbot, pat = strip_inputs(rng, n, m, k, 0, local, semi, rps)
    kw = dict(local=local, semi=semi, rps=rps)
    ref = jax_strip(ts, bot, fbot, pat, k, n, m, 0, **kw)
    got = port_strip(ts, bot, fbot, pat, k, n, m, 0, **kw)
    assert len(got) == 9 and got[5] is None and got[8] is None
    # Every word and run bit, readable by a walker or not, and both
    # streams.
    for idx in (0, 6, 1, 7):
        np.testing.assert_array_equal(got[idx].numpy(), ref[idx])
    assert_trackers(got, ref, mode)


@pytest.mark.parametrize("mode", MODES)
def test_checkpoints_plain_matches_jax_kernel(mode):
    # The geometry and text length of the checkpoint engine's cases below,
    # whose phase 1 then reuses the JAX kernel compiled here.
    local, semi = mode == "local", mode == "semi"
    rng = np.random.default_rng(410 + ALGO[mode])
    n, m, every, rps = 700, 125, 256, 1
    ts, bot, fbot, pat = strip_inputs(rng, n, m, 4, 0, local, semi, rps)
    kw = dict(local=local, semi=semi, with_dirs=False, ckpt_every=every,
              rps=rps)
    ref = jax_strip(ts, bot, fbot, pat, 4, n, m, 0, **kw)
    got = port_strip(ts, bot, fbot, pat, 4, n, m, 0, **kw)
    assert got[0] is None and got[6] is None
    for idx in (1, 7):
        np.testing.assert_array_equal(got[idx].numpy(), ref[idx])
    assert_trackers(got, ref, mode)
    # Columns 256 and 512 of H and of E, every slot of which the sweep
    # passes (< n).
    full = n // every * rps
    for idx in (5, 8):
        assert got[idx].shape == ref[idx].shape
        np.testing.assert_array_equal(got[idx].numpy()[:full],
                                      ref[idx][:full])
    # E holds real values there, not its minus infinity.
    assert (got[8].numpy()[:full] > NEG_HALF // 2).all()


@pytest.mark.parametrize("mode", ["global", "local"])
def test_left_column_plain_matches_jax_kernel(mode):
    # An interior tile: rows from i0 = 256, columns after col_lo, with the
    # top rows of H and F and the left columns of H and E as the
    # checkpoint engine passes them (semi-global tiles fill as global
    # ones).
    local = mode == "local"
    rng = np.random.default_rng(420 + ALGO[mode])
    n, i0 = 500, 256
    rows = RPS * SLOTS
    ts, bot, fbot, pat = strip_inputs(rng, n, 10 ** 6, 4, i0, local, False)
    lc_full = np.sort(rng.integers(-2000, 400, rows + 1))[::-1].astype(
        np.int32)
    if local:
        lc_full = np.maximum(lc_full, 0)
    le_full = (lc_full - rng.integers(1, 40, rows + 1)).astype(np.int32)
    le_full[0] = NEG_HALF
    left_in = np.asarray(jax_wf.make_left_input(lc_full, RPS, SLOTS))
    left_e = np.asarray(jax_wf.make_left_input(le_full, RPS, SLOTS))
    ref = jax_strip(ts, bot, fbot, pat, 4, n, rows, i0, local=local,
                    left_in=left_in, left_e=left_e)
    got = port_strip(ts, bot, fbot, pat, 4, n, rows, i0, local=local,
                     left_in=left_in, left_e=left_e)
    for idx in (0, 6, 1, 7):
        np.testing.assert_array_equal(got[idx].numpy(), ref[idx])


def test_wrapper_checks_affine_inputs():
    rng = np.random.default_rng(430)
    ts, bot, fbot, pat = strip_inputs(rng, 200, 200, 4, 0, False, False)
    args = layout.from_reference_arrays(ts, bot, pat, score_matrix(4), 4,
                                        "cpu")
    kw = dict(rps=RPS, slots=SLOTS)
    with pytest.raises(ValueError, match="fbot_in"):
        port_wf.wavefront_strip(*args, OPEN, 200, 200, 0, 4, affine=True,
                                ext=EXT, **kw)
    with pytest.raises(ValueError, match="affine inputs"):
        port_wf.wavefront_strip(*args, OPEN, 200, 200, 0, 4,
                                fbot_in=torch.from_numpy(fbot), **kw)
    left_in = torch.zeros((RPS + 1, 1, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="left_e"):
        port_wf.wavefront_strip(*args, OPEN, 200, 200, 0, 4, affine=True,
                                ext=EXT, fbot_in=torch.from_numpy(fbot),
                                left_in=left_in, **kw)


# K2's three-state walk, on random words and run bits.

ROWS, COLS = RPS * SLOTS, 300


def random_planes(rng, local):
    hi = 4 if local else 3  # global words never hold STOP
    dirs = rng.integers(0, hi, (ROWS + 1, COLS + 1)).astype(np.uint8)
    bits = rng.integers(0, 4, (ROWS + 1, COLS + 1)).astype(np.uint8)
    return (np.asarray(jax_tb.pack_words_skewed(dirs, RPS, SLOTS)),
            np.asarray(jax_tb.pack_words_skewed(bits, RPS, SLOTS)))


@pytest.mark.parametrize("mode,state0", [
    ("global", 0), ("global", 1), ("global", 2), ("local", 0), ("local", 1),
    ("local", 2),
])
def test_walk_plain_matches_jax_walker(mode, state0):
    local = mode == "local"
    rng = np.random.default_rng(440 + 3 * local + state0)
    words, words2 = random_planes(rng, local)
    for _ in range(3):
        i = int(rng.integers(1, ROWS + 1))
        j = int(rng.integers(1, COLS + 1))
        mv, k, ri, rj, rst, rdone = pallas_walk_skewed_window(
            words, words2, RPS, 0, 0, i, j, state0, local, True,
            ROWS + COLS + 1, interpret=True,
        )
        moves, result = port_walk.walk_skewed_window(
            torch.as_tensor(words), RPS, 0, 0, i, j, local, ROWS + COLS + 1,
            words2=torch.as_tensor(words2), state0=state0,
        )
        count, pi, pj, state, done = result.tolist()
        assert count == int(k)
        np.testing.assert_array_equal(
            port_walk.unpack_moves(moves.numpy(), count),
            unpack_moves(mv, int(k)))
        assert (pi, pj, state, done) == (int(ri), int(rj), int(rst),
                                         int(rdone))


def test_walk_resumes_from_a_short_buffer():
    # The walk stops at the end of its buffer with done = 0 and hands
    # back its cursor and gap state; resumed from there it makes the
    # rest of the full walk's moves.
    rng = np.random.default_rng(450)
    words, words2 = (torch.as_tensor(x) for x in random_planes(rng, False))
    cap = ROWS + COLS + 1
    full_mv, full = port_walk.walk_skewed_window(
        words, RPS, 0, 0, ROWS, COLS, False, cap, words2=words2, state0=1)
    count = full.tolist()[0]
    assert count > 64
    first, res = port_walk.walk_skewed_window(
        words, RPS, 0, 0, ROWS, COLS, False, 64, words2=words2, state0=1)
    c1, i1, j1, st1, done1 = res.tolist()
    assert (c1, done1) == (64, 0)
    rest, res2 = port_walk.walk_skewed_window(
        words, RPS, 0, 0, i1, j1, False, cap, words2=words2, state0=st1)
    c2 = res2.tolist()[0]
    assert res2.tolist()[1:] == full.tolist()[1:] and c1 + c2 == count
    np.testing.assert_array_equal(
        np.concatenate([port_walk.unpack_moves(first.numpy(), c1),
                        port_walk.unpack_moves(rest.numpy(), c2)]),
        port_walk.unpack_moves(full_mv.numpy(), count))


def test_walk_wrapper_checks_affine_inputs():
    words = torch.zeros((16 * RPS, 1, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="state 0"):
        port_walk.walk_skewed_window(words, RPS, 0, 0, 5, 4, False, 64,
                                     state0=1)
    with pytest.raises(ValueError, match="words2"):
        port_walk.walk_skewed_window(words, RPS, 0, 0, 5, 4, False, 64,
                                     words2=words[:RPS])


@pytest.mark.parametrize("seed,start", [(460, (40, 60)), (461, (0, 0)),
                                        (462, (25, 7))])
def test_emit_moves_affine_matches_jax(seed, start):
    rng = np.random.default_rng(seed)
    text = rng.integers(0, 4, 80).astype(np.int32)
    pattern = rng.integers(0, 4, 50).astype(np.int32)
    start_i, start_j = start
    moves = rng.integers(0, 3, start_i + start_j).astype(np.uint8)
    got = port_tb.emit_moves_affine(moves, start_i, start_j, text, pattern, 4)
    want = jax_tb.emit_moves_affine(moves, start_i, start_j, text, pattern,
                                    4)
    assert got[2:] == want[2:]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


# The routes: direct and checkpoint engine, against the JAX engines and
# the oracle.


def oracle(text, pattern, sm, k, mode, gap=OPEN, ext=EXT):
    at, ap, st, sp, score = jax_bindings.oracle_align_affine(
        ALGO[mode], text, pattern, sm, k, gap, ext)
    return score, at, ap, st, sp


def assert_alignment(got, want):
    assert (got[0], got[3], got[4]) == (want[0], want[3], want[4])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


def as_alignment(result):
    """(score, at, ap, st, sp) of a 7-tuple engine result."""
    return (result[0], *result[3:])


@pytest.mark.parametrize("mode", MODES)
def test_direct_align_matches_jax_and_oracle(mode):
    rng = np.random.default_rng(470 + ALGO[mode])
    sm = score_matrix(4)
    text = rng.integers(0, 4, 500).astype(np.int32)
    pattern = rng.integers(0, 4, 300).astype(np.int32)
    geom = dict(rps=1, slots=512)
    got = port_direct.direct_align(text, pattern, sm, 4, OPEN,
                                   gap_extend=EXT, device="cpu", **geom,
                                   **MODES[mode])
    ref = jax_direct.direct_align(text, pattern, sm, 4, OPEN, gap_extend=EXT,
                                  **geom, **MODES[mode])
    assert got[1:3] == ref[1:3]
    assert_alignment(as_alignment(got), as_alignment(ref))
    assert_alignment(as_alignment(got), oracle(text, pattern, sm, 4, mode))


GEOM = dict(ckpt_cols=256, rps=1, slots=128)
# n in [642, 768] and m in [257, 384]: 3 column tiles by 3 strips, the
# same compiled shapes of the JAX engine for every case below.
N, M = 700, 300


def checkpointed(text, pattern, sm, mode):
    """The port's checkpointed_align, the JAX one and the oracle, each as
    (score, at, ap, st, sp); the port's best cell besides."""
    got = port_ck.checkpointed_align(text, pattern, sm, 4, OPEN,
                                     gap_extend=EXT, device="cpu", **GEOM,
                                     **MODES[mode])
    ref = jax_ck.checkpointed_align(text, pattern, sm, 4, OPEN,
                                    gap_extend=EXT, **GEOM, **MODES[mode])
    assert got[1:3] == ref[1:3]
    return (as_alignment(got), as_alignment(ref),
            oracle(text, pattern, sm, 4, mode), got[1:3])


@pytest.mark.parametrize("mode", MODES)
def test_checkpointed_align_matches_jax_and_oracle(mode):
    rng = np.random.default_rng(480 + ALGO[mode])
    text = rng.integers(0, 4, N).astype(np.int32)
    pattern = rng.integers(0, 4, M).astype(np.int32)
    got, ref, want, (bi, bj) = checkpointed(text, pattern, score_matrix(4),
                                            mode)
    assert_alignment(got, ref)
    assert_alignment(got, want)
    # The path's first and last cells lie in different strips and column
    # tiles.
    first, last = path_tiles(got, bi, bj)
    assert first[0] != last[0] and first[1] != last[1]


def path_tiles(got, bi, bj):
    """(strip, column tile) of an alignment's first and last cells, its
    last cell (bi, bj); the first counted back over its letters."""
    rows, cols = GEOM["rps"] * GEOM["slots"], GEOM["ckpt_cols"]
    first_i = bi - int(np.sum(got[2] != 4)) + 1
    first_j = bj - int(np.sum(got[1] != 4)) + 1
    return (((first_i - 1) // rows, (first_j - 1) // cols),
            ((bi - 1) // rows, (bj - 1) // cols))


def test_local_path_between_inner_tiles():
    # A planted match with a 6-gap run in it puts the local best in tile
    # (strip 2, column tile 2); the path runs back to a STOP inside tile
    # (1, 1), where the letters before the match never agree.
    rng = np.random.default_rng(490)
    text = rng.integers(0, 4, N).astype(np.int32)
    pattern = rng.integers(0, 4, M).astype(np.int32)
    text[:380] = rng.integers(0, 2, 380)
    pattern[:150] = rng.integers(2, 4, 150)
    pattern[150:] = np.delete(text[380:536], np.arange(70, 76))
    got, ref, want, (bi, bj) = checkpointed(text, pattern, score_matrix(4),
                                            "local")
    assert path_tiles(got, bi, bj) == ((1, 1), (2, 2))
    assert "4" * 6 in "".join(map(str, got[2]))  # the 6-gap run
    assert_alignment(got, ref)
    assert_alignment(got, want)


@pytest.mark.parametrize("route", ["direct", "checkpoint"])
def test_extend_equal_to_open_gives_linear_alignment(route):
    rng = np.random.default_rng(495)
    sm = score_matrix(4)
    text = rng.integers(0, 4, 400).astype(np.int32)
    pattern = rng.integers(0, 4, 250).astype(np.int32)
    for mode in MODES:
        if route == "direct":
            got = port_direct.direct_align(text, pattern, sm, 4, 5,
                                           gap_extend=5, device="cpu", rps=1,
                                           slots=256, **MODES[mode])
        else:
            got = port_ck.checkpointed_align(
                text, pattern, sm, 4, 5, gap_extend=5, device="cpu",
                ckpt_cols=256, rps=1, slots=128, **MODES[mode])
        at, ap, st, sp, score = jax_bindings.oracle_align(
            ALGO[mode], text, pattern, sm, 4, 5)
        assert_alignment(as_alignment(got), (score, at, ap, st, sp))


# Routing of affine requests in the models.

TYPES = {"global": AlignmentType.GLOBAL, "local": AlignmentType.LOCAL,
         "semi": AlignmentType.SEMI_GLOBAL}


@pytest.fixture
def engine_calls(monkeypatch):
    """Records the models' direct-route and checkpoint-engine calls and
    runs them at small geometries."""
    calls = {"direct": [], "checkpoint": []}
    real_direct, real_ck = port_direct.direct_align, port_ck.checkpointed_align

    def direct(*args, **kwargs):
        calls["direct"].append(kwargs)
        return real_direct(*args, **kwargs, rps=1, slots=512)

    def checkpoint(*args, **kwargs):
        calls["checkpoint"].append(kwargs)
        return real_ck(*args, **kwargs, ckpt_cols=256, rps=1, slots=128)

    monkeypatch.setattr(port_direct, "direct_align", direct)
    monkeypatch.setattr(port_ck, "checkpointed_align", checkpoint)
    return calls


def routed(mode, seed):
    rng = np.random.default_rng(seed)
    sm = score_matrix(4)
    text = rng.integers(0, 4, 450).astype(np.int32)
    pattern = rng.integers(0, 4, 300).astype(np.int32)
    r = aligner_for(TYPES[mode]).align(text, pattern, sm, 4, OPEN,
                                       gap_extend=EXT, device="cpu")
    return ((r.score, r.aligned_text, r.aligned_pattern,
             r.start_in_aligned_text, r.start_in_aligned_pattern),
            oracle(text, pattern, sm, 4, mode))


@pytest.mark.parametrize("mode", MODES)
def test_affine_request_takes_direct_route(mode, engine_calls):
    got, want = routed(mode, 500 + ALGO[mode])
    assert engine_calls["checkpoint"] == []
    assert engine_calls["direct"] == [dict(local=mode == "local",
                                           semi=mode == "semi", device="cpu",
                                           gap_extend=EXT)]
    assert_alignment(got, want)


def test_affine_direct_budget_counts_both_planes(monkeypatch, engine_calls):
    # Words that fit the budget alone but not beside their run bits send
    # the pair to the checkpoint engine.
    n, m = 450, 300
    rps, slots = port_direct._direct_geometry(m)
    words = (layout.steps_padded(n, slots) // 16) * rps * slots * 4
    monkeypatch.setattr(port_direct, "MAX_DIRECT_DIRS_BYTES", words)
    assert port_direct.fits_direct(n, m)
    assert not port_direct.fits_direct(n, m, affine=True)
    got, want = routed("local", 510)
    assert engine_calls["direct"] == []
    assert engine_calls["checkpoint"] == [dict(local=True, semi=False,
                                               device="cpu", gap_extend=EXT)]
    assert_alignment(got, want)


def test_affine_out_of_memory_retries_on_checkpoint_engine(monkeypatch,
                                                           engine_calls):
    def out_of_memory(*args, **kwargs):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    monkeypatch.setattr(port_direct, "direct_align", out_of_memory)
    got, want = routed("global", 520)
    assert len(engine_calls["checkpoint"]) == 1
    assert engine_calls["checkpoint"][0]["gap_extend"] == EXT
    assert_alignment(got, want)


def test_affine_launch_out_of_memory_retries_on_checkpoint_engine(
        monkeypatch, engine_calls):
    def out_of_memory(*args, **kwargs):
        raise RuntimeError("direct kernel launch failed: "
                           "cudaErrorMemoryAllocation: out of memory "
                           "(cudaError_t 2)")

    monkeypatch.setattr(port_direct, "direct_align", out_of_memory)
    got, want = routed("local", 521)
    assert len(engine_calls["checkpoint"]) == 1
    assert engine_calls["checkpoint"][0]["gap_extend"] == EXT
    assert_alignment(got, want)


def test_affine_other_direct_errors_propagate(monkeypatch, engine_calls):
    def fails(*args, **kwargs):
        raise RuntimeError("direct kernel launch failed: "
                           "cudaErrorIllegalAddress: an illegal memory "
                           "access was encountered (cudaError_t 700)")

    monkeypatch.setattr(port_direct, "direct_align", fails)
    with pytest.raises(RuntimeError, match="cudaErrorIllegalAddress"):
        routed("semi", 522)
    assert engine_calls["checkpoint"] == []
