"""The port's checkpoint engine (seqalign_torch.ops.checkpoint: K1
score-only with column checkpoints, then K1 with a left column and K2 on
each path tile) on the CPU, against the JAX engine in interpreter mode
and against the oracle, and the models' routing to it.  All outputs are
integers, so every comparison is exact (tolerance 0).

Small tiles (slots 128, rps 2, 256 columns) make the paths cross many
tiles.  The JAX engine compiles once per mode and alphabet for a given
set of shapes, so the cases share their n and m ranges."""

import numpy as np
import pytest
import torch

from seqalign_torch import config
from seqalign_torch.models import aligner_for
from seqalign_torch.constants import AlignmentType
from seqalign_torch.ops import checkpoint as port_ck
from seqalign_torch.ops import direct as port_direct
from seqalign_torch.ops import walk, wavefront
from seqalign_tpu.native import bindings as jax_bindings
from seqalign_tpu.ops import checkpoint as jax_ck

from .torch_support import one_torch_thread, score_matrix  # noqa: F401

MODES = {"global": {}, "local": {"local": True}, "semi": {"semi": True}}
ALGO = {"global": 0, "local": 1, "semi": 2}
TYPES = {"global": AlignmentType.GLOBAL, "local": AlignmentType.LOCAL,
         "semi": AlignmentType.SEMI_GLOBAL}
GEOM = dict(ckpt_cols=256, rps=2, slots=128)
ROWS = GEOM["rps"] * GEOM["slots"]
# n in [898, 1024] and m in [513, 768]: 4 column tiles by 3 strips, the
# same compiled shapes of the JAX engine for every case below.
N, M = 1000, 700


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("SEQALIGN_ENGINE", "pallas_interpret")


def random_pair(rng, k, n=N, m=M):
    return (rng.integers(0, k, n).astype(np.int32),
            rng.integers(0, k, m).astype(np.int32))


def oracle(text, pattern, sm, k, gap, mode):
    at, ap, st, sp, score = jax_bindings.oracle_align(
        ALGO[mode], text, pattern, sm, k, gap)
    return score, at, ap, st, sp


def assert_alignment(got, want):
    """got: (score, at, ap, st, sp) of the port; want: the same of a
    reference."""
    assert (got[0], got[3], got[4]) == (want[0], want[3], want[4])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


def port_and_references(text, pattern, sm, k, gap, mode):
    """The port's checkpointed_align, the JAX one and the oracle, each as
    (score, at, ap, st, sp); the port's best cell besides."""
    score, bi, bj, at, ap, st, sp = port_ck.checkpointed_align(
        text, pattern, sm, k, gap, device="cpu", **GEOM, **MODES[mode])
    ref = jax_ck.checkpointed_align(text, pattern, sm, k, gap, **GEOM,
                                    **MODES[mode])
    assert (bi, bj) == (ref[1], ref[2])
    return ((score, at, ap, st, sp), (ref[0], *ref[3:]),
            oracle(text, pattern, sm, k, gap, mode), (bi, bj))


@pytest.mark.parametrize("k", [4, 23], ids=["dna", "protein"])
@pytest.mark.parametrize("mode", MODES)
def test_checkpointed_align_matches_jax_and_oracle(mode, k):
    rng = np.random.default_rng(300 + ALGO[mode] + k)
    text, pattern = random_pair(rng, k)
    got, ref, want, _ = port_and_references(text, pattern, score_matrix(k), k,
                                            5 if k == 4 else 4, mode)
    assert_alignment(got, ref)
    assert_alignment(got, want)
    # The path crosses at least 2 x 2 tiles.
    assert len(got[1]) > GEOM["ckpt_cols"] + ROWS


@pytest.mark.parametrize("mode", MODES)
def test_tie_heavy_input(mode):
    # A 1/-1 matrix and gap 1 over two letters: most cells have tied
    # moves, so the tie rules decide the path at every tile edge, in the
    # tiles of row 0 and column 0 as well (arithmetic edges and corners).
    rng = np.random.default_rng(310 + ALGO[mode])
    sm = np.where(np.eye(4, dtype=bool), 1, -1).astype(np.int32)
    text = rng.integers(0, 2, 950).astype(np.int32)
    pattern = rng.integers(0, 2, 600).astype(np.int32)
    got, ref, want, _ = port_and_references(text, pattern, sm, 4, 1, mode)
    assert_alignment(got, ref)
    assert_alignment(got, want)


def test_local_path_between_inner_tiles():
    # A planted match puts the local best in tile (strip 2, column tile
    # 2); the path runs back to a STOP inside tile (1, 1), where the
    # letters before the match never agree (H = 0 there).
    rng = np.random.default_rng(320)
    text, pattern = random_pair(rng, 4)
    text[:480] = rng.integers(0, 2, 480)
    pattern[:420] = rng.integers(2, 4, 420)
    pattern[420:640] = text[480:700]
    got, ref, want, (bi, bj) = port_and_references(
        text, pattern, score_matrix(4), 4, 5, "local")
    cols = GEOM["ckpt_cols"]
    assert (bi - 1) // ROWS == 2 and (bj - 1) // cols == 2
    # The path's first cell: its letters counted back from the best cell.
    first_i = bi - int(np.sum(got[2] != 4)) + 1
    first_j = bj - int(np.sum(got[1] != 4)) + 1
    assert (first_i - 1) // ROWS == 1 and (first_j - 1) // cols == 1
    assert_alignment(got, ref)
    assert_alignment(got, want)


def test_local_no_match():
    sm = np.full((4, 4), -4, dtype=np.int32)
    text = np.zeros(N, np.int32)
    pattern = np.ones(M, np.int32)
    got, ref, want, best = port_and_references(text, pattern, sm, 4, 5,
                                               "local")
    assert got[0] == 0 and best == (0, 0) and len(got[1]) == 0
    assert_alignment(got, ref)
    assert_alignment(got, want)


@pytest.mark.parametrize("mode", MODES)
def test_traceback_on_jax_fill(mode):
    rng = np.random.default_rng(330 + ALGO[mode])
    sm = score_matrix(4)
    text, pattern = random_pair(rng, 4, n=980, m=650)
    ref = jax_ck.checkpointed_fill(text, pattern, sm, 4, 5, **GEOM,
                                   **MODES[mode])
    ck = port_ck.from_reference_fill(ref, "cpu")
    # The port's own fill holds the same values: score, best cell, the
    # strips' bottom rows (the JAX rows are zero-padded further) and
    # every checkpoint column the strip passes.
    own = port_ck.checkpointed_fill(text, pattern, sm, 4, 5, device="cpu",
                                    **GEOM, **MODES[mode])
    assert (own.score, own.best_i, own.best_j) == (ck.score, ck.best_i,
                                                   ck.best_j)
    assert len(own.boundaries) == len(ck.boundaries) == 3
    for a, b in zip(own.boundaries, ck.boundaries):
        assert torch.equal(a, b[:len(a)]) and not b[len(a):].any()
    full = 980 // GEOM["ckpt_cols"]
    for a, b in zip(own.colvals, ck.colvals):
        assert torch.equal(a[:full], b[:full])

    at, ap, st, sp = port_ck.checkpointed_traceback(ck, text, pattern, sm, 4)
    assert_alignment((ck.score, at, ap, st, sp),
                     oracle(text, pattern, sm, 4, 5, mode))


def test_on_cpu_launches_no_kernel():
    rng = np.random.default_rng(340)
    text, pattern = random_pair(rng, 4, n=300, m=200)
    before = (wavefront.wavefront_strip.launches,
              walk.walk_skewed_window.launches)
    port_ck.checkpointed_align(text, pattern, score_matrix(4), 4, 5,
                               device="cpu", ckpt_cols=256, rps=1, slots=128)
    assert (wavefront.wavefront_strip.launches,
            walk.walk_skewed_window.launches) == before


@pytest.mark.parametrize("mode", MODES)
def test_traceback_on_jax_affine_fill(mode):
    # An affine (Gotoh) fill of the JAX engine brings its E checkpoint
    # columns and F bottom rows; the port's own fill holds the same ones.
    rng = np.random.default_rng(335 + ALGO[mode])
    sm = score_matrix(4)
    text, pattern = random_pair(rng, 4, n=980, m=650)
    ref = jax_ck.checkpointed_fill(text, pattern, sm, 4, 8, gap_extend=2,
                                   **GEOM, **MODES[mode])
    ck = port_ck.from_reference_fill(ref, "cpu")
    own = port_ck.checkpointed_fill(text, pattern, sm, 4, 8, gap_extend=2,
                                    device="cpu", **GEOM, **MODES[mode])
    assert (own.score, own.best_i, own.best_j, own.gap_extend) == (
        ck.score, ck.best_i, ck.best_j, ck.gap_extend) == (
        ck.score, ck.best_i, ck.best_j, 2)
    full = 980 // GEOM["ckpt_cols"]
    for mine, theirs in ((own.boundaries, ck.boundaries),
                         (own.boundaries_f, ck.boundaries_f)):
        assert len(mine) == len(theirs) == 3
        for a, b in zip(mine, theirs):
            assert torch.equal(a, b[:len(a)]) and not b[len(a):].any()
    for mine, theirs in ((own.colvals, ck.colvals),
                         (own.colvals_e, ck.colvals_e)):
        for a, b in zip(mine, theirs):
            assert torch.equal(a[:full], b[:full])

    at, ap, st, sp = port_ck.checkpointed_traceback(ck, text, pattern, sm, 4)
    oat, oap, ost, osp, oscore = jax_bindings.oracle_align_affine(
        ALGO[mode], text, pattern, sm, 4, 8, 2)
    assert_alignment((ck.score, at, ap, st, sp), (oscore, oat, oap, ost, osp))


@pytest.mark.parametrize("m,rps,slots,want", [
    (1000, None, None, (4, 4096)), (36864, None, None, (16, 4096)),
    (200000, None, None, (16, 4096)), (500, 1, None, (1, 4096)),
    (500, None, 128, (4, 128)),
])
def test_geometry_matches_jax(m, rps, slots, want):
    assert port_ck._pick_geometry(m, rps, slots) == want
    assert jax_ck._pick_geometry(m, rps, slots) == want
    assert port_ck.DEFAULT_CKPT_COLS == jax_ck.DEFAULT_CKPT_COLS


# Routing: which engine a pair takes in the models.


@pytest.fixture
def checkpoint_calls(monkeypatch):
    """Records the models' checkpoint engine calls and runs them at the
    small geometry."""
    calls = []
    real = port_ck.checkpointed_align

    def small(*args, **kwargs):
        calls.append(kwargs)
        return real(*args, **kwargs, ckpt_cols=256, rps=1, slots=128)

    monkeypatch.setattr(port_ck, "checkpointed_align", small)
    # Past the wavefront route's host budget.
    monkeypatch.setattr(config, "MAX_HOST_DIRS_BYTES", 0)
    return calls


def routed(mode, seed):
    rng = np.random.default_rng(seed)
    text, pattern = random_pair(rng, 4, n=500, m=300)
    sm = score_matrix(4)
    r = aligner_for(TYPES[mode]).align(text, pattern, sm, 4, 5,
                                       device="cpu")
    return ((r.score, r.aligned_text, r.aligned_pattern,
             r.start_in_aligned_text, r.start_in_aligned_pattern),
            oracle(text, pattern, sm, 4, 5, mode))


@pytest.mark.parametrize("mode", MODES)
def test_pair_past_direct_route_takes_checkpoint_engine(mode, monkeypatch,
                                                         checkpoint_calls):
    monkeypatch.setattr(port_direct, "fits_direct", lambda *a, **k: False)

    def refuse(*args, **kwargs):
        raise AssertionError("direct route taken")

    monkeypatch.setattr(port_direct, "direct_align", refuse)
    got, want = routed(mode, 350 + ALGO[mode])
    assert checkpoint_calls == [dict(local=mode == "local",
                                     semi=mode == "semi", gap_extend=None,
                                     device="cpu")]
    assert_alignment(got, want)


def test_direct_out_of_memory_retries_on_checkpoint_engine(monkeypatch,
                                                           checkpoint_calls):
    def out_of_memory(*args, **kwargs):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    monkeypatch.setattr(port_direct, "direct_align", out_of_memory)
    got, want = routed("global", 360)
    assert len(checkpoint_calls) == 1
    assert_alignment(got, want)


# Out-of-memory errors that are not torch.cuda.OutOfMemoryError: a kernel
# launch's (ops/_build.py::check_launch), torch's untyped one, and the
# reference's other phrase.
UNTYPED_OOM = (
    "direct kernel launch failed: cudaErrorMemoryAllocation: out of memory "
    "(cudaError_t 2)",
    "CUDA error: out of memory",
    "RESOURCE_EXHAUSTED: while allocating the words",
)


@pytest.mark.parametrize("message", UNTYPED_OOM)
def test_direct_untyped_out_of_memory_retries_on_checkpoint_engine(
        message, monkeypatch, checkpoint_calls):
    def out_of_memory(*args, **kwargs):
        raise RuntimeError(message)

    monkeypatch.setattr(port_direct, "direct_align", out_of_memory)
    got, want = routed("global", 363)
    assert len(checkpoint_calls) == 1
    assert_alignment(got, want)


def test_direct_other_errors_propagate(monkeypatch, checkpoint_calls):
    def fails(*args, **kwargs):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(port_direct, "direct_align", fails)
    with pytest.raises(RuntimeError, match="launch failed"):
        routed("local", 361)
    assert checkpoint_calls == []


def test_small_pair_fits_direct_route(monkeypatch, checkpoint_calls):
    calls = []
    real = port_direct.direct_align

    def small(*args, **kwargs):
        calls.append(kwargs)
        return real(*args, **kwargs, rps=1, slots=1024)

    monkeypatch.setattr(port_direct, "direct_align", small)
    got, want = routed("semi", 362)
    assert len(calls) == 1 and checkpoint_calls == []
    assert_alignment(got, want)
