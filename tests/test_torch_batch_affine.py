"""Affine (Gotoh) gaps on the port's batch path, on the CPU: K3's and K4's
plain versions (seqalign_torch.ops.batch_fill, .batch_traceback) against
the JAX inter-pair kernel and walkers in interpreter mode, the port's
BatchAligner(gap_extend=...) against the JAX class and the native oracle,
and ``-g``'s mapping of device RuntimeErrors to MEM_ERROR.  Every output
is an integer: the comparisons are exact (tolerance 0)."""

import ctypes
import io

import numpy as np
import pytest
import torch

from seqalign_torch import api, cli, constants
from seqalign_torch import models as port_models
from seqalign_torch.native import bindings as port_bindings
from seqalign_torch.ops import _build, batch_fill, batch_traceback
from seqalign_torch.parallel import BatchAligner
from seqalign_torch.parallel import batch as port_batch
from seqalign_torch.types import Request, Response
from seqalign_tpu.ops.batch_traceback import (batch_device_traceback,
                                              batch_pallas_traceback)
from seqalign_tpu.ops.pallas_fill import (batch_fill_dirs_pallas,
                                          batch_score_pallas)
from seqalign_tpu.parallel import mesh as mesh_lib
from seqalign_tpu.parallel.batch import BatchAligner as JaxBatchAligner

from .test_torch_batch import ragged_pairs
from .test_torch_batch_fill import (B, M, N, TILE, make_batch, tensors,
                                    ties_sm)
from .test_torch_batch_traceback import assert_same_walks
from .torch_support import one_torch_thread, score_matrix  # noqa: F401

MODES = {"global": {}, "local": {"local": True}, "semi": {"semi": True}}
ALGO = {"global": 0, "local": 1, "semi": 2}
# (open, extend): extend below open, and equal to it (the linear costs).
COSTS = [(8, 2), (5, 5)]


def jax_dirs(texts, patterns, ns, ms, sm, k, gap, ext, mode):
    return [np.array(x) for x in batch_fill_dirs_pallas(
        texts, patterns, ns, ms, sm, gap, k_alpha=k, tile_pairs=TILE,
        gap_extend=ext, interpret=True, **MODES[mode])]


def compare_dirs(texts, patterns, ns, ms, sm, k, gap, ext, mode):
    ref = jax_dirs(texts, patterns, ns, ms, sm, k, gap, ext, mode)
    got = [x.numpy() for x in batch_fill.batch_fill_dirs_plain(
        *tensors(texts, patterns, ns, ms, sm), gap, k, tile_pairs=TILE,
        gap_extend=ext, **MODES[mode])]
    assert len(got) == 5
    real = ns > 0
    np.testing.assert_array_equal(got[0][real], ref[0][real])
    if mode != "global":  # global's best cell is (m, n), not reported
        np.testing.assert_array_equal(got[1][real], ref[1][real])
        np.testing.assert_array_equal(got[2][real], ref[2][real])
    shape = (B // TILE, M // 16, N, 1, 128)
    assert got[3].shape == ref[3].shape == shape
    assert got[4].shape == ref[4].shape == shape
    np.testing.assert_array_equal(got[3], ref[3])  # every word
    np.testing.assert_array_equal(got[4], ref[4])  # every run-bit word
    return got


@pytest.mark.parametrize("cost", COSTS, ids=["open8-ext2", "open5-ext5"])
@pytest.mark.parametrize("k", [4, 23])
@pytest.mark.parametrize("mode", ["global", "local", "semi"])
def test_batch_fill_dirs_affine_plain_matches_jax(mode, k, cost):
    rng = np.random.default_rng(701 + k + len(mode) + cost[1])
    got = compare_dirs(*make_batch(rng, k), score_matrix(k), k, *cost, mode)
    if cost[0] > cost[1]:
        assert got[4].any()  # some gap runs go on


@pytest.mark.parametrize("mode", ["global", "local", "semi"])
def test_batch_fill_dirs_affine_plain_matches_jax_on_ties(mode):
    rng = np.random.default_rng(711 + len(mode))
    compare_dirs(*make_batch(rng, 4, "ties"), ties_sm(), 4, 3, 1, mode)


@pytest.mark.parametrize("k", [4, 23])
@pytest.mark.parametrize("mode", ["global", "local", "semi"])
def test_batch_score_affine_plain_matches_jax(mode, k):
    rng = np.random.default_rng(721 + k + len(mode))
    # M not a multiple of 16: the score-only fill takes any width.
    texts, patterns, ns, ms = make_batch(rng, k, m_rows=45)
    sm = score_matrix(k)
    real = ns > 0
    for gap, ext in COSTS:
        ref = np.asarray(batch_score_pallas(
            texts, patterns, ns, ms, sm, gap, k_alpha=k, gap_extend=ext,
            interpret=True, **MODES[mode]))
        got = batch_fill.batch_score_plain(
            *tensors(texts, patterns, ns, ms, sm), gap, k, gap_extend=ext,
            **MODES[mode]).numpy()
        np.testing.assert_array_equal(got[real], ref[real])


def test_batch_fill_affine_on_cpu_runs_the_plain_version():
    rng = np.random.default_rng(731)
    args = tensors(*make_batch(rng, 4), score_matrix(4))
    before = (batch_fill.batch_score.launches,
              batch_fill.batch_fill_dirs.launches)
    got = batch_fill.batch_fill_dirs(*args, 8, 4, local=True, gap_extend=2)
    want = batch_fill.batch_fill_dirs_plain(*args, 8, 4, local=True,
                                            gap_extend=2)
    assert len(got) == 5
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    scores = batch_fill.batch_score(*args, 8, 4, local=True, gap_extend=2)
    assert torch.equal(scores, want[0])
    assert (batch_fill.batch_score.launches,
            batch_fill.batch_fill_dirs.launches) == before
    with pytest.raises(ValueError, match="gap >= gap_extend"):
        batch_fill.batch_score(*args, 1, 4, gap_extend=2)


def filled_affine(mode, seed):
    """JAX-filled words and run bits of a ragged DNA batch (padding pairs
    last) and the walk starts BatchAligner gives them."""
    rng = np.random.default_rng(seed)
    texts, patterns, ns, ms = make_batch(rng, 4)
    scores, bis, bjs, dirs, dirs2 = jax_dirs(texts, patterns, ns, ms,
                                             score_matrix(4), 4, 8, 2, mode)
    if mode == "local":
        bis = np.where(scores > 0, bis, 0).astype(np.int32)
        bjs = np.where(scores > 0, bjs, 0).astype(np.int32)
    return dirs, ns, ms, bis, bjs, dirs2


def port_walk(dirs, ns, ms, bis, bjs, dirs2, mode, max_len):
    out = batch_traceback.batch_walk_plain(
        *tensors(dirs, ns, ms, bis, bjs), mode == "local", mode == "semi",
        max_len, dirs2=torch.from_numpy(dirs2))
    return [x.numpy() for x in out]


@pytest.mark.parametrize("mode", ["global", "local", "semi"])
def test_batch_walk_affine_plain_matches_lockstep(mode):
    dirs, ns, ms, bis, bjs, dirs2 = filled_affine(mode, 741 + len(mode))
    max_len = -(-(N + M) // 16) * 16
    ref = batch_device_traceback(dirs, ns, ms, bis, bjs, max_len=max_len,
                                 dirs2=dirs2,
                                 **{"local": False, "semi": False,
                                    **MODES[mode]})
    got = port_walk(dirs, ns, ms, bis, bjs, dirs2, mode, max_len)
    assert got[1].max() > 16  # walks span several move words
    assert_same_walks(got, [np.asarray(x) for x in ref])
    # The run bits change walks: the linear walk over the same words
    # differs somewhere.
    linear = batch_traceback.batch_walk_plain(
        *tensors(dirs, ns, ms, bis, bjs), mode == "local", mode == "semi",
        max_len)
    assert not np.array_equal(linear[0].numpy(), got[0])


@pytest.mark.parametrize("mode", ["global", "local", "semi"])
def test_batch_walk_affine_plain_matches_pallas_walker_short_buffer(mode):
    # A 32-move buffer: longer walks stop there, as the TPU walker does.
    dirs, ns, ms, bis, bjs, dirs2 = filled_affine(mode, 751 + len(mode))
    ref = batch_pallas_traceback(dirs, ns, ms, bis, bjs, max_len=32,
                                 dirs2=dirs2, interpret=True,
                                 **{"local": False, "semi": False,
                                    **MODES[mode]})
    got = port_walk(dirs, ns, ms, bis, bjs, dirs2, mode, 32)
    assert (got[1] == 32).any()
    assert_same_walks(got, [np.asarray(x) for x in ref])


def test_batch_walk_affine_on_cpu_runs_the_plain_version():
    dirs, ns, ms, bis, bjs, dirs2 = filled_affine("semi", 761)
    args = tensors(dirs, ns, ms, bis, bjs)
    d2 = torch.from_numpy(dirs2)
    before = batch_traceback.batch_walk.launches
    got = batch_traceback.batch_walk(*args, False, True, 160, dirs2=d2)
    want = batch_traceback.batch_walk_plain(*args, False, True, 160,
                                            dirs2=d2)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert batch_traceback.batch_walk.launches == before
    with pytest.raises(ValueError, match="dirs2"):
        batch_traceback.batch_walk(*args, False, True, 160,
                                   dirs2=d2[:, :1].contiguous())


def assert_oracle_alignment(got, t, p, sm, k, gap, ext, mode):
    want = port_bindings.oracle_align_affine(ALGO[mode], t, p, sm, k, gap,
                                             ext)
    assert got.score == want[4]
    np.testing.assert_array_equal(got.aligned_text, want[0])
    np.testing.assert_array_equal(got.aligned_pattern, want[1])
    assert (got.start_in_aligned_text,
            got.start_in_aligned_pattern) == (want[2], want[3])


@pytest.mark.parametrize("mode", ["global", "local", "semi"])
def test_batch_aligner_affine_matches_jax_and_oracle(mode, monkeypatch):
    monkeypatch.setenv("SEQALIGN_ENGINE", "pallas_interpret")
    rng = np.random.default_rng(771 + len(mode))
    sm = score_matrix(4)
    texts, patterns = ragged_pairs(rng, 4, 8, hi=100)  # one bucket
    texts[2] = np.zeros(0, np.int32)
    patterns[5] = np.zeros(0, np.int32)
    port = BatchAligner(sm, 4, 8, gap_extend=2, device="cpu",
                        **MODES[mode])
    ref = JaxBatchAligner(sm, 4, 8, gap_extend=2,
                          mesh=mesh_lib.make_data_mesh(1), **MODES[mode])
    got = port.align(texts, patterns)
    want = ref.align(texts, patterns)
    for i, (t, p) in enumerate(zip(texts, patterns)):
        assert got[i].score == want[i].score, i
        np.testing.assert_array_equal(got[i].aligned_text,
                                      want[i].aligned_text)
        np.testing.assert_array_equal(got[i].aligned_pattern,
                                      want[i].aligned_pattern)
        assert (got[i].start_in_aligned_text,
                got[i].start_in_aligned_pattern) == (
            want[i].start_in_aligned_text, want[i].start_in_aligned_pattern)
        assert_oracle_alignment(got[i], t, p, sm, 4, 8, 2, mode)
    scores = port.score(texts, patterns)
    np.testing.assert_array_equal(scores, ref.score(texts, patterns))
    for i, (t, p) in enumerate(zip(texts, patterns)):
        if len(t) < len(p):
            t, p = p, t
        want_score, _ = port_bindings.oracle_fill_affine(ALGO[mode], t, p,
                                                         sm, 4, 8, 2)
        assert scores[i] == want_score, i


@pytest.mark.parametrize("mode", ["global", "local", "semi"])
def test_batch_aligner_affine_protein_matches_oracle(mode):
    # Two buckets (lengths across 128), an empty pair among them.
    rng = np.random.default_rng(781 + len(mode))
    sm = score_matrix(23)
    texts, patterns = ragged_pairs(rng, 23, 10)
    texts[4] = np.zeros(0, np.int32)
    port = BatchAligner(sm, 23, 11, gap_extend=1, device="cpu",
                        **MODES[mode])
    for r, t, p in zip(port.align(texts, patterns), texts, patterns):
        assert_oracle_alignment(r, t, p, sm, 23, 11, 1, mode)
    scores = port.score(texts, patterns, swap=False)
    for i, (t, p) in enumerate(zip(texts, patterns)):
        assert scores[i] == port_bindings.oracle_fill_affine(
            ALGO[mode], t, p, sm, 23, 11, 1)[0], i


def test_batch_aligner_affine_local_no_match():
    # Every substitution negative: empty alignments with the oracle's
    # cursors, score 0.
    sm = np.full((4, 4), -4, dtype=np.int32)
    texts = [np.zeros(40, np.int32), np.zeros(7, np.int32)]
    patterns = [np.ones(20, np.int32), np.full(9, 2, np.int32)]
    port = BatchAligner(sm, 4, 6, local=True, gap_extend=2, device="cpu")
    for r, t, p in zip(port.align(texts, patterns), texts, patterns):
        assert r.score == 0 and r.aligned_text.shape == (0,)
        assert_oracle_alignment(r, t, p, sm, 4, 6, 2, "local")
    np.testing.assert_array_equal(port.score(texts, patterns), [0, 0])


def test_batch_aligner_affine_chunks(monkeypatch):
    # Both word planes count against the chunk budget; cutting a bucket
    # into chunks of 128 pairs changes no output.
    sm = score_matrix(4)
    linear = BatchAligner(sm, 4, 5, device="cpu")
    affine = BatchAligner(sm, 4, 5, gap_extend=2, device="cpu")
    assert linear._dirs_tile_pairs(4096, 4096) == (128, 512)
    assert affine._dirs_tile_pairs(4096, 4096) == (128, 256)
    rng = np.random.default_rng(791)
    texts, patterns = ragged_pairs(rng, 4, 300, lo=20, hi=60)
    port = BatchAligner(sm, 4, 6, local=True, gap_extend=2, device="cpu")
    whole = port.align(texts, patterns)
    monkeypatch.setattr(port_batch, "PIPELINE_PAIRS", 1)
    assert port._dirs_tile_pairs(128, 128) == (128, 128)
    for a, b in zip(port.align(texts, patterns), whole):
        assert a.score == b.score
        np.testing.assert_array_equal(a.aligned_text, b.aligned_text)
        np.testing.assert_array_equal(a.aligned_pattern, b.aligned_pattern)
        assert (a.start_in_aligned_text, a.start_in_aligned_pattern) == (
            b.start_in_aligned_text, b.start_in_aligned_pattern)


def test_batch_aligner_affine_cpu_launches_no_kernel():
    rng = np.random.default_rng(801)
    texts, patterns = ragged_pairs(rng, 4, 4, hi=100)
    port = BatchAligner(score_matrix(4), 4, 8, gap_extend=2, device="cpu")
    before = (batch_fill.batch_score.launches,
              batch_fill.batch_fill_dirs.launches,
              batch_traceback.batch_walk.launches)
    port.score(texts, patterns)
    port.align(texts, patterns)
    assert (batch_fill.batch_score.launches,
            batch_fill.batch_fill_dirs.launches,
            batch_traceback.batch_walk.launches) == before


def gpu_request():
    request = Request()
    argv = ["alignSequence", "-g", "data/dna/dna_01.txt",
            "data/dna/dna_02.txt"]
    assert cli.parse_arguments(argv, request) == 0
    return request


def run_gpu_engine_raising(monkeypatch, error):
    """``api.align`` of a ``-g`` request on a host that reports a CUDA
    device, with the engine raising ``error``: (rc, stderr)."""
    class Raising:
        def align(self, *args, **kwargs):
            raise error

    monkeypatch.delenv("SEQALIGN_TORCH_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(port_models, "aligner_for", lambda _type: Raising())
    err = io.StringIO()
    rc = api.align(gpu_request(), Response(), err=err)
    return rc, err.getvalue()


@pytest.mark.parametrize("message", [
    "CUDA error: out of memory\nCUDA kernel errors might be asynchronously "
    "reported at some other API call",
    "interpair kernel launch failed: cudaErrorMemoryAllocation: out of "
    "memory (cudaError_t 2)",
    "CUDA error: CUDA-capable device(s) is/are busy or unavailable",
    "batch_walk kernel launch failed: cudaErrorDevicesUnavailable: "
    "CUDA-capable device(s) is/are busy or unavailable (cudaError_t 46)",
    "RESOURCE_EXHAUSTED: Out of memory while trying to allocate "
    "137438953472 bytes.",
    "Unable to initialize backend 'cuda': no device",
], ids=["torch-oom", "launch-oom", "busy", "launch-unavailable",
        "resource-exhausted", "backend"])
def test_device_runtime_error_maps_to_mem_error(monkeypatch, message):
    rc, err = run_gpu_engine_raising(monkeypatch, RuntimeError(message))
    assert (rc, err) == (1, constants.MEM_ERROR)


def test_other_runtime_error_still_raises(monkeypatch):
    with pytest.raises(RuntimeError, match="misaligned"):
        run_gpu_engine_raising(
            monkeypatch, RuntimeError("CUDA error: misaligned address"))


def test_launch_failure_names_its_cuda_error(monkeypatch):
    # check_launch reads the error's name and text from the library whose
    # launch failed (sa_error_text, csrc/launch_error.cuh); here a stand-in
    # library answers as the CUDA runtime does for code 2.
    class ErrorText:
        argtypes = None

        def __call__(self, code, out, size):
            text = b"cudaErrorMemoryAllocation: out of memory"[:size - 1]
            ctypes.memmove(out, text + b"\0", len(text) + 1)
            return len(text)

    class Library:
        sa_error_text = ErrorText()

    monkeypatch.setattr(_build, "library", lambda name: Library())
    _build.check_launch("interpair", 0)
    with pytest.raises(RuntimeError) as failed:
        _build.check_launch("interpair", 2)
    message = str(failed.value)
    assert message == ("interpair kernel launch failed: "
                       "cudaErrorMemoryAllocation: out of memory "
                       "(cudaError_t 2)")
    rc, err = run_gpu_engine_raising(monkeypatch, failed.value)
    assert (rc, err) == (1, constants.MEM_ERROR)
