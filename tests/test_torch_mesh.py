"""The port's mesh (seqalign_torch.parallel.mesh) and the batch over it:
``sharded_batch_score`` and ``BatchAligner(mesh=...)`` on meshes of 1, 2,
3 and 8 CPU entries against the port on one device, the JAX functions on
their 8-device virtual mesh (Pallas in interpreter mode) and the native
oracle.  Exact comparisons."""

import contextlib
import functools
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seqalign_torch import config
from seqalign_torch.native import bindings as port_bindings
from seqalign_torch.parallel import BatchAligner, DataMesh, dryrun
from seqalign_torch.parallel import batch as port_batch
from seqalign_torch.parallel import mesh as port_mesh
from seqalign_tpu.parallel import mesh as jax_mesh
from seqalign_tpu.parallel.batch import BatchAligner as JaxBatchAligner
from seqalign_tpu.parallel.batch import (
    sharded_batch_score as jax_sharded_batch_score)

from .torch_support import one_torch_thread, score_matrix  # noqa: F401

SIZES = (1, 2, 3, 8)
# (oracle algo, BatchAligner keywords, affine extend cost)
MODES = {
    "global": (0, {}, None), "local": (1, {"local": True}, None),
    "semi": (2, {"semi": True}, None),
    "affine-global": (0, {}, 2), "affine-local": (1, {"local": True}, 2),
    "affine-semi": (2, {"semi": True}, 2),
}
GAP = 5


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("SEQALIGN_ENGINE", "pallas_interpret")


def cpu_mesh(k):
    return DataMesh(["cpu"] * k)


def one_bucket_pairs(seed, count=14):
    """Ragged DNA pairs of one score bucket and one align bucket (every
    length below 127), an empty text among them."""
    rng = np.random.default_rng(seed)
    texts = [rng.integers(0, 4, int(rng.integers(20, 120))).astype(np.int32)
             for _ in range(count)]
    patterns = [rng.integers(0, 4, int(rng.integers(20, 120)))
                .astype(np.int32) for _ in range(count)]
    texts[4] = np.zeros(0, np.int32)
    return texts, patterns


def oracle(mode, t, p, align):
    algo, _, ext = MODES[mode]
    sm = score_matrix(4)
    if align:
        return (port_bindings.oracle_align_affine(algo, t, p, sm, 4, GAP, ext)
                if ext else port_bindings.oracle_align(algo, t, p, sm, 4, GAP))
    if ext:
        return port_bindings.oracle_fill_affine(algo, t, p, sm, 4, GAP,
                                                ext)[0]
    return port_bindings.oracle_fill(algo, t, p, sm, 4, GAP)[1]


def aligner(mode, **where):
    _, kw, ext = MODES[mode]
    return BatchAligner(score_matrix(4), 4, GAP, gap_extend=ext, **where,
                        **kw)


@functools.lru_cache(maxsize=None)
def reference(mode):
    """(pairs, JAX scores, JAX alignments on the 8-device virtual mesh,
    the port's scores and alignments on one device) of a mode."""
    texts, patterns = one_bucket_pairs(700 + len(mode))
    _, kw, ext = MODES[mode]
    jax_aligner = JaxBatchAligner(score_matrix(4), 4, GAP, gap_extend=ext,
                                  mesh=jax_mesh.make_data_mesh(8), **kw)
    one = aligner(mode, device="cpu")
    return ((texts, patterns), jax_aligner.score(texts, patterns),
            jax_aligner.align(texts, patterns), one.score(texts, patterns),
            one.align(texts, patterns))


def assert_same(got, want):
    assert got.score == want.score
    np.testing.assert_array_equal(got.aligned_text, want.aligned_text)
    np.testing.assert_array_equal(got.aligned_pattern, want.aligned_pattern)
    assert (got.start_in_aligned_text, got.start_in_aligned_pattern) == (
        want.start_in_aligned_text, want.start_in_aligned_pattern)


@pytest.mark.parametrize("k", SIZES)
@pytest.mark.parametrize("mode", list(MODES))
def test_batch_aligner_on_mesh_matches_one_device_jax_and_oracle(mode, k):
    (texts, patterns), jax_scores, jax_aligned, one_scores, one_aligned = (
        reference(mode))
    port = aligner(mode, mesh=cpu_mesh(k))
    scores = port.score(texts, patterns)
    np.testing.assert_array_equal(scores, one_scores)
    np.testing.assert_array_equal(scores, jax_scores)
    for i, (t, p) in enumerate(zip(texts, patterns)):
        if len(t) < len(p):
            t, p = p, t
        assert scores[i] == oracle(mode, t, p, align=False), i
    aligned = port.align(texts, patterns)
    for i, (t, p) in enumerate(zip(texts, patterns)):
        assert_same(aligned[i], one_aligned[i])
        assert_same(aligned[i], jax_aligned[i])
        at, ap, st, sp, score = oracle(mode, t, p, align=True)
        assert aligned[i].score == score
        np.testing.assert_array_equal(aligned[i].aligned_text, at)
        np.testing.assert_array_equal(aligned[i].aligned_pattern, ap)
        assert (aligned[i].start_in_aligned_text,
                aligned[i].start_in_aligned_pattern) == (st, sp)


@functools.lru_cache(maxsize=None)
def score_batch():
    """24 full-length DNA pairs of 64 x 64 (24 splits over 1, 2, 3 and 8
    entries)."""
    rng = np.random.default_rng(717)
    texts = rng.integers(0, 4, (24, 64)).astype(np.int32)
    patterns = rng.integers(0, 4, (24, 64)).astype(np.int32)
    return texts, patterns, np.full(24, 64, np.int32)


@functools.lru_cache(maxsize=None)
def jax_scores(mode):
    texts, patterns, lengths = score_batch()
    _, kw, ext = MODES[mode]
    return np.asarray(jax_sharded_batch_score(
        jax_mesh.make_data_mesh(8), jnp.asarray(texts), jnp.asarray(patterns),
        jnp.asarray(lengths), jnp.asarray(lengths),
        jnp.asarray(score_matrix(4)), GAP, gap_extend=ext, **kw))


@pytest.mark.parametrize("k", SIZES)
@pytest.mark.parametrize("mode", list(MODES))
def test_sharded_batch_score_matches_jax_and_oracle(mode, k):
    texts, patterns, lengths = score_batch()
    _, kw, ext = MODES[mode]
    got = port_batch.sharded_batch_score(
        cpu_mesh(k), texts.astype(np.int8), patterns.astype(np.int8),
        lengths, lengths, score_matrix(4), GAP, gap_extend=ext, **kw)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, jax_scores(mode))
    assert got.tolist() == [oracle(mode, t, p, align=False)
                            for t, p in zip(texts, patterns)]


def test_align_in_chunks_over_a_mesh(monkeypatch):
    # PIPELINE_PAIRS 1: a chunk is one tile an entry, so 300 pairs on 3
    # entries run as one chunk of 384 pairs, the last entry's block part
    # padding; on 8 entries the last blocks are all padding and get no
    # work.  Every alignment equals the one-device run's.
    rng = np.random.default_rng(733)
    texts = [rng.integers(0, 4, int(rng.integers(20, 60))).astype(np.int32)
             for _ in range(300)]
    patterns = [rng.integers(0, 4, int(rng.integers(20, 60)))
                .astype(np.int32) for _ in range(300)]
    whole = aligner("local", device="cpu").align(texts, patterns)
    monkeypatch.setattr(port_batch, "PIPELINE_PAIRS", 1)
    for k in (3, 8):
        port = aligner("local", mesh=cpu_mesh(k))
        assert port._dirs_tile_pairs(128, 128, k) == (128, 128 * k)
        for a, b in zip(port.align(texts, patterns), whole):
            assert_same(a, b)


def test_dirs_tile_pairs_scale_with_the_mesh():
    port = aligner("local", device="cpu")
    # One entry: today's chunks (tests/test_torch_batch_affine.py).
    assert port._dirs_tile_pairs(4096, 4096) == (128, 512)
    # Each entry keeps its own words under the budget.
    assert port._dirs_tile_pairs(4096, 4096, 4) == (128, 2048)
    # PIPELINE_PAIRS bounds a chunk, rounded up to a tile an entry.
    assert port._dirs_tile_pairs(128, 128, 3) == (128, 16512)


def test_mesh_rows_and_shards():
    mesh = DataMesh(["cpu"] * 2, rank=1, world_size=3)
    assert (mesh.size, mesh.local_size, mesh.first) == (6, 2, 2)
    assert mesh.rows(24, 0) == slice(8, 12)
    assert mesh.rows(24, 1) == slice(12, 16)
    assert mesh.local_rows(24) == slice(8, 16)
    with pytest.raises(ValueError, match="does not split"):
        mesh.rows(25, 0)
    assert mesh.streams == (None, None)
    with pytest.raises(ValueError, match="at least one device"):
        DataMesh([])


def test_make_data_mesh_defaults(monkeypatch):
    monkeypatch.setenv(config.DEVICE_ENV, "cpu")
    mesh = port_mesh.make_data_mesh()
    assert mesh.devices == (torch.device("cpu"),)
    assert (mesh.rank, mesh.world_size) == (0, 1)
    monkeypatch.setattr(config, "mesh_devices",
                        lambda default=None: ["cpu"] * 8)
    assert port_mesh.make_data_mesh().size == 8
    assert port_mesh.make_data_mesh(3).size == 3
    assert BatchAligner(score_matrix(4), 4, GAP).mesh.size == 8
    assert port_mesh.make_data_mesh(
        devices=["cpu", "cpu"]).devices == (torch.device("cpu"),) * 2


def test_mesh_devices_of_the_engine_device(monkeypatch):
    # "cuda" spans every visible card; a named card or the CPU is a mesh
    # of one entry.
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    monkeypatch.delenv(config.DEVICE_ENV, raising=False)
    assert config.mesh_devices() == ["cuda:0", "cuda:1", "cuda:2"]
    assert config.mesh_devices(torch.device("cuda")) == \
        ["cuda:0", "cuda:1", "cuda:2"]
    assert config.mesh_devices("cuda:1") == ["cuda:1"]
    assert config.mesh_devices(torch.device("cuda", 2)) == ["cuda:2"]
    assert config.mesh_devices("cpu") == ["cpu"]
    monkeypatch.setenv(config.DEVICE_ENV, "cpu")
    assert config.mesh_devices() == ["cpu"]


def test_no_cuda_device_is_refused(monkeypatch):
    # The default CUDA mesh on a host without CUDA: no device, no
    # fallback to the CPU (the message maps to MEM_ERROR on -g).
    monkeypatch.delenv(config.DEVICE_ENV, raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert config.mesh_devices() == []
    with pytest.raises(RuntimeError, match="unavailable"):
        port_mesh.make_data_mesh()


def test_mesh_or_device_not_both():
    with pytest.raises(ValueError, match="not both"):
        BatchAligner(score_matrix(4), 4, GAP, mesh=cpu_mesh(2), device="cpu")


def test_hand_over_on_the_cpu():
    mesh = cpu_mesh(2)
    x = torch.arange(5, dtype=torch.int32)
    assert torch.equal(mesh.hand_over(x, 0, 1), x)
    assert torch.equal(mesh.hand_over(x, 1), x)
    assert torch.equal(mesh.all_gather(x), x)
    with mesh.on(1):
        mesh.synchronize()


def test_maybe_initialize_distributed_is_a_no_op_without_torchrun(
        monkeypatch):
    for name in port_mesh.TORCHRUN_ENV:
        monkeypatch.delenv(name, raising=False)
    assert port_mesh.maybe_initialize_distributed() is False


@pytest.mark.parametrize("forced,device,cards,want", [
    ("1", "cpu", 0, True), ("0", "cuda", 8, False), ("", "cuda", 8, True),
    ("", "cpu", 8, False), ("", "cuda:1", 8, False), ("", "cuda", 1, False)])
def test_sequence_parallel_gate(monkeypatch, forced, device, cards, want):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setenv("SEQALIGN_SEQUENCE_PARALLEL", forced)
    assert config.sequence_parallel(device) is want


def test_dryrun_on_a_cpu_mesh():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert dryrun.main(["3", "--device", "cpu"]) == 0
    assert out.getvalue().strip() == "dryrun ok"
