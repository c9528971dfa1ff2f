"""The port's sequence-parallel fills (seqalign_torch.parallel.sequence)
on meshes of CPU entries, where every kernel runs its plain version,
against the JAX functions on their 8-device virtual mesh (Pallas in
interpreter mode), the port's single-device checkpoint engine and the
native oracle; and the long-pair route of ``-g`` that takes them.  All
outputs are integers: every comparison is exact."""

import contextlib
import io

import numpy as np
import pytest
import torch

from seqalign_torch import cli as port_cli
from seqalign_torch import config
from seqalign_torch.native import bindings as port_bindings
from seqalign_torch.ops import checkpoint as port_ck
from seqalign_torch.ops import strip_fill
from seqalign_torch.parallel import DataMesh
from seqalign_torch.parallel import mesh as port_mesh
from seqalign_torch.parallel import sequence as port_seq
from seqalign_tpu.parallel import sequence as jax_seq

from .torch_support import one_torch_thread  # noqa: F401

SM = np.where(np.eye(4, dtype=bool), 5, -4).astype(np.int32)
# (oracle algo, keywords, gap): linear costs gap 5, affine open 6 extend 2.
MODES = {
    "global": (0, {}, 5), "local": (1, {"local": True}, 5),
    "semi": (2, {"semi": True}, 5),
    "affine": (0, {"gap_extend": 2}, 6),
    "affine-semi": (2, {"semi": True, "gap_extend": 2}, 6),
}
# 3 strips of 128 rows and 5 chunks of 512 columns (one checkpoint a
# chunk: 768 steps).
GEOM = dict(rps=1, slots=128, ckpt_cols=512)
N, M = 2300, 300


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("SEQALIGN_ENGINE", "pallas_interpret")


def pair(seed, n=N, m=M):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 4, n).astype(np.int32),
            rng.integers(0, 4, m).astype(np.int32))


def oracle_alignment(mode, text, pattern):
    algo, kw, gap = MODES[mode]
    if "gap_extend" in kw:
        return port_bindings.oracle_align_affine(algo, text, pattern, SM, 4,
                                                 gap, kw["gap_extend"])
    return port_bindings.oracle_align(algo, text, pattern, SM, 4, gap)


def assert_traceback_is_oracle(ck, mode, text, pattern):
    at, ap, st, sp = port_ck.checkpointed_traceback(ck, text, pattern, SM, 4)
    oat, oap, ost, osp, score = oracle_alignment(mode, text, pattern)
    assert ck.score == score
    np.testing.assert_array_equal(at, oat)
    np.testing.assert_array_equal(ap, oap)
    assert (st, sp) == (ost, osp)


FIELDS = ("colvals", "boundaries", "colvals_e", "boundaries_f")


def assert_same_fill(got, want):
    for name in ("score", "best_i", "best_j", "n", "m", "rows", "rps",
                 "ckpt_cols", "gap", "local", "semi", "gap_extend"):
        assert getattr(got, name) == getattr(want, name), name
    for name in FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None), name
        for x, y in zip(a or [], b or []):
            assert torch.equal(x, y), name


def assert_checkpoint_engine_values(got, want, n):
    """The sequence-parallel fill against ``checkpointed_fill`` at the
    same geometry: the score, the best cell, and every boundary value the
    single-device fill defines: the bottom rows' first n entries and the
    checkpoints of columns <= n."""
    assert (got.score, got.best_i, got.best_j) == (want.score, want.best_i,
                                                   want.best_j)
    whole = n // got.ckpt_cols
    for cols, rows in (("colvals", "boundaries"),
                       ("colvals_e", "boundaries_f")):
        if getattr(want, cols) is None:
            assert getattr(got, cols) is None
            continue
        assert len(getattr(got, cols)) == len(getattr(want, cols))
        for a, b in zip(getattr(got, cols), getattr(want, cols)):
            assert torch.equal(a[:whole], b[:whole]), cols
        for a, b in zip(getattr(got, rows), getattr(want, rows)):
            assert torch.equal(a[:n], b[:n]), rows


@pytest.mark.parametrize("mode", list(MODES))
def test_checkpointed_fill_matches_jax_checkpoint_engine_and_oracle(mode):
    text, pattern = pair(801 + len(mode))
    _, kw, gap = MODES[mode]
    want = port_ck.from_reference_fill(
        jax_seq.sequence_parallel_checkpointed_fill(
            text, pattern, SM, 4, gap, **GEOM, **kw), "cpu")
    single = port_ck.checkpointed_fill(text, pattern, SM, 4, gap,
                                       device="cpu", **GEOM, **kw)
    got = port_seq.sequence_parallel_checkpointed_fill(
        text, pattern, SM, 4, gap, mesh=DataMesh(["cpu"] * 4), **GEOM, **kw)
    assert_same_fill(got, want)
    assert_checkpoint_engine_values(got, single, N)
    assert_traceback_is_oracle(got, mode, text, pattern)


@pytest.mark.parametrize("mode", ["global", "local", "affine-semi"])
def test_checkpointed_fill_keeps_a_chunks_first_checkpoint(mode):
    # 256 columns a chunk over 128 slots: 512 steps, room for two
    # checkpoints, of which the chunk's right column is the first.  One
    # strip (m <= 128), many chunks: the left column carried alone.
    text, pattern = pair(821 + len(mode), n=1500, m=120)
    _, kw, gap = MODES[mode]
    geom = dict(rps=1, slots=128, ckpt_cols=256)
    got = port_seq.sequence_parallel_checkpointed_fill(
        text, pattern, SM, 4, gap, mesh=DataMesh(["cpu"] * 2), **geom, **kw)
    assert got.colvals[0].shape == (6, 128)
    assert got.boundaries[0].shape == (6 * 256,)
    single = port_ck.checkpointed_fill(text, pattern, SM, 4, gap,
                                       device="cpu", **geom, **kw)
    assert_checkpoint_engine_values(got, single, 1500)
    assert_traceback_is_oracle(got, mode, text, pattern)


def test_checkpointed_fill_refuses_more_strips_than_entries():
    text, pattern = pair(831)
    with pytest.raises(ValueError, match="3 strips of 128 rows"):
        port_seq.sequence_parallel_checkpointed_fill(
            text, pattern, SM, 4, 5, mesh=DataMesh(["cpu"] * 2), **GEOM)


def test_pipelines_refuse_a_mesh_across_processes():
    text, pattern = pair(833, n=600, m=100)
    mesh = DataMesh(["cpu"], rank=0, world_size=2)
    with pytest.raises(ValueError, match="one process"):
        port_seq.sequence_parallel_checkpointed_fill(
            text, pattern, SM, 4, 5, mesh=mesh, **GEOM)
    with pytest.raises(ValueError, match="one process"):
        port_seq.sequence_parallel_fill(text, pattern, SM, 4, 5, mesh=mesh)


def words_to_dirs(words, n, m):
    rows = np.arange(1, m + 1)
    w = words[(rows - 1) // 16]
    return ((w >> (2 * ((rows - 1) % 16))[:, None]) & 3)[:, :n]


@pytest.mark.parametrize("local", [False, True])
def test_sequence_parallel_fill_matches_jax_and_oracle(local):
    # 8 strips of 2,048 columns, 3 row blocks: 10 supersteps (the JAX
    # test's shape).
    text, pattern = pair(841 + local, n=10000, m=300)
    want = jax_seq.sequence_parallel_fill(text, pattern, SM, 4, 5,
                                          local=local, with_dirs=True)
    got = port_seq.sequence_parallel_fill(
        text, pattern, SM, 4, 5, local=local, with_dirs=True,
        mesh=DataMesh(["cpu"] * 8))
    assert got[:3] == tuple(int(x) for x in want[:3])
    np.testing.assert_array_equal(got[3], want[3])
    odirs, oscore, obest = port_bindings.oracle_fill(
        int(local), text, pattern, SM, 4, 5)
    assert got[0] == oscore
    if local:
        assert got[1:3] == (obest // 10001, obest % 10001)
    np.testing.assert_array_equal(words_to_dirs(got[3], 10000, 300),
                                  odirs[1:, 1:])


@pytest.mark.parametrize("local", [False, True])
def test_sequence_parallel_fill_in_pieces(monkeypatch, local):
    # Strips wider than one K5 region run as pieces: 3 entries of 3,072
    # columns, regions of at most 2,048, blocks of 128 rows.
    monkeypatch.setattr(strip_fill, "MAX_STRIP_COLS", 2048)
    text, pattern = pair(851 + local, n=8500, m=260)
    score, bi, bj, words = port_seq.sequence_parallel_fill(
        text, pattern, SM, 4, 3, local=local, with_dirs=True,
        mesh=DataMesh(["cpu"] * 3))
    odirs, oscore, obest = port_bindings.oracle_fill(
        int(local), text, pattern, SM, 4, 3)
    assert score == oscore
    assert (bi, bj) == ((obest // 8501, obest % 8501) if local
                        else (260, 8500))
    assert words.shape == (384 // 16, 9216)
    np.testing.assert_array_equal(words_to_dirs(words, 8500, 260),
                                  odirs[1:, 1:])
    at, ap, st, sp = port_bindings.traceback_packed(int(local), words, text,
                                                    pattern, 4, best_i=bi,
                                                    best_j=bj)
    oat, oap, ost, osp, _ = port_bindings.oracle_align(int(local), text,
                                                       pattern, SM, 4, 3)
    np.testing.assert_array_equal(at, oat)
    np.testing.assert_array_equal(ap, oap)
    assert (st, sp) == (ost, osp)


def test_merge_states_matches_jax():
    rng = np.random.default_rng(861)
    for local in (False, True):
        for _ in range(20):
            states = rng.integers(-3, 4, (5, 4)).astype(np.int32)
            assert port_seq._merge_states(states, local, 9, 7) == \
                jax_seq._merge_states(states, local, 9, 7)


def test_estimated_speedup_matches_jax():
    for n in (1000, 32768, 50000, 280482, 1_000_000):
        for m in (100, 36864, 48632, 202437, 500000):
            for d in (1, 2, 4, 8):
                assert port_seq.estimated_speedup(
                    n, m, d, overhead_steps=0) == \
                    jax_seq.estimated_speedup(n, m, d), (n, m, d)
    assert port_seq.estimated_speedup(1000, 200000, 2) == 0.0


def test_gate_keeps_the_long_pair_on_one_card():
    # The long pair (211,518 x 202,437: 4 strips, 7 chunks) on four cards:
    # the step count alone says 2.34x; with each chunk's measured cost the
    # pipeline does not beat one card, so the route stays closed.
    n, m = 211518, 202437
    assert port_seq.estimated_speedup(n, m, 4, overhead_steps=0) == \
        pytest.approx(2.3396, abs=1e-4)
    assert port_seq.estimated_speedup(n, m, 4) < port_seq.ROUTE_SPEEDUP
    assert port_seq.estimated_speedup(n, m, 4) == \
        port_seq.estimated_speedup(
            n, m, 4, overhead_steps=port_seq.PIPE_CHUNK_OVERHEAD_STEPS)


def write_pair(tmp_path, seed, n, m):
    text, pattern = pair(seed, n=n, m=m)
    paths = []
    for name, seq in (("text.txt", text), ("pattern.txt", pattern)):
        path = tmp_path / name
        path.write_text("".join("ACGT"[x] for x in seq) + "\n")
        paths.append(str(path))
    return paths


def run_cli(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = port_cli.main(["alignSequence", *argv])
    return rc, out.getvalue()


@pytest.fixture
def small_mesh_route(monkeypatch):
    """-g on the CPU with a default mesh of 8 entries, every long pair
    past the wavefront route, and the checkpoint geometry cut to 128-row
    strips and 512-column chunks.  Returns the list of the calls of
    ``sequence_parallel_checkpointed_fill``."""
    monkeypatch.setenv(config.DEVICE_ENV, "cpu")
    monkeypatch.setattr(config, "mesh_devices",
                        lambda default=None: ["cpu"] * 8)
    monkeypatch.setattr(config, "MAX_HOST_DIRS_BYTES", 1)
    monkeypatch.setattr(port_ck, "DEFAULT_CKPT_RPS", 1)
    monkeypatch.setattr(port_ck, "DEFAULT_CKPT_SLOTS", 128)
    monkeypatch.setattr(port_ck, "DEFAULT_CKPT_COLS", 512)
    calls = []
    real = port_seq.sequence_parallel_checkpointed_fill

    def spy(*args, **kwargs):
        calls.append(kwargs["mesh"].size)
        return real(*args, **kwargs)

    monkeypatch.setattr(port_seq, "sequence_parallel_checkpointed_fill", spy)
    return calls


@pytest.mark.parametrize("flags", [
    ["--global"], ["--local"], ["--semi-global"],
    ["--gap-penalty", "8", "--gap-extend", "2"],
    ["--semi-global", "--gap-penalty", "8", "--gap-extend", "2"]],
    ids=["global", "local", "semi", "affine", "affine-semi"])
def test_g_takes_the_sequence_parallel_route(tmp_path, monkeypatch, flags,
                                             small_mesh_route):
    # 1,200 x 900: 8 strips on the 8 entries, 3 chunks.
    argv = [*flags, *write_pair(tmp_path, 871, 1200, 900)]
    want = run_cli(["-c", *argv])
    for forced, calls in (("1", [8]), ("0", [])):
        monkeypatch.setenv("SEQALIGN_SEQUENCE_PARALLEL", forced)
        small_mesh_route.clear()
        got = run_cli(["-g", *argv])
        assert small_mesh_route == calls
        assert got == want
        assert want[0] == 0 and "# Score:" in want[1]


@pytest.mark.parametrize("overhead,taken", [(0, True), (None, False)],
                         ids=["steps-alone", "measured-chunk-cost"])
def test_unforced_route_follows_the_gate(tmp_path, monkeypatch,
                                         small_mesh_route, overhead, taken):
    # 1,200 x 900 on 8 entries: 8 x 1,328 single-device steps against 10
    # chunk fills of 640 steps, 1.66x by steps alone; with the measured
    # chunk cost the pipeline loses and the pair keeps one device.
    monkeypatch.delenv("SEQALIGN_SEQUENCE_PARALLEL", raising=False)
    if overhead is not None:
        monkeypatch.setattr(port_seq, "PIPE_CHUNK_OVERHEAD_STEPS", overhead)
    assert (port_seq.estimated_speedup(1200, 900, 8, 512)
            >= port_seq.ROUTE_SPEEDUP) is taken
    argv = ["--local", *write_pair(tmp_path, 891, 1200, 900)]
    assert run_cli(["-g", *argv]) == run_cli(["-c", *argv])
    assert small_mesh_route == ([8] if taken else [])


def test_route_needs_strips_that_fit_the_mesh(tmp_path, monkeypatch,
                                              small_mesh_route):
    # 1,100 pattern rows need 9 strips of 128: past the 8 entries, the
    # pair keeps the single-device routes even when forced.
    monkeypatch.setenv("SEQALIGN_SEQUENCE_PARALLEL", "1")
    argv = ["--local", *write_pair(tmp_path, 881, 1200, 1100)]
    assert run_cli(["-g", *argv]) == run_cli(["-c", *argv])
    assert small_mesh_route == []


def test_route_is_not_taken_in_a_process_group(tmp_path, monkeypatch,
                                               small_mesh_route):
    # Ranks of a process group align pairs of their own: a long pair
    # keeps its rank's device and builds no mesh, even when forced.
    monkeypatch.setenv("SEQALIGN_SEQUENCE_PARALLEL", "1")
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)

    def no_mesh(*args, **kwargs):
        raise AssertionError("a mesh was built in a process group")

    monkeypatch.setattr(port_mesh, "make_data_mesh", no_mesh)
    argv = ["--global", *write_pair(tmp_path, 901, 1200, 900)]
    assert run_cli(["-g", *argv]) == run_cli(["-c", *argv])
    assert small_mesh_route == []
