"""The database search on the CPU: ``BatchAligner.search`` over a
``Database`` (``seqalign_torch/parallel/search.py``, K3's plain version in
the search layout and K1's for the tail) against the plain reference of
the benchmark (``cellbench/reference/affine.py``), the native oracle and
per-pair ``BatchAligner.score``, on seeded random protein sequences at a
small size; and that reference on hand-worked Gotoh cases.  Every output
is an integer: the comparisons are exact."""

import numpy as np
import pytest
import torch

from cellbench.reference import affine
from seqalign_torch import tracing
from seqalign_torch.native import bindings
from seqalign_torch.ops import batch_fill
from seqalign_torch.parallel import BatchAligner, Database
from seqalign_torch.parallel import search as search_lib
from seqalign_torch.parallel.batch import cell16_for

from .torch_support import one_torch_thread, score_matrix  # noqa: F401

K = 23
GAP, EXT = 12, 2  # CUDASW++'s open 10, extend 2: a gap of k costs 10 + 2k
ALGO = {"global": 0, "local": 1, "semi": 2}
MODES = {"global": {}, "local": {"local": True}, "semi": {"semi": True}}


def ragged_database(seed, count=90, longest=150):
    """Protein sequences of ragged lengths: empty ones, one-letter ones,
    and mutated copies of a shared stretch (scores well above zero)."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(2, longest, size=count)
    lengths[:4] = (0, 1, 1, 0)
    seqs = [rng.integers(0, 20, size=int(n)).astype(np.int8)
            for n in lengths]
    core = rng.integers(0, 20, size=40).astype(np.int8)
    for i in range(4, count, 9):
        seqs[i] = np.concatenate([seqs[i][:5], core[3:20], core[23:],
                                  seqs[i][5:9]])
    return seqs, core


def query_of(seed, core, m):
    rng = np.random.default_rng(seed + 1000)
    q = rng.integers(0, 20, size=m).astype(np.int8)
    q[m // 4:m // 4 + min(len(core), m - m // 4)] = core[:m - m // 4]
    return q


def oracle(seqs, query, mode="local", gap=GAP, ext=EXT, sm=None):
    sm = score_matrix(K) if sm is None else sm
    if ext is None:
        return np.array([bindings.oracle_fill(ALGO[mode], s, query, sm, K,
                                              gap)[1] for s in seqs])
    return np.array([bindings.oracle_fill_affine(ALGO[mode], s, query, sm, K,
                                                 gap, ext)[0] for s in seqs])


def aligner(mode="local", gap=GAP, ext=EXT, **kw):
    return BatchAligner(score_matrix(K), K, gap, gap_extend=ext,
                        **MODES[mode], **kw)


@pytest.mark.parametrize("m", [1, 2, 17, 40, 71])
def test_search_equals_the_reference_the_oracle_and_score(m):
    seqs, core = ragged_database(1)
    query = query_of(1, core, m)
    al = aligner(device="cpu")
    got = al.search(query, al.database(seqs))
    assert got.dtype == np.int32 and got.shape == (len(seqs),)
    want = oracle(seqs, query)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, affine.local_scores(seqs, query, score_matrix(K), GAP, EXT))
    np.testing.assert_array_equal(
        got, al.score(seqs, [query] * len(seqs), swap=False))
    assert m < 40 or got.max() > 40  # the planted stretch, with a gap


@pytest.mark.parametrize("mode,gap,ext", [("local", 12, 2),
                                          ("local", 6, None),
                                          ("global", 12, 2),
                                          ("global", 6, None),
                                          ("semi", 12, 2),
                                          ("semi", 6, None)])
def test_search_every_mode_equals_the_oracle(mode, gap, ext):
    seqs, core = ragged_database(2, count=60)
    query = query_of(2, core, 33)
    al = aligner(mode, gap, ext, device="cpu")
    np.testing.assert_array_equal(al.search(query, al.database(seqs)),
                                  oracle(seqs, query, mode, gap, ext))


@pytest.mark.parametrize("tail", [60, 100, 149])
def test_sequences_above_the_tail_threshold_take_k1(monkeypatch, tail):
    monkeypatch.setattr(search_lib, "TAIL_LETTERS", tail)
    seqs, core = ragged_database(3, count=50, longest=180)
    seqs.append(np.concatenate([seqs[4], seqs[5], seqs[6]]))
    query = query_of(3, core, 30)
    al = aligner(device="cpu")
    db = al.database(seqs)
    lengths = np.array([len(s) for s in seqs])
    np.testing.assert_array_equal(db.tail, np.flatnonzero(lengths > tail))
    with tracing.recording() as rec:
        got = al.search(query, db)
    assert rec.counters["search.tail_pairs"] == len(db.tail) > 0
    np.testing.assert_array_equal(got, oracle(seqs, query))


def test_tail_geometry_keeps_the_strip_to_the_query():
    for m in (1, 144, 512, 4096, 5147, 16384, 40000):
        rps, slots = search_lib.tail_geometry(m)
        assert rps in (4, 8, 16) and slots % 128 == 0 and slots <= 1024
        if m <= 16384:
            assert m <= rps * slots < max(m, 128 * rps) + 128 * rps


# A 23-letter matrix of max|sub| 100: the local int16 gate's edge at
# 15,800 falls at a width of 158 (a query of rows >= 158).
SM100 = np.where(np.eye(K, dtype=bool), 100, -30).astype(np.int32)


@pytest.mark.parametrize("cells,mode", [("auto", "global"), ("0", "local")],
                         ids=["auto", "0"])
def test_buckets_on_both_sides_of_cell16_for(monkeypatch, cells, mode):
    """Short groups take the int16 cells and long ones int32, two
    launches, on both sides of the gate: a global search's gate is
    ``cell16_for`` (under ``auto``; BLOSUM62), a local search's
    ``int16_local_ok`` whatever ``SEQALIGN_INT16_CELLS`` says (under
    ``0``; max|sub| 100, the edge at 158)."""
    monkeypatch.setenv("SEQALIGN_INT16_CELLS", cells)
    rng = np.random.default_rng(4)
    lengths = np.concatenate([rng.integers(1, 60, size=70),
                              rng.integers(900, 960, size=70)])
    seqs = [rng.integers(0, 20, size=int(n)).astype(np.int8)
            for n in lengths]
    query = rng.integers(0, 20, size=300).astype(np.int8)
    sm = score_matrix(K) if mode == "global" else SM100
    al = BatchAligner(sm, K, GAP, gap_extend=EXT, device="cpu",
                      **MODES[mode])
    db = al.database(seqs)
    widths = db.shares[0].widths
    g16 = search_lib._first_cell16(al, widths, 304)
    assert 0 < g16 < widths.shape[0]
    assert widths[g16 - 1] >= 900 > 60 > widths[g16]
    with tracing.recording() as rec:
        got = al.search(query, db)
    assert rec.counters["search.buckets"] == 2
    np.testing.assert_array_equal(got, oracle(seqs, query, mode, sm=sm))


# (max|sub|, the query's rows, the widest admitted group): max|sub| *
# min(width, rows) <= 15,800 (BLOSUM62's 11: 1,436).
EDGES = [(11, 1440, 1436), (100, 176, 158), (127, 128, 124), (1, 16384, 15800)]


@pytest.mark.parametrize("max_sub,rows,edge", EDGES)
def test_int16_local_ok_at_its_edge(max_sub, rows, edge):
    sm = np.full((K, K), -min(max_sub, 4), dtype=np.int32)
    sm[3, 3] = max_sub
    ok = batch_fill.int16_local_ok
    assert max_sub * edge <= batch_fill.INT16_VALUE_CAP < max_sub * (edge + 1)
    for gap, ext in ((12, 2), (12, None), (12, 12), (0, 0)):
        assert ok(edge, rows, sm, K, gap, ext)
        assert ok(rows, edge, sm, K, gap, ext)  # min(n, m): either side
        assert not ok(edge + 1, rows, sm, K, gap, ext)
        assert not ok(rows, edge + 1, sm, K, gap, ext)
    # A query of rows <= the edge admits every width.
    assert ok(8192, edge, sm, K, 12, 2)
    # Costs outside 0 <= extend <= open <= the cap, never.
    for gap, ext in ((batch_fill.INT16_VALUE_CAP + 1, 2), (2, 12), (-1, None),
                     (12, -1)):
        assert not ok(16, 16, sm, K, gap, ext)


def planted_database(rng, lengths, planted):
    """Random sequences of ``lengths`` with, in front, runs of letter 0
    of the ``planted`` lengths (a query of 0s scores 100 a letter of
    them under SM100)."""
    seqs = [np.zeros(int(n), dtype=np.int8) for n in planted]
    return seqs + [rng.integers(1, 20, size=int(n)).astype(np.int8)
                   for n in lengths]


def score_by_the_twin(monkeypatch, al, db, query, cell16):
    """The search with every K3 group in int16 cells where the gate admits
    it (``cell16``), or every group in int32 cells."""
    with monkeypatch.context() as patch:
        if not cell16:
            patch.setattr(search_lib, "_first_cell16",
                          lambda al, widths, rows: widths.shape[0])
        with tracing.recording() as rec:
            return al.search(query, db), rec.counters


@pytest.mark.parametrize("gap,ext", [(12, 2), (12, None), (12, 5)])
def test_search_straddling_the_local_edge(monkeypatch, gap, ext):
    """A group of width 159 (int32 cells) and one of 158 (int16, values
    at the cap: 158 matches of 100) against a query of 170 letters (176
    rows): the twin in int16 and in int32 cells, both the oracle's."""
    rng = np.random.default_rng(11)
    lengths = np.concatenate([np.full(61, 159), rng.integers(1, 158, 70)])
    seqs = planted_database(rng, lengths, [159, 159, 159, 158, 158, 120])
    query = np.zeros(170, dtype=np.int8)
    query[160:] = rng.integers(0, 20, size=10)
    al = BatchAligner(SM100, K, gap, gap_extend=ext, local=True,
                      device="cpu")
    db = al.database(seqs)
    share = db.shares[0]
    assert list(share.widths[:2]) == [159, 158]
    assert search_lib._first_cell16(al, share.widths, 176) == 1
    want = oracle(seqs, query, "local", gap, ext, SM100)
    assert list(want[:5]) == [15_900] * 3 + [batch_fill.INT16_VALUE_CAP] * 2
    got16, counts = score_by_the_twin(monkeypatch, al, db, query, True)
    got32, _ = score_by_the_twin(monkeypatch, al, db, query, False)
    np.testing.assert_array_equal(got16, want)
    np.testing.assert_array_equal(got32, want)
    assert counts["search.buckets"] == 2
    assert counts["search.cells16"] == 170 * int(share.residues_before[-1]
                                                 - share.residues_before[1])
    assert counts["search.cells"] == 170 * db.residues


@pytest.mark.parametrize("gap,ext", [(12, None), (12, 5)])
def test_search_at_the_widest_group_the_local_gate_admits(monkeypatch, gap,
                                                         ext):
    """The twin's ramp cases: a query of 144 letters (B = 14,400 under
    max|sub| 100) admits groups as wide as the tail threshold, 8,192,
    where gap * k and extend * (k + 1) leave int16; int16 and int32 cells
    both the oracle's, a run of 144 matches among them."""
    rng = np.random.default_rng(12)
    lengths = np.concatenate([np.full(6, search_lib.TAIL_LETTERS),
                              rng.integers(1, 300, 20)])
    seqs = planted_database(rng, lengths, [search_lib.TAIL_LETTERS, 144])
    # Sequence 0: two runs of 72 0s, 100 other letters apart, past the
    # column (6,554 at extend 5) where the ramps leave int16: the query's
    # 144 0s bridge them with one gap.
    seqs[0] = rng.integers(1, 20, size=search_lib.TAIL_LETTERS).astype(
        np.int8)
    seqs[0][7000:7072] = seqs[0][7172:7244] = 0
    query = np.zeros(144, dtype=np.int8)
    al = BatchAligner(SM100, K, gap, gap_extend=ext, local=True,
                      device="cpu")
    db = al.database(seqs)
    assert db.shares[0].widths[0] == search_lib.TAIL_LETTERS
    assert search_lib._first_cell16(al, db.shares[0].widths, 144) == 0
    want = oracle(seqs, query, "local", gap, ext, SM100)
    assert want[1] == 14_400
    assert want[0] == 14_400 - gap - (gap if ext is None else ext) * 99
    got16, counts = score_by_the_twin(monkeypatch, al, db, query, True)
    got32, _ = score_by_the_twin(monkeypatch, al, db, query, False)
    np.testing.assert_array_equal(got16, want)
    np.testing.assert_array_equal(got32, want)
    assert counts["search.cells16"] == counts["search.cells"]


@pytest.mark.parametrize("cells", ["0", "auto"])
@pytest.mark.parametrize("mode", ["global", "semi", "local"])
def test_the_search_gate_by_mode(monkeypatch, mode, cells):
    """Global and semi searches take ``cell16_for``'s gate, as
    ``BatchAligner.score`` does; a local search ``int16_local_ok``'s,
    whatever ``SEQALIGN_INT16_CELLS`` says."""
    monkeypatch.setenv("SEQALIGN_INT16_CELLS", cells)
    rng = np.random.default_rng(13)
    lengths = np.concatenate([rng.integers(1, 60, size=70),
                              rng.integers(900, 960, size=70)])
    seqs = [rng.integers(0, 20, size=int(n)).astype(np.int8)
            for n in lengths]
    query = rng.integers(0, 20, size=300).astype(np.int8)
    al = aligner(mode, device="cpu")
    db = al.database(seqs)
    widths = db.shares[0].widths
    gate = batch_fill.int16_local_ok if mode == "local" else cell16_for
    admitted = [gate(int(w), 304, al.score_matrix, K, GAP, EXT)
                for w in widths]
    assert admitted == sorted(admitted)  # the shortest, last
    g16 = search_lib._first_cell16(al, widths, 304)
    assert g16 == (admitted + [True]).index(True)
    if mode == "local":
        assert g16 == 0  # every width <= 1,436
    elif cells == "0":
        assert g16 == widths.shape[0]
    else:
        assert 0 < g16 < widths.shape[0]
    np.testing.assert_array_equal(al.search(query, db),
                                  oracle(seqs, query, mode))


def test_the_twin_refuses_values_past_the_gates_range():
    """320 matches of 100 (32,000) fit int16 but leave the range in which
    the gates hold every value: the int16 twin raises; int32 scores it."""
    pair = torch.zeros((1, 320), dtype=torch.int8)
    args = (pair, pair, torch.tensor([320], dtype=torch.int32),
            torch.tensor([320], dtype=torch.int32), torch.from_numpy(SM100),
            12, K)
    assert not batch_fill.int16_local_ok(320, 320, SM100, K, 12, 2)
    assert batch_fill.batch_score_plain(*args, local=True,
                                        gap_extend=2).tolist() == [32_000]
    with pytest.raises(ValueError, match="int16 cells"):
        batch_fill.batch_score_plain(*args, local=True, gap_extend=2,
                                     cell16=True)


def test_the_answer_is_in_database_order():
    seqs, core = ragged_database(5, count=70)
    query = query_of(5, core, 40)
    al = aligner(device="cpu")
    got = al.search(query, al.database(seqs))
    perm = np.random.default_rng(5).permutation(len(seqs))
    shuffled = al.search(query, al.database([seqs[i] for i in perm]))
    np.testing.assert_array_equal(shuffled, got[perm])


def test_one_database_serves_several_queries():
    seqs, core = ragged_database(6, count=80)
    al = aligner(device="cpu")
    db = al.database(seqs)
    for m in (5, 30, 64):
        query = query_of(6 + m, core, m)
        np.testing.assert_array_equal(al.search(query, db),
                                      oracle(seqs, query))


@pytest.mark.parametrize("entries", [1, 2, 3])
def test_meshes_of_cpu_entries(monkeypatch, entries):
    """A one-device mesh holds every group; more entries deal the groups
    out in turn, and the answer does not change."""
    from seqalign_torch.parallel import make_data_mesh

    rng = np.random.default_rng(7)
    seqs = [rng.integers(0, 20, size=int(n)).astype(np.int8)
            for n in rng.integers(0, 120, size=200)]
    query = rng.integers(0, 20, size=25).astype(np.int8)
    monkeypatch.setattr(search_lib, "TAIL_LETTERS", 110)
    al = aligner(mesh=make_data_mesh(devices=["cpu"] * entries))
    db = al.database(seqs)
    assert len(db.shares) == entries
    groups = sum(s.widths.shape[0] for s in db.shares)
    assert groups == -(-(sum(0 < len(s) <= 110 for s in seqs)) // 64)
    np.testing.assert_array_equal(al.search(query, db), oracle(seqs, query))


def test_the_database_padding_and_residues():
    rng = np.random.default_rng(8)
    lengths = np.sort(rng.integers(100, 110, size=640))[::-1]
    seqs = [np.zeros(int(n), dtype=np.int8) for n in lengths]
    db = aligner(device="cpu").database(seqs)
    assert isinstance(db, Database)
    assert db.residues == lengths.sum() and db.size == 640
    assert db.padded >= db.residues
    assert db.padding == (db.padded - db.residues) / db.residues < 0.1


def test_search_refuses_bad_input():
    seqs, core = ragged_database(9, count=10)
    al = aligner(device="cpu")
    db = al.database(seqs)
    with pytest.raises(ValueError):
        al.search(np.zeros(0, dtype=np.int8), db)
    with pytest.raises(ValueError):
        al.search(np.array([0, K], dtype=np.int8), db)
    with pytest.raises(ValueError):
        aligner(device="cpu").search(core, db)  # another mesh
    with pytest.raises(ValueError):
        al.database([np.array([K + 1], dtype=np.int8)])


# The reference on hand-worked cases: a 4-letter alphabet, match 5,
# mismatch -4, gap 12 for one letter and 2 for each further one.
SM4 = np.where(np.eye(4, dtype=bool), 5, -4).astype(np.int32)
A, C, G, T = 0, 1, 2, 3
CASES = [
    # (sequence, query, affine score, linear score at 12 a letter)
    ([A, C, G, T], [A, C, G, T], 20, 20),
    # A gap costs 12 where a mismatch costs 9: ten As with the C between.
    ([A] * 5 + [C] + [A] * 5, [A] * 10, 41, 41),
    # A gap of three opens and extends: 50 - (12 + 2 + 2); linear gaps
    # cost 36, so the best there is five As, 25.
    ([A] * 5 + [C] * 3 + [A] * 5, [A] * 10, 34, 25),
    ([C] * 6, [A] * 4, 0, 0),  # nothing aligns: the floor
    ([], [A, C], 0, 0),
    ([G], [G], 5, 5),
    # Query and sequence swapped: a gap in the query this time.
    ([A] * 10, [A] * 5 + [C] * 3 + [A] * 5, 34, 25),
]


@pytest.mark.parametrize("seq,query,want,linear", CASES)
def test_the_reference_on_hand_worked_gotoh_cases(seq, query, want, linear):
    seq = np.array(seq, dtype=np.int8)
    query = np.array(query, dtype=np.int8)
    assert affine.local_scores([seq], query, SM4, 12, 2)[0] == want
    assert affine.local_scores([seq], query, SM4, 12, 12)[0] == linear
    assert bindings.oracle_fill_affine(1, seq, query, SM4, 4, 12, 2)[0] == \
        want


def test_the_reference_controls_differ_from_it():
    """Saturating at 127 caps a long match; with linear gaps the three
    Cs cost less as mismatches (77 matches less 12) than as a gap (36)."""
    seq = np.array([A] * 40 + [C] * 3 + [A] * 40, dtype=np.int8)
    query = np.array([A] * 80, dtype=np.int8)
    exact = affine.local_scores([seq], query, SM4, 12, 2)[0]
    assert exact == 400 - 16
    assert affine.local_scores([seq], query, SM4, 12, 2, saturate=127)[0] \
        == 127
    assert affine.local_scores([seq], query, SM4, 12, 12)[0] == 385 - 12


def test_the_reference_refuses_extend_above_gap():
    with pytest.raises(ValueError):
        affine.local_scores([np.array([A])], np.array([A]), SM4, 2, 12)


def test_the_reference_groups_by_length():
    lengths = [0, 1, 64, 65, 256, 257, 1024, 1025, 5000]
    groups = affine.groups_by_length(lengths)
    assert sorted(np.concatenate(groups).tolist()) == list(range(9))
    for g in groups:
        real = [lengths[i] for i in g if lengths[i] > affine.SHORT]
        assert not real or max(real) <= 4 * min(real)
