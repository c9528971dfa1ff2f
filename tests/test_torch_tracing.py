"""The port's own spans and counters (``seqalign_torch.tracing``) on the
CPU, and the benchmark's split of idle device time over them
(``cellbench/program.py``) on synthetic device traces.

Off, tracing records nothing and reads no clock; on, a request through
``api.align`` leaves one tree of spans with one request id, a
``checkpoint.tile`` span for every path tile counted, and its reads of
device tensors counted.  The split gives idle time to the deepest span
that covers it, by intersection, and passing the program's spans to
``trace.reduce`` leaves every existing per-layer reading as it was."""

import sys
import threading
import types

import numpy as np
import pytest

from cellbench import harness, program, trace
from seqalign_torch import api, config, tracing, types as sa_types
from seqalign_torch.constants import AlignmentType, Device
from seqalign_torch.ops import checkpoint, direct

from .torch_support import one_torch_thread, score_matrix  # noqa: F401

# Small tiles, so that a pair of 1,000 x 700 crosses several of them.
GEOM = dict(ckpt_cols=256, rps=2, slots=128)
N, M = 1000, 700


def pair(seed, n=N, m=M):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 4, n).astype(np.int32),
            rng.integers(0, 4, m).astype(np.int32))


def test_span_off_is_one_shared_no_op():
    assert tracing._rec is None
    first = tracing.span("api.align")
    assert first is tracing.span("checkpoint.tile") is tracing._NOOP
    with first as inside:
        assert inside is None
    assert tracing.count("host_waits") is None
    assert tracing.annotate("route", "direct") is None


@pytest.mark.parametrize("engine", ["direct", "checkpoint"])
def test_off_records_nothing_and_reads_no_clock(engine, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("tracing did work while off")

    monkeypatch.setattr(tracing, "_clock", refuse)
    monkeypatch.setattr(tracing, "Span", refuse)
    monkeypatch.setattr(tracing.Recording, "_count", refuse)
    text, pattern = pair(11)
    sm = score_matrix(4)
    if engine == "direct":
        out = direct.direct_align(text, pattern, sm, 4, 5, local=True,
                                  rps=1, slots=1024, device="cpu")
    else:
        out = checkpoint.checkpointed_align(text, pattern, sm, 4, 5,
                                            device="cpu", **GEOM)
    assert out[0] > 0
    assert tracing._rec is None


def _request(text, pattern, mode=AlignmentType.GLOBAL):
    request = sa_types.Request(
        device_type=Device.GPU, alignment_type=mode, text=text,
        pattern=pattern, score_matrix=score_matrix(4), gap_penalty=5)
    response = sa_types.Response()
    assert api.align(request, response) == 0
    return response


@pytest.fixture
def small_engines(monkeypatch):
    """The models' engines on the CPU at small geometries, past the
    wavefront route's host budget."""
    monkeypatch.setenv(config.DEVICE_ENV, "cpu")
    monkeypatch.setattr(config, "MAX_HOST_DIRS_BYTES", 0)
    real_ck, real_direct = (checkpoint.checkpointed_align,
                            direct.direct_align)
    monkeypatch.setattr(checkpoint, "checkpointed_align",
                        lambda *a, **k: real_ck(*a, **k, **GEOM))
    monkeypatch.setattr(direct, "direct_align",
                        lambda *a, **k: real_direct(*a, **k, rps=1,
                                                    slots=1024))
    return monkeypatch


def _check_tree(rec):
    by_id = {s.id: s for s in rec.spans}
    roots = [s for s in rec.spans if s.parent is None]
    assert [r.name for r in roots] == ["api.align"]
    assert {s.request for s in rec.spans} == {roots[0].request}
    for s in rec.spans:
        assert s.start <= s.end
        if s.parent is not None:
            up = by_id[s.parent]
            assert up.start <= s.start and s.end <= up.end
    return by_id, roots[0]


def test_checkpoint_request_is_one_tree_over_several_tiles(small_engines):
    small_engines.setattr(direct, "fits_direct", lambda *a, **k: False)
    text, pattern = pair(12)
    with tracing.recording() as rec:
        response = _request(text, pattern)
    assert response.aligned_text
    by_id, root = _check_tree(rec)
    assert root.attrs == {"route": "checkpoint"}
    parents: dict = {}
    for s in rec.spans:
        up = parents.setdefault(s.name, set())
        if s.parent is not None:
            up.add(by_id[s.parent].name)
    assert parents == {
        "api.align": set(), "checkpoint.fill": {"api.align"},
        "checkpoint.strip": {"checkpoint.fill"},
        "checkpoint.traceback": {"api.align"},
        "checkpoint.tile": {"checkpoint.traceback"},
        "native.emit": {"checkpoint.traceback"}}
    tiles = [s for s in rec.spans if s.name == "checkpoint.tile"]
    assert len(tiles) == rec.counters["checkpoint.tiles"] > 3
    assert sum(s.name == "checkpoint.strip" for s in rec.spans) == 3
    # Global: one read of S[m, n], then two a tile (its result, its moves).
    assert rec.counters["host_waits"] == 1 + 2 * len(tiles)


def test_direct_request_is_one_tree(small_engines):
    text, pattern = pair(13, n=600, m=300)
    with tracing.recording() as rec:
        _request(text, pattern, AlignmentType.LOCAL)
    by_id, root = _check_tree(rec)
    assert root.attrs == {"route": "direct"}
    assert [(s.name, by_id[s.parent].name) for s in rec.spans
            if s.parent is not None] == [("native.emit", "direct.align"),
                                         ("direct.align", "api.align")]
    # Local: the best cell's three ints, then the walk's result and moves.
    assert rec.counters == {"host_waits": 3}


def test_other_routes_are_named_other(monkeypatch):
    monkeypatch.setenv(config.DEVICE_ENV, "cpu")
    text, pattern = pair(14, n=200, m=150)
    with tracing.recording() as rec:
        _request(text, pattern)
    assert [(s.name, s.attrs) for s in rec.spans] == [
        ("api.align", {"route": "other"})]


def test_recordings_do_not_nest_and_always_end():
    with pytest.raises(RuntimeError, match="already"):
        with tracing.recording():
            with tracing.recording():
                pass
    assert tracing._rec is None
    with pytest.raises(ValueError):
        with tracing.recording() as rec:
            with tracing.span("api.align"):
                raise ValueError("request failed")
    assert tracing._rec is None
    assert [s.name for s in rec.spans] == ["api.align"]
    assert rec.spans[0].end >= rec.spans[0].start


def test_threads_count_every_event_and_keep_their_own_trees():
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with tracing.recording() as rec:
            def work():
                for _ in range(500):
                    with tracing.span("api.align"):
                        with tracing.span("direct.align"):
                            tracing.count("host_waits")

            threads = [threading.Thread(target=work) for _ in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert rec.counters == {"host_waits": 16 * 500}
    by_id = {s.id: s for s in rec.spans}
    assert len(by_id) == len(rec.spans) == 2 * 16 * 500
    children = [s for s in rec.spans if s.name == "direct.align"]
    assert all(by_id[s.parent].name == "api.align"
               and by_id[s.parent].request == s.request for s in children)
    assert len({s.request for s in children}) == 16 * 500


# --- cellbench/program.py on synthetic traces ------------------------------

MARK_NS = 5_000_000_000  # the host clock at the profiler's marker
MARK_US = 1_000.0        # the marker on the trace's clock


def S(name, sid, parent, start_ms, end_ms):
    """A span on the host clock, ``start_ms`` after the marker."""
    return types.SimpleNamespace(
        name=name, id=sid, parent=parent, attrs={},
        start=MARK_NS + int(start_ms * 1e6), end=MARK_NS + int(end_ms * 1e6))


def K(name, start_ms, end_ms, cat="kernel"):
    """A device event on the trace's clock, ``start_ms`` after the
    marker."""
    return (cat, name, MARK_US + 1e3 * start_ms, MARK_US + 1e3 * end_ms)


# Window 0-100 ms.  Busy: 10-30 (K1), 40-45 (K2), 60-62 (a copy), 90-95
# (K1).  Idle: 0-10, 30-40, 45-60, 62-90, 95-100 (68 ms).
RAW = {"mark_us": MARK_US, "mark_ns": MARK_NS, "events": [
    K("void wavefront_strip_kernel<16>(int)", 10, 30),
    K("walk_window_kernel", 40, 45),
    K("Memcpy DtoH", 60, 62, "gpu_memcpy"),
    K("void wavefront_strip_kernel<16>(int)", 90, 95)]}
WINDOW = (MARK_NS, MARK_NS + 100_000_000)
# One request (5-97 ms): phase 1 (8-32), phase 2 (33-96) with two tiles
# (35-50, 55-80) and the replay (82-88).
SPANS = [S("checkpoint.fill", 2, 1, 8, 32),
         S("checkpoint.tile", 4, 3, 35, 50),
         S("checkpoint.tile", 5, 3, 55, 80),
         S("native.emit", 6, 3, 82, 88),
         S("checkpoint.traceback", 3, 1, 33, 96),
         S("api.align", 1, None, 5, 97)]


def _ms(split, name, key):
    return round(1e3 * split["spans"][name][key], 6)


def test_idle_goes_to_the_deepest_span_by_intersection():
    split = program.apportion(RAW, WINDOW, SPANS)
    assert round(1e3 * split["idle_s"], 6) == 68.0
    # The tiles hold idle 35-40 and 45-50, then 55-60 and 62-80: parts of
    # gaps (by a gap's midpoint the first tile would get all of 30-40 and
    # none of 45-60).
    assert _ms(split, "checkpoint.tile", "inclusive_s") == 10.0 + 23.0
    assert _ms(split, "checkpoint.tile", "exclusive_s") == 33.0
    assert _ms(split, "native.emit", "exclusive_s") == 6.0
    # Phase 2's own idle: 33-35, 50-55, 80-82, 88-90, 95-96.
    assert _ms(split, "checkpoint.traceback", "exclusive_s") == 12.0
    assert _ms(split, "checkpoint.traceback", "inclusive_s") == 51.0
    # Phase 1 covers 8-10 and 30-32.
    assert _ms(split, "checkpoint.fill", "exclusive_s") == 4.0
    # The request's own: 5-8, 32-33, 96-97.
    assert _ms(split, "api.align", "exclusive_s") == 5.0
    assert _ms(split, "api.align", "inclusive_s") == 60.0
    assert round(1e3 * split["outside_s"], 6) == 8.0  # 0-5 and 97-100
    assert split["spans"]["checkpoint.tile"]["count"] == 2
    assert _ms(split, "checkpoint.tile", "total_s") == 15.0 + 25.0
    assert _ms(split, "api.align", "total_s") == 92.0


@pytest.mark.parametrize("order", ["ended", "reversed", "by_name"])
def test_exclusive_and_outside_idle_add_up_to_the_window(order):
    spans = {"ended": SPANS, "reversed": SPANS[::-1],
             "by_name": sorted(SPANS, key=lambda s: s.name)}[order]
    split = program.apportion(RAW, WINDOW, spans)
    exclusive = sum(v["exclusive_s"] for v in split["spans"].values())
    assert exclusive + split["outside_s"] == pytest.approx(split["idle_s"],
                                                           abs=1e-12)
    for v in split["spans"].values():
        assert v["inclusive_s"] >= v["exclusive_s"] - 1e-12
    reduced = trace.reduce(RAW, WINDOW, {})
    assert split["idle_s"] == pytest.approx(
        reduced["window_s"] - reduced["busy_s"], abs=1e-12)


def test_spans_past_the_window_and_overlapping_threads():
    spans = [S("api.align", 1, None, -20, 5),       # starts before it
             S("api.align", 2, None, 20, 130),      # ends after it
             S("direct.align", 3, 2, 25, 70),
             S("api.align", 7, None, 50, 65)]       # another thread's
    split = program.apportion(RAW, WINDOW, spans)
    exclusive = sum(v["exclusive_s"] for v in split["spans"].values())
    assert exclusive + split["outside_s"] == pytest.approx(split["idle_s"])
    assert _ms(split, "direct.align", "inclusive_s") == 10.0 + 15.0 + 8.0
    assert _ms(split, "direct.align", "exclusive_s") == 33.0
    assert _ms(split, "api.align", "exclusive_s") == 5.0 + 25.0
    assert _ms(split, "api.align", "total_s") == 5.0 + 80.0 + 15.0
    assert round(1e3 * split["outside_s"], 6) == 5.0  # 5-10


def test_layer_metrics_of_a_split():
    split = program.apportion(RAW, WINDOW, SPANS)
    got = program.layer_metrics(split, {"checkpoint.tiles": 2,
                                        "host_waits": 5}, requests=1)
    assert {k: round(v, 6) for k, v in got.items()} == {
        "idle_api_ms.pair": 5.0,
        "idle_engine_ms.pair": 4.0 + 51.0 - 6.0,
        "idle_tile_ms.pair": 16.5,
        "host_waits.pair": 5.0}
    direct_only = [S("api.align", 1, None, 5, 97),
                   S("direct.align", 2, 1, 8, 96)]
    got = program.layer_metrics(program.apportion(RAW, WINDOW, direct_only),
                                {"host_waits": 3}, requests=1)
    assert set(got) == {"idle_api_ms.pair", "idle_engine_ms.pair",
                        "host_waits.pair"}
    # A program without spans (or no request) has nothing to read.
    assert program.layer_metrics(program.apportion(RAW, WINDOW, []), {},
                                 requests=3) == {}
    assert program.layer_metrics(split, {}, requests=0) == {}


def test_labels_are_deepest_first():
    assert list(program.labels(SPANS)) == [
        "checkpoint.tile", "native.emit", "checkpoint.fill",
        "checkpoint.traceback", "api.align"]


EXISTING = ("fill_roofline.pair", "walk_ns_per_move.pair", "emit_ms.pair",
            "device_idle.pair")


def _readings(host_spans):
    reduced = trace.reduce(RAW, WINDOW, host_spans)
    rec = harness.Record(
        setup_s=1.0, seconds=0.1, done=[], aligns=True,
        traced={"requests": 1, "pairs": 1, "cells": 3_000_000_000,
                "moves": 20_000},
        trace=reduced, spans={"emit": (1, 0.004)})
    values = {name: harness.load_module("metrics", name).read(rec)
              for name in EXISTING}
    return values, reduced


def test_program_spans_leave_the_existing_readings_as_they_are():
    host = {"emit": [(S("", 0, None, 82, 86).start,
                      S("", 0, None, 82, 86).end)],
            "request": [(S("", 0, None, 4, 98).start,
                         S("", 0, None, 4, 98).end)]}
    without, plain = _readings(host)
    with_spans, named = _readings({**program.labels(SPANS), **host})
    assert without == with_spans
    assert all(v is not None for v in without.values())
    for key in ("kernels", "busy_s", "window_s", "device_ops"):
        assert plain[key] == named[key]
    assert [g[1] for g in plain["idle_gaps"]] == [
        g[1] for g in named["idle_gaps"]]
    # Largest first: 62-90 (its midpoint, 76 ms, in the second tile),
    # 45-60, 0-10, 30-40, 95-100 (past the program's span, in the
    # benchmark's request).
    assert [g[0].split("@")[0] for g in plain["idle_gaps"]] == [
        "request"] * 5
    assert [g[0].split("@")[0] for g in named["idle_gaps"]] == [
        "checkpoint.tile", "checkpoint.traceback", "api.align",
        "checkpoint.tile", "request"]


def search_case(monkeypatch, tail=None):
    """A small protein database (one sequence of 200 letters, above a
    tail threshold of 150) and a query, on a one-device CPU mesh."""
    from seqalign_torch.parallel import BatchAligner, search

    if tail is not None:
        monkeypatch.setattr(search, "TAIL_LETTERS", tail)
    rng = np.random.default_rng(40)
    seqs = [rng.integers(0, 20, int(n)).astype(np.int8)
            for n in rng.integers(0, 120, 100)]
    seqs.append(rng.integers(0, 20, 200).astype(np.int8))
    al = BatchAligner(score_matrix(23), 23, 12, local=True, gap_extend=2,
                      device="cpu")
    db = al.database(seqs)
    return al, db, rng.integers(0, 20, 37).astype(np.int8)


@pytest.mark.parametrize("tail", [150, None])
def test_search_spans_nest_under_batch_search(monkeypatch, tail):
    al, db, query = search_case(monkeypatch, tail)
    with tracing.recording() as rec:
        al.search(query, db)
    (root,) = [s for s in rec.spans if s.parent is None]
    assert root.name == "batch.search"
    assert root.attrs["buckets"] == rec.counters["search.buckets"] == 1
    names = {s.name for s in rec.spans if s.parent == root.id}
    assert names == {"search.dispatch", "search.tail", "search.collect"}
    assert {s.request for s in rec.spans} == {root.request}
    tails = rec.counters.get("search.tail_pairs", 0)
    assert tails == (1 if tail else 0)
    fills = [s for s in rec.spans if s.name == "checkpoint.fill"]
    assert len(fills) == tails
    tail_span = next(s for s in rec.spans if s.name == "search.tail")
    assert all(s.parent == tail_span.id for s in fills)
    # One read-back of the scores, and the tail's own (two a strip).
    assert rec.counters["host_waits"] == 1 + 2 * tails


def test_search_counts_its_cells(monkeypatch):
    al, db, query = search_case(monkeypatch, 150)
    with tracing.recording() as rec:
        al.search(query, db)
    assert rec.counters["search.cells"] == len(query) * db.residues
    assert rec.counters["search.cells_padded"] >= rec.counters["search.cells"]


def test_search_off_records_nothing(monkeypatch):
    al, db, query = search_case(monkeypatch, 150)

    def refuse(*args, **kwargs):
        raise AssertionError("tracing did work while off")

    monkeypatch.setattr(tracing, "_clock", refuse)
    monkeypatch.setattr(tracing, "Span", refuse)
    monkeypatch.setattr(tracing.Recording, "_count", refuse)
    assert al.search(query, db).shape == (db.size,)
    assert tracing._rec is None
