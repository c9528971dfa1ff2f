"""The yardstick's arithmetic and the metric readers on hand-worked
records."""

import pytest

from cellbench import harness, work


def test_work_counts():
    assert work.cells(3, 4) == 12
    assert work.ops(12, aligns=True) == 12 * 11
    assert work.ops(12, aligns=False) == 12 * 5
    assert work.OPS_PER_CELL_ALIGN == work.OPS_PER_CELL_SCORE + 6
    assert work.roofline_pct(33.5e12, 1.0) == pytest.approx(100.0)
    assert work.roofline_pct(1.0, 0.0) is None


def _record(**kw):
    rec = harness.Record(setup_s=12.5, seconds=2.0, aligns=True, done=[
        {"latency_s": x / 1e3, "cells": 10**9, "pairs": 1}
        for x in range(1, 21)])
    rec.traced = {"requests": 21, "pairs": 21, "cells": 21 * 10**9,
                  "moves": 4_000_000}
    rec.trace = {"kernels": {"wavefront_strip_kernel": 0.5,
                             "walk_window_kernel": 0.1},
                 "busy_s": 0.8, "window_s": 2.0}
    rec.spans = {"emit": (21, 0.042)}
    for key, value in kw.items():
        setattr(rec, key, value)
    return rec


@pytest.mark.parametrize("name,want", [
    ("setup_s", 12.5),
    ("gcups", 20 * 10**9 / 2.0 / 1e9),
    ("p90_ms", 18.0),
    ("fill_roofline.pair", 100 * 21e9 * 11 / (33.5e12 * 0.5)),
    ("walk_ns_per_move.pair", 1e9 * 0.1 / 4e6),
    ("emit_ms.pair", 1e3 * 0.042 / 21),
    ("device_idle.pair", 60.0),
])
def test_readers(name, want):
    reader = harness.load_module("metrics", name)
    assert reader.read(_record()) == pytest.approx(want)


def test_score_only_rooflines_count_five_operations():
    reader = harness.load_module("metrics", "fill_roofline.pair")
    assert reader.read(_record(aligns=False)) == pytest.approx(
        100 * 21e9 * 5 / (33.5e12 * 0.5))


@pytest.mark.parametrize("name", ["fill_roofline.pair", "device_idle.pair",
                                  "walk_ns_per_move.pair", "emit_ms.pair"])
def test_readers_with_nothing_to_read_return_nothing(name):
    reader = harness.load_module("metrics", name)
    empty = _record(trace={"kernels": {}, "busy_s": 0.0, "window_s": 2.0},
                    spans={})
    assert reader.read(empty) is None


def test_reservoir_keeps_the_largest():
    import numpy as np

    r = harness.Reservoir(3, np.random.default_rng(0))
    for k in range(100):
        r.offer(k if k != 57 else 10**6, k)
    sample = r.sample()
    assert len(sample) == 3 and 57 in sample
    with pytest.raises(ValueError):
        harness.Reservoir(1, np.random.default_rng(0))


def test_trace_reduction():
    from cellbench import trace

    raw = {"mark_us": 1000.0, "mark_ns": 0,
           "events": [("kernel", "void wavefront_strip_kernel<16, 4>(A)",
                       1000.0, 1500.0),
                      ("kernel", "walk_window_kernel(B)", 1400.0, 1600.0),
                      ("gpu_memcpy", "Memcpy DtoH", 2500.0, 2600.0)]}
    out = trace.reduce(raw, (0, 3_000_000), {"emit": [(1_700_000,
                                                       2_400_000)]})
    assert out["kernels"]["wavefront_strip_kernel"] == pytest.approx(5e-4)
    assert out["kernels"]["walk_window_kernel"] == pytest.approx(2e-4)
    assert out["busy_s"] == pytest.approx(7e-4)
    assert out["window_s"] == pytest.approx(3e-3)
    (first, s1), (second, s2) = out["idle_gaps"]
    assert first.startswith("emit@") and s1 == pytest.approx(1.4e-3)
    assert second.startswith("none@") and s2 == pytest.approx(9e-4)


@pytest.mark.parametrize("name,short", [
    ("void (anonymous namespace)::interpair_kernel<1, true, false, 4>"
     "(signed char const*, int)", "interpair_kernel"),
    ("void (anonymous namespace)::wavefront_strip_kernel<16, 4, 4, false, "
     "true, false>(int const*)", "wavefront_strip_kernel"),
    ("walk_window_kernel(B)", "walk_window_kernel"),
    ("at::native::elementwise_kernel", "at::native::elementwise_kernel")])
def test_kernel_short_names(name, short):
    from cellbench import trace

    assert trace.short_name(name) == short
