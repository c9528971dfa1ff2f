"""The program's own spans (``seqalign_torch.tracing``) on the device trace:
the traced window's idle device time split over them, and the per-layer
numbers read from that split.

Idle time is the window less the union of every kernel, copy and fill the
profiler recorded: the events and clock offset ``trace.reduce`` takes, so
that its ``busy_s`` and this split agree.  The idle intervals are cut
where spans start and end, and each piece goes to the deepest span that
covers it; a piece that no span covers is outside every request.  Per span
name the split gives the inclusive idle (all idle inside its spans) and
the exclusive idle (the pieces it won).  The exclusive totals and the
idle outside every span add up to the window's idle.

Spans are objects with ``name``, ``id``, ``parent``, ``start`` and ``end``
(``time.perf_counter_ns``), as a ``tracing.recording()`` holds them.
"""

from __future__ import annotations

import bisect

from .trace import _union

# The pair engines' spans, whose idle (less the replay's) is the engines'.
ENGINES = ("direct.align", "checkpoint.fill", "checkpoint.traceback")
ROOT = "api.align"
EMIT = "native.emit"
TILE = "checkpoint.tile"


def _offset_us(raw: dict) -> float:
    if raw.get("mark_us") is None:
        raise RuntimeError("the profiler recorded no marker")
    return raw["mark_us"] - raw["mark_ns"] / 1e3


def idle_intervals(raw: dict, window_ns: tuple) -> list:
    """The window's idle intervals on the trace's clock (us), in order."""
    offset = _offset_us(raw)
    w0, w1 = window_ns[0] / 1e3 + offset, window_ns[1] / 1e3 + offset
    busy = _union([(max(a, w0), min(b, w1)) for _, _, a, b in raw["events"]
                   if min(b, w1) > max(a, w0)])
    gaps, cursor = [], w0
    for a, b in busy:
        if a > cursor:
            gaps.append((cursor, a))
        cursor = max(cursor, b)
    if cursor < w1:
        gaps.append((cursor, w1))
    return gaps


class _Idle:
    """Idle time between two points, over sorted disjoint intervals."""

    def __init__(self, gaps):
        self.starts = [a for a, _ in gaps]
        self.ends = [b for _, b in gaps]
        self.cum = [0.0]
        for a, b in gaps:
            self.cum.append(self.cum[-1] + (b - a))

    def between(self, a: float, b: float) -> float:
        if b <= a:
            return 0.0
        i = bisect.bisect_right(self.ends, a)
        j = bisect.bisect_left(self.starts, b)
        if i >= j:
            return 0.0
        return (self.cum[j] - self.cum[i] - max(0.0, a - self.starts[i])
                - max(0.0, self.ends[j - 1] - b))


def depths(spans) -> dict:
    """Span id -> depth (0 for a span whose parent is not among them)."""
    by_id = {s.id: s for s in spans}
    out: dict = {}

    def depth(s):
        if s.id not in out:
            parent = by_id.get(s.parent)
            out[s.id] = 0 if parent is None else depth(parent) + 1
        return out[s.id]

    for s in spans:
        depth(s)
    return out


def labels(spans) -> dict:
    """Span name -> [(start_ns, end_ns)], the deepest names first: the
    ``host_spans`` by which ``trace.reduce`` names an idle gap."""
    level = depths(spans)
    deepest: dict = {}
    for s in spans:
        deepest[s.name] = max(deepest.get(s.name, 0), level[s.id])
    order = sorted(deepest, key=lambda name: (-deepest[name], name))
    return {name: [(s.start, s.end) for s in spans if s.name == name]
            for name in order}


def apportion(raw: dict, window_ns: tuple, spans) -> dict:
    """The window's idle device time split over ``spans``: ``idle_s``,
    ``outside_s`` (idle under no span) and ``spans`` (name -> ``count``,
    ``total_s``, the spans' time in the window, ``inclusive_s``,
    ``exclusive_s``), in seconds."""
    gaps = idle_intervals(raw, window_ns)
    idle = _Idle(gaps)
    offset = _offset_us(raw)
    w0, w1 = window_ns[0] / 1e3 + offset, window_ns[1] / 1e3 + offset
    level = depths(spans)
    out: dict = {}
    events = []
    for s in spans:
        a = max(w0, s.start / 1e3 + offset)
        b = min(w1, s.end / 1e3 + offset)
        entry = out.setdefault(s.name, {"count": 0, "total_s": 0.0,
                                        "inclusive_s": 0.0,
                                        "exclusive_s": 0.0})
        entry["count"] += 1
        entry["total_s"] += max(0.0, b - a) / 1e6
        entry["inclusive_s"] += idle.between(a, b) / 1e6
        if b > a:
            events.append((a, 0, s))  # opens before any close at a time
            events.append((b, 1, s))
    events.sort(key=lambda e: (e[0], e[1]))
    active: dict = {}
    outside, cursor = 0.0, w0
    for t, kind, s in events:
        piece = idle.between(cursor, t)
        if piece:
            if active:
                top = max(active.values(),
                          key=lambda x: (level[x.id], x.start))
                out[top.name]["exclusive_s"] += piece / 1e6
            else:
                outside += piece
        cursor = t
        if kind == 0:
            active[s.id] = s
        else:
            active.pop(s.id, None)
    outside += idle.between(cursor, w1)
    return {"idle_s": sum(b - a for a, b in gaps) / 1e6,
            "outside_s": outside / 1e6, "spans": out}


def layer_metrics(split: dict, counters: dict, requests: int) -> dict:
    """The per-layer numbers of a split (``apportion``) and the program's
    counters over ``requests`` traced requests; a number with nothing to
    read is left out.

    ``idle_api_ms.pair``: idle in ``api.align`` outside every engine span,
    ms a request.  ``idle_engine_ms.pair``: idle in the engines' spans
    less the replay's (``native.emit``), ms a request.
    ``idle_tile_ms.pair``: idle in ``checkpoint.tile`` spans, ms a path
    tile (``checkpoint.tiles``).  ``host_waits.pair``: the ``host_waits``
    count a request."""
    spans = split["spans"]
    if not requests or ROOT not in spans:
        return {}

    def inclusive(name):
        return spans[name]["inclusive_s"] if name in spans else 0.0

    out = {"idle_api_ms.pair": 1e3 * spans[ROOT]["exclusive_s"] / requests}
    if any(name in spans for name in ENGINES):
        engines = sum(inclusive(name) for name in ENGINES)
        out["idle_engine_ms.pair"] = (1e3 * (engines - inclusive(EMIT))
                                      / requests)
    tiles = counters.get("checkpoint.tiles", 0)
    if tiles:
        out["idle_tile_ms.pair"] = 1e3 * inclusive(TILE) / tiles
    out["host_waits.pair"] = counters.get("host_waits", 0) / requests
    return out
