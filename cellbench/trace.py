"""The traced run's instruments: benchmark spans around program functions,
and ``torch.profiler``'s device trace reduced to kernel times, the device's
busy time and its idle gaps.

Spans are the benchmark's own: a wrapper around a named function of the
port records the host clock around each call (from any thread) and is
taken out again when the window closes.  The device trace is the
profiler's record of every kernel, copy and fill the card ran (CUPTI sees
the port's kernels however they are launched); host spans are put on its
clock by a marker recorded at a known host time.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import os
import re
import tempfile
import threading
import time

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
MARK = "cellbench.mark"


class Spans:
    """Host-clock spans (perf_counter ns) around program functions, by
    label: ``targets`` maps a label to (module, function name)."""

    def __init__(self, targets: dict):
        self.targets = dict(targets)
        self.spans: dict[str, list] = {label: [] for label in targets}
        self._saved: list = []
        self._lock = threading.Lock()

    def install(self):
        for label, (module, name) in self.targets.items():
            mod = importlib.import_module(module)
            original = getattr(mod, name)
            self._saved.append((mod, name, original))
            setattr(mod, name, self._wrap(label, original))

    def remove(self):
        while self._saved:
            mod, name, original = self._saved.pop()
            setattr(mod, name, original)

    def _wrap(self, label, fn):
        record = self.spans[label]
        lock = self._lock

        def wrapper(*args, **kwargs):
            t0 = time.perf_counter_ns()
            try:
                return fn(*args, **kwargs)
            finally:
                t1 = time.perf_counter_ns()
                with lock:
                    record.append((t0, t1))

        wrapper.__wrapped__ = fn
        return wrapper

    def totals(self) -> dict:
        """label -> (calls, seconds)."""
        return {label: (len(v), sum(b - a for a, b in v) / 1e9)
                for label, v in self.spans.items()}


def short_name(kernel: str) -> str:
    """A kernel's name without its return type, anonymous namespaces,
    template arguments and parameters:
    ``void (anonymous namespace)::k<16, 4>(Args)`` -> ``k``."""
    name = kernel.strip().replace("(anonymous namespace)::", "")
    name = re.sub(r"^(void|static)\s+", "", name)
    return re.split(r"[<(]", name, maxsplit=1)[0].strip() or kernel


@contextlib.contextmanager
def device_trace(result: dict):
    """Profile the card over the block; on exit ``result`` holds the raw
    device events (``events``: (category, name, start_us, end_us)), the
    marker's start on the trace's clock (``mark_us``) and the host clock at
    the marker (``mark_ns``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        t_mark = time.perf_counter_ns()
        with record_function(MARK):
            pass
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    finally:
        prof.__exit__(None, None, None)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    events, mark_us = [], None
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        if cat in DEVICE_CATEGORIES:
            start = float(ev["ts"])
            events.append((cat, ev.get("name", ""), start,
                           start + float(ev.get("dur", 0.0))))
        elif ev.get("name") == MARK and cat == "user_annotation":
            mark_us = float(ev["ts"])
    result.update(events=events, mark_us=mark_us, mark_ns=t_mark)


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def reduce(raw: dict, window_ns: tuple, host_spans: dict, top: int = 10):
    """The traced window's device numbers.

    ``window_ns``: the window on the host clock (perf_counter ns);
    ``host_spans``: label -> [(start_ns, end_ns)] on the host clock, the
    labels that name an idle gap in order of precedence.  Returns a dict:
    ``kernels`` (short name -> device seconds), ``busy_s``, ``window_s``,
    ``device_ops`` and ``idle_gaps`` (the ``top`` largest, [name, s])."""
    if raw.get("mark_us") is None:
        raise RuntimeError("the profiler recorded no marker")
    offset_us = raw["mark_us"] - raw["mark_ns"] / 1e3

    def to_trace(ns):
        return ns / 1e3 + offset_us

    w0, w1 = to_trace(window_ns[0]), to_trace(window_ns[1])
    clipped, kernels = [], {}
    for cat, name, a, b in raw["events"]:
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        clipped.append((a, b))
        key = short_name(name) if cat == "kernel" else cat
        kernels[key] = kernels.get(key, 0.0) + (b - a) / 1e6
    busy = _union(clipped)
    busy_s = sum(b - a for a, b in busy) / 1e6
    gaps, cursor = [], w0
    for a, b in busy:
        if a > cursor:
            gaps.append((cursor, a))
        cursor = max(cursor, b)
    if cursor < w1:
        gaps.append((cursor, w1))
    spans = {label: sorted((to_trace(a), to_trace(b)) for a, b in v)
             for label, v in host_spans.items()}

    def label_of(t):
        for label, v in spans.items():
            for a, b in v:
                if a <= t <= b:
                    return label
                if a > t:
                    break
        return "none"

    gaps.sort(key=lambda g: g[0] - g[1])
    idle = [[f"{label_of((a + b) / 2)}@{(a - w0) / 1e6:.6f}s",
             (b - a) / 1e6] for a, b in gaps[:top]]
    ops = sorted(kernels.items(), key=lambda kv: -kv[1])[:top]
    return {"kernels": kernels, "busy_s": busy_s,
            "window_s": (w1 - w0) / 1e6,
            "device_ops": [[k, v] for k, v in ops], "idle_gaps": idle}
