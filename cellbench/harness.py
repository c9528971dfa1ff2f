"""Run one cell of ``BENCHMARK.json`` once and print its result line.

Everything of a cell is found by name: the workload's configuration
(``configs/<name>.json``, the ``file`` its entry in BENCHMARK.json names)
and traffic (``traffic/<name>.json``), the traffic's generator
(``gen/<name>.py``) and entry driver (``entries/<name>.py``), and each
metric's reader (``metrics/<name>.py``).  A new cell, traffic mix or
metric is new files and new entries in BENCHMARK.json.

A run: set-up (torch, the card, the kernel libraries, the traffic made
from the seed, one warm-up of each route the traffic takes), then a window
of ``--seconds`` in which one client sends the traffic's requests one
after another, each when the last has answered (a closed loop).  A
request counts when it ends inside the window.  After the window the
device's peak memory is read, the program's state is freed, and a sample
of the answers drawn from the seed (with the request of most work in it)
is judged by the plain reference under ``reference/``.  With ``--trace 1``
the window runs under the profiler and the benchmark's spans, and the
line carries the cell's per-layer metrics in place of its end-to-end ones.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import os
import statistics
import subprocess
import sys
import time
import traceback

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# Top-level module names that may not be loaded in a run.
FORBIDDEN = ("jax", "jaxlib", "flax", "seqalign_tpu")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None
                                           else modules)}
    return sorted(names & set(FORBIDDEN))


@dataclasses.dataclass
class Cell:
    workload: dict
    config: dict
    traffic: dict
    generator: object
    entry: object
    metrics: list  # [(metric entry, reader module)]


def load_module(kind: str, name: str, bench_dir: str = BENCH_DIR):
    """A generator or entry driver (``cellbench.<kind>.<name>``), or a
    metric's reader (``<bench_dir>/metrics/<name>.py``: its name may hold
    dots)."""
    if kind in ("gen", "entries"):
        return importlib.import_module(f"cellbench.{kind}.{name}")
    path = os.path.join(bench_dir, kind, f"{name}.py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind} reader named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"cellbench_{kind}_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _read_json(path):
    with open(path) as f:
        return json.load(f)


def metrics_of(bench: dict, workload: str, traced: bool) -> list:
    """The metric entries a cell reports: its end-to-end ones untraced,
    its per-layer ones traced (an entry with ``workloads`` only in those
    cells)."""
    group = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in group
            if "workloads" not in m or workload in m["workloads"]]


def resolve(bench: dict, workload: str, traced: bool, root: str = ROOT,
            bench_dir: str = BENCH_DIR) -> Cell:
    """Every piece of the cell ``workload``, by name."""
    found = [w for w in bench["workloads"] if w["name"] == workload]
    if not found:
        raise KeyError(f"no workload named {workload!r}")
    w = found[0]
    config_entry = next(c for c in bench["configs"]
                        if c["name"] == w["config"])
    config = _read_json(os.path.join(root, config_entry["file"]))
    traffic = _read_json(os.path.join(bench_dir, "traffic",
                                      f"{w['traffic']}.json"))
    generator = load_module("gen", traffic["generator"], bench_dir)
    entry = load_module("entries", traffic["entry"], bench_dir)
    metrics = [(m, load_module("metrics", m["name"], bench_dir))
               for m in metrics_of(bench, workload, traced)]
    return Cell(w, config, traffic, generator, entry, metrics)


@dataclasses.dataclass
class Record:
    """What the metric readers read.

    done: one dict a request completed inside the window (``latency_s``,
    ``cells``, ``pairs``).  traced: the work of every request in the traced
    window (``requests``, ``pairs``, ``cells``, ``moves``), None untraced.
    trace: ``trace.reduce``'s numbers, None untraced.  spans: label ->
    (calls, seconds) of the benchmark's spans."""

    setup_s: float
    seconds: float
    done: list
    aligns: bool
    traced: dict | None = None
    trace: dict | None = None
    spans: dict = dataclasses.field(default_factory=dict)


class Reservoir:
    """A uniform sample of ``size`` of the items offered, drawn from
    ``rng``, with the item of most work in place of one of them: at least
    two, so that one is always drawn."""

    def __init__(self, size: int, rng):
        if size < 2:
            raise ValueError("a check samples two answers or more")
        self.size, self.rng = size, rng
        self.kept: list = []
        self.seen = 0
        self.largest = None

    def offer(self, work: int, item):
        if self.largest is None or work > self.largest[0]:
            self.largest = (work, item)
        if len(self.kept) < self.size:
            self.kept.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.size:
                self.kept[j] = item
        self.seen += 1

    def sample(self) -> list:
        out = list(self.kept)
        if self.largest is not None and not any(
                x is self.largest[1] for x in out):
            if len(out) >= self.size and out:
                out[0] = self.largest[1]
            else:
                out.append(self.largest[1])
        return out


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return proc.stdout.strip().splitlines()[0] if proc.stdout else "?"
    except (OSError, subprocess.SubprocessError):
        return "?"


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", metavar="NAME",
                   help="judge the control NAME's answers to the sample in "
                        "the program's place (calibration of the limits; "
                        "never part of a benchmark run)")
    return p.parse_args(argv)


def main(argv=None, start=None, device=None, bench_path=None,
         bench_dir=BENCH_DIR, root=ROOT) -> int:
    """One run; returns the exit code.  ``device`` None means the card:
    the run fails without one.  Tests pass ``device="cpu"`` to drive the
    rest of a run through the port's plain versions."""
    start = time.perf_counter() if start is None else start
    args = parse_args(argv)
    bench = _read_json(bench_path or os.path.join(root, "BENCHMARK.json"))
    cell = resolve(bench, args.workload, bool(args.trace), root, bench_dir)
    chips = int(cell.workload["chips"])
    if args.control is not None and args.control not in cell.entry.CONTROLS:
        print(f"cellbench: --control takes one of {cell.entry.CONTROLS}",
              file=sys.stderr)
        return 2

    import torch

    on_card = device is None
    if on_card:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"cellbench: the cell needs {chips} CUDA device(s); "
                  f"{torch.cuda.device_count()} available", file=sys.stderr)
            return 2
        device = "cuda:0"

    from . import pool as pool_lib
    from . import trace as trace_lib

    traffic = cell.traffic
    pool = cell.generator.make(traffic, cell.config, args.seed, root)
    entry = cell.entry.Entry(cell.config, traffic, device)
    for idx in pool.warm:
        cell.entry.missing(pool.items[idx], entry.run(pool.items[idx]))
    if on_card:
        torch.cuda.synchronize()
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - start

    sample = Reservoir(int(traffic["check"]["sample"]),
                       pool_lib.seeded(args.seed, 5))
    spans = trace_lib.Spans(cell.entry.SPANS if args.trace else {})
    raw: dict = {}
    done, in_trace, errors = [], [], []
    missing = 0
    schedule = pool.schedule()
    spans.install()
    try:
        with (trace_lib.device_trace(raw) if args.trace
              else contextlib.nullcontext()):
            cpu_before = time.process_time()
            t_start = time.perf_counter_ns()
            deadline = t_start + int(args.seconds * 1e9)
            while time.perf_counter_ns() < deadline:
                idx = next(schedule)
                item = pool.items[idx]
                t1 = time.perf_counter_ns()
                try:
                    answer = entry.run(item)
                except Exception:  # a failed request is an unanswered one
                    answer = None
                    if len(errors) < 3:
                        errors.append(traceback.format_exc())
                t2 = time.perf_counter_ns()
                lost = cell.entry.missing(item, answer)
                request = {"latency_s": (t2 - t1) / 1e9, "cells":
                           item["cells"], "pairs": item["pairs"],
                           "span": (t1, t2)}
                if args.trace:
                    request["moves"] = (cell.entry.moves(item, answer)
                                        if answer is not None else 0)
                in_trace.append(request)
                if t2 <= deadline:
                    done.append(request)
                    missing += lost
                    sample.offer(item["cells"], (item, answer))
            t_end = time.perf_counter_ns()
            cpu_s = time.process_time() - cpu_before
    finally:
        spans.remove()
    seconds = (deadline - t_start) / 1e9
    gc.unfreeze()

    peak = torch.cuda.max_memory_allocated(0) if on_card else 0
    del entry
    gc.collect()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    rec = Record(setup_s=setup_s, seconds=seconds, done=done,
                 aligns=bool(cell.entry.ALIGNS), spans=spans.totals())
    if args.trace:
        rec.traced = {key: sum(r.get(key, 0) for r in in_trace)
                      for key in ("pairs", "cells", "moves")}
        rec.traced["requests"] = len(in_trace)
        host = dict(spans.spans)
        host["request"] = [r["span"] for r in in_trace]
        rec.trace = trace_lib.reduce(raw, (t_start, t_end), host)

    samples = sample.sample()
    if args.control is not None and samples:
        answers = cell.entry.control(cell.config, traffic, samples, device,
                                     args.control)
        samples = [(item, a) for (item, _), a in zip(samples, answers)]
    t_check = time.perf_counter()
    reasons = (cell.entry.check(cell.config, traffic, samples, device)
               if samples else [])
    check_s = time.perf_counter() - t_check
    wrong = [r for r in reasons if r is not None]
    checks = {
        "missing_answers": {"value": missing, "limit": 0, "rule": "<="},
        "wrong_answers": {"value": len(wrong), "limit": 0, "rule": "<="},
        "checked_pairs": {"value": len(reasons), "limit": 1, "rule": ">="},
    }
    correct = all(c["value"] <= c["limit"] if c["rule"] == "<="
                  else c["value"] >= c["limit"] for c in checks.values())

    metrics = {}
    for m, reader in cell.metrics:
        value = reader.read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    found = forbidden_modules()
    if found:
        print(f"cellbench: loaded in the run: {', '.join(found)}",
              file=sys.stderr)
        return 3

    dev = {"platform": "gpu" if on_card else str(device),
           "kind": torch.cuda.get_device_name(0) if on_card else str(device),
           "count": chips, "memory_peak_bytes": int(peak)}
    if rec.trace is not None:
        dev["busy_s"] = rec.trace["busy_s"]
        dev["window_s"] = rec.trace["window_s"]
    result = {"correct": bool(correct),
              "attempted": sum(r["pairs"] for r in done),
              "failed": int(missing), "metrics": metrics, "device": dev}
    if rec.trace is not None:
        result["breakdown"] = {"device_ops": rec.trace["device_ops"],
                               "idle_gaps": rec.trace["idle_gaps"]}
    result["checks"] = checks

    lat = [r["latency_s"] for r in done]
    err = sys.stderr
    for text in errors:
        print(text, file=err)
    print(f"cellbench: {cell.workload['name']} seed {args.seed}: "
          f"{len(done)} requests ({result['attempted']} pairs) in "
          f"{seconds:.3f} s, median "
          f"{1e3 * statistics.median(lat) if lat else math.nan:.3f} ms, "
          f"setup {setup_s:.3f} s, check {check_s:.3f} s, peak "
          f"{int(peak)} B, card {power_limit() if on_card else device}",
          file=err)
    print(f"cellbench: mean latency by fifth of the window (ms): "
          f"{_by_fifth(done, t_start, deadline)}; the process's CPU time "
          f"{cpu_s:.3f} s", file=err)
    if wrong:
        print(f"cellbench: wrong answers by rule: "
              f"{dict(collections.Counter(wrong))}", file=err)
    if args.control is not None:
        print(f"cellbench: the control {args.control!r} judged in the "
              f"program's place", file=err)
    for name, c in checks.items():
        print(f"cellbench check: {name} {c['value']} (limit {c['rule']} "
              f"{c['limit']})", file=err)
    err.flush()
    print(json.dumps(result))
    sys.stdout.flush()
    return 0


def _by_fifth(done, t0, t1) -> list:
    """Mean latency (ms) of the requests started in each fifth of the
    window."""
    fifths: list = [[] for _ in range(5)]
    for r in done:
        k = min(4, int(5 * (r["span"][0] - t0) / max(1, t1 - t0)))
        fifths[k].append(r["latency_s"])
    return [round(1e3 * sum(v) / len(v), 3) if v else None for v in fifths]

