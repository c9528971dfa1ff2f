"""Run one cell of BENCHMARK.json traced, with the program's own spans.

    python3 tools/program_trace.py --workload genome.long --seed 7 \\
        --seconds 51 [--program 0]

The run is ``cellbench/run.py --trace 1``'s, with its window inside
``seqalign_torch.tracing.recording()``: the breakdown's idle gaps are named
by the deepest program span that covers them (by ``request`` or ``emit``
only where none does), and a last line ``{"program": ...}`` gives
``cellbench.program``'s split of the window's idle time by span, the
program's counters, the per-layer numbers read from them, and the traced
requests' median and p90 latency.  ``--program 0`` makes the same traced
run without the recording, to measure what the recording costs.  The
benchmark's own harness records no program spans.
"""

import time

START = time.perf_counter()

import argparse  # noqa: E402
import collections  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--program", type=int, choices=(0, 1), default=1,
                   help="record the program's spans in the window")
    args, rest = p.parse_known_args(argv)

    from cellbench import harness, program, trace
    from seqalign_torch import tracing

    state: dict = {}
    device_trace, reduce = trace.device_trace, trace.reduce

    @contextlib.contextmanager
    def recorded(raw):
        with device_trace(raw):
            with (tracing.recording() if args.program
                  else contextlib.nullcontext()) as rec:
                yield
        state["rec"] = rec

    def named(raw, window_ns, host_spans, top=10):
        spans = state["rec"].spans if state.get("rec") else []
        state.update(raw=raw, window=window_ns,
                     requests=host_spans["request"])
        return reduce(raw, window_ns, {**program.labels(spans), **host_spans},
                      top)

    trace.device_trace, trace.reduce = recorded, named
    try:
        rc = harness.main(rest + ["--trace", "1"], start=START)
    finally:
        trace.device_trace, trace.reduce = device_trace, reduce
    if rc or "raw" not in state:
        return rc or 1

    rec = state.get("rec")
    spans = rec.spans if rec else []
    counters = dict(rec.counters) if rec else {}
    split = program.apportion(state["raw"], state["window"], spans)
    window_s = (state["window"][1] - state["window"][0]) / 1e9
    lat = sorted((b - a) / 1e6 for a, b in state["requests"])
    exclusive = sum(v["exclusive_s"] for v in split["spans"].values())
    print(json.dumps({"program": {
        "recorded": bool(args.program),
        "requests": len(lat),
        "median_ms": statistics.median(lat) if lat else None,
        "p90_ms": lat[math.ceil(0.9 * len(lat)) - 1] if lat else None,
        "window_s": window_s,
        "idle_s": split["idle_s"],
        "outside_s": split["outside_s"],
        "unbalanced_share": (exclusive + split["outside_s"]
                             - split["idle_s"]) / window_s,
        "routes": dict(collections.Counter(
            s.attrs.get("route") for s in spans if s.name == program.ROOT)),
        "spans": split["spans"],
        "counters": counters,
        "metrics": program.layer_metrics(split, counters, len(lat)),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
