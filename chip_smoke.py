#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``seqalign_torch``) on one GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failed check raises and the script exits non-zero
without its last line:

1. Build the CUDA kernels (K1 ``csrc/wavefront.cu``, K2 ``csrc/walk.cu``)
   and the native oracle from the sources, all at once.
2. K1 against its plain PyTorch version, on the card: global, local and
   semi-global, DNA and protein, at rps 8 and 16 with 4096 slots and at
   rps 8 with 1024 slots.  Every output is an integer, so the comparison
   is exact (tolerance 0).
3. K2 against its plain version on the words of phase 2, also with a
   move buffer shorter than the path.  Exact.
4. The main path: the ``-g`` command line (``cli.main``, the body of
   ``python -m seqalign_torch``) in this process on the bundled pairs,
   each compared byte for byte with ``python -m seqalign_torch -c`` (the
   native oracle) run in a subprocess.  The launch counters are set to 0
   just before and read just after, and show which route each pair took.
   One ``python -m seqalign_torch -g`` subprocess proves the module entry
   point in a fresh process.
5. Full width: the largest bundled pair the direct route takes,
   NC_045839 x GCA_003434045 (280,482 x 48,632, rps 16 x 4096 slots),
   through ``-g``.  Its score must equal the oracle's O(n)-memory
   score-only fill, and rescoring the printed alignment must give it too.
   Then each kernel is timed at this shape with CUDA events and held
   against its plain version there.
6. A JSON line of the kernels, the card's name and power limit from
   nvidia-smi, and ``{"ok": true, "device": {...}}``.

A host without a CUDA device fails at once and prints no result.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from seqalign_torch import cli
from seqalign_torch.io import parse_score_matrix_file
from seqalign_torch.native import bindings
from seqalign_torch.native.build import ensure_built
from seqalign_torch.ops import _build, direct, layout, walk, wavefront
from seqalign_torch.types import Request

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).  Memory:
# 3.35 TB/s.  int32: the 67 TFLOP/s float32 rate is 132 SMs x 128 lanes
# x 2 (an FMA counts twice) x 1.98 GHz; an SM has 64 int32 lanes, so
# int32 add/max/compare/select issue at a quarter of that figure.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4
# Integer operations per cell of the linear fill: H = max(diag + s,
# max(top, left) - gap) is 4; the 2-bit direction (two compares, two
# selects, a shift and an or into the word) is 6.
K1_OPS_PER_CELL = 10
# Per move of the walk: the cell's slot, row and step (4), the word's
# index (2), the 2 bits out of it (2), packing them (2), the i/j step (2).
K2_OPS_PER_MOVE = 12

DNA = ("data/dna/dna_01.txt", "data/dna/dna_02.txt")
NC_034972 = ("data/dna/NC_034972.1.txt", "data/dna/mutated_NC_034972.1.txt")
# (route the pair must take, argv after -g / -c)
MAIN_PATH = [
    ("wavefront", [*DNA]),
    ("wavefront", ["-p", "data/protein/P04775.fasta",
                   "data/protein/P10635.fasta"]),
    ("direct", ["--protein", "--gap-penalty", "10", "--local",
                "data/protein/P08519.fasta", "data/protein/P10635.fasta"]),
    ("direct", ["--global", *NC_034972]),
    ("direct", ["--local", *NC_034972]),
    ("direct", ["--semi-global", *NC_034972]),
]
FULL_WIDTH = ["data/dna/NC_045839.txt", "data/dna/GCA_003434045.txt"]


def log(*parts):
    print(*parts, flush=True)


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def in_thread(fn, *args):
    """Run fn(*args) in a daemon thread (native calls and subprocess
    pipes release the GIL); returns a function that waits and returns
    its value or raises its exception."""
    box = {}

    def run():
        try:
            box["value"] = fn(*args)
        except BaseException as e:  # handed to the caller by result()
            box["error"] = e

    thread = threading.Thread(target=run, daemon=True)
    thread.start()

    def result():
        thread.join()
        if "error" in box:
            raise box["error"]
        return box["value"]

    return result


class Subprocesses:
    """Subprocesses run beside the device phases; ``stop`` kills every
    one still running."""

    def __init__(self):
        self._procs = []

    def start(self, argv, env=None):
        proc = subprocess.Popen(
            argv, cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True,
        )
        self._procs.append(proc)

        def wait():
            out, err = proc.communicate()
            return proc.returncode, out, err

        return in_thread(wait)

    def stop(self):
        for proc in self._procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def port_cli(flag, argv):
    return [sys.executable, "-m", "seqalign_torch", flag, *argv]


def launches():
    return {"K1": wavefront.wavefront_strip.launches,
            "K2": walk.walk_skewed_window.launches}


def reset_launches():
    wavefront.wavefront_strip.launches = 0
    walk.walk_skewed_window.launches = 0


def run_cli(argv):
    """``cli.main`` in this process, stdout captured: (rc, stdout)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["alignSequence", *argv])
    torch.cuda.synchronize()
    return rc, out.getvalue()


def score_matrix(k):
    path = ("scoreMatrices/dna/blast.txt" if k == 4
            else "scoreMatrices/protein/blosum62.txt")
    sm = np.zeros((k, k), dtype=np.int32)
    check(parse_score_matrix_file(path, k, sm) == 0, f"cannot read {path}")
    return sm


def max_abs_err(got, want):
    """Largest |a - b| over pairs of int32 tensors of equal shape (words
    compared as int32), in chunks to bound the int64 temporaries."""
    err = 0
    chunk = 1 << 26
    for a, b in zip(got, want):
        check(a.shape == b.shape, f"shape {tuple(a.shape)} != "
                                  f"{tuple(b.shape)}")
        a, b = a.reshape(-1), b.reshape(-1)
        for s in range(0, a.numel(), chunk):
            d = (a[s:s + chunk].long() - b[s:s + chunk].long()).abs().max()
            err = max(err, int(d))
    return err


def cuda_ms(fn, *args, **kwargs):
    """(result, milliseconds) of one call, between CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn(*args, **kwargs)
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def ptxas_summary(path):
    """One line per kernel instantiation from ``nvcc -Xptxas -v``:
    registers, stack and spill bytes."""
    with open(path + ".log") as f:
        text = f.read()
    pattern = re.compile(
        r"Function properties for (\S+)\n\s+(\d+) bytes stack frame, "
        r"(\d+) bytes spill stores, (\d+) bytes spill loads\n"
        r"ptxas info\s+: Used (\d+) registers"
    )
    lines = []
    for name, stack, st, ld, regs in pattern.findall(text):
        args = re.search(r"ILi(\d+)ELi(\d+)ELb(\d)E", name)
        label = (f"<rps {args[1]}, slots/thread {args[2]}, track {args[3]}>"
                 if args else "")
        kernel = re.search(r"(wavefront_strip_kernel|walk_skewed_kernel)",
                           name)
        lines.append(f"  {kernel[1] if kernel else name}{label}: {regs} "
                     f"registers, stack {stack} B, spill stores {st} B, "
                     f"loads {ld} B")
    return lines


def strip_case(rng, n, m, k, rps, slots, local, semi, device):
    """Random one-strip inputs from row 0, as the JAX wrapper takes them,
    as tensors on ``device``."""
    text = rng.integers(0, k, n).astype(np.int32)
    pattern = rng.integers(0, k, m).astype(np.int32)
    steps = layout.steps_padded(n, slots)
    pat_pad = np.zeros(rps * slots, dtype=np.int32)
    pat_pad[:m] = pattern
    gap = 5 if k == 4 else 10
    bottom = direct.top_row(steps, gap, local or semi, "cpu").numpy()
    return gap, layout.from_reference_arrays(
        layout.text_steps(text, steps), bottom,
        layout.pattern_slots(pat_pad, rps, slots), score_matrix(k), k,
        device,
    )


def walk_start(out, n, m, rps, slots, local, semi):
    _, _, rowmax, argj, snap = out
    _, bi, bj = direct.best_cell(rowmax, argj, snap, rps, slots, n, m,
                                 local, semi)
    return bi, bj


def compare_walk(words, rps, i0, j0, local, max_moves):
    """K2 and its plain version from (i0, j0): (max_abs_err, result)."""
    mv, res = walk.walk_skewed_window(words, rps, 0, 0, i0, j0, local,
                                      max_moves)
    torch.cuda.synchronize()
    mv_p, res_p = walk.walk_skewed_window_plain(words, rps, 0, 0, i0, j0,
                                                local, max_moves)
    used = -(-int(res_p[0]) // 16)
    err = max_abs_err([res, mv[:used]], [res_p, mv_p[:used]])
    return err, [int(x) for x in res.cpu()]


def phase_kernels(device="cuda", n=4000,
                  geometries=((8, 4096), (16, 4096), (8, 1024))):
    """Phases 2 and 3: K1 and K2 against their plain versions."""
    rng = np.random.default_rng(2024)
    k1_err = k2_err = 0
    for rps, slots in geometries:
        for k in (4, 23):
            for mode in ("global", "local", "semi"):
                local, semi = mode == "local", mode == "semi"
                m = rps * slots - 3
                gap, args = strip_case(rng, n, m, k, rps, slots, local,
                                       semi, device)
                kw = dict(local=local, rps=rps, slots=slots, semi=semi)
                t0 = time.time()
                out = wavefront.wavefront_strip(*args, gap, n, m, 0, k, **kw)
                torch.cuda.synchronize()
                t1 = time.time()
                plain = wavefront.wavefront_strip_plain(*args, gap, n, m, 0,
                                                        k, **kw)
                torch.cuda.synchronize()
                err = max_abs_err(out, plain)
                check(err == 0, f"K1 {mode} k={k} rps={rps} slots={slots}: "
                                f"max_abs_err {err}")
                k1_err = max(k1_err, err)
                i0, j0 = walk_start(out, n, m, rps, slots, local, semi)
                werr, res = compare_walk(out[0], rps, i0, j0, local,
                                         -(-(n + m + 1) // 16) * 16)
                check(werr == 0, f"K2 {mode} k={k} rps={rps}: max_abs_err "
                                 f"{werr}")
                # A buffer of 64 moves: the walk stops there, done = 0.
                terr, tres = compare_walk(out[0], rps, i0, j0, local, 64)
                check(terr == 0 and (res[0] <= 64 or tres[0] == 64
                                     and tres[4] == 0),
                      f"K2 {mode} k={k} rps={rps}: short buffer {tres}")
                k2_err = max(k2_err, werr, terr)
                log(f"K1 {mode:6s} k={k:2d} rps={rps:2d} slots={slots}: "
                    f"exact, kernel {t1 - t0:.3f} s, plain "
                    f"{time.time() - t1:.2f} s; K2 from ({i0}, {j0}): "
                    f"exact, {res[0]} moves")
    return k1_err, k2_err


def phase_main_path(oracle_outputs):
    """Phase 4: ``-g`` in process against the ``-c`` subprocess outputs;
    returns the launches per route."""
    reset_launches()
    by_route = {"wavefront": {"K1": 0, "K2": 0}, "direct": {"K1": 0, "K2": 0}}
    for (route, argv), oracle in zip(MAIN_PATH, oracle_outputs):
        before = launches()
        t0 = time.time()
        rc, out = run_cli(["-g", *argv])
        wall = time.time() - t0
        delta = {k: v - before[k] for k, v in launches().items()}
        rc_c, out_c, err_c = oracle()
        check(rc == 0 and rc_c == 0, f"{argv}: rc -g {rc}, -c {rc_c} "
                                     f"{err_c}")
        check(out == out_c, f"{argv}: -g output differs from -c")
        if route == "direct":
            check(delta == {"K1": 1, "K2": 1}, f"{argv}: launches {delta}, "
                                               f"not the direct route")
        else:
            check(delta["K1"] >= 1 and delta["K2"] == 0,
                  f"{argv}: launches {delta}, not the wavefront route")
        for kname in delta:
            by_route[route][kname] += delta[kname]
        score = out.rstrip("\n").rsplit("\t", 1)[-1]
        log(f"-g {' '.join(argv)}: {route} route, launches {delta}, "
            f"{wall:.2f} s, Score {score}, byte-identical to -c")
    total = launches()
    check(total["K1"] == sum(r["K1"] for r in by_route.values()) and
          total["K2"] == sum(r["K2"] for r in by_route.values()),
          "launch counts do not add up")
    return by_route


def parse_alignment(out):
    """The aligned text and pattern rows from the pretty report."""
    lines = out.split("\n")
    text, pattern = [], []
    i = 0
    while not lines[i].startswith("#"):
        text.append(lines[i].split()[1])
        pattern.append(lines[i + 2].split()[1])
        i += 4
    return "".join(text), "".join(pattern)


def rescore(aligned_text, aligned_pattern, alphabet, sm, gap):
    """Linear-gap score of an alignment (gap = the last letter)."""
    table = np.full(256, -1, dtype=np.int64)
    for idx, letter in enumerate(alphabet):
        table[ord(letter)] = idx
    a = table[np.frombuffer(aligned_text.encode(), dtype=np.uint8)]
    b = table[np.frombuffer(aligned_pattern.encode(), dtype=np.uint8)]
    check((a >= 0).all() and (b >= 0).all(), "unknown letter in the output")
    k = len(alphabet) - 1
    gaps = (a == k) | (b == k)
    check(not ((a == k) & (b == k)).any(), "a column of two gaps")
    return int(sm[a[~gaps], b[~gaps]].sum()) - gap * int(gaps.sum())


def phase_full_width(oracle_score):
    """Phase 5: the full-width pair through -g, then each kernel timed
    at its shape and held against its plain version."""
    request = Request()
    check(cli.parse_arguments(["alignSequence", "-g", *FULL_WIDTH],
                              request, err=sys.stderr) == 0,
          "cannot read the full-width pair")
    text = np.asarray(request.text, dtype=np.int32)
    pattern = np.asarray(request.pattern, dtype=np.int32)
    n, m, k, gap = len(text), len(pattern), request.alphabet_size, \
        request.gap_penalty
    sm = layout.pack_score_matrix(request.score_matrix, k)
    rps, slots = direct._direct_geometry(m)
    check(direct.fits_direct(n, m), f"{m} x {n} does not fit the direct "
                                    f"route")

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.time()
    rc, out = run_cli(["-g", *FULL_WIDTH])
    wall = time.time() - t0
    counts = launches()
    peak = torch.cuda.max_memory_allocated()
    check(rc == 0, f"-g on the full-width pair: rc {rc}")
    check(counts == {"K1": 1, "K2": 1}, f"full width: launches {counts}")
    score = int(out.rstrip("\n").rsplit("\t", 1)[-1])
    aligned_text, aligned_pattern = parse_alignment(out)
    rescored = rescore(aligned_text, aligned_pattern, request.alphabet, sm,
                       gap)
    expected = oracle_score()
    check(score == expected == rescored,
          f"full width: -g Score {score}, oracle {expected}, rescored "
          f"{rescored}")
    log(f"full width {m} x {n} (rps {rps}, slots {slots}): -g wall "
        f"{wall:.2f} s, Score {score} == oracle score-only fill == "
        f"rescored alignment of {len(aligned_text)} columns; launches "
        f"{counts}; max_memory_allocated {peak} B")

    # Each kernel at this shape: CUDA-event time, then the plain version.
    ts, pat, sm_dev = direct.strip_inputs(text, pattern, sm, k, rps, slots,
                                          "cuda")
    bottom = direct.top_row(ts.numel(), gap, False, "cuda")
    args = (ts, bottom, pat, sm_dev, gap, n, m, 0, k)
    kw = dict(local=False, rps=rps, slots=slots, semi=False)
    k1_out, k1_ms = cuda_ms(wavefront.wavefront_strip, *args, **kw)
    max_moves = -(-(n + m + 1) // 16) * 16
    (mv, res), k2_ms = cuda_ms(walk.walk_skewed_window, k1_out[0], rps, 0,
                               0, m, n, False, max_moves)
    moves = int(res[0])
    log(f"full width: K1 {k1_ms:.3f} ms, K2 {k2_ms:.3f} ms "
        f"({moves} moves), CUDA events")

    t1 = time.time()
    k1_plain = wavefront.wavefront_strip_plain(*args, **kw)
    torch.cuda.synchronize()
    k1_plain_ms = (time.time() - t1) * 1e3
    k1_err = max_abs_err(k1_out, k1_plain)
    check(k1_err == 0, f"full width: K1 max_abs_err {k1_err}")
    del k1_plain
    t1 = time.time()
    mv_p, res_p = walk.walk_skewed_window_plain(k1_out[0], rps, 0, 0, m, n,
                                                False, max_moves)
    torch.cuda.synchronize()
    k2_plain_ms = (time.time() - t1) * 1e3
    used = -(-moves // 16)
    k2_err = max_abs_err([res, mv[:used]], [res_p, mv_p[:used]])
    check(k2_err == 0, f"full width: K2 max_abs_err {k2_err}")
    log(f"full width: plain K1 {k1_plain_ms:.1f} ms, plain K2 "
        f"{k2_plain_ms:.1f} ms; both exact")

    steps = ts.numel()
    cells = n * m
    k1_bytes = (4 * (2 * steps + rps * slots + k * k)       # inputs
                + cells // 4                                # 2-bit words
                + 4 * (steps + 2 * rps * slots + slots))    # stream, trackers
    k1_ops = cells * K1_OPS_PER_CELL
    k2_bytes = 4 * moves + 4 * used + 4 * 5   # one word per move, out
    k2_ops = moves * K2_OPS_PER_MOVE
    return {
        "shape": f"{m} x {n}, rps {rps}, slots {slots}, global",
        "wall_s": wall, "peak_bytes": peak, "counts": counts,
        "K1": bound(k1_bytes, k1_ops) | {
            "ms": k1_ms, "plain_ms": k1_plain_ms, "err": k1_err},
        "K2": bound(k2_bytes, k2_ops) | {
            "ms": k2_ms, "plain_ms": k2_plain_ms, "err": k2_err},
    }


def bound(nbytes, ops):
    """The least time of the work on an H100: bytes over the memory rate
    or int32 operations over the int32 rate, whichever is larger."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    os.chdir(REPO)
    procs = Subprocesses()
    try:
        return run(procs)
    finally:
        procs.stop()


def run(procs):
    t_start = time.time()
    # 1. Build: one nvcc per kernel source and g++ for the oracle, at once.
    oracle_lib = in_thread(ensure_built)
    kernels = _build.build_all()
    oracle_lib()
    log(f"build: {time.time() - t_start:.1f} s "
        f"({', '.join(sorted(kernels))} and the native oracle)")
    for path in kernels.values():
        for line in ptxas_summary(path):
            log(line)

    # Host work beside the device phases: the oracle's outputs for
    # phase 4, a fresh-process -g run, and the score-only fill for
    # phase 5 (ctypes releases the GIL).
    oracle_outputs = [procs.start(port_cli("-c", argv))
                      for _, argv in MAIN_PATH]
    module_g = procs.start(port_cli("-g", [*DNA]))
    full = Request()
    check(cli.parse_arguments(["alignSequence", *FULL_WIDTH], full) == 0,
          "cannot read the full-width pair")
    oracle_score = in_thread(
        lambda: bindings.oracle_fill_affine(
            0, full.text, full.pattern,
            layout.pack_score_matrix(full.score_matrix, full.alphabet_size),
            full.alphabet_size, full.gap_penalty, full.gap_penalty)[0])

    t0 = time.time()
    k1_err, k2_err = phase_kernels()
    log(f"phases 2-3 (K1, K2 against their plain versions): "
        f"{time.time() - t0:.1f} s")

    t0 = time.time()
    by_route = phase_main_path(oracle_outputs)
    rc_m, out_m, err_m = module_g()
    check(rc_m == 0 and out_m == oracle_outputs[0]()[1],
          f"python -m seqalign_torch -g: rc {rc_m}, {err_m}")
    log("python -m seqalign_torch -g " + " ".join(DNA)
        + ": byte-identical to -c")
    log(f"phase 4 (main path): {time.time() - t0:.1f} s, launches by "
        f"route {json.dumps(by_route)}")

    t0 = time.time()
    fw = phase_full_width(oracle_score)
    log(f"phase 5 (full width): {time.time() - t0:.1f} s")

    summary = []
    for name, source, replaces in (
        ("K1 wavefront_strip", "seqalign_torch/csrc/wavefront.cu",
         "seqalign_tpu/ops/wavefront.py:71"),
        ("K2 walk_skewed_window", "seqalign_torch/csrc/walk.cu",
         "seqalign_tpu/ops/pallas_walk.py:37"),
    ):
        kid = name[:2]
        err = max(fw[kid]["err"], k1_err if kid == "K1" else k2_err)
        summary.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": (by_route["wavefront"][kid] + by_route["direct"][kid]
                         + fw["counts"][kid]),
            "max_abs_err": err, "exact": err == 0,
            "ms": fw[kid]["ms"], "plain_ms": fw[kid]["plain_ms"],
            "bound_ms": fw[kid]["bound_ms"],
            "bound_by": fw[kid]["bound_by"], "library_ms": None,
            "shape": fw["shape"],
        })
    log(f"total: {time.time() - t_start:.1f} s")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(json.dumps({"kernels": summary}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
