"""P1: the cost of a dependent chain of loads on the card.

The counterpart of the JAX package's
``scripts/probe_walk_costs.py::probe_pallas_chase``, which timed a chain
of dynamic scalar loads over a 2 MiB VMEM table inside a Pallas kernel
(the per-move cost of an in-kernel walker).  ``chase`` runs the same
recurrence on one thread over a (rows, 128) int32 table, rows a power of
two: acc = seed, r0 = seed & (rows - 1), r2 = 0, and at step k
v = table[r0, r2], acc += v, r0 = (v + k) & (rows - 1),
r2 = (v >> 6) & 127; it returns acc (wrapping int32) as a (1,) tensor.
The kernel (``csrc/probe_chase.cu``) reads the table from shared memory
or from global memory; ``chase_plain`` is the plain version.

``python -m seqalign_torch.probes.walk_costs`` times STEPS steps over
each table of TABLES (shared memory at 32 KiB, the size a K2 window of
word rows would take, and at the largest power of two one block holds;
L2 at 16 MiB; HBM at 1 GiB) and prints ns a step, each acc held against
the plain version.
"""

from __future__ import annotations

import ctypes
import sys

import torch

from ..ops._build import check_launch, library

LANE = 128
STEPS = 262_144  # the JAX probe's
SEED = 1
# (name, rows, shared): tables of rows x 128 int32.
TABLES = (
    ("shared 32 KiB", 64, True),
    ("shared 128 KiB", 256, True),
    ("L2 16 MiB", 32_768, False),
    ("HBM 1 GiB", 1 << 21, False),
)


def _check(table, steps):
    if (table.dtype != torch.int32 or table.dim() != 2
            or table.shape[1] != LANE or not table.is_contiguous()):
        raise ValueError(f"the table must be a contiguous (rows, {LANE}) "
                         f"int32 tensor")
    rows = table.shape[0]
    if rows < 1 or rows & (rows - 1):
        raise ValueError(f"rows must be a power of two, got {rows}")
    if steps < 0:
        raise ValueError("steps must be >= 0")


def chase_plain(table, steps=STEPS, seed=SEED):
    """The chain in plain Python over the table's values (copied to the
    host); returns acc as a (1,) int32 tensor on the table's device."""
    _check(table, steps)
    rows = table.shape[0]
    flat = table.reshape(-1).cpu()
    acc = seed
    r0, r2 = seed & (rows - 1), 0
    for k in range(steps):
        v = int(flat[r0 * LANE + r2])
        acc += v
        r0 = (v + k) & (rows - 1)
        r2 = (v >> 6) & (LANE - 1)
    acc = ((acc + (1 << 31)) % (1 << 32)) - (1 << 31)
    return torch.tensor([acc], dtype=torch.int32, device=table.device)


def _kernel():
    fn = library("probe_chase").sa_probe_chase
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, i, i, i, p, p]
        fn.restype = ctypes.c_int
    return fn


def chase_launch(table, steps=STEPS, seed=SEED, shared=False):
    """The chase kernel on a CUDA table, ready to launch: returns (launch,
    out); each ``launch()`` runs it once and counts in ``chase.launches``.
    ``shared``: the block copies the table to shared memory first."""
    _check(table, steps)
    if table.device.type != "cuda":
        raise ValueError("the chase kernel runs on a CUDA device")
    out = torch.empty(1, dtype=torch.int32, device=table.device)

    def launch():
        with torch.cuda.device(table.device):
            stream = torch.cuda.current_stream(table.device).cuda_stream
            rc = _kernel()(table.data_ptr(), table.shape[0], steps, seed,
                           int(shared), out.data_ptr(), stream)
        check_launch("probe_chase", rc)
        chase.launches += 1

    return launch, out


def chase(table, steps=STEPS, seed=SEED, shared=False):
    """acc of the chain over ``table``: the kernel for a CUDA table (from
    shared memory with ``shared``), ``chase_plain`` for a CPU one."""
    _check(table, steps)
    if table.device.type == "cpu":
        return chase_plain(table, steps, seed)
    launch, out = chase_launch(table, steps, seed, shared)
    launch()
    return out


chase.launches = 0


def make_table(rows, seed=0, device="cuda"):
    """(rows, 128) int32 values in [0, 2^20), the JAX probe's range, from
    a seeded generator on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, 1 << 20, (rows, LANE), generator=gen,
                         dtype=torch.int32, device=device)


def run(steps=STEPS, device="cuda"):
    """Every table of TABLES on the card: the kernel's acc against the
    plain version's, and the kernel's time (CUDA events, best of 3, warm:
    the table read once before).  Returns one dict a table: name, rows,
    bytes, exact, ms, ns_per_step, plain_ms."""
    out = []
    for name, rows, shared in TABLES:
        table = make_table(rows, device=device)
        launch, acc = chase_launch(table, steps, SEED, shared)
        int(table.sum())  # warm the table where it fits a cache
        best = None
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            launch()
            stop.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(stop)
            best = ms if best is None else min(best, ms)
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        want = chase_plain(table, steps, SEED)
        t1.record()
        torch.cuda.synchronize()
        out.append({"name": name, "rows": rows, "shared": shared,
                    "bytes": rows * LANE * 4, "steps": steps,
                    "exact": torch.equal(acc, want), "acc": int(acc),
                    "want": int(want), "ms": best,
                    "ns_per_step": best * 1e6 / steps,
                    "plain_ms": t0.elapsed_time(t1)})
        del table
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("walk_costs: no CUDA device", file=sys.stderr)
        return 1
    ok = True
    for r in run():
        ok &= r["exact"]
        print(f"chase {r['name']}: {r['ns_per_step']:.1f} ns/step "
              f"({r['ms']:.3f} ms / {r['steps']} steps), acc {r['acc']} "
              f"{'==' if r['exact'] else '!='} plain {r['want']}",
              flush=True)
    print(f"device: {torch.cuda.get_device_name(0)}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
