"""A toy cell added as data alone: small genomes and small windows,
through the port's plain versions on the CPU."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

from .conftest import REPO

MUTATION = {"delete": 0.05, "insert": 0.02, "substitute": 0.05}
SMALL = ("NC_018874", "GCA_003231495")
TRAFFIC = {
    "toy.global": {"generator": "genome_pairs", "entry": "pair_align",
                   "mode": "global", "genomes": ["GCA_003231495"],
                   "pattern": {"lengths": [80, 160]},
                   "mutation": MUTATION, "variants": 2,
                   "check": {"sample": 3}},
    "toy.local": {"generator": "genome_pairs", "entry": "pair_align",
                  "mode": "local", "genomes": list(SMALL),
                  "pattern": {"lengths": [60, 120]},
                  "mutation": MUTATION, "variants": 2,
                  "check": {"sample": 3}},
}
LIKE = {"toy.global": "genome.long", "toy.local": "genome.direct"}
# Runs the harness on the CPU; argv[1] is the benchmark's root, argv[2] a
# fault to plant in the port ("" for none), the rest the run's arguments.
DRIVER = r'''
import os, sys
os.environ["SEQALIGN_TORCH_DEVICE"] = "cpu"
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(1)
root, fault = sys.argv[1], sys.argv[2]
if fault == "token":
    from seqalign_torch.native import bindings
    def alter(fn):
        def altered(*a, **kw):
            at, ap, st, sp = fn(*a, **kw)
            at = at.copy()
            at[len(at) // 2] = (at[len(at) // 2] + 1) % 5
            return at, ap, st, sp
        return altered
    bindings.emit_moves = alter(bindings.emit_moves)
    bindings.traceback_skewed = alter(bindings.traceback_skewed)
from cellbench import harness
sys.exit(harness.main(sys.argv[3:], device="cpu", root=root,
                      bench_dir=os.path.join(root, "cellbench")))
'''


def add_toy_cells(root, cells=tuple(TRAFFIC)) -> None:
    """Add the toy configuration, traffic files and cells to the copy of
    the benchmark at ``root``: new files and new entries only."""
    sys.path.insert(0, REPO)
    from cellbench import dna

    bench_dir = os.path.join(root, "cellbench")
    genomes = []
    for gid in SMALL:  # the checkout's data files
        rel = f"data/dna/{gid}.txt"
        os.makedirs(os.path.join(root, "data", "dna"), exist_ok=True)
        shutil.copy(os.path.join(REPO, rel), os.path.join(root, rel))
        genomes.append({"id": gid, "file": rel,
                        "letters": len(dna.load(os.path.join(root, rel)))})
    with open(os.path.join(bench_dir, "configs",
                           "dna_genome_pair.json")) as f:
        config = json.load(f)
    config.update(name="toy_pair", genomes=genomes)
    with open(os.path.join(bench_dir, "configs", "toy_pair.json"), "w") as f:
        json.dump(config, f)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "toy_pair", "source": "toy",
                             "file": "cellbench/configs/toy_pair.json",
                             "reduced": [], "why": "toy"})
    for cell in cells:
        with open(os.path.join(bench_dir, "traffic", f"{cell}.json"),
                  "w") as f:
            json.dump(TRAFFIC[cell], f)
        bench["workloads"].append({"name": cell, "config": "toy_pair",
                                   "traffic": cell, "chips": 1,
                                   "why": "toy"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if LIKE[cell] in m.get("workloads", ()):
                m["workloads"].append(cell)
    with open(path, "w") as f:
        json.dump(bench, f)


def run_toy(root, cell, fault="", seconds=2.0, trace=0, seed=20260101,
            extra=()):
    """Run a toy cell in a fresh process; returns (rc, result or None,
    stderr)."""
    proc = subprocess.run(
        [sys.executable, "-c", DRIVER.format(repo=REPO), str(root), fault,
         "--workload", cell, "--seed", str(seed), "--seconds",
         str(seconds), "--trace", str(trace), *extra],
        capture_output=True, text=True, timeout=600)
    lines = proc.stdout.strip().splitlines()
    result = json.loads(lines[-1]) if proc.returncode == 0 and lines else None
    return proc.returncode, result, proc.stderr
