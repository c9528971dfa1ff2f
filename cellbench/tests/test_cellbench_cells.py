"""BENCHMARK.json against the contract, every cell resolved by name, and
a toy cell added as data alone run end to end through the plain versions,
with its result line, its traced line and the faults it has to catch."""

import ast
import json
import os
import re
import subprocess
import sys

import pytest

from cellbench import harness

from .conftest import REPO
from .toy import add_toy_cells, run_toy

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_json_meets_the_contract():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["cellbench"]
    assert b["command"] == ["python3", "cellbench/run.py"]
    assert 1 <= b["run_seconds"] <= 51
    # A full check of 24 cells: 2 + 14 runs a cell, each of run_seconds
    # + 60 s, 2 x 90 s of compiling a cell and 1,200 s spare.
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("cellbench/")
        assert os.path.exists(os.path.join(REPO, c["file"]))
        names.add(c["name"])
    used = {w["config"] for w in b["workloads"]}
    assert used == names
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        for cell in m["workloads"]:
            reported = harness.metrics_of(b, cell, traced=False)
            assert m["moves"] in {x["name"] for x in reported}
    for cell in cells:
        assert len(harness.metrics_of(b, cell, traced=False)) >= 2
        assert harness.metrics_of(b, cell, traced=True)
    assert len(json.dumps(b)) < 64 * 1024


@pytest.mark.parametrize("cell", ["genome.long", "genome.direct"])
@pytest.mark.parametrize("traced", [False, True])
def test_every_cell_resolves_by_name(cell, traced):
    c = harness.resolve(_bench(), cell, traced)
    assert c.workload["name"] == cell
    assert hasattr(c.generator, "make") and hasattr(c.entry, "Entry")
    for fn in ("missing", "moves", "check", "control"):
        assert callable(getattr(c.entry, fn))
    assert c.entry.CONTROLS
    assert c.metrics and all(hasattr(r, "read") for _, r in c.metrics)


def test_run_needs_a_card():
    """Without a CUDA card the run exits non-zero and prints no result."""
    proc = subprocess.run(
        [sys.executable, "cellbench/run.py", "--workload", "genome.direct",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_run_needs_the_program(tmp_path):
    """In a directory with BENCHMARK.json and cellbench/ alone the run
    exits non-zero and prints no result."""
    import shutil

    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(REPO, "cellbench"), tmp_path / "cellbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    proc = subprocess.run(
        [sys.executable, "cellbench/run.py", "--workload", "genome.long",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert proc.returncode != 0 and proc.stdout.strip() == ""


TOY = ["toy.global", "toy.local"]


@pytest.mark.parametrize("cell", TOY)
def test_a_toy_cell_added_as_data_runs(bench_copy, cell):
    """New files and new BENCHMARK.json entries only: the harness finds the
    cell, runs it through the plain versions and judges it correct."""
    before = {p: open(p, "rb").read() for p in _files(bench_copy)}
    add_toy_cells(bench_copy, [cell])
    for p, data in before.items():
        if not p.endswith("BENCHMARK.json"):
            assert open(p, "rb").read() == data
    rc, result, err = run_toy(bench_copy, cell)
    assert rc == 0, err
    assert result["correct"] is True, err
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics",
                                "device"]
    assert list(result)[-1] == "checks"
    assert set(result["device"]) == {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    want = {m["name"] for m in harness.metrics_of(
        json.load(open(bench_copy / "BENCHMARK.json")), cell, False)}
    assert set(result["metrics"]) == want
    assert result["checks"]["checked_pairs"]["value"] >= 1
    assert err.strip().splitlines()[-1].startswith("cellbench check:")


def test_a_toy_traced_line(bench_copy):
    add_toy_cells(bench_copy, ["toy.local"])
    rc, result, err = run_toy(bench_copy, "toy.local", trace=1)
    assert rc == 0, err
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert not {"gcups", "p90_ms", "setup_s"} & set(result["metrics"])


def test_a_metric_added_as_data(bench_copy):
    add_toy_cells(bench_copy, ["toy.local"])
    with open(bench_copy / "cellbench" / "metrics" / "pairs_per_s.py",
              "w") as f:
        f.write("def read(rec):\n"
                "    return sum(r['pairs'] for r in rec.done) / rec.seconds\n")
    path = bench_copy / "BENCHMARK.json"
    bench = json.load(open(path))
    bench["end_to_end"].append({"name": "pairs_per_s", "unit": "pairs/s",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["toy.local"]})
    json.dump(bench, open(path, "w"))
    rc, result, err = run_toy(bench_copy, "toy.local")
    assert rc == 0, err
    assert result["metrics"]["pairs_per_s"]["value"] > 0


@pytest.mark.parametrize("cell", TOY)
def test_faults_make_the_run_incorrect(bench_copy, cell):
    """An answer altered where it is produced (the replay of the moves)."""
    add_toy_cells(bench_copy, [cell])
    rc, result, err = run_toy(bench_copy, cell, fault="token")
    assert rc == 0, err
    assert result["correct"] is False


@pytest.mark.parametrize("cell", TOY)
def test_the_control_is_judged_wrong(bench_copy, cell):
    """The control's answers in the program's place read correct false
    through the run's own check (the ties control: the int16 one needs
    scores above 32,767, test_cellbench_reference's)."""
    add_toy_cells(bench_copy, [cell])
    rc, result, err = run_toy(bench_copy, cell, seconds=2.0,
                              extra=["--control", "flipped"])
    assert rc == 0, err
    assert result["correct"] is False
    assert result["checks"]["wrong_answers"]["value"] > 0


def test_an_unknown_control_is_refused(bench_copy):
    add_toy_cells(bench_copy, ["toy.global"])
    rc, result, err = run_toy(bench_copy, "toy.global",
                              extra=["--control", "int8"])
    assert rc != 0 and result is None


def _files(root):
    out = []
    for d, _, files in os.walk(root):
        out.extend(os.path.join(d, f) for f in files)
    return out


def test_forbidden_modules_compare_whole_names():
    found = harness.forbidden_modules(["seqalign_torch", "seqalign_torch.ops",
                                       "jax_like", "flaxen", "numpy"])
    assert found == []
    found = harness.forbidden_modules(["seqalign_tpu.ops.wavefront", "jax",
                                       "jaxlib.xla_client", "flax.linen"])
    assert found == ["flax", "jax", "jaxlib", "seqalign_tpu"]


def test_a_run_loads_no_jax(bench_copy):
    """A whole toy run ends with no jax, jaxlib, flax or seqalign_tpu
    module loaded (the harness exits 3 where it finds one)."""
    add_toy_cells(bench_copy, ["toy.local"])
    rc, result, err = run_toy(bench_copy, "toy.local")
    assert rc == 0 and result is not None, err


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_benchmark_source_imports_jax():
    bad = set()
    for d, _, files in os.walk(os.path.join(REPO, "cellbench")):
        if os.path.basename(d) == "tests":
            continue
        for f in files:
            if f.endswith(".py"):
                tops = {m.split(".")[0] for m in _imports(os.path.join(d, f))}
                bad |= tops & set(harness.FORBIDDEN)
    assert bad == set()


def test_the_reference_imports_nothing_of_the_port():
    ref = os.path.join(REPO, "cellbench", "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            tops = {m.split(".")[0] for m in _imports(os.path.join(ref, f))}
            assert tops <= {"__future__", "dataclasses", "numpy", "torch"}
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys; sys.path.insert(0, sys.argv[1]);"
         "import cellbench.reference.dp, cellbench.reference.verify,"
         " cellbench.reference.walk;"
         "print(sorted({m.split('.')[0] for m in sys.modules}))", REPO],
        capture_output=True, text=True, timeout=120)
    loaded = set(json.loads(proc.stdout.replace("'", '"')))
    assert "seqalign_torch" not in loaded and "seqalign_tpu" not in loaded
    assert not loaded & set(harness.FORBIDDEN)


@pytest.mark.cuda
def test_a_cell_on_the_card(cuda_card):
    """A short run of the cheapest cell on the card is correct."""
    proc = subprocess.run(
        [sys.executable, "cellbench/run.py", "--workload", "genome.direct",
         "--seed", "31337", "--seconds", "3", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1])["correct"]

