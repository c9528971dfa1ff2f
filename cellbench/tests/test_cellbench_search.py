"""The ``db.score`` cell: it resolves by name, and a toy copy of it (a
small database, two short queries) runs end to end on the CPU through
the port's plain versions, correct, and incorrect under each control."""

import json
import os

import numpy as np
import pytest

from cellbench import harness
from cellbench.entries import db_search
from cellbench.gen import protein_db

from .conftest import REPO
from .toy import run_toy

TOY_TRAFFIC = {"generator": "protein_db", "entry": "db_search",
               "check": {"sample": 2, "always": 2, "sequences": 48,
                         "longest": 8, "longest_share": 0.05}}


def _bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def _config():
    with open(os.path.join(REPO, "cellbench", "configs",
                           "protein_swissprot_search.json")) as f:
        return json.load(f)


def toy_config():
    """The configuration at a toy's scale: 300 sequences of median 60
    letters, the longest 2,000, two queries, three homologs each."""
    config = _config()
    config.update(name="toy_protein", queries=config["queries"][:2])
    config["database"] = dict(config["database"], sequences=300)
    config["database"]["lengths"] = dict(config["database"]["lengths"],
                                         median=60, longest=2000)
    config["homologs"] = dict(config["homologs"], per_query=3)
    return config


def add_toy_db_cell(root):
    """The toy configuration, traffic and cell ``toy.db`` added to the copy
    of the benchmark at ``root``, reporting what ``db.score`` reports."""
    bench_dir = os.path.join(root, "cellbench")
    with open(os.path.join(bench_dir, "configs", "toy_protein.json"),
              "w") as f:
        json.dump(toy_config(), f)
    with open(os.path.join(bench_dir, "traffic", "toy.db.json"), "w") as f:
        json.dump(TOY_TRAFFIC, f)
    os.makedirs(os.path.join(root, "data", "protein"), exist_ok=True)
    for q in toy_config()["queries"]:
        with open(os.path.join(REPO, q["file"]), "rb") as src, \
                open(os.path.join(root, q["file"]), "wb") as dst:
            dst.write(src.read())
    path = os.path.join(root, "BENCHMARK.json")
    bench = json.load(open(path))
    bench["configs"].append({"name": "toy_protein", "source": "toy",
                             "file": "cellbench/configs/toy_protein.json",
                             "reduced": [], "why": "toy"})
    bench["workloads"].append({"name": "toy.db", "config": "toy_protein",
                               "traffic": "toy.db", "chips": 1,
                               "why": "toy"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "db.score" in m.get("workloads", ()):
            m["workloads"].append("toy.db")
    json.dump(bench, open(path, "w"))


@pytest.mark.parametrize("traced", [False, True])
def test_the_db_cell_resolves_by_name(traced):
    c = harness.resolve(_bench(), "db.score", traced)
    assert c.generator is protein_db and c.entry is db_search
    names = {m["name"] for m, _ in c.metrics}
    if traced:
        assert names == {"fill_roofline.search", "tail_ms.search",
                         "dispatch_ms.search", "device_idle.pair"}
    else:
        assert names == {"gcups", "p90_ms", "setup_s"}


def test_the_generator_plants_homologs_and_the_longest():
    config = toy_config()
    pool = protein_db.make(TOY_TRAFFIC, config, 2**31 + 12345, REPO)
    db = pool.items[0]["db"]
    assert db.lengths.shape[0] == 300 and db.lengths.max() == 2000
    assert all(it["db"] is db for it in pool.items)
    assert pool.items[pool.warm[0]]["id"] == "P05013"
    for item in pool.items:
        assert item["cells"] == len(item["query"]) * int(db.lengths.sum())
        assert len(db.homologs[item["id"]]) == 3
    again = protein_db.make(TOY_TRAFFIC, config, 2**31 + 12345, REPO)
    assert np.array_equal(again.items[0]["db"].letters, db.letters)
    assert sorted(pool.order(0)) == [0, 1]


def test_the_longest_are_always_judged():
    config = toy_config()
    pool = protein_db.make(TOY_TRAFFIC, config, 2**31 + 777, REPO)
    for item in pool.items:
        db = item["db"]
        idx = db_search.judged(TOY_TRAFFIC, item, None)
        assert set(np.argsort(-db.lengths, kind="stable")[:2]) <= set(idx)
        assert set(db.homologs[item["id"]]) <= set(idx)


def test_a_toy_db_cell_runs(bench_copy):
    add_toy_db_cell(bench_copy)
    rc, result, err = run_toy(bench_copy, "toy.db", seconds=3.0)
    assert rc == 0, err
    assert result["correct"] is True, err
    assert set(result["metrics"]) == {"gcups", "p90_ms", "setup_s"}
    assert result["failed"] == 0 and result["attempted"] % 300 == 0
    assert result["checks"]["checked_pairs"]["value"] >= 48


def test_a_toy_db_traced_line(bench_copy):
    add_toy_db_cell(bench_copy)
    rc, result, err = run_toy(bench_copy, "toy.db", seconds=3.0, trace=1)
    assert rc == 0, err
    assert result["metrics"]["dispatch_ms.search"]["value"] > 0
    assert not {"gcups", "p90_ms", "setup_s"} & set(result["metrics"])


@pytest.mark.parametrize("control", db_search.CONTROLS)
def test_the_db_controls_are_judged_wrong(bench_copy, control):
    add_toy_db_cell(bench_copy)
    rc, result, err = run_toy(bench_copy, "toy.db", seconds=3.0,
                              extra=["--control", control])
    assert rc == 0, err
    assert result["correct"] is False
    assert result["checks"]["wrong_answers"]["value"] > 0


def test_the_entry_refuses_a_program_without_the_search(monkeypatch):
    from seqalign_torch.parallel import BatchAligner

    monkeypatch.delattr(BatchAligner, "search")
    with pytest.raises(RuntimeError, match="database search"):
        db_search.Entry(_config(), TOY_TRAFFIC, "cpu")
