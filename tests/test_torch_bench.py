"""The port's benchmark entry points on the CPU (the plain versions, under
SEQALIGN_TORCH_DEVICE=cpu): K1's score-only ``wavefront_fill`` against
the JAX one in interpret mode and the oracle, exactly; every verb of
``seqalign_torch.bench.suite``, the headline and the batch-e2e record at
tiny sizes, their output's format; and that none of them runs without a
CUDA device unless the setting asks for the CPU."""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from seqalign_torch.bench import batch_e2e, headline, suite, timing
from seqalign_torch.models import SmithWaterman
from seqalign_torch.native import bindings
from seqalign_torch.ops import batch_fill
from seqalign_torch.ops import wavefront as port_wf
from seqalign_tpu.ops import wavefront as jax_wf

from .torch_support import one_torch_thread, score_matrix  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUMBER = r"(?:-?[0-9.]+|nan)"


@pytest.fixture
def on_cpu(monkeypatch):
    monkeypatch.setenv("SEQALIGN_TORCH_DEVICE", "cpu")


@pytest.mark.parametrize("local,k,rps,slots,n,m", [
    (False, 4, 1, 128, 300, 290), (True, 4, 1, 128, 300, 290),
    (False, 23, 2, 128, 100, 300), (True, 23, 2, 128, 100, 300),
    (True, 4, 4, 4096, 50, 40),  # the maxlength verb's strips
])
def test_score_only_fill_matches_jax_and_oracle(local, k, rps, slots, n, m):
    rng = np.random.default_rng(31 * n + m + k)
    sm, gap = score_matrix(k), 5 if k == 4 else 10
    text = rng.integers(0, k, n).astype(np.int32)
    pattern = rng.integers(0, k, m).astype(np.int32)
    got = port_wf.wavefront_fill(text, pattern, sm, k, gap, local=local,
                                 with_dirs=False, rps=rps, slots=slots,
                                 device="cpu")
    want = jax_wf.wavefront_fill(text, pattern, sm, k, gap, local=local,
                                 with_dirs=False, rps=rps, slots=slots,
                                 interpret=True)
    assert got[3] is None and want[3] is None
    assert (got[:3], got[4]) == (tuple(want[:3]), want[4])
    _, score, best = bindings.oracle_fill(int(local), text, pattern, sm, k,
                                          gap)
    assert got[0] == score
    if local and score > 0:
        assert (got[1], got[2]) == divmod(best, n + 1)


def test_timing_counts_every_call_on_the_cpu():
    calls = []
    sec = timing.device_seconds_per_call(lambda: calls.append(1), reps=4,
                                         timings=3, device="cpu")
    assert len(calls) == 12 and sec >= 0  # no warm call on the CPU
    assert timing.wall_seconds(lambda: calls.append(1), repeats=2) >= 0
    assert len(calls) == 14


def table_rows(out, header):
    """The lines after ``header`` in printed output."""
    lines = out.splitlines()
    return lines[lines.index(next(x for x in lines if x.split() == header))
                 + 1:]


@pytest.mark.parametrize("local", [False, True], ids=["global", "local"])
def test_throughput_verb(on_cpu, capsys, local):
    rows = suite.throughput(local=local, sizes=[(64, 48)], reps=1, timings=1)
    out = capsys.readouterr().out
    assert out.splitlines()[0].startswith(
        f"Fill throughput ({'local' if local else 'global'})")
    (line,) = table_rows(out, ["size", "gpu", "ms", "gpu", "MCUPS", "cpu",
                               "ms", "cpu", "MCUPS"])
    assert re.fullmatch(rf"\s+64x48\s+({NUMBER}\s+){{3}}{NUMBER}", line)
    assert rows[0]["gpu_ms"] > 0 and rows[0]["cpu_ms"] > 0


def test_latency_verb(on_cpu, capsys):
    rows = suite.latency(sizes=[(60, 50)], repeats=1)
    out = capsys.readouterr().out
    lines = table_rows(out, ["size", "algo", "gpu", "ms", "cpu", "ms"])
    assert [x.split()[:2] for x in lines] == [["60x50", "global"],
                                              ["60x50", "local"]]
    assert [r["algo"] for r in rows] == ["global", "local"]


@pytest.mark.parametrize("kw", [dict(dna=True), dict(semi=True),
                                dict(dna=True, affine_extend=2)],
                         ids=["dna-local", "protein-semi", "dna-affine"])
def test_batch_verb(on_cpu, capsys, kw):
    rows = suite.batch(size=32, pairs=[8, 16], timings=1, **kw)
    out = capsys.readouterr().out
    assert out.splitlines()[0].startswith("Batch throughput, 32x32")
    lines = table_rows(out, ["batch", "ms", "pairs/s", "GCUPS"])
    assert [x.split()[0] for x in lines] == ["8", "16"]
    assert [r["pairs"] for r in rows] == [8, 16]
    assert not rows[0]["cell16"]


def test_batch_verb_takes_the_int16_setting(on_cpu, capsys, monkeypatch):
    monkeypatch.setenv("SEQALIGN_INT16_CELLS", "1")
    seen = []
    real = batch_fill.batch_score

    def spy(*args, **kwargs):
        seen.append(kwargs["cell16"])
        return real(*args, **kwargs)

    monkeypatch.setattr(batch_fill, "batch_score", spy)
    rows = suite.batch(size=32, dna=True, pairs=[8], timings=1)
    assert rows[0]["cell16"] and seen and all(seen)
    assert "int16 cells" in capsys.readouterr().out


def test_batch_e2e_verb(on_cpu, capsys):
    rows = suite.batch_e2e(size=32, dna=True, local=True, pairs=[4, 8],
                           repeats=1)
    out = capsys.readouterr().out
    lines = table_rows(out, ["batch", "ms", "pairs/s", "GCUPS", "e2e"])
    assert [x.split()[0] for x in lines] == ["4", "8"]
    assert rows[1]["pairs_per_s"] > 0


def test_maxlength_verb_engines_agree(on_cpu, capsys):
    """K1 score-only and the tiled fill (K5) give one score, the model's
    ``score()`` and the oracle's."""
    wave = suite.maxlength(lengths=[60], engine="wavefront", repeats=1)
    tiled = suite.maxlength(lengths=[60], engine="tiled", repeats=1)
    out = capsys.readouterr().out
    assert re.search(r"^60x60 \(wavefront\): \d+ ms \(\d+ MCUPS\), "
                     r"score=\d+$", out, re.M)
    assert re.search(r"^60x60 \(tiled\): ", out, re.M)
    (_, text, pattern), = suite.maxlength_pairs([60])
    sm = suite.DNA_5_4
    want = bindings.oracle_fill(1, text, pattern, sm, 4, 5)[1]
    assert wave[0]["score"] == tiled[0]["score"] == want
    assert SmithWaterman().score(text, pattern, sm, 4, 5) == want


def test_engines_verb(on_cpu, capsys):
    rows = suite.engines(size=48, reps=1, timings=1)
    out = capsys.readouterr().out.splitlines()
    assert out[0].split(":")[1].strip() == "not ported (ops/scan_engine.py)"
    assert [r["engine"] for r in rows] == [
        "xla scan engine", "K5 strip fill", "K1 wavefront route 8x1024",
        "K1 4096-slot 4x4096", "K1 deep-strip 16x4096"]
    for line in out[1:]:
        assert re.fullmatch(r"K[15] .*: +[0-9.]+ ms +\d+ MCUPS", line)


@pytest.mark.parametrize("argv", [
    ["batch", "--size", "16", "--dna", "--pairs", "4"],
    ["batch-e2e", "--size", "16", "--pairs", "4"],
    ["maxlength", "--lengths", "40", "--engine", "tiled"],
], ids=["batch", "batch-e2e", "maxlength"])
def test_suite_command_line(on_cpu, capsys, argv):
    assert suite.main(argv) == 0
    assert capsys.readouterr().out.strip()


def test_headline_last_line_is_the_record(on_cpu, capsys):
    record = headline.run(pairs=8, size=32, reps=1, timings=1)
    captured = capsys.readouterr()
    last = json.loads(captured.out.strip().splitlines()[-1])
    assert last == record
    assert set(last) == {"metric", "value", "unit", "vs_baseline"}
    assert (last["metric"], last["unit"]) == ("sw_batch_fill", "GCUPS")
    # value is GCUPS to 3 places, vs_baseline GCUPS / 14.354 to 4.
    assert abs(last["vs_baseline"] * 14.354 - last["value"]) <= (
        0.0005 + 0.00005 * 14.354)
    assert re.search(r"\[headline:K3\] 8 pairs 32x32 on cpu: ",
                     captured.err)


def test_batch_e2e_record(on_cpu, capsys, tmp_path):
    path = tmp_path / "record.json"
    record = batch_e2e.run(pairs=8, size=32, warm_reps=2, out=str(path))
    lines = capsys.readouterr().out.strip().splitlines()
    assert [x.split("]")[0] for x in lines[:3]] == [
        "[batch-e2e:cold", "[batch-e2e:warm0", "[batch-e2e:warm1"]
    assert json.loads(lines[-1]) == record == json.loads(path.read_text())
    assert (record["metric"], record["pairs"], record["size"]) == (
        "dna_batch_e2e", 8, 32)
    assert len(record["warm_walls_s"]) == 2


@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA host runs it")
@pytest.mark.parametrize("module", ["headline", "batch_e2e"])
def test_entry_points_need_cuda_or_the_cpu_setting(module):
    env = {k: v for k, v in os.environ.items()
           if k != "SEQALIGN_TORCH_DEVICE"}
    proc = subprocess.run(
        [sys.executable, "-m", f"seqalign_torch.bench.{module}"], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"metric"' not in proc.stdout
