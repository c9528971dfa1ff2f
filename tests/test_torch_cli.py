"""The slice as a whole: the port's command line (``python -m
seqalign_torch``) against its own oracle (-c) and the JAX package's CLI,
byte for byte, and its error paths.  The GPU engine runs its kernels'
plain versions here (SEQALIGN_TORCH_DEVICE=cpu)."""

import os
import subprocess
import sys

import pytest

import seqalign_torch.cli as port_cli
import seqalign_tpu.cli as jax_cli
from seqalign_torch import config, constants
from seqalign_torch.ops import checkpoint, direct, strip_fill, tiled, wavefront

from .torch_support import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DNA = ["data/dna/dna_01.txt", "data/dna/dna_02.txt"]
PROTEIN = ["-p", "data/protein/P56980.fasta",
           "data/protein/mutated_P56980.fasta"]
MODES = ["--global", "--local", "--semi-global"]


def run_main(main, argv, capsys):
    capsys.readouterr()
    rc = main(["alignSequence", *argv])
    return rc, capsys.readouterr().out


def run_port(argv, device="cpu"):
    """The port's CLI in a subprocess: (rc, stdout, stderr)."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("SEQALIGN_TORCH_DEVICE", None)
    if device is not None:
        env["SEQALIGN_TORCH_DEVICE"] = device
    proc = subprocess.run(
        [sys.executable, "-m", "seqalign_torch", *argv], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    return proc.returncode, proc.stdout, proc.stderr


@pytest.fixture
def cpu_engine(monkeypatch):
    monkeypatch.setenv("SEQALIGN_TORCH_DEVICE", "cpu")


@pytest.mark.parametrize("inputs", [DNA, PROTEIN], ids=["dna", "protein"])
@pytest.mark.parametrize("mode", MODES)
def test_gpu_engine_matches_oracles(inputs, mode, cpu_engine, capsys):
    argv = [mode, *inputs]
    rc_g, out_g = run_main(port_cli.main, ["-g", *argv], capsys)
    rc_c, out_c = run_main(port_cli.main, ["-c", *argv], capsys)
    rc_j, out_j = run_main(jax_cli.main, ["-c", *argv], capsys)
    assert rc_g == rc_c == rc_j == 0
    assert "# Score:" in out_g
    assert out_g == out_c == out_j


@pytest.mark.parametrize("mode", MODES)
def test_gpu_engine_matches_jax_kernels(mode, cpu_engine, monkeypatch,
                                        capsys):
    monkeypatch.setenv("SEQALIGN_ENGINE", "pallas_interpret")
    rc_g, out_g = run_main(port_cli.main, ["-g", mode, *DNA], capsys)
    rc_j, out_j = run_main(jax_cli.main, ["-g", mode, *DNA], capsys)
    assert rc_g == rc_j == 0
    assert out_g == out_j


def test_golden_protein_local_direct_route(cpu_engine, capsys):
    # 4548 x 497: its words exceed the host budget, so -g takes the
    # direct route (K1 + K2 on the device).
    argv = ["--protein", "--gap-penalty", "10", "--local",
            "data/protein/P08519.fasta", "data/protein/P10635.fasta"]
    rc_g, out_g = run_main(port_cli.main, ["-g", *argv], capsys)
    rc_c, out_c = run_main(port_cli.main, ["-c", *argv], capsys)
    assert rc_g == rc_c == 0
    assert "# Score: \t57\n" in out_g
    assert out_g == out_c


@pytest.mark.parametrize("argv,expected", [
    ([], constants.USAGE),
    (["--gap-penalty", "abc", *DNA], constants.GAP_PENALTY_NOT_READ_ERROR),
    (["no_such_file.txt", DNA[1]],
     "no_such_file.txt file does not exist\n" + constants.SEQ_NOT_READ_ERROR),
    (["-s", "tests/corruptScoreMatrix.txt", *DNA],
     constants.SCORE_MATRIX_NOT_READ_ERROR),
    (["-p", "-c"], constants.SEQ_NOT_READ_ERROR + constants.USAGE),
], ids=["usage", "bad-gap", "missing-file", "corrupt-matrix", "no-files"])
def test_error_paths(argv, expected):
    rc, out, err = run_port(["-g", *argv] if argv else argv)
    assert (rc, out, err) == (1, "", expected)


def test_oversized_scores_give_error(tmp_path):
    matrix = tmp_path / "big.txt"
    matrix.write_text("200 -4 -4 -4\n-4 200 -4 -4\n-4 -4 200 -4\n"
                      "-4 -4 -4 200\n")
    rc, out, err = run_port(["-g", "-s", str(matrix), *DNA])
    assert (rc, out) == (1, "")
    assert err.startswith("error: ") and err.endswith("\n")
    assert "[-127, 127]" in err and "Traceback" not in err


def test_no_cuda_device_gives_mem_error():
    # No CUDA device here, and no CPU request: the reference's MEM_ERROR.
    rc, out, err = run_port(["-g", *DNA], device=None)
    assert (rc, out, err) == (1, "", constants.MEM_ERROR)


@pytest.mark.parametrize("route,mode", [
    ("direct", "--global"), ("direct", "--local"), ("direct", "--semi-global"),
    ("checkpoint", "--local"),
])
def test_affine_gaps_match_oracle(route, mode, cpu_engine, monkeypatch,
                                  capsys):
    # -g --gap-extend takes the direct route, or the checkpoint engine
    # (here at small tiles) for a pair the direct route does not take.
    calls = []
    if route == "checkpoint":
        real = checkpoint.checkpointed_align

        def small(*args, **kwargs):
            calls.append(kwargs)
            return real(*args, **kwargs, ckpt_cols=256, rps=1, slots=128)

        monkeypatch.setattr(direct, "fits_direct",
                            lambda n, m, affine=False: False)
        monkeypatch.setattr(checkpoint, "checkpointed_align", small)
    argv = [mode, "--gap-penalty", "11", "--gap-extend", "1", *PROTEIN]
    rc_g, out_g = run_main(port_cli.main, ["-g", *argv], capsys)
    rc_c, out_c = run_main(port_cli.main, ["-c", *argv], capsys)
    rc_j, out_j = run_main(jax_cli.main, ["-c", *argv], capsys)
    assert rc_g == rc_c == rc_j == 0
    assert "# Score:" in out_g
    assert out_g == out_c == out_j
    if route == "checkpoint":
        assert len(calls) == 1 and calls[0]["gap_extend"] == 1


@pytest.mark.parametrize("mode", MODES)
def test_checkpoint_route_matches_oracle(mode, cpu_engine, monkeypatch,
                                         capsys):
    # A pair past the wavefront route's host budget that the direct route
    # does not take: -g runs the checkpoint engine, here at small tiles
    # (128 rows x 256 columns) so that the path crosses many of them.
    calls = []
    real = checkpoint.checkpointed_align

    def small(*args, **kwargs):
        calls.append(kwargs)
        return real(*args, **kwargs, ckpt_cols=256, rps=1, slots=128)

    monkeypatch.setattr(config, "MAX_HOST_DIRS_BYTES", 0)
    monkeypatch.setattr(direct, "fits_direct", lambda *a, **k: False)
    monkeypatch.setattr(checkpoint, "checkpointed_align", small)
    argv = [mode, "-p", "data/protein/P04775.fasta",
            "data/protein/P10635.fasta"]
    rc_g, out_g = run_main(port_cli.main, ["-g", *argv], capsys)
    rc_c, out_c = run_main(port_cli.main, ["-c", *argv], capsys)
    assert len(calls) == 1
    assert rc_g == rc_c == 0
    assert "# Score:" in out_g
    assert out_g == out_c


def spy(monkeypatch, module, name):
    """Count the calls of module.name (a kernel's plain version, which
    the wrappers run for CPU tensors, so it marks the route taken)."""
    calls = []
    real = getattr(module, name)

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("traceback", ["host", "device"])
@pytest.mark.parametrize("mode", ["--global", "--local"])
@pytest.mark.parametrize("inputs", [DNA, PROTEIN], ids=["dna", "protein"])
def test_strip_engine_matches_oracle(inputs, mode, traceback, cpu_engine,
                                     monkeypatch, capsys):
    # SEQALIGN_PAIR_ENGINE=strip: K5 over one region, then the native walk
    # (host) or K4 (device); never K1.
    monkeypatch.setenv("SEQALIGN_PAIR_ENGINE", "strip")
    monkeypatch.setenv("SEQALIGN_TRACEBACK", traceback)
    k5 = spy(monkeypatch, strip_fill, "strip_fill_plain")
    k1 = spy(monkeypatch, wavefront, "wavefront_strip_plain")
    argv = [mode, *inputs]
    rc_g, out_g = run_main(port_cli.main, ["-g", *argv], capsys)
    rc_c, out_c = run_main(port_cli.main, ["-c", *argv], capsys)
    assert rc_g == rc_c == 0
    assert "# Score:" in out_g
    assert out_g == out_c
    assert len(k5) == 1 and k1 == []


@pytest.mark.parametrize("traceback", ["host", "device"])
@pytest.mark.parametrize("mode", ["--global", "--local"])
def test_strip_engine_tiled_route(mode, traceback, cpu_engine, monkeypatch,
                                  capsys):
    # Words past the budget take the tiled fill, here in strips of 1,024
    # columns and blocks of 128 rows: 2 strips x 4 blocks for the text
    # P04775 (2,005 letters) and the pattern P10635 (497).
    monkeypatch.setenv("SEQALIGN_PAIR_ENGINE", "strip")
    monkeypatch.setenv("SEQALIGN_TRACEBACK", traceback)
    monkeypatch.setattr(config, "MAX_DIRS_BYTES", 0)
    real = tiled.tiled_fill
    calls = []

    def small(*args, **kwargs):
        calls.append(kwargs)
        return real(*args, **kwargs, strip_cols=1024, block_rows=128)

    monkeypatch.setattr(tiled, "tiled_fill", small)
    k5 = spy(monkeypatch, strip_fill, "strip_fill_plain")
    argv = [mode, "-p", "data/protein/P10635.fasta",
            "data/protein/P04775.fasta"]
    rc_g, out_g = run_main(port_cli.main, ["-g", *argv], capsys)
    rc_c, out_c = run_main(port_cli.main, ["-c", *argv], capsys)
    assert rc_g == rc_c == 0
    assert out_g == out_c
    assert len(calls) == 1 and len(k5) == 2 * 4


@pytest.mark.parametrize("argv", [
    ["--semi-global", *DNA],
    ["--global", "--gap-penalty", "11", "--gap-extend", "1", *PROTEIN],
    ["--local", "--gap-penalty", "11", "--gap-extend", "1", *PROTEIN],
], ids=["semi", "affine-global", "affine-local"])
def test_strip_engine_leaves_semi_and_affine(argv, cpu_engine, monkeypatch,
                                             capsys):
    # Semi-global and affine requests never take the strip engine: they
    # run K1 (the direct route), as the JAX package routes them.
    monkeypatch.setenv("SEQALIGN_PAIR_ENGINE", "strip")
    k5 = spy(monkeypatch, strip_fill, "strip_fill_plain")
    k1 = spy(monkeypatch, wavefront, "wavefront_strip_plain")
    rc_g, out_g = run_main(port_cli.main, ["-g", *argv], capsys)
    rc_c, out_c = run_main(port_cli.main, ["-c", *argv], capsys)
    assert rc_g == rc_c == 0
    assert out_g == out_c
    assert k5 == [] and len(k1) >= 1


def test_checkpoint_engine_setting(cpu_engine, monkeypatch, capsys):
    # SEQALIGN_PAIR_ENGINE=checkpoint sends a small pair to the checkpoint
    # engine, as in the JAX package.
    monkeypatch.setenv("SEQALIGN_PAIR_ENGINE", "checkpoint")
    calls = []
    real = checkpoint.checkpointed_align

    def small(*args, **kwargs):
        calls.append(kwargs)
        return real(*args, **kwargs, ckpt_cols=256, rps=1, slots=128)

    monkeypatch.setattr(checkpoint, "checkpointed_align", small)
    argv = ["--local", *PROTEIN]
    rc_g, out_g = run_main(port_cli.main, ["-g", *argv], capsys)
    rc_c, out_c = run_main(port_cli.main, ["-c", *argv], capsys)
    assert rc_g == rc_c == 0
    assert out_g == out_c
    assert len(calls) == 1


def test_strip_engine_without_cuda_gives_mem_error():
    env = dict(os.environ, SEQALIGN_PAIR_ENGINE="strip",
               SEQALIGN_TRACEBACK="device")
    env.pop("SEQALIGN_TORCH_DEVICE", None)
    proc = subprocess.run(
        [sys.executable, "-m", "seqalign_torch", "-g", *DNA], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=300)
    assert (proc.returncode, proc.stdout, proc.stderr) == (
        1, "", constants.MEM_ERROR)
