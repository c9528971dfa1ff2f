"""The port's direct route (seqalign_torch.ops.direct: K1 + device merge +
K2 + native emit) on the CPU against the JAX direct route in interpreter
mode and against the oracle.  Exact comparisons."""

import numpy as np
import pytest

from seqalign_torch.native import bindings as port_bindings
from seqalign_torch.ops import direct as port_direct
from seqalign_torch.ops import walk, wavefront
from seqalign_tpu.native import bindings as jax_bindings
from seqalign_tpu.ops import direct as jax_direct

from .torch_support import one_torch_thread  # noqa: F401

MODES = {"global": {}, "local": {"local": True}, "semi": {"semi": True}}
ALGO = {"global": 0, "local": 1, "semi": 2}


def dna_sm():
    return np.where(np.eye(4, dtype=bool), 5, -4).astype(np.int32)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("SEQALIGN_ENGINE", "pallas_interpret")


def both_and_oracle(text, pattern, sm, k, gap, mode):
    got = port_direct.direct_align(text, pattern, sm, k, gap, rps=1,
                                   slots=1024, device="cpu", **MODES[mode])
    ref = jax_direct.direct_align(text, pattern, sm, k, gap, rps=1,
                                  slots=1024, **MODES[mode])
    oat, oap, ost, osp, oscore = jax_bindings.oracle_align(
        ALGO[mode], text, pattern, sm, k, gap
    )
    return got, ref, (oscore, oat, oap, ost, osp)


def assert_same(got, ref, oracle):
    score, bi, bj, at, ap, st, sp = got
    assert (score, bi, bj, st, sp) == (ref[0], ref[1], ref[2], ref[5],
                                       ref[6])
    np.testing.assert_array_equal(at, ref[3])
    np.testing.assert_array_equal(ap, ref[4])
    assert (score, st, sp) == (oracle[0], oracle[3], oracle[4])
    np.testing.assert_array_equal(at, oracle[1])
    np.testing.assert_array_equal(ap, oracle[2])


@pytest.mark.parametrize("mode", ["global", "local", "semi"])
def test_direct_matches_jax_and_oracle(mode):
    rng = np.random.default_rng(71 + ALGO[mode])
    sm = dna_sm()
    for _ in range(2):
        n = int(rng.integers(200, 900))
        m = int(rng.integers(50, 700))
        gap = int(rng.integers(1, 8))
        text = rng.integers(0, 4, n).astype(np.int32)
        pattern = rng.integers(0, 4, m).astype(np.int32)
        assert_same(*both_and_oracle(text, pattern, sm, 4, gap, mode))


def test_direct_sw_no_match():
    sm = np.full((4, 4), -4, dtype=np.int32)
    text = np.zeros(700, np.int32)
    pattern = np.ones(90, np.int32)
    got, ref, oracle = both_and_oracle(text, pattern, sm, 4, 5, "local")
    assert got[0] == 0 and got[3].shape[0] == 0
    assert_same(got, ref, oracle)


@pytest.mark.parametrize("mode", ["global", "semi"])
def test_direct_forced_edge_moves(mode):
    # The pattern's first four letters align to gaps before the text
    # (forced TOP moves down column 0) and the text's last four letters
    # to gaps after the pattern (global: LEFT moves along row 0 are not
    # reached; the walk ends on column 0).
    rng = np.random.default_rng(73)
    core = rng.integers(0, 4, 300).astype(np.int32)
    text = np.concatenate([core, np.zeros(4, np.int32)])
    pattern = np.concatenate([np.full(4, 2, np.int32), core])
    got, ref, oracle = both_and_oracle(text, pattern, dna_sm(), 4, 1, mode)
    assert_same(got, ref, oracle)


def test_direct_forced_row_moves():
    # The text starts with letters the pattern lacks: the walk reaches
    # row 0 before column 0 and the forced LEFT moves finish it.
    rng = np.random.default_rng(74)
    core = rng.integers(0, 3, 250).astype(np.int32)
    text = np.concatenate([np.full(40, 3, np.int32), core])
    got, ref, oracle = both_and_oracle(text, core, dna_sm(), 4, 2,
                                       "global")
    assert_same(got, ref, oracle)


def test_direct_on_cpu_launches_no_kernel():
    rng = np.random.default_rng(75)
    before = (wavefront.wavefront_strip.launches,
              walk.walk_skewed_window.launches)
    port_direct.direct_align(rng.integers(0, 4, 300), rng.integers(0, 4, 200),
                             dna_sm(), 4, 5, rps=1, slots=1024, device="cpu")
    assert (wavefront.wavefront_strip.launches,
            walk.walk_skewed_window.launches) == before


@pytest.mark.parametrize("n,m", [
    (4096, 4096), (65536, 65536), (500000, 500000), (100000, 70000),
    (280482, 48632), (27682, 26320), (4000000, 500), (5000000, 100),
    (1, 1), (65537, 65537),
])
def test_fits_direct_matches_jax(n, m):
    assert port_direct.fits_direct(n, m) == jax_direct.fits_direct(n, m)
    assert port_direct._direct_geometry(m) == jax_direct._direct_geometry(m)


@pytest.mark.parametrize("algo", [0, 1, 2])
def test_affine_fill_with_extend_equal_to_open_is_linear(algo):
    rng = np.random.default_rng(76 + algo)
    sm = dna_sm()
    for _ in range(5):
        n = int(rng.integers(1, 400))
        m = int(rng.integers(1, n + 1))
        gap = int(rng.integers(1, 9))
        text = rng.integers(0, 4, n).astype(np.int8)
        pattern = rng.integers(0, 4, m).astype(np.int8)
        score, _ = port_bindings.oracle_fill_affine(algo, text, pattern, sm,
                                                    4, gap, gap)
        *_, linear = port_bindings.oracle_align(algo, text, pattern, sm, 4,
                                                gap)
        assert score == linear, (n, m, gap)
