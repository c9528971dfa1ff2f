"""The int16 cell mode on the port's batch path, on the CPU: K3-cell16's
plain versions (seqalign_torch.ops.batch_fill with ``cell16=True``)
against the JAX ``cell16`` kernels in interpreter mode, the port's gate
and setting against the JAX package's, the port's BatchAligner under
SEQALIGN_INT16_CELLS against the JAX class and the native oracle, and
the plain versions of the two probes (P2 ``probes.dpx16``, P1
``probes.walk_costs``) against jax.numpy and numpy.  Every output is an
integer: the comparisons are exact (tolerance 0)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from seqalign_torch import config as port_config
from seqalign_torch.native import bindings as port_bindings
from seqalign_torch.ops import batch_fill
from seqalign_torch.parallel import BatchAligner
from seqalign_torch.probes import dpx16, walk_costs
from seqalign_tpu import config as jax_config
from seqalign_tpu.ops import pallas_fill
from seqalign_tpu.parallel import mesh as mesh_lib
from seqalign_tpu.parallel.batch import BatchAligner as JaxBatchAligner

from .test_torch_batch import ragged_pairs
from .torch_support import one_torch_thread, score_matrix  # noqa: F401

MODES = {"global": {}, "local": {"local": True}, "semi": {"semi": True}}
ALGO = {"global": 0, "local": 1, "semi": 2}
# The six modes of tests/test_int16_cells.py: (mode, gap_extend).
SIX = [(mode, ext) for ext in (None, 2) for mode in MODES]
TILE = 128
B, N, M = 128, 40, 32  # one tile; N not a multiple of 16
PAD = 12               # padding pairs (ns = ms = 0) at the end
DNA_5_4 = np.where(np.eye(4, dtype=bool), 5, -4).astype(np.int32)


def protein_sm(rng, k=23):
    sm = rng.integers(-8, 12, (k, k))
    return ((sm + sm.T) // 2).astype(np.int32)


def make_batch(rng, k, n=N, m=M):
    texts = rng.integers(0, k, (B, n)).astype(np.int32)
    patterns = rng.integers(0, k, (B, m)).astype(np.int32)
    ns = rng.integers(1, n + 1, B).astype(np.int32)
    ms = rng.integers(1, m + 1, B).astype(np.int32)
    ns[-PAD:] = 0
    ms[-PAD:] = 0
    return texts, patterns, ns, ms


def tensors(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def case(k, mode, ext, seed):
    rng = np.random.default_rng(seed)
    sm = DNA_5_4 if k == 4 else protein_sm(rng)
    gap = 5 if k == 4 else 10
    return make_batch(rng, k), sm, gap, ext, MODES[mode]


# The words variant: the six modes on DNA, as tests/test_int16_cells.py
# holds the JAX kernel, and protein (the 2-byte packed planes) in one.
@pytest.mark.parametrize("mode,ext,k", [(mode, ext, 4) for mode, ext in SIX]
                         + [("local", 2, 23)])
def test_cell16_dirs_plain_matches_jax(mode, ext, k):
    (texts, patterns, ns, ms), sm, gap, ext, kw = case(k, mode, ext,
                                                       800 + k + len(mode))
    assert batch_fill.int16_cells_ok(N, M, sm, k, gap, ext)
    want = pallas_fill.batch_fill_dirs_pallas(
        texts, patterns, ns, ms, sm, gap, k_alpha=k, tile_pairs=TILE,
        gap_extend=ext, cell16=True, interpret=True, **kw)
    got = batch_fill.batch_fill_dirs_plain(
        *tensors(texts, patterns, ns, ms, sm), gap, k, tile_pairs=TILE,
        gap_extend=ext, cell16=True, **kw)
    assert len(got) == (4 if ext is None else 5)
    for g, w in zip(got, want):  # every pair, padding included
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if mode != "local":  # padding pairs score NEG_16, the JAX convention
        assert (got[0].numpy()[-PAD:] == batch_fill.NEG_16).all()
    # On real pairs the int16 cells change nothing.
    int32 = batch_fill.batch_fill_dirs_plain(
        *tensors(texts, patterns, ns, ms, sm), gap, k, tile_pairs=TILE,
        gap_extend=ext, **kw)
    real = ns > 0
    np.testing.assert_array_equal(got[0].numpy()[real],
                                  int32[0].numpy()[real])
    for g, w in zip(got[1:], int32[1:]):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


@pytest.mark.parametrize("k", [4, 23])
@pytest.mark.parametrize("mode,ext", SIX)
def test_cell16_score_plain_matches_jax(mode, ext, k):
    # M not a multiple of 16: the score-only fill takes any width.
    (texts, patterns, ns, ms), sm, gap, ext, kw = case(k, mode, ext,
                                                       820 + k + len(mode))
    patterns = patterns[:, :M - 3]
    ms = np.minimum(ms, M - 3)
    want = np.asarray(pallas_fill.batch_score_pallas(
        texts, patterns, ns, ms, sm, gap, k_alpha=k, tile_pairs=TILE,
        gap_extend=ext, cell16=True, interpret=True, **kw))
    got = batch_fill.batch_score_plain(
        *tensors(texts, patterns, ns, ms, sm), gap, k, gap_extend=ext,
        cell16=True, **kw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_cell16_near_cap_exact():
    # The +-127 matrix at the largest eligible shape of
    # tests/test_int16_cells.py::test_int16_near_cap_exact.
    rng = np.random.default_rng(5)
    sm = np.where(np.eye(4, dtype=bool), 127, -127).astype(np.int32)
    n, m = 48, 32
    assert batch_fill.int16_cells_ok(n, m, sm, 4, 127)
    assert not batch_fill.int16_cells_ok(64, 48, sm, 4, 127)
    texts, patterns, ns, ms = make_batch(rng, 4, n, m)
    ns[:PAD] = n
    ms[:PAD] = m
    args = tensors(texts, patterns, ns, ms, sm)
    want = np.asarray(pallas_fill.batch_score_pallas(
        texts, patterns, ns, ms, sm, 127, k_alpha=4, tile_pairs=TILE,
        cell16=True, interpret=True))
    got = batch_fill.batch_score_plain(*args, 127, 4, cell16=True)
    np.testing.assert_array_equal(got.numpy(), want)
    want = pallas_fill.batch_fill_dirs_pallas(
        texts, patterns, ns, ms, sm, 127, k_alpha=4, tile_pairs=TILE,
        local=True, cell16=True, interpret=True)
    got = batch_fill.batch_fill_dirs_plain(*args, 127, 4, local=True,
                                           cell16=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_cell16_large_gaps_at_a_tiny_shape():
    # Open 500, extend 20 at 16 x 10: inside the gate, far costlier gap
    # runs than the batch workloads have.
    rng = np.random.default_rng(17)
    texts, patterns, ns, ms = make_batch(rng, 4, 10, 16)
    assert batch_fill.int16_cells_ok(10, 16, DNA_5_4, 4, 500, 20)
    want = pallas_fill.batch_fill_dirs_pallas(
        texts, patterns, ns, ms, DNA_5_4, 500, k_alpha=4, tile_pairs=TILE,
        gap_extend=20, cell16=True, interpret=True)
    got = batch_fill.batch_fill_dirs_plain(
        *tensors(texts, patterns, ns, ms, DNA_5_4), 500, 4, gap_extend=20,
        cell16=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_cell16_wrappers_on_cpu_run_the_plain_versions():
    rng = np.random.default_rng(31)
    texts, patterns, ns, ms = make_batch(rng, 4)
    args = tensors(texts[:-1], patterns[:-1], ns[:-1], ms[:-1], DNA_5_4)
    before = (batch_fill.batch_score.launches,
              batch_fill.batch_score.cell16_launches,
              batch_fill.batch_fill_dirs.launches,
              batch_fill.batch_fill_dirs.cell16_launches)
    # An odd batch: the score-only kernel would pad it; the plain version
    # takes it as it is.
    got = batch_fill.batch_score(*args, 8, 4, gap_extend=2, cell16=True)
    want = batch_fill.batch_score_plain(*args, 8, 4, gap_extend=2,
                                        cell16=True)
    assert got.shape == (B - 1,) and torch.equal(got, want)
    args = tensors(texts, patterns, ns, ms, DNA_5_4)
    got = batch_fill.batch_fill_dirs(*args, 5, 4, semi=True, cell16=True)
    want = batch_fill.batch_fill_dirs_plain(*args, 5, 4, semi=True,
                                            cell16=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (batch_fill.batch_score.launches,
            batch_fill.batch_score.cell16_launches,
            batch_fill.batch_fill_dirs.launches,
            batch_fill.batch_fill_dirs.cell16_launches) == before


def test_pair_columns_pad_an_odd_batch():
    # The int16 kernel's host layout: [column][pair] int8, one padding
    # pair (zero letters, zero lengths) making the batch even.
    texts = torch.arange(15, dtype=torch.int32).reshape(3, 5)
    cols = batch_fill._pair_columns(texts, 4)
    assert cols.dtype == torch.int8 and cols.shape == (5, 4)
    assert torch.equal(cols[:, :3], texts.t().to(torch.int8))
    assert not cols[:, 3].any()
    lengths = batch_fill._pad_lengths(torch.tensor([3, 4, 5],
                                                   dtype=torch.int32), 4)
    assert lengths.tolist() == [3, 4, 5, 0]
    assert batch_fill._pair_columns(texts, 3).is_contiguous()


@pytest.mark.parametrize("k", [4, 23])
def test_int16_cells_ok_matches_jax(k):
    rng = np.random.default_rng(41 + k)
    matrices = [score_matrix(k), protein_sm(rng, k),
                np.where(np.eye(k, dtype=bool), 127, -127).astype(np.int32),
                np.zeros((k, k), np.int32)]
    shapes = [(16, 16), (48, 32), (64, 48), (127, 128), (256, 256),
              (511, 512), (639, 512), (639, 640), (1279, 1280), (4095, 128)]
    costs = [(1, None), (5, None), (10, None), (61, None), (127, None),
             (8, 2), (11, 1), (5, 5), (60, 61), (500, 20)]
    seen = set()
    for sm in matrices:
        for n, m in shapes:
            for gap, ext in costs:
                got = batch_fill.int16_cells_ok(n, m, sm, k, gap, ext)
                assert got == pallas_fill.int16_cells_ok(n, m, sm, k, gap,
                                                         ext)
                seen.add(got)
    assert seen == {True, False}


@pytest.mark.parametrize("value", ["0", "1", "auto", "AUTO", "Auto", "",
                                   "yes", " auto", None])
def test_int16_cells_setting_matches_jax(value, monkeypatch):
    if value is None:
        monkeypatch.delenv("SEQALIGN_INT16_CELLS", raising=False)
    else:
        monkeypatch.setenv("SEQALIGN_INT16_CELLS", value)
    got = port_config.int16_cells()
    assert got in ("0", "1", "auto")
    forced = (value or "").lower()
    if forced in ("0", "1", "auto"):
        assert got == forced == jax_config.int16_cells()
    else:
        # The port's default; the JAX one reads its TPU validation marker.
        assert got == "0"


def batch_mix(seed, k):
    rng = np.random.default_rng(seed)
    texts, patterns = ragged_pairs(rng, k, 10, hi=120)
    texts[3] = np.zeros(0, np.int32)
    return texts, patterns


@pytest.mark.parametrize("mode,ext", [("global", None), ("local", 2),
                                      ("semi", 2)])
def test_batch_aligner_int16_matches_jax_and_oracle(mode, ext, monkeypatch):
    monkeypatch.setenv("SEQALIGN_ENGINE", "pallas_interpret")
    sm = score_matrix(4)
    gap = 8 if ext else 5
    texts, patterns = batch_mix(850 + len(mode) + (ext or 0), 4)
    port = BatchAligner(sm, 4, gap, gap_extend=ext, device="cpu",
                        **MODES[mode])
    ref = JaxBatchAligner(sm, 4, gap, gap_extend=ext,
                          mesh=mesh_lib.make_data_mesh(1), **MODES[mode])
    monkeypatch.setenv("SEQALIGN_INT16_CELLS", "auto")
    want_scores = ref.score(texts, patterns)
    want = ref.align(texts, patterns)
    for setting in ("0", "auto", "1"):
        monkeypatch.setenv("SEQALIGN_INT16_CELLS", setting)
        scores = port.score(texts, patterns)
        np.testing.assert_array_equal(scores, want_scores)
        got = port.align(texts, patterns)
        for i, (t, p) in enumerate(zip(texts, patterns)):
            assert got[i].score == want[i].score, (setting, i)
            np.testing.assert_array_equal(got[i].aligned_text,
                                          want[i].aligned_text)
            np.testing.assert_array_equal(got[i].aligned_pattern,
                                          want[i].aligned_pattern)
            assert (got[i].start_in_aligned_text,
                    got[i].start_in_aligned_pattern) == (
                want[i].start_in_aligned_text,
                want[i].start_in_aligned_pattern)
    args = (ALGO[mode],)
    for i, (t, p) in enumerate(zip(texts, patterns)):
        if ext is None:
            oracle = port_bindings.oracle_align(*args, t, p, sm, 4, gap)
        else:
            oracle = port_bindings.oracle_align_affine(*args, t, p, sm, 4,
                                                       gap, ext)
        assert got[i].score == oracle[4], i
        np.testing.assert_array_equal(got[i].aligned_text, oracle[0])
        np.testing.assert_array_equal(got[i].aligned_pattern, oracle[1])


def spied_routes(monkeypatch):
    """Record (function, n_cols, m_rows, cell16) of every batch fill."""
    routes = []
    for name in ("batch_score", "batch_fill_dirs"):
        real = getattr(batch_fill, name)

        def spy(texts, patterns, *args, _real=real, _name=name, **kwargs):
            routes.append((_name, texts.shape[1], patterns.shape[1],
                           kwargs.get("cell16", False)))
            return _real(texts, patterns, *args, **kwargs)

        monkeypatch.setattr(batch_fill, name, spy)
    return routes


def straddling_mix():
    # DNA 5/-4 gap 5: pairs near 600 letters fit the gate (639 x 640:
    # bound 9,590), pairs near 1,200 do not (1,279 x 1,280: 19,190).
    rng = np.random.default_rng(61)
    lengths = [(590, 600), (610, 560), (1190, 1210), (1250, 1180)]
    texts = [rng.integers(0, 4, n).astype(np.int32) for n, _ in lengths]
    patterns = [rng.integers(0, 4, m).astype(np.int32) for _, m in lengths]
    return texts, patterns


def test_batch_aligner_routes_what_the_jax_gate_admits(monkeypatch):
    texts, patterns = straddling_mix()
    port = BatchAligner(DNA_5_4, 4, 5, local=True, device="cpu")
    monkeypatch.setenv("SEQALIGN_INT16_CELLS", "0")
    base_scores = port.score(texts, patterns)
    routes = spied_routes(monkeypatch)
    monkeypatch.setenv("SEQALIGN_INT16_CELLS", "auto")
    scores = port.score(texts, patterns)
    got = port.align(texts, patterns)
    assert [r[0] for r in routes] == ["batch_score"] * 2 + [
        "batch_fill_dirs"] * 2
    for _, n, m, cell16 in routes:
        assert cell16 == pallas_fill.int16_cells_ok(n, m, DNA_5_4, 4, 5)
    assert [r[3] for r in routes] == [True, False, True, False]
    np.testing.assert_array_equal(scores, base_scores)
    for i, (t, p) in enumerate(zip(texts, patterns)):
        st, sp = (p, t) if len(t) < len(p) else (t, p)
        assert scores[i] == port_bindings.oracle_fill(1, st, sp, DNA_5_4, 4,
                                                      5)[1]
        want = port_bindings.oracle_align(1, t, p, DNA_5_4, 4, 5)
        assert got[i].score == want[4]
        np.testing.assert_array_equal(got[i].aligned_text, want[0])
        np.testing.assert_array_equal(got[i].aligned_pattern, want[1])
        assert (got[i].start_in_aligned_text,
                got[i].start_in_aligned_pattern) == (want[2], want[3])


def test_int16_cells_1_refuses_an_ineligible_bucket(monkeypatch):
    texts, patterns = straddling_mix()
    port = BatchAligner(DNA_5_4, 4, 5, local=True, device="cpu")
    monkeypatch.setenv("SEQALIGN_INT16_CELLS", "1")
    message = ("SEQALIGN_INT16_CELLS=1 but the padded shapes/scores "
               "exceed the int16 value cap")
    with pytest.raises(ValueError, match=message):
        port.score(texts, patterns)
    with pytest.raises(ValueError, match=message):
        port.align(texts, patterns)
    # The eligible pairs alone go through.
    port.score(texts[:2], patterns[:2])


JNP16 = {
    "cmp16": lambda a, b, c: jnp.where(a > b, a, b + 1),
    "cmp32_sel16": lambda a, b, c: jnp.where(
        a.astype(jnp.int32) > b.astype(jnp.int32), a, b + 1),
    "cmp16_to_val": lambda a, b, c: (a > b).astype(jnp.int16) + b,
    "cmp32_to_val16": lambda a, b, c: (
        a.astype(jnp.int32) > b.astype(jnp.int32)).astype(jnp.int16) + b,
    "cmp32_val32_narrow": lambda a, b, c: (
        a.astype(jnp.int32) > b.astype(jnp.int32)).astype(
            jnp.int32).astype(jnp.int16) + b,
    "max16": lambda a, b, c: jnp.maximum(a, b - 1),
    "shr16_var": lambda a, b, c: (a >> (b & 7)) & 0xFF,
    "eq16_arith": lambda a, b, c: 1 - jnp.minimum(jnp.abs(a - b), 1),
    "ext_narrow": lambda a, b, c: (
        a.astype(jnp.int32) + b.astype(jnp.int32)).astype(jnp.int16),
    "add16": lambda a, b, c: a + b,
    "sub16": lambda a, b, c: a - b,
    "mul16": lambda a, b, c: a * b,
    "or16": lambda a, b, c: a | b,
    "shl16_const": lambda a, b, c: (a << 1) + b,
    "min16": lambda a, b, c: jnp.minimum(a, b - 1),
    "cmp16_zero": lambda a, b, c: jnp.where(a > 0, a, b),
    "vimax3": lambda a, b, c: jnp.maximum(jnp.maximum(a, b), c),
    "viaddmax": lambda a, b, c: jnp.maximum(a + b, c),
    "viaddmax_relu": lambda a, b, c: jnp.maximum(jnp.maximum(a + b, c), 0),
    "vibmax": lambda a, b, c: jnp.maximum(a, b) + (a >= b).astype(jnp.int16),
    "vimax_relu": lambda a, b, c: jnp.maximum(jnp.maximum(a, b), 0),
    "add16_asm": lambda a, b, c: a + b,
}


def probe_words(n=4096):
    words = [dpx16.random_words(n, 90 + s, "cpu") for s in range(3)]
    # The edges of int16 in both halves of the first words.
    edges = np.array([-32768, -32767, -1, 0, 1, 32766, 32767, -16384],
                     np.int16)
    for s, w in enumerate(words):
        w.view(torch.int16)[:64] = torch.from_numpy(
            np.roll(np.repeat(edges, 8), s))
    return words


@pytest.mark.parametrize("name", [v[0] for v in dpx16.VARIANTS16])
def test_dpx16_plain_matches_jax_numpy(name):
    words = probe_words()
    got = dpx16.apply_plain(name, *words).view(torch.int16).numpy()
    a, b, c = (jnp.asarray(w.view(torch.int16).numpy()) for w in words)
    want = np.asarray(JNP16[name](a, b, c))
    assert want.dtype == np.int16
    np.testing.assert_array_equal(got, want)
    # The wrapper takes the plain version for CPU words.
    before = dpx16.apply.launches
    assert torch.equal(dpx16.apply(name, *words), dpx16.apply_plain(
        name, *words))
    assert dpx16.apply.launches == before


@pytest.mark.parametrize("name", [v[0] for v in dpx16.VARIANTS32])
def test_dpx16_int32_counterparts_match_jax_numpy(name):
    words = probe_words()
    jnp32 = {"sel32": JNP16["cmp16"], "cmp32": JNP16["cmp16_to_val"],
             "max32": JNP16["max16"], "shr32_var": JNP16["shr16_var"],
             "eq32_arith": JNP16["eq16_arith"], "add32": JNP16["add16"],
             "sub32": JNP16["sub16"], "mul32": JNP16["mul16"],
             "or32": JNP16["or16"], "shl32_const": JNP16["shl16_const"],
             "min32": JNP16["min16"], "sel32_zero": JNP16["cmp16_zero"],
             "vimax3_s32": JNP16["vimax3"],
             "viaddmax_s32": JNP16["viaddmax"],
             "viaddmax_s32_relu": JNP16["viaddmax_relu"],
             "vibmax_s32": lambda a, b, c: jnp.maximum(a, b) + (
                 a >= b).astype(jnp.int32),
             "vimax_s32_relu": JNP16["vimax_relu"]}
    got = dpx16.apply_plain(name, *words).numpy()
    a, b, c = (jnp.asarray(w.numpy()) for w in words)
    want = np.asarray(jnp32[name](a, b, c)).astype(np.int32)
    np.testing.assert_array_equal(got, want)


def test_dpx16_rate_plain_repeats_the_op():
    words = probe_words(64)[0]
    got = dpx16.rate_plain("viaddmax", words, 5, 3)
    n = words.numel()
    want = []
    for t in range(5):
        x = [torch.tensor([int(words[(3 * t + k) % n]) ^ (
            ((0x9E3779B9 * k + (1 << 31)) % (1 << 32)) - (1 << 31))],
            dtype=torch.int32) for k in range(dpx16.CHAINS)]
        for _ in range(3):
            for k in range(dpx16.CHAINS):
                x[k] = dpx16.apply_plain(
                    "viaddmax", x[k], x[(k + 1) % dpx16.CHAINS],
                    x[(k + 2) % dpx16.CHAINS])
        folded = 0
        for chain in x:
            folded ^= int(chain)
        want.append(folded)
    assert got.tolist() == want


SASS_SAMPLE = """
        /*0080*/                   ISETP.GE.AND P0, PT, R4, 0x1, PT ;
        /*0090*/                   VIMNMX3.S16x2 R2, R2, R3, R5, !PT ;
        /*00a0*/                   VIMNMX3.S16x2 R3, R3, R5, R2, !PT ;
        /*00b0*/                   IADD3 R4, R4, -0x4, RZ ;
        /*00c0*/               @P0 BRA 0x90 ;
        /*00d0*/                   STG.E [R6.64], R2 ;
        /*00e0*/                   EXIT ;
        /*00f0*/                   BRA 0xf0;
"""


def test_dpx16_loop_body_reads_the_largest_backward_branch():
    assert dpx16.loop_body(SASS_SAMPLE) == [
        "VIMNMX3.S16x2", "VIMNMX3.S16x2", "IADD3", "BRA"]
    assert dpx16.loop_body("/*0000*/ EXIT ;") == []


def numpy_chase(table, steps, seed):
    """The JAX kernel's recurrence (scripts/probe_walk_costs.py:36-46) as
    a numpy loop: int32 throughout, so acc wraps as on the TPU."""
    rows = table.shape[0]
    acc = np.int32(seed)
    r0, r2 = seed & (rows - 1), 0
    with np.errstate(over="ignore"):
        for k in range(steps):
            v = table[r0, r2]
            acc = np.int32(acc + v)
            r0 = int((v + k) & (rows - 1))
            r2 = int((v >> 6) & 127)
    return int(acc)


@pytest.mark.parametrize("rows", [64, 1024])
def test_chase_plain_matches_numpy(rows):
    rng = np.random.default_rng(rows)
    table = rng.integers(0, 1 << 20, (rows, 128)).astype(np.int32)
    # Large values too, so that acc wraps within the steps.
    table[rows // 2:] |= 1 << 30
    want = numpy_chase(table, 4096, walk_costs.SEED)
    got = walk_costs.chase_plain(torch.from_numpy(table), 4096)
    assert got.dtype == torch.int32 and got.tolist() == [want]
    before = walk_costs.chase.launches
    assert walk_costs.chase(torch.from_numpy(table), 4096).tolist() == [want]
    assert walk_costs.chase.launches == before
    with pytest.raises(ValueError, match="power of two"):
        walk_costs.chase_plain(torch.zeros((3, 128), dtype=torch.int32))
