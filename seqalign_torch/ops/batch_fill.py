"""Inter-pair batch fill (K3): wrappers and plain versions.

Every pair of a padded batch fills its own DP matrix; the batch is the
parallel axis (the SWIPE formulation of the JAX package's
``pallas_fill._interpair_kernel``).  Two public functions share one
kernel body:

* ``batch_score`` — the optimal score of every pair;
* ``batch_fill_dirs`` — the scores, the best cells and the 2-bit
  direction words in the JAX layout (tiles, M/16, N, tile_pairs/128,
  128): word (t, w, j) holds rows 16w+1..16w+16 at column j+1 of pair
  t*tile_pairs + slot, row 16w+1+r at bits 2r; with affine gaps also
  the run bits ``dirs2`` in the same layout (bit 2r: the cell's left run
  goes on, E - extend > left - open; bit 2r+1: its top run, F).

Inputs are the JAX wrappers' arrays as tensors: pair-major (B, N) texts
and (B, M) patterns (int8 or int32 letters in 0..k-1), (B,) int32
lengths with 0 <= ns <= N and 0 <= ms <= M (pairs with ns = 0 are
padding: their outputs are defined but meaningless), and the (k, k)
int32 score matrix.  Linear gaps, or affine (Gotoh) ones with
``gap_extend`` (``gap`` is then the open cost, and must be >= the
extend cost, as the JAX ``BatchAligner`` requires): global, local and
semi-global.

``search_score`` runs the score-only kernels in the search layout of
``parallel/search.py``'s resident database: one query shared by every
pair, and the texts in groups of ``GROUP`` pairs of similar length, each
group a (width, GROUP) [column][pair] block of its own width.

``cell16=True`` runs the same DP in int16 cells (the JAX kernel's
``cell16`` mode): ``NEG_16`` sentinels in place of ``NEG_HALF`` and
``NEG_INF``, int32 words, best cells and scores.  Callers gate it on
``int16_cells_ok`` over the padded widths, as the JAX callers do, or in
local mode on ``int16_local_ok`` (the search does).  Inside the gate no
value wraps, so every output equals the int32 mode's except the scores
of padding pairs (ns = 0): ``NEG_16`` where int32 gives ``NEG_INF``
(global and semi).

For tensors on a CUDA device the wrappers launch the kernel
(``csrc/interpair.cu``; ``csrc/interpair16.cu`` with ``cell16``), after
moving the letters to [column][pair] order with plain tensor ops; for
tensors on the CPU they run the plain versions.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ._build import c_function, check_launch, library

NEG_INF = -(1 << 30)
NEG_HALF = NEG_INF // 2  # E and F before any gap run (affine)
DIR_ROWS_PER_WORD = 16
TILE_QUANTUM = 128  # tile_pairs is a multiple of this (the JAX layout)
WARP = 32  # pairs a CTA of K3 (64 of K3-cell16, two a lane)
GROUP = 2 * WARP  # pairs of a search group: one K3-cell16 CTA, two of K3
TRACE_WORDS = 4  # a warp's trace (csrc/interpair_chain.cuh's kTraceWords)
# int16 cell mode (the JAX package's values): sentinels at -2^14; every
# DP value must stay clear of them and of int16 wraparound, which
# int16_cells_ok bounds over the padded shapes.
NEG_16 = -(1 << 14)
INT16_VALUE_CAP = 15_800  # NEG_16 head/tailroom: bound + open + sub < 16384


def int16_cells_ok(n_pad: int, m_pad: int, score_matrix, k_alpha: int,
                   gap, gap_extend=None) -> bool:
    """True when every DP value of every mode fits the int16 cells: the
    JAX ``int16_cells_ok``, |v| <= max|sub| * min(n, m) + max(open,
    extend) * (n + m) <= INT16_VALUE_CAP over the padded widths."""
    sm = np.asarray(score_matrix)[:k_alpha, :k_alpha]
    max_sub = int(np.abs(sm).max(initial=0))
    g = abs(int(gap))
    ge = abs(int(gap_extend)) if gap_extend is not None else g
    bound = max_sub * min(n_pad, m_pad) + max(g, ge) * (n_pad + m_pad)
    return bound <= INT16_VALUE_CAP


def int16_local_ok(n_pad: int, m_pad: int, score_matrix, k_alpha: int,
                   gap, gap_extend=None) -> bool:
    """True when every value of a local fill fits the int16 cells: B =
    max|sub| * min(n_pad, m_pad) <= INT16_VALUE_CAP, with costs 0 <=
    extend <= open <= INT16_VALUE_CAP (linear: 0 <= gap <= the cap).

    No gap term: it bounds global and semi values, which run down to
    -gap * (n + m), and a local fill floors H at 0.  Against the int16
    kernel's arithmetic (``csrc/interpair16.cu``, and ``_fill_plain``'s),
    with g the open (or linear) cost and ge the extend:

    * H lies in [0, B]: a local path ending at (i, j) takes at most
      min(i, j) diagonal steps of at most max|sub| each, and every gap
      costs >= 0.  Padded rows and columns are letter 0, so they score
      within max|sub| too; the bound is over the padded widths.
    * E and F lie in [-g, B - g] from the first column (row) on: E =
      max(E - ge, left - g) with left >= 0, and their NEG_16 start is
      replaced at the first step, since NEG_16 - ge < -g.  Before that
      replacement E - ge = NEG_16 - ge >= -2^14 - the cap; after it, E -
      ge >= -g - ge >= -2 * the cap.
    * diag + s lies in [min sub, B + max|sub|], and max|sub| <= B (a
      width is >= 1), so in [-the cap, 2 * the cap].
    * The two cells of a 32-bit register are independent pairs: the
      packed add, subtract and max act on each half alone.
    * The trackers start at NEG_16, below every H.

    So every value lies in [-(2^14 + the cap), 2 * the cap] = [-32,184,
    31,600], inside int16.  The cap's headroom below 2^14 (584; in the
    all-mode bound, the room for open + sub above the sentinel) still
    covers three of these facts: B + max|sub| <= 2 * the cap < 2^15, -g
    above NEG_16 - ge (the first step's replacement), and NEG_16 - ge and
    -g - ge >= -2^15.  Any cap below 2^14 would keep them."""
    g = int(gap)
    ge = int(gap_extend) if gap_extend is not None else g
    if not 0 <= ge <= g <= INT16_VALUE_CAP:
        return False
    sm = np.asarray(score_matrix)[:k_alpha, :k_alpha]
    max_sub = int(np.abs(sm).max(initial=0))
    return max_sub * min(n_pad, m_pad) <= INT16_VALUE_CAP


def mode_code(local: bool, semi: bool) -> int:
    """The kernels' mode argument: 0 global, 1 local, 2 semi-global."""
    return 1 if local else (2 if semi else 0)


def _check(texts, patterns, ns, ms, score_matrix, gap, gap_extend,
           k_alpha, local, semi, tile_pairs=None):
    if local and semi:
        raise ValueError("local and semi are exclusive")
    if gap_extend is not None and int(gap) < int(gap_extend):
        raise ValueError("affine gaps require gap >= gap_extend")
    if not 1 <= k_alpha <= 32:
        raise ValueError(f"alphabet size must be in 1..32, got {k_alpha}")
    if texts.dim() != 2 or patterns.dim() != 2:
        raise ValueError("texts and patterns must be (B, N) and (B, M)")
    b, n_cols = texts.shape
    m_rows = patterns.shape[1]
    if patterns.shape[0] != b or n_cols < 1 or m_rows < 1:
        raise ValueError(f"texts {tuple(texts.shape)} and patterns "
                         f"{tuple(patterns.shape)} do not make a batch")
    device = texts.device
    for name, x, shape in (("patterns", patterns, None), ("ns", ns, (b,)),
                           ("ms", ms, (b,)),
                           ("score_matrix", score_matrix,
                            (k_alpha, k_alpha))):
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, expected {device}")
        if shape is not None and tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                             f"expected {shape}")
    for name, x in (("texts", texts), ("patterns", patterns)):
        if x.dtype not in (torch.int8, torch.int32):
            raise ValueError(f"{name} must be int8 or int32 letters")
    for name, x in (("ns", ns), ("ms", ms), ("score_matrix", score_matrix)):
        if x.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {x.dtype}")
    if tile_pairs is not None:
        if m_rows % DIR_ROWS_PER_WORD:
            raise ValueError(f"patterns' width {m_rows} is not a multiple "
                             f"of {DIR_ROWS_PER_WORD}")
        if tile_pairs < 1 or tile_pairs % TILE_QUANTUM or b % tile_pairs:
            raise ValueError(f"tile_pairs {tile_pairs} must be a multiple "
                             f"of {TILE_QUANTUM} dividing the batch {b}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"the batch fill runs on cuda or cpu, not {device}")


def library_name(cell16: bool) -> str:
    """The K3 library, ``interpair``, or with ``cell16`` ``interpair16``:
    its C entries are ``sa_<name>_fill``, ``_search``, ``_shape`` and (the
    all-shapes build) ``_fill_shape``."""
    return "interpair16" if cell16 else "interpair"


def _pair_columns(x, b2):
    """(B, W) letters as [column][pair] int8, (W, b2): a warp reads
    neighbouring bytes.  Pairs past B (one, to make the batch even for
    the two-pairs-a-lane int16 kernel) get zero letters."""
    out = x.to(torch.int8).t()
    if b2 == x.shape[0]:
        return out.contiguous()
    padded = torch.zeros((x.shape[1], b2), dtype=torch.int8,
                         device=x.device)
    padded[:, :x.shape[0]] = out
    return padded


def _pad_lengths(x, b2):
    if b2 == x.shape[0]:
        return x.contiguous()
    return torch.cat([x, x.new_zeros(b2 - x.shape[0])])


def kernel_launch(texts, patterns, ns, ms, score_matrix, gap, k_alpha,
                  local, semi, *, tile_pairs, with_dirs, gap_extend=None,
                  cell16=False):
    """K3 on the inputs' CUDA device, ready to launch: the letters moved to
    [column][pair] int8 order and the outputs allocated.  Returns
    (launch, (scores, best_is, best_js, dirs)), with dirs2 fifth for
    affine gaps; each ``launch()`` runs the kernel once on the current
    stream (a second run writes the same outputs), raising if the launch
    failed, and counts nothing (the wrappers count their launches).
    ``cell16``: the int16 kernel, two pairs a lane; an odd score-only
    batch gains one padding pair on the device, and its score is not
    returned."""
    return shape_launch(library(library_name(cell16)), None, texts,
                        patterns, ns, ms, score_matrix, gap, k_alpha, local,
                        semi, tile_pairs=tile_pairs, with_dirs=with_dirs,
                        gap_extend=gap_extend, cell16=cell16)


def shape_in_code(lib, with_dirs, affine, m_rows, b, cell16=False):
    """(warps a CTA, columns a block, the most warps a CTA may run, the
    variant's most for a grid that fills the card) that ``lib``, a build
    of ``csrc/interpair.cu`` (``interpair16.cu`` with ``cell16``), takes
    for the variant on ``b`` pairs of ``m_rows`` pattern rows."""
    name = library_name(cell16)
    out = (ctypes.c_int * 4)()
    fn = c_function(lib, f"sa_{name}_shape",
                    [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                     ctypes.c_int64, ctypes.c_void_p], None)
    fn(int(with_dirs), int(affine), int(m_rows), int(b),
       ctypes.addressof(out))
    return tuple(out)


def shape_launch(lib, shape, texts, patterns, ns, ms, score_matrix, gap,
                 k_alpha, local, semi, *, tile_pairs, with_dirs,
                 gap_extend=None, cell16=False, trace=False):
    """``kernel_launch`` through ``lib``, a build of ``csrc/interpair.cu``
    (``interpair16.cu`` with ``cell16``): ``shape`` None calls
    ``sa_interpair[16]_fill`` at the variant's own shape; ``shape`` =
    (warps a CTA, columns a block) calls the all-shapes build's
    ``sa_interpair[16]_fill_shape`` at it, and with ``trace`` gives
    ``launch.trace``, TRACE_WORDS int32 a warp of each CTA (the sleeps
    waiting for the top row, the sleeps waiting for a ring block, the
    GPU's nanosecond clock at the kernel's start and after the warp's
    last block); ``launch.warps`` and ``launch.ctas`` are its shape and
    ``launch.scratch`` the global scratch (row, frow or None) that the
    last warp hands to the first through."""
    device = texts.device
    b, n_cols = texts.shape
    m_rows = patterns.shape[1]
    b2 = b + (b & 1) if cell16 else b
    texts_cp = _pair_columns(texts, b2)
    patterns_cp = _pair_columns(patterns, b2)
    ns = _pad_lengths(ns, b2)
    ms = _pad_lengths(ms, b2)
    sm = score_matrix.contiguous()
    i32 = torch.int32
    affine = gap_extend is not None
    # The bottom rows (and F) the last warp hands to the first: one int32
    # a pair, or one packed pair of int16 cells a lane.
    row_shape = (n_cols, b2 // 2 if cell16 else b2)
    row = torch.empty(row_shape, dtype=i32, device=device)
    frow = torch.empty(row_shape, dtype=i32, device=device) \
        if affine else None
    scores = torch.empty(b2, dtype=i32, device=device)
    best_is = best_js = dirs = dirs2 = None
    if with_dirs:
        best_is = torch.empty(b, dtype=i32, device=device)
        best_js = torch.empty(b, dtype=i32, device=device)
        out_shape = (b // tile_pairs, m_rows // DIR_ROWS_PER_WORD, n_cols,
                     tile_pairs // 128, 128)
        dirs = torch.empty(out_shape, dtype=i32, device=device)
        if affine:
            dirs2 = torch.empty(out_shape, dtype=i32, device=device)
    name = library_name(cell16)
    warps = (shape_in_code(lib, with_dirs, affine, m_rows, b2, cell16)[0]
             if shape is None else shape[0])
    ctas = -(-b2 // (2 * WARP if cell16 else WARP))
    trace_buf = (torch.zeros(ctas * warps * TRACE_WORDS, dtype=i32,
                             device=device) if trace else None)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = c_function(lib, f"sa_{name}_fill" if shape is None
                    else f"sa_{name}_fill_shape",
                    [p] * 5 + [i, i, i, i, ctypes.c_int64, i, i, i, i, i]
                    + [p] * 7 + [i, i, p] * (shape is not None) + [p])
    tail = () if shape is None else (*shape, ptr(trace_buf))

    def launch():
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = fn(
                texts_cp.data_ptr(), patterns_cp.data_ptr(), ns.data_ptr(),
                ms.data_ptr(), sm.data_ptr(), k_alpha, int(gap),
                int(gap_extend) if affine else 0, int(affine), b2, n_cols,
                m_rows, tile_pairs or TILE_QUANTUM, mode_code(local, semi),
                int(with_dirs), row.data_ptr(), ptr(frow), scores.data_ptr(),
                ptr(best_is), ptr(best_js), ptr(dirs), ptr(dirs2), *tail,
                stream,
            )
        check_launch(name, rc)

    launch.trace = trace_buf
    launch.warps = warps
    launch.ctas = ctas
    launch.scratch = (row, frow)
    out = (scores[:b], best_is, best_js, dirs)
    return launch, (out + (dirs2,) if affine else out)


def ptr(x):
    """A tensor's device address, or None for no tensor."""
    return None if x is None else x.data_ptr()


def batch_score(texts, patterns, ns, ms, score_matrix, gap, k_alpha: int,
                local: bool = False, semi: bool = False, gap_extend=None,
                cell16: bool = False):
    """Optimal scores of a padded batch (the JAX ``batch_score_pallas``;
    affine with ``gap_extend``; int16 cells with ``cell16``, which the
    caller gates on ``int16_cells_ok``).  Returns (B,) int32 on the
    inputs' device: local scores floored at 0; padding pairs (ns = 0)
    score 0 (local) or NEG_INF (NEG_16 with ``cell16``).  A launch of the
    int16 kernel counts in ``batch_score.cell16_launches``, one of the
    int32 kernel in ``batch_score.launches``."""
    _check(texts, patterns, ns, ms, score_matrix, gap, gap_extend, k_alpha,
           local, semi)
    if texts.device.type == "cpu":
        return batch_score_plain(texts, patterns, ns, ms, score_matrix, gap,
                                 k_alpha, local=local, semi=semi,
                                 gap_extend=gap_extend, cell16=cell16)
    launch, out = kernel_launch(
        texts, patterns, ns, ms, score_matrix, gap, k_alpha, local, semi,
        tile_pairs=None, with_dirs=False, gap_extend=gap_extend,
        cell16=cell16)
    scores = out[0]
    launch()
    if cell16:
        batch_score.cell16_launches += 1
    else:
        batch_score.launches += 1
    return scores


batch_score.launches = 0
batch_score.cell16_launches = 0


def batch_fill_dirs(texts, patterns, ns, ms, score_matrix, gap,
                    k_alpha: int, local: bool = False, semi: bool = False,
                    tile_pairs: int = TILE_QUANTUM, gap_extend=None,
                    cell16: bool = False):
    """Fill with direction words (the JAX ``batch_fill_dirs_pallas``;
    affine with ``gap_extend``; int16 cells with ``cell16``, gated by the
    caller on ``int16_cells_ok``).  M must be a multiple of 16 and B of
    tile_pairs.

    Returns (scores, best_is, best_js, dirs), and dirs2 fifth for affine
    gaps, on the inputs' device: scores (B,) as ``batch_score``;
    best_is/best_js (B,) the local or semi best cell, the first in
    row-major order (0 for global, whose walk starts at (m, n)); dirs
    (B/tile_pairs, M/16, N, tile_pairs/128, 128) int32 words and dirs2
    the run bits in the same layout, every word defined, padding
    included.  Launches count as in ``batch_score``.
    """
    _check(texts, patterns, ns, ms, score_matrix, gap, gap_extend, k_alpha,
           local, semi, tile_pairs)
    if texts.device.type == "cpu":
        return batch_fill_dirs_plain(texts, patterns, ns, ms, score_matrix,
                                     gap, k_alpha, local=local, semi=semi,
                                     tile_pairs=tile_pairs,
                                     gap_extend=gap_extend, cell16=cell16)
    launch, out = kernel_launch(texts, patterns, ns, ms, score_matrix, gap,
                                k_alpha, local, semi, tile_pairs=tile_pairs,
                                with_dirs=True, gap_extend=gap_extend,
                                cell16=cell16)
    launch()
    if cell16:
        batch_fill_dirs.cell16_launches += 1
    else:
        batch_fill_dirs.launches += 1
    return out


batch_fill_dirs.launches = 0
batch_fill_dirs.cell16_launches = 0


def search_score(texts, groups, width: int, ns, query, score_matrix, gap,
                 k_alpha: int, local: bool = False, semi: bool = False,
                 gap_extend=None, cell16: bool = False):
    """Scores of ``query`` against every pair of a run of search groups
    (``csrc/interpair.cu``'s search layout; int16 cells with ``cell16``,
    which the caller gates on ``int16_local_ok`` in local mode and on
    ``int16_cells_ok`` in the others).

    texts: int8, the run's groups' blocks, group g's (width_g, GROUP)
    [column][pair] block from ``groups[g] - groups[0]``, the blocks in
    order and back to back; groups: (G,) int64 offsets; width: the
    widest group's width (the caller's, so that no launch reads the
    device); ns: (G * GROUP,) int32 lengths, pair GROUP * g + l the text
    in column l of group g (0 for a padding pair); query: (m,) int8
    letters, m >= 1.  Returns (G * GROUP,) int32 on the inputs' device,
    as ``batch_score``'s for the pairs (text, query).  A launch counts in
    ``search_score.launches`` or ``search_score.cell16_launches``."""
    b, m = ns.shape[0], query.shape[0]
    if groups.dim() != 1 or b != GROUP * groups.shape[0] or m < 1:
        raise ValueError(f"{b} lengths for {groups.shape[0]} groups of "
                         f"{GROUP}, query of {m}")
    if texts.device.type == "cpu":
        return _search_plain(texts, groups, ns, query, score_matrix, gap,
                             k_alpha, local, semi, gap_extend, cell16)
    for name, x, dtype in (("texts", texts, torch.int8),
                           ("groups", groups, torch.int64),
                           ("ns", ns, torch.int32),
                           ("query", query, torch.int8),
                           ("score_matrix", score_matrix, torch.int32)):
        if x.device != texts.device or x.dtype != dtype or \
                not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dtype} on "
                             f"{texts.device}")
    name = library_name(cell16)
    affine = gap_extend is not None
    device = texts.device
    i32 = torch.int32
    # The scratch holds the texts' extent in int32 (in packed int16
    # pairs, half of it, for cell16).
    extent = texts.shape[0] // 2 if cell16 else texts.shape[0]
    row = torch.empty(extent, dtype=i32, device=device)
    frow = torch.empty(extent, dtype=i32, device=device) if affine else None
    ms = torch.full((1,), m, dtype=i32, device=device)
    scores = torch.empty(b, dtype=i32, device=device)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = c_function(library(name), f"sa_{name}_search",
                    [p] * 6 + [i, i, i, i, ctypes.c_int64, i, i, i]
                    + [p] * 4)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(texts.data_ptr(), groups.data_ptr(), query.data_ptr(),
                ns.data_ptr(), ms.data_ptr(), score_matrix.data_ptr(),
                k_alpha, int(gap), int(gap_extend) if affine else 0,
                int(affine), b, int(width), m,
                mode_code(local, semi), row.data_ptr(), ptr(frow),
                scores.data_ptr(), stream)
    check_launch(name, rc)
    if cell16:
        search_score.cell16_launches += 1
    else:
        search_score.launches += 1
    return scores


search_score.launches = 0
search_score.cell16_launches = 0


def _search_plain(texts, groups, ns, query, score_matrix, gap, k_alpha,
                  local, semi, gap_extend, cell16):
    """``search_score``'s plain version: the groups' blocks unpacked to
    (B, widest) rows and the query repeated, through
    ``batch_score_plain``."""
    rel = groups.to(torch.int64) - groups[0]
    widths = (torch.cat([rel[1:], rel.new_tensor([texts.shape[0]])])
              - rel) // GROUP
    cols = torch.arange(int(widths.max()), device=texts.device)
    lanes = torch.arange(GROUP, device=texts.device)
    at = rel[:, None, None] + cols * GROUP + lanes[:, None]
    inside = (cols < widths[:, None, None]).expand_as(at)
    rows = torch.zeros(at.shape, dtype=torch.int8, device=texts.device)
    rows[inside] = texts[at[inside]]
    b, m = ns.shape[0], query.shape[0]
    return batch_score_plain(
        rows.reshape(b, -1), query.reshape(1, m).expand(b, m), ns,
        torch.full((b,), m, dtype=torch.int32, device=texts.device),
        score_matrix, gap, k_alpha, local=local, semi=semi,
        gap_extend=gap_extend, cell16=cell16)


def _fill_plain(texts, patterns, ns, ms, score_matrix, gap, k_alpha, local,
                semi, tile_pairs, gap_extend=None, cell16=False):
    """Row-by-row fill of every pair at once, on the inputs' device.

    A linear-gap row resolves its left dependency with one running
    maximum: H[j] = max(T[j], H[j-1] - gap) with T = max(diag, top - gap)
    (floored at 0 for local) is cummax(T[k] + gap*k) - gap*j, with H[i, 0]
    in front.  An affine row takes F elementwise from the row above; its
    left run closes with one running maximum too: with T = max(diag, F)
    (floored for local) and T[0] = H[i, 0], E[j] + ge*j is the running
    maximum of T[k] - g + ge*(k+1) over k < j, and of NEG_HALF.  The
    terms E[k] leaves out are no larger, since gap >= ge: extending E[k]
    beats closing it and reopening.

    ``cell16``: the cells, E and F are torch.int16, E, F and the
    trackers start at NEG_16, and the words, best cells and scores widen
    to int32, as in the JAX kernel's int16 mode.  The running maxima are
    taken in int32, since their ramps (gap * k, extend * (k + 1)) leave
    int16 at the widths ``int16_local_ok`` admits (12 * 8,192), and their
    results, H and E, are narrowed to int16; a ValueError at the end if
    one left [NEG_16 - INT16_VALUE_CAP, 2 * INT16_VALUE_CAP], the range
    in which ``int16_cells_ok`` and ``int16_local_ok`` hold every cell,
    E, F, T and diagonal (their docstrings; B <= the cap), so the check
    never fails inside them, and the outputs are the kernel's.

    Returns (scores, best_is, best_js, dirs or None, dirs2 or None)."""
    device = texts.device
    i32 = torch.int32
    b, n_cols = texts.shape
    m_rows = patterns.shape[1]
    gap = int(gap)
    affine = gap_extend is not None
    ge = int(gap_extend) if affine else 0
    # The cells' type, the gap runs' sentinel and the trackers' start.
    cdt, neg_run, neg_acc = ((torch.int16, NEG_16, NEG_16) if cell16
                             else (i32, NEG_HALF, NEG_INF))
    text = texts.long()
    pat = patterns.long()
    sm = score_matrix.reshape(-1)
    n = ns.long().clamp(max=n_cols)[:, None]
    m = ms.long().clamp(max=m_rows)
    col = torch.arange(n_cols, device=device)[None, :]  # j: DP column j+1
    ramp = (ge if affine else gap) * torch.arange(n_cols + 1, dtype=i32,
                                                  device=device)
    # cell16: the least and the largest running maximum narrowed to
    # int16, checked at the end.
    lo = hi = torch.zeros((), dtype=i32, device=device)

    def narrow(x):
        nonlocal lo, hi
        if not cell16:
            return x
        x_lo, x_hi = torch.aminmax(x)
        lo, hi = torch.minimum(lo, x_lo), torch.maximum(hi, x_hi)
        return x.to(cdt)

    in_text = col < n
    if local or semi:
        prev = torch.zeros((b, n_cols), dtype=cdt, device=device)
    elif affine:
        prev = (-gap - ge * col).to(cdt).expand(b, n_cols)
    else:
        prev = (-gap * (col + 1)).to(cdt).expand(b, n_cols)
    f_prev = torch.full((b, n_cols), neg_run, dtype=cdt, device=device)
    acc = torch.full((b,), neg_acc, dtype=cdt, device=device)
    bi = torch.zeros(b, dtype=i32, device=device)
    bj = torch.zeros(b, dtype=i32, device=device)
    with_dirs = tile_pairs is not None
    if with_dirs:
        planes = 2 if affine else 1
        words = torch.empty((planes, m_rows // DIR_ROWS_PER_WORD, n_cols, b),
                            dtype=i32, device=device)

    def column0(i):  # H[i, 0]
        if local:
            return 0
        if affine:
            return 0 if i == 0 else -gap - ge * (i - 1)
        return -gap * i

    for i in range(1, m_rows + 1):
        h0 = torch.full((b, 1), column0(i), dtype=cdt, device=device)
        d0 = torch.full((b, 1), column0(i - 1), dtype=cdt, device=device)
        sub = sm[pat[:, i - 1:i] * k_alpha + text].to(cdt)
        diag = torch.cat([d0, prev[:, :-1]], dim=1) + sub
        if affine:
            f_ext = f_prev - ge
            f_open = prev - gap
            f = torch.maximum(f_ext, f_open)
            t = torch.maximum(diag, f)
            if local:
                t = t.clamp_min(0)
            # E[j] + ge*j for j = 1..N: the running maximum over the
            # columns k < j of T[k] - gap + ge*(k+1), T[0] = H[i, 0].
            opened = torch.cat([h0, t[:, :-1]], dim=1) + (ramp[1:] - gap)
            e = narrow(torch.cummax(opened, dim=1).values.clamp_min(neg_run)
                       - ramp[1:])
            cur = torch.maximum(t, e)
            gap_best = torch.maximum(e, f)
            is_left = e >= f
        else:
            t = torch.maximum(diag, prev - gap)
            if local:
                t = t.clamp_min(0)
            chain = torch.cummax(torch.cat([h0, t], dim=1) + ramp,
                                 dim=1).values
            cur = narrow((chain - ramp)[:, 1:])
        if with_dirs:
            left = torch.cat([h0, cur[:, :-1]], dim=1)
            if not affine:
                gap_best = torch.maximum(prev, left) - gap
                is_left = left >= prev
            d = torch.where(diag > gap_best, 1,
                            torch.where(is_left, 0, 2)).to(i32)
            if local:
                d = torch.where(torch.maximum(diag, gap_best) > 0, d, 3)
            r = (i - 1) % DIR_ROWS_PER_WORD
            word = d if r == 0 else word | (d << (2 * r))
            if affine:
                e_before = torch.cat(
                    [torch.full((b, 1), neg_run, dtype=cdt, device=device),
                     e[:, :-1]], dim=1)
                runs = ((e_before - ge > left - gap).to(i32)
                        | ((f_ext > f_open).to(i32) << 1))
                word2 = runs if r == 0 else word2 | (runs << (2 * r))
            if r == DIR_ROWS_PER_WORD - 1:
                words[0, (i - 1) // DIR_ROWS_PER_WORD] = word.t()
                if affine:
                    words[1, (i - 1) // DIR_ROWS_PER_WORD] = word2.t()
        if local or semi:
            row_ok = (i <= m) if local else (m == i)
            cand = torch.where(in_text & row_ok[:, None], cur, neg_acc)
            best, arg = cand.max(dim=1)  # the first best column of the row
            better = best > acc
            acc = torch.where(better, best, acc)
            bi = torch.where(better, i, bi)
            bj = torch.where(better, (arg + 1).to(i32), bj)
        else:
            hit = (m == i) & (n[:, 0] >= 1)
            at_n = cur.gather(1, (n - 1).clamp(min=0)).reshape(-1)
            acc = torch.where(hit, at_n, acc)
        prev = cur
        if affine:
            f_prev = f
    if cell16 and not (NEG_16 - INT16_VALUE_CAP <= int(lo)
                       and int(hi) <= 2 * INT16_VALUE_CAP):
        raise ValueError(f"int16 cells: values {int(lo)}..{int(hi)} leave "
                         f"the gates' range (the shape is outside them)")
    scores = (acc.clamp_min(0) if local else acc).to(i32)
    if not with_dirs:
        return scores, bi, bj, None, None
    tiles = b // tile_pairs
    dirs = (words.reshape(planes, m_rows // DIR_ROWS_PER_WORD, n_cols,
                          tiles, tile_pairs)
            .permute(0, 3, 1, 2, 4)
            .reshape(planes, tiles, m_rows // DIR_ROWS_PER_WORD, n_cols,
                     tile_pairs // 128, 128)
            .contiguous())
    return scores, bi, bj, dirs[0], dirs[1] if affine else None


def batch_score_plain(texts, patterns, ns, ms, score_matrix, gap,
                      k_alpha: int, local: bool = False, semi: bool = False,
                      gap_extend=None, cell16: bool = False):
    """Plain PyTorch version of ``batch_score``, on the inputs' device,
    with identical outputs."""
    return _fill_plain(texts, patterns, ns, ms, score_matrix, gap, k_alpha,
                       local, semi, None, gap_extend, cell16)[0]


def batch_fill_dirs_plain(texts, patterns, ns, ms, score_matrix, gap,
                          k_alpha: int, local: bool = False,
                          semi: bool = False,
                          tile_pairs: int = TILE_QUANTUM, gap_extend=None,
                          cell16: bool = False):
    """Plain PyTorch version of ``batch_fill_dirs``, on the inputs'
    device, with identical outputs."""
    out = _fill_plain(texts, patterns, ns, ms, score_matrix, gap, k_alpha,
                      local, semi, tile_pairs, gap_extend, cell16)
    return out if gap_extend is not None else out[:4]
