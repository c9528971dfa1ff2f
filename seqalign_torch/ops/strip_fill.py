"""Prefix-max strip fill (K5): wrapper, plain version and the single-pair
fill over one region.

The counterpart of the JAX package's ``pallas_fill.strip_fill_pallas``,
``pair_fill_pallas`` and their helpers.  One call fills a region of the
DP matrix: rows row_base+1 .. row_base+M of one column strip, columns
strip_off+1 .. strip_off+W, linear gaps, global or local.  It takes the
left boundary column, the DP row above and the state [best, best_i,
best_j, score] carried from earlier regions, and returns

* the 2-bit direction words, (M/16, W) int32: word (w, p) holds rows
  16w+1 .. 16w+16 at column strip_off+p+1, row 16w+r+1 at bits 2r (the
  JAX words ``(M/16, 8, L)`` flattened: their (8, L) rows are row-major
  segments in column order); None for the score-only fill;
* the region's last DP row, (W,) int32;
* its right boundary column S[i, strip_off+W], (M,) int32;
* the state after the region, (4,) int32: local, the best moves only on
  a row maximum over columns <= n strictly above it, for rows <= m, to
  the first column of that maximum in its row; global, ``score`` takes
  S[m, n] when the strip holds column n.

The TPU kernel reads a (K, 8, L) profile; the port's kernel reads the
strip's text letters and the (k, k) matrix and scores columns past n with
PAD_SCORE itself (``strip_letters`` is the profile's role).  For tensors
on a CUDA device ``strip_fill`` launches the CUDA kernel
(``csrc/strip.cu``: the region as a chain of one-warp bands over the
whole card, handing their last rows on through streams in a scratch
buffer the wrapper owns); for tensors on the CPU it runs
``strip_fill_plain``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import layout
from ._build import c_function, check_launch, int_function, library

NEG_INF = -(1 << 30)
PAD_SCORE = -(1 << 24)
DIR_ROWS_PER_WORD = 16   # 2-bit directions, 16 DP rows per int32 word
ROWS_PER_STEP = 128      # a region's rows are a multiple of this
MAX_CHUNK_ROWS = 16384   # rows of one region at most
COLS_QUANTUM = 1024      # a strip's width is a multiple of this
MAX_STRIP_COLS = 65536   # and at most this


def zeros_state() -> np.ndarray:
    """[best, best_i, best_j, score] before any region: the local best
    starts at 0 in cell (0, 0), the reference's init; the global score at
    NEG_INF."""
    return np.array([0, 0, 0, NEG_INF], dtype=np.int32)


def nw_boundary_col(row_base: int, m_chunk: int, gap: int,
                    local: bool) -> np.ndarray:
    """Left boundary of strip 0, S[i, 0] for i = row_base .. row_base +
    m_chunk: 0 (local) or -gap*i (global)."""
    rows = np.arange(row_base, row_base + m_chunk + 1, dtype=np.int64)
    if local:
        return np.zeros_like(rows, dtype=np.int32)
    return (-gap * rows).astype(np.int32)


def init_prev_row(strip_cols: int, strip_off: int, gap: int,
                  local: bool) -> np.ndarray:
    """DP row 0 of a strip, (strip_cols,): 0 (local) or -gap*j (global)."""
    jpos = strip_off + np.arange(1, strip_cols + 1, dtype=np.int64)
    if local:
        return np.zeros(strip_cols, np.int32)
    return (-gap * jpos).astype(np.int32)


def pair_columns(n: int) -> int:
    """Width of the single region of a text of n letters (the JAX
    ``build_pair_profile``'s p_cols)."""
    return max(COLS_QUANTUM, -(-n // COLS_QUANTUM) * COLS_QUANTUM)


def pair_rows(m: int) -> int:
    """Rows of a pattern of m letters, padded to whole steps."""
    return max(ROWS_PER_STEP, -(-m // ROWS_PER_STEP) * ROWS_PER_STEP)


def strip_letters(text, strip_off: int, strip_cols: int) -> np.ndarray:
    """(strip_cols,) int32 letters of text[strip_off : strip_off +
    strip_cols], zero past its end: the kernels' substitution input, in
    the role of the JAX strip profile (columns past n score PAD_SCORE)."""
    chunk = np.asarray(text, dtype=np.int32)[strip_off:strip_off + strip_cols]
    out = np.zeros(strip_cols, dtype=np.int32)
    out[:chunk.shape[0]] = chunk
    return out


def _check(text, score_matrix, pattern, n, m, row_base, strip_off,
           left_col, prev_row, state):
    device = text.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"the strip fill runs on cuda or cpu, not {device}")
    if score_matrix.dim() != 2 or score_matrix.shape[0] != \
            score_matrix.shape[1] or not 1 <= score_matrix.shape[0] <= 32:
        raise ValueError("score_matrix must be (k, k) with k in 1..32")
    k = score_matrix.shape[0]
    if text.dim() != 1 or pattern.dim() != 1:
        raise ValueError("text and pattern must be 1-D letter tensors")
    w, rows = text.shape[0], pattern.shape[0]
    if w % COLS_QUANTUM or not COLS_QUANTUM <= w <= MAX_STRIP_COLS:
        raise ValueError(f"strip width {w} must be a multiple of "
                         f"{COLS_QUANTUM} up to {MAX_STRIP_COLS}")
    if rows % ROWS_PER_STEP or not ROWS_PER_STEP <= rows <= MAX_CHUNK_ROWS:
        raise ValueError(f"region rows {rows} must be a multiple of "
                         f"{ROWS_PER_STEP} up to {MAX_CHUNK_ROWS}")
    for name, x, shape in (("score_matrix", score_matrix, (k, k)),
                           ("pattern", pattern, (rows,)),
                           ("left_col", left_col, (rows + 1,)),
                           ("prev_row", prev_row, (w,)),
                           ("state", state, (4,))):
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, expected {device}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                             f"{shape}")
        if x.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {x.dtype}")
    if text.dtype not in (torch.int8, torch.int32):
        raise ValueError("text must be int8 or int32 letters")
    for name, x in (("text", text), ("pattern", pattern)):
        if int(x.min()) < 0 or int(x.max()) >= k:
            raise ValueError(f"{name} has letters outside 0..{k - 1}")
    if min(n, m, row_base, strip_off) < 0:
        raise ValueError("n, m, row_base and strip_off must be >= 0")


def strip_fill(text, score_matrix, pattern, gap, n: int, m: int,
               row_base: int, strip_off: int, left_col, prev_row, state,
               local: bool = False, with_dirs: bool = True):
    """Fill one region (see the module docstring).

    Args, all tensors on one device: text (W,) int8 or int32 letters of
    the strip's columns (``strip_letters``); score_matrix (k, k) int32;
    pattern (M,) int32 letters of the region's rows (zero past m);
    left_col (M+1,) S[row_base + r, strip_off]; prev_row (W,) DP row
    row_base of the strip; state (4,) the carried [best, best_i, best_j,
    score].  n and m are the pair's real lengths.

    Returns (words or None, prev_out, right_col, state_out), the JAX
    order.
    """
    _check(text, score_matrix, pattern, n, m, row_base, strip_off,
           left_col, prev_row, state)
    if text.device.type == "cpu":
        return strip_fill_plain(text, score_matrix, pattern, gap, n, m,
                                row_base, strip_off, left_col, prev_row,
                                state, local=local, with_dirs=with_dirs)
    launch, out = kernel_launch(text, score_matrix, pattern, gap, n, m,
                                row_base, strip_off, left_col, prev_row,
                                state, local, with_dirs)
    launch()
    strip_fill.launches += 1
    return out


strip_fill.launches = 0


# K5's scratch (csrc/strip.cu): SCRATCH_COUNTERS int32 (the ticket, the
# CTAs done, S[m, n], the stream windows loaded at LOADS and found empty
# at MISSES; from SM_LOG each CTA's SM + 1, from BAND_START / BAND_END
# each band's first and last iteration in ns, then each band's local
# candidate), then the bands' tagged streams.
SCRATCH_COUNTERS = 4096
LOADS = 4
MISSES = 5
SM_LOG = 512
BAND_START = 1024
BAND_END = 1536
WARP = 32


def rows_per_lane(with_dirs: bool) -> int:
    """Rows a lane of K5 owns in the variant with words or score-only (a
    band is 32 of them)."""
    return int_function(library("strip"), "sa_strip_rows_per_lane", 1)(
        int(with_dirs))


def kernel_launch(text, score_matrix, pattern, gap, n, m, row_base,
                  strip_off, left_col, prev_row, state, local: bool,
                  with_dirs: bool):
    """K5 on the inputs' CUDA device, ready to launch: the letters as int8
    and the outputs and the scratch allocated.  Returns (launch, (words,
    prev_out, right_col, state_out)); each ``launch()`` runs the kernel
    once on the current stream (a second run writes the same outputs),
    raising if the launch failed, and counts nothing (``strip_fill``
    counts its launches).  ``launch.scratch`` is the launch's scratch (the
    bands' streams and counters), re-zeroed by every ``launch()``;
    ``_build.launch_sms(launch)`` reads where its CTAs ran."""
    return shape_launch(library("strip"), None, text, score_matrix, pattern,
                        gap, n, m, row_base, strip_off, left_col, prev_row,
                        state, local, with_dirs)


def shape_launch(lib, shape, text, score_matrix, pattern, gap, n, m,
                 row_base, strip_off, left_col, prev_row, state, local: bool,
                 with_dirs: bool):
    """``kernel_launch`` through ``lib``, a build of ``csrc/strip.cu``:
    ``shape`` None calls ``sa_strip_fill`` at the variant's own shape;
    ``shape`` = (rows a lane, columns an iteration) calls the all-shapes
    build's ``sa_strip_fill_shape`` at it."""
    rpl = (int_function(lib, "sa_strip_rows_per_lane", 1)(int(with_dirs))
           if shape is None else shape[0])
    device = text.device
    w, rows = text.shape[0], pattern.shape[0]
    i32 = torch.int32
    text8 = text.to(torch.int8).contiguous()
    sm, pattern, left_col, prev_row, state = (
        x.contiguous() for x in (score_matrix, pattern, left_col, prev_row,
                                 state))
    words = (torch.empty((rows // DIR_ROWS_PER_WORD, w), dtype=i32,
                         device=device) if with_dirs else None)
    prev_out = torch.empty(w, dtype=i32, device=device)
    rcol = torch.empty(rows, dtype=i32, device=device)
    state_out = torch.empty(4, dtype=i32, device=device)
    # The bands' streams, the ticket and the counters (csrc/strip.cu's
    # head note); the C entry point zeroes them on the stream before every
    # launch.
    nbytes = int_function(lib, "sa_strip_scratch_bytes", 3,
                          ctypes.c_longlong)(w, rows, rpl)
    scratch = torch.empty(-(-nbytes // 8), dtype=torch.int64, device=device)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = c_function(lib, "sa_strip_fill" if shape is None
                    else "sa_strip_fill_shape",
                    [p, p, p] + [i] * 8 + [p, p, p, i] + [p] * 4
                    + [i, i] * (shape is not None) + [p, p])
    tail = () if shape is None else tuple(shape)

    def launch():
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = fn(
                text8.data_ptr(), pattern.data_ptr(), sm.data_ptr(),
                sm.shape[0], int(gap), int(n), int(m), int(row_base),
                int(strip_off), w, rows, left_col.data_ptr(),
                prev_row.data_ptr(), state.data_ptr(), int(local),
                None if words is None else words.data_ptr(),
                state_out.data_ptr(), prev_out.data_ptr(), rcol.data_ptr(),
                *tail, scratch.data_ptr(), stream,
            )
        check_launch("strip", rc)

    launch.scratch = scratch
    launch.sm_log = SM_LOG
    launch.ctas = rows // (WARP * rpl)
    return launch, (words, prev_out, rcol, state_out)


def strip_fill_plain(text, score_matrix, pattern, gap, n: int, m: int,
                     row_base: int, strip_off: int, left_col, prev_row,
                     state, local: bool = False, with_dirs: bool = True):
    """Plain PyTorch version of ``strip_fill``, on the inputs' device, with
    identical outputs: row by row, the left-gap chain of a row as one
    running maximum, S[i, j] = cummax(tmp[k] + g k) - g j with the left
    boundary in front."""
    device = text.device
    i32 = torch.int32
    g = int(gap)
    w, rows = text.shape[0], pattern.shape[0]
    k = score_matrix.shape[0]
    jpos = strip_off + 1 + torch.arange(w, device=device)
    col_ok = jpos <= n
    gj = (g * jpos).to(i32)
    sm = torch.cat([score_matrix,
                    torch.full((k, 1), PAD_SCORE, dtype=i32, device=device)],
                   dim=1).reshape(-1)
    letters = torch.where(col_ok, text.long(), k)
    pat = pattern.tolist()
    lc = left_col.tolist()
    prev = prev_row.clone()
    best, bi, bj, score = (x.reshape(1) for x in state.clone())
    words = (torch.empty((rows // DIR_ROWS_PER_WORD, w), dtype=i32,
                         device=device) if with_dirs else None)
    rcol = torch.empty(rows, dtype=i32, device=device)
    at_n = n - strip_off - 1 if strip_off < n <= strip_off + w else None
    for rr in range(rows):
        i = row_base + rr + 1
        above = torch.full((1,), lc[rr], dtype=i32, device=device)
        here = torch.full((1,), lc[rr + 1], dtype=i32, device=device)
        diag = torch.cat([above, prev[:-1]]) + sm[pat[rr] * (k + 1) + letters]
        top = prev - g
        tmp = torch.maximum(diag, top)
        if local:
            tmp = tmp.clamp_min(0)
        chain = torch.cat([here + g * strip_off, tmp + gj])
        row = torch.cummax(chain, dim=0).values[1:] - gj
        if with_dirs:
            left = torch.cat([here, row[:-1]]) - g
            gap_best = torch.maximum(left, top)
            d = torch.where(diag > gap_best, 1,
                            torch.where(left >= top, 0, 2)).to(i32)
            if local:
                d = torch.where(torch.maximum(diag, gap_best) > 0, d, 3)
            r = rr % DIR_ROWS_PER_WORD
            word = d if r == 0 else word | (d << (2 * r))
            if r == DIR_ROWS_PER_WORD - 1:
                words[rr // DIR_ROWS_PER_WORD] = word
        rcol[rr] = row[-1]
        if local and i <= m:
            masked = torch.where(col_ok, row, NEG_INF)
            rm = masked.max().reshape(1)
            better = rm > best
            best = torch.where(better, rm, best)
            bi = torch.where(better, i, bi)
            # argmax gives the first column of the maximum.
            bj = torch.where(better, jpos[masked.argmax()].to(i32), bj)
        elif not local and i == m and at_n is not None:
            score = torch.maximum(score, row[at_n].reshape(1))
        prev = row
    state_out = torch.cat([best, bi, bj, score]).to(i32)
    return words, prev, rcol, state_out


def pair_fill(text, score_matrix, pattern, gap, n: int, m: int,
              local: bool = False):
    """Single-pair fill over one region from row 0 and column 0 (the JAX
    ``pair_fill_pallas``): text (P,) the letters of ``strip_letters(text,
    0, pair_columns(n))``, pattern (M_pad,) padded with 0.  Returns
    (words (M_pad/16, P) on the inputs' device, score, best_i, best_j);
    global's best cell is (0, 0), its walk starts at (m, n)."""
    device = text.device
    p_cols, m_pad = text.shape[0], pattern.shape[0]

    def tensor(x):
        return torch.from_numpy(x).to(device)

    words, _, _, state = strip_fill(
        text, score_matrix, pattern, gap, n, m, 0, 0,
        tensor(nw_boundary_col(0, m_pad, gap, local)),
        tensor(init_prev_row(p_cols, 0, gap, local)),
        tensor(zeros_state()), local=local,
    )
    best, bi, bj, score = state.tolist()
    return words, (best if local else score), bi, bj


def from_reference_strip(text, score_matrix, k_alpha: int, strip_off: int,
                         strip_cols: int, pattern, left_col, prev_row, state,
                         device):
    """The inputs of one JAX region as the port's tensors on ``device``:
    (text, score_matrix, pattern, left_col, prev_row, state) for
    ``strip_fill``.  The JAX profile is built from ``text`` and the
    matrix; the port takes the strip's letters and the (k, k) matrix in
    its place.  The (8, L) row is flattened (row-major segments are the
    column order), the (1, 4) state too."""
    def as_tensor(x):
        return torch.as_tensor(
            np.ascontiguousarray(np.asarray(x, dtype=np.int32)).reshape(-1)
        ).to(device)

    return (as_tensor(strip_letters(text, strip_off, strip_cols)),
            torch.as_tensor(layout.pack_score_matrix(score_matrix,
                                                     k_alpha)).to(device),
            as_tensor(pattern), as_tensor(left_col), as_tensor(prev_row),
            as_tensor(state))


def from_reference_outputs(dirs, prev_out, right_col, state,
                           with_dirs: bool = True):
    """The outputs of one JAX region (dirs (M/16, 8, L), prev_out (8, L),
    right_col, state (1, 4)) as the port's numpy arrays: (words (M/16, W)
    or None, prev_out (W,), right_col (M,), state (4,)).  The score-only
    JAX call returns a dummy word block that it never writes: None."""
    words = None
    if with_dirs:
        dirs = np.asarray(dirs, dtype=np.int32)
        words = dirs.reshape(dirs.shape[0], -1)
    return (words, np.asarray(prev_out, np.int32).reshape(-1),
            np.asarray(right_col, np.int32).reshape(-1),
            np.asarray(state, np.int32).reshape(-1))
