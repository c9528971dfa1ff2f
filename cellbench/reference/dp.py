"""The linear-gap DP in plain PyTorch, row by row, for many pairs at once.

The recurrence is the reference program's (alignSequenceCPU.cpp, and
``seqalign_torch/native/oracle.cpp``'s ``fill``): H[i][j] = max(H[i-1][j-1]
+ s(pattern[i-1], text[j-1]), H[i-1][j] - g, H[i][j-1] - g), with H >= 0 in
local mode, H[0][j] = -g j and H[i][0] = -g i in global mode and zero
edges in local mode.

A row is computed without a loop over its columns.  In the shifted values
G[i][j] = H[i][j] + g (i + j) the left term needs no gap, so a row is a
running maximum: G[i][j] = max(T[j], G[i][j-1]) with T[j] = max(G[i-1][j-1]
+ s + 2g, G[i-1][j] [, g (i + j) in local mode]).  The running maximum is
taken in chunks of columns (``torch.cummax``) and the chunks' carries by
a second ``cummax`` (``_Scan``), so a row is a handful of tensor operations
over all pairs.  Every value is an int32 sum of integers:
the fill is exact.

With ``int16`` the cells saturate as a 16-bit integer DP's do (every sum
clamped to -32,768..32,767), the precision below the configurations'
int32: the control.  Clamping the row's diagonal-and-top term T is
enough, since clamping commutes with the maximum and a left move from a
clamped cell stays in range.

What is kept: with a band (``lo``, ``width``), G at columns lo[b, i] ..
lo[b, i] + width - 1 of every row i of pair b; in local mode the maximum
of each row and its first column; in global mode H[m][n] of each pair.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

NEG = -(1 << 29)
INT16_MIN, INT16_MAX = -(1 << 15), (1 << 15) - 1
# Bytes of substitution rows made at a time.
CHUNK_BYTES = 256 << 20


@dataclasses.dataclass
class Fill:
    """What a fill kept, on the host.

    band: (rows, B, width) int32, G at columns clip(lo[b, i] + w) (None
      without a band); ``value`` turns it into H.
    lo: (B, rows) int64 band starts (None without a band).
    row_max, row_arg: (rows, B) the largest H of each row over the pair's
      columns 0..n and its first column (local mode; None otherwise).
    last: (B,) int64 H[m][n] of each pair (global mode; None otherwise).
    """

    band: np.ndarray | None
    lo: np.ndarray | None
    row_max: np.ndarray | None
    row_arg: np.ndarray | None
    last: np.ndarray | None
    gap: int
    ns: np.ndarray
    ms: np.ndarray

    def value(self, b, i, c):
        """(H, inside) at pair b, row i, column c (arrays): inside is False
        where the cell is off the pair's matrix or outside the band."""
        b, i, c = (np.asarray(x, dtype=np.int64) for x in (b, i, c))
        width = self.band.shape[2]
        rows = self.band.shape[0]
        i_ok = (i >= 0) & (i <= self.ms[b]) & (i < rows)
        ic = np.clip(i, 0, rows - 1)
        w = c - self.lo[b, ic]
        inside = i_ok & (c >= 0) & (c <= self.ns[b]) & (w >= 0) & (w < width)
        g = self.band[ic, b, np.clip(w, 0, width - 1)].astype(np.int64)
        return g - self.gap * (i + c), inside


# Columns of the running maximum's chunks: the fastest split measured on an
# H100 for rows of 281,600 columns (109 us a row for four pairs; chunks of
# 512 and 1,024 columns and two or three levels of chunks took 156-730 us).
SCAN_WIDTH = 128


class _Scan:
    """Running maximum along the rows of a (B, N) int32 tensor:
    ``torch.cummax`` within chunks of ``width`` columns, again over the
    chunks' last values, and the carry of the chunks before each folded
    in.  N must be a multiple of ``width``."""

    def __init__(self, b: int, n: int, width: int, device):
        self.shape = (b, n // width, width)
        self.chunks = torch.empty(self.shape, dtype=torch.int32, device=device)
        self.chunks_at = torch.empty(self.shape, dtype=torch.int64,
                                     device=device)
        self.carry = (torch.empty(self.shape[:2], dtype=torch.int32,
                                  device=device),
                      torch.empty(self.shape[:2], dtype=torch.int64,
                                  device=device))
        self.before = torch.full(self.shape[:2], NEG, dtype=torch.int32,
                                 device=device)

    def __call__(self, t, out):
        """out = running max of t along dim 1 (out may be a row view)."""
        torch.cummax(t.view(self.shape), dim=2,
                     out=(self.chunks, self.chunks_at))
        torch.cummax(self.chunks[:, :, -1], dim=1, out=self.carry)
        self.before[:, 1:] = self.carry[0][:, :-1]
        torch.maximum(self.chunks, self.before[:, :, None],
                      out=out.view(self.shape))


def fill(texts, patterns, score_matrix, gap: int, local: bool,
         lo: np.ndarray | None = None, width: int = 0,
         device="cpu", int16: bool = False) -> Fill:
    """Fill the DP of every pair (texts[b] along the columns, patterns[b]
    down the rows) on ``device``; see the module docstring for what is
    kept.  ``lo`` (B, max m + 1) and ``width`` place the band; ``int16``
    saturates the cells."""
    device = torch.device(device)
    b_count = len(texts)
    ns = np.array([len(t) for t in texts], dtype=np.int64)
    ms = np.array([len(p) for p in patterns], dtype=np.int64)
    n_max, m_max = int(ns.max()), int(ms.max())
    rows = m_max + 1
    n_cols = -(-(n_max + 1) // SCAN_WIDTH) * SCAN_WIDTH
    g = int(gap)
    i32 = dict(dtype=torch.int32, device=device)

    sm = torch.as_tensor(np.asarray(score_matrix, dtype=np.int32), **i32)
    k = sm.shape[0]
    text_cols = np.zeros((b_count, n_cols), dtype=np.int64)
    pat_rows = np.zeros((b_count, max(m_max, 1)), dtype=np.int64)
    for b in range(b_count):
        text_cols[b, 1:ns[b] + 1] = texts[b]
        pat_rows[b, :ms[b]] = patterns[b]
    text_cols = torch.as_tensor(text_cols, device=device)
    pat_rows = torch.as_tensor(pat_rows, device=device)
    # table[b, a, j] = s(a, text_b[j-1]) + 2g: the diagonal term in G.
    table = (sm[:, text_cols] + 2 * g).permute(1, 0, 2).contiguous()
    table[:, :, 0] = 0
    del text_cols
    b_index = torch.arange(b_count, device=device)[None, :]

    g_prev = torch.full((b_count, n_cols + 1), NEG, **i32)
    g_next = torch.full((b_count, n_cols + 1), NEG, **i32)
    g_cols = g * torch.arange(n_cols, **i32)
    g_diag = g * torch.arange(rows + n_cols, **i32)  # g (i + j) from i
    g_prev[:, 1:] = g_cols if local else 0
    if int16:
        # T in G, clamped to the int16 range of H: g (i + j) + INT16_*.
        t_min, t_max = g_diag + INT16_MIN, g_diag + INT16_MAX
        if not local:  # H[0][j] = max(-g j, INT16_MIN)
            g_prev[:, 1:] = torch.clamp(t_min[:n_cols], min=0)
    t_row = torch.empty((b_count, n_cols), **i32)
    h_row = torch.empty((b_count, n_cols), **i32)
    running_max = _Scan(b_count, n_cols, SCAN_WIDTH, device)

    banded = lo is not None
    if banded:
        lo_dev = torch.as_tensor(lo, dtype=torch.int64, device=device)
        offsets = torch.arange(width, dtype=torch.int64, device=device)
        band = torch.empty((rows, b_count, width), **i32)
    beyond = None
    if local:
        row_max = torch.zeros((rows, b_count), **i32)
        row_arg = torch.zeros((rows, b_count), dtype=torch.int64,
                              device=device)
        if (ns != n_max).any() or n_cols != n_max + 1:
            beyond = (torch.arange(n_cols, device=device)[None, :]
                      > torch.as_tensor(ns, device=device)[:, None])
    else:
        last = torch.zeros(b_count, **i32)
        ends: dict[int, list[int]] = {}
        for b in range(b_count):
            ends.setdefault(int(ms[b]), []).append(b)

    def keep(i, r):
        body = g_prev[:, 1:]
        if banded:
            torch.gather(body, 1, index[r], out=band[i])
        if local:
            if i:
                torch.sub(body, g_diag[i:i + n_cols], out=h_row)
                if beyond is not None:
                    h_row.masked_fill_(beyond, NEG)
                torch.max(h_row, dim=1, out=(row_max[i], row_arg[i]))
        elif i in ends:
            for b in ends[i]:
                last[b] = body[b, ns[b]] - g * (i + int(ns[b]))

    per_row = b_count * n_cols * 4
    chunk = max(1, min(64, CHUNK_BYTES // per_row))
    for i0 in range(0, rows, chunk):
        i1 = min(rows, i0 + chunk)
        if banded:
            index = (lo_dev[:, i0:i1].T[:, :, None] + offsets).clamp_(
                0, n_cols - 1)
        if i0 == 0:
            keep(0, 0)
            first = 1
        else:
            first = i0
        if first >= i1:
            continue
        subs = table[b_index, pat_rows[:, first - 1:i1 - 1].T]
        for i in range(first, i1):
            torch.add(g_prev[:, :n_cols], subs[i - first], out=t_row)
            torch.maximum(t_row, g_prev[:, 1:], out=t_row)
            if local:
                torch.maximum(t_row, g_diag[i:i + n_cols], out=t_row)
            if int16:
                torch.clamp(t_row, t_min[i:i + n_cols], t_max[i:i + n_cols],
                            out=t_row)
            running_max(t_row, g_next[:, 1:])
            g_prev, g_next = g_next, g_prev
            keep(i, i - i0)

    return Fill(
        band=band.cpu().numpy() if banded else None,
        lo=np.asarray(lo, dtype=np.int64) if banded else None,
        row_max=row_max.cpu().numpy() if local else None,
        row_arg=row_arg.cpu().numpy() if local else None,
        last=None if local else last.cpu().numpy().astype(np.int64),
        gap=g, ns=ns, ms=ms)


def best_cells(f: Fill):
    """Local mode: (score, best_i, best_j) of every pair, the reference's
    first row-major occurrence of the largest H (0, 0, 0 when no cell
    scores above 0)."""
    rows = f.row_max.shape[0]
    valid = np.arange(rows)[:, None] <= f.ms[None, :]
    rm = np.where(valid, f.row_max, NEG).astype(np.int64)
    score = rm.max(axis=0)
    bi = np.argmax(rm == score[None, :], axis=0)
    bj = f.row_arg[bi, np.arange(rm.shape[1])]
    none = score <= 0
    return (np.where(none, 0, score), np.where(none, 0, bi),
            np.where(none, 0, bj))


def scores(texts, patterns, score_matrix, gap: int, local: bool,
           device="cpu", int16: bool = False) -> np.ndarray:
    """Optimal scores of the pairs (no band)."""
    f = fill(texts, patterns, score_matrix, gap, local, device=device,
             int16=int16)
    if local:
        return best_cells(f)[0]
    return f.last
