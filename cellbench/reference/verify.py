"""Judge alignments against the reference DP, cell by cell along their paths.

An alignment is what the reference program prints: the aligned text and
pattern as index arrays (``gap`` = the alphabet's size), the two start
offsets and the score.  It equals the reference's own output exactly when

- its path ends where the reference's traceback starts: cell (m, n) in
  global mode, the first row-major cell of the largest H in local mode;
- at every cell of the path the move into the cell is the one the
  reference tie policy picks there (``oracle.cpp``'s ``pick``: the
  diagonal only when strictly above both gap moves, LEFT over TOP on a
  tie; global mode's first row and column force LEFT and TOP);
- the path stops where the reference's traceback stops: at (0, 0) in
  global mode; in local mode at a cell on row or column 0, or at one whose
  best move is not above 0;
- every letter is the sequence's letter at its cell, and the starts are
  the reference traceback's cursors at its end (``sa_traceback_nw`` and
  ``sa_traceback_sw``);
- the score is H at the end cell.

So the reference needs H only next to the path: ``place_band`` puts a
band of columns around the path the alignment claims, ``dp.fill`` keeps
H there, and ``judge`` checks every rule above with the path anchored at
the reference's own end cell.  A path that leaves the band is not the
reference's (whose path would be the claimed one), and is judged wrong.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import dp

LEFT, DIAG, TOP = 0, 1, 2
# Columns kept beside the claimed path on each side.
MARGIN = 2
# Widest band (columns) a fill keeps.
WIDTH_CAP = 4096


@dataclasses.dataclass
class Alignment:
    """One alignment as the reference prints it (index arrays)."""

    text: np.ndarray
    pattern: np.ndarray
    start_text: int
    start_pattern: int
    score: int


def _columns(outs, gap: int):
    """The alignments' columns flattened: pair of each column, whether it
    takes a text letter and a pattern letter, and its two symbols."""
    lens = np.array([len(o.text) for o in outs], dtype=np.int64)
    pid = np.repeat(np.arange(len(outs)), lens)
    at = np.concatenate([np.asarray(o.text, dtype=np.int64) for o in outs]
                        + [np.zeros(0, np.int64)])
    ap = np.concatenate([np.asarray(o.pattern, dtype=np.int64) for o in outs]
                        + [np.zeros(0, np.int64)])
    t = (at != gap).astype(np.int64)
    p = (ap != gap).astype(np.int64)
    return lens, pid, at, ap, t, p


def _sums(x, lens):
    """(running sum within each segment, each segment's total)."""
    total = np.concatenate([[0], np.cumsum(x)])
    starts = np.cumsum(lens) - lens
    base = total[starts]
    running = total[1:] - np.repeat(base, lens)
    return running, total[starts + lens] - base


def place_band(texts, patterns, outs, local: bool, gap_symbol: int,
               margin: int = MARGIN, cap: int = WIDTH_CAP):
    """(lo, width): a band around the path each alignment claims, for
    ``dp.fill``.  The claimed path starts at (0, 0) in global mode and at
    the cell the starts name in local mode; rows it does not reach take the
    nearest row's columns."""
    b_count = len(outs)
    rows = max(len(x) for x in patterns) + 1
    lens, pid, _, _, t, p = _columns(outs, gap_symbol)
    run_t, _ = _sums(t, lens)
    run_p, _ = _sums(p, lens)
    if local:
        i0 = np.array([o.start_pattern + 1 for o in outs], dtype=np.int64)
        j0 = np.array([o.start_text + 1 for o in outs], dtype=np.int64)
    else:
        i0 = np.zeros(b_count, np.int64)
        j0 = np.zeros(b_count, np.int64)
    # Every cell of every claimed path, its start first, pair by pair.
    cell_pid = np.concatenate([np.arange(b_count), pid])
    cell_i = np.concatenate([i0, i0[pid] + run_p])
    cell_j = np.concatenate([j0, j0[pid] + run_t])
    order = np.lexsort((cell_j, cell_i, cell_pid))
    cell_pid, cell_i, cell_j = cell_pid[order], cell_i[order], cell_j[order]
    cell_i = np.clip(cell_i, 0, rows - 1)
    key = cell_pid * rows + cell_i
    first = np.ones(len(key), dtype=bool)
    first[1:] = key[1:] != key[:-1]
    last = np.ones(len(key), dtype=bool)
    last[:-1] = key[1:] != key[:-1]
    a = np.full(b_count * rows, -1, dtype=np.int64)
    z = np.full(b_count * rows, -1, dtype=np.int64)
    a[key[first]] = cell_j[first]
    z[key[last]] = cell_j[last]
    a = a.reshape(b_count, rows)
    z = z.reshape(b_count, rows)
    a, z = _fill_rows(a), _fill_rows(z)
    a_next = np.concatenate([a[:, 1:], a[:, -1:]], axis=1)
    z_next = np.concatenate([z[:, 1:], z[:, -1:]], axis=1)
    lo = np.minimum(a, a_next) - 1 - margin
    hi = np.maximum(z, z_next) + margin
    need = int((hi - lo + 1).max()) if hi.size else 8
    width = min(cap, max(8, -(-need // 8) * 8))
    return lo, width


def _fill_rows(x):
    """Rows marked -1 take the nearest marked row's value before them, or
    after them at the start; all -1 stays 0."""
    rows = x.shape[1]
    idx = np.where(x >= 0, np.arange(rows)[None, :], -1)
    fwd = np.maximum.accumulate(idx, axis=1)
    idx_b = np.where(x >= 0, np.arange(rows)[None, :], rows)
    bwd = np.minimum.accumulate(idx_b[:, ::-1], axis=1)[:, ::-1]
    src = np.where(fwd >= 0, fwd, bwd)
    src = np.where(src >= rows, 0, src)
    out = np.take_along_axis(x, src, axis=1)
    return np.where(out < 0, 0, out)


def pick(left, top, diag):
    """The reference tie policy, vectorised: (direction, best value)."""
    gap_best = np.maximum(left, top)
    d = np.where(diag > gap_best, DIAG, np.where(left >= top, LEFT, TOP))
    return d, np.maximum(diag, gap_best)


def moves_at(f: dp.Fill, b, i, j, texts_flat, pats_flat, t_off, p_off,
             score_matrix):
    """Reference (direction, best value, inside) at interior cells (i, j)
    of pairs b: H of the three neighbours, looked up in the band."""
    h_left, in_l = f.value(b, i, j - 1)
    h_top, in_t = f.value(b, i - 1, j)
    h_diag, in_d = f.value(b, i - 1, j - 1)
    tj = texts_flat[t_off[b] + np.clip(j - 1, 0, None)]
    pi = pats_flat[p_off[b] + np.clip(i - 1, 0, None)]
    s = score_matrix[pi, tj]
    d, best = pick(h_left - f.gap, h_top - f.gap, h_diag + s)
    return d, best, in_l & in_t & in_d


def judge(texts, patterns, outs, score_matrix, gap: int, local: bool,
          f: dp.Fill):
    """A reason string for each alignment that is not the reference's, None
    for each that is.  ``outs[b]`` None is judged missing."""
    score_matrix = np.asarray(score_matrix, dtype=np.int64)
    k = score_matrix.shape[0]
    b_count = len(outs)
    reasons: list = ["missing" if o is None else None for o in outs]
    bad = np.array([o is None for o in outs], dtype=bool)
    outs = [_EMPTY if o is None else o for o in outs]
    ns, ms = f.ns, f.ms
    if local:
        ref_score, end_i, end_j = dp.best_cells(f)
    else:
        ref_score, end_i, end_j = f.last, ms.copy(), ns.copy()

    def flag(pairs, why):
        """Mark pairs (a bool mask, or indices) wrong for ``why``, unless
        an earlier rule has."""
        mask = np.zeros(b_count, dtype=bool)
        mask[pairs] = True
        for b in np.flatnonzero(mask & ~bad):
            reasons[b] = why
        bad[mask] = True

    lens, pid, at, ap, t, p = _columns(outs, k)
    run_t, tot_t = _sums(t, lens)
    run_p, tot_p = _sums(p, lens)
    # The path anchored at the reference's end cell: (ci, cj) the cell
    # each column moves into, (e0_i, e0_j) the cell before the first.
    e0_i, e0_j = end_i - tot_p, end_j - tot_t
    ci = e0_i[pid] + run_p
    cj = e0_j[pid] + run_t

    flag(np.array([o.score for o in outs]) != ref_score, "score")
    if local:
        flag((ref_score <= 0) & (lens != 0), "not empty")
    symbols = (at >= 0) & (at <= k) & (ap >= 0) & (ap <= k) & ((t + p) > 0)
    flag(pid[~symbols], "symbols")
    in_matrix = (ci >= 0) & (ci <= ms[pid]) & (cj >= 0) & (cj <= ns[pid])
    flag(pid[~in_matrix], "off the matrix")
    flag((e0_i < 0) | (e0_j < 0), "off the matrix")

    t_off = np.cumsum(ns) - ns
    p_off = np.cumsum(ms) - ms
    texts_flat = np.concatenate([np.asarray(x, np.int64) for x in texts])
    pats_flat = np.concatenate([np.asarray(x, np.int64) for x in patterns])
    ok = ~bad[pid]
    letters = (np.where(t == 1, at == texts_flat[t_off[pid]
                                                 + np.clip(cj - 1, 0, None)],
                        at == k)
               & np.where(p == 1, ap == pats_flat[p_off[pid]
                                                  + np.clip(ci - 1, 0, None)],
                          ap == k))
    flag(pid[ok & ~letters], "letters")

    def reference_moves(sel_pid, sel_i, sel_j):
        return moves_at(f, sel_pid, sel_i, sel_j, texts_flat, pats_flat,
                        t_off, p_off, score_matrix)

    move = np.where((t == 1) & (p == 1), DIAG, np.where(t == 1, LEFT, TOP))
    ok = ~bad[pid]
    if local:
        # Every cell the traceback emits is interior, with a best move
        # above 0 and equal to the column's.
        interior = (ci >= 1) & (cj >= 1)
        flag(pid[ok & ~interior], "past an edge")
        sel = np.flatnonzero(ok & interior)
    else:
        # Global mode's first column forces TOP and its first row LEFT.
        forced_top = (cj == 0) & (ci > 0)
        forced_left = (ci == 0) & (cj > 0)
        flag(pid[ok & forced_top & (move != TOP)], "move")
        flag(pid[ok & forced_left & (move != LEFT)], "move")
        sel = np.flatnonzero(ok & ~forced_top & ~forced_left)
    d, best, inside = reference_moves(pid[sel], ci[sel], cj[sel])
    flag(pid[sel[~inside]], "outside band")
    wrong = d != move[sel]
    if local:
        wrong |= best <= 0
    flag(pid[sel[inside & wrong]], "move")

    starts_t = np.array([o.start_text for o in outs], dtype=np.int64)
    starts_p = np.array([o.start_pattern for o in outs], dtype=np.int64)
    if local:
        # The walk ends on reaching row or column 0 (the cursors stay at
        # the last emitted cell) or at a cell whose best move is not above
        # 0 (the cursors at that cell).
        live = np.flatnonzero(~bad & (ref_score > 0))
        border = (e0_i == 0) | (e0_j == 0)
        inner = live[~border[live]]
        _, best0, inside0 = reference_moves(inner, e0_i[inner], e0_j[inner])
        flag(inner[~inside0], "outside band")
        flag(inner[inside0 & (best0 > 0)], "stops early")
        first_col = np.minimum(np.cumsum(lens) - lens, max(len(ci) - 1, 0))
        e1_i = ci[first_col] if len(ci) else e0_i
        e1_j = cj[first_col] if len(cj) else e0_j
        want_t = np.where(border, e1_j - 1, e0_j - 1)
        want_p = np.where(border, e1_i - 1, e0_i - 1)
        live = ~bad & (ref_score > 0)
    else:
        flag((e0_i != 0) | (e0_j != 0), "does not reach (0, 0)")
        want_t = np.maximum(0, ns - 1 - tot_t)
        want_p = np.maximum(0, ms - 1 - tot_p)
        live = ~bad
    flag(live & ((starts_t != want_t) | (starts_p != want_p)), "starts")
    return reasons


_EMPTY = Alignment(np.zeros(0, np.uint8), np.zeros(0, np.uint8), 0, 0, 0)


def check(texts, patterns, outs, score_matrix, gap: int, local: bool,
          device="cpu"):
    """Fill the reference around the alignments' claimed paths and judge
    them; returns (reasons, fill).  ``outs[b]`` None is missing."""
    gap = int(gap)
    k = np.asarray(score_matrix).shape[0]
    placed = [_EMPTY if o is None else o for o in outs]
    lo, width = place_band(texts, patterns, placed, local, k)
    f = dp.fill(texts, patterns, score_matrix, gap, local, lo=lo,
                width=width, device=device)
    return judge(texts, patterns, outs, score_matrix, gap, local, f), f
