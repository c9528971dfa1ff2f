"""A traceback over the reference's band under a chosen tie policy.

``walk`` follows the reference traceback (``sa_traceback_nw`` and
``sa_traceback_sw`` of ``seqalign_torch/native/oracle.cpp``) from the
reference's end cell, reading H from a ``dp.Fill``'s band, and returns the
alignments it prints.  Under ``policy="reference"`` that is the reference's
own output.  Under ``policy="flipped"`` every tie goes the other way (the
diagonal wins a tie with a gap move, TOP wins a tie with LEFT): a
co-optimal alignment that breaks the tie policy and so the byte-identity
the configurations state.  A walk that leaves the band returns None for
its pair.  ``control`` makes the benchmark's controls from it.
"""

from __future__ import annotations

import numpy as np

from . import dp
from .verify import _EMPTY, DIAG, LEFT, TOP, Alignment, pick, place_band

POLICIES = ("reference", "flipped")


def _pick(left, top, diag, policy):
    if policy == "reference":
        return pick(left, top, diag)
    gap_best = np.maximum(left, top)
    return (np.where(diag >= gap_best, DIAG,
                     np.where(top >= left, TOP, LEFT)),
            np.maximum(diag, gap_best))


def walk(texts, patterns, score_matrix, gap: int, local: bool, f: dp.Fill,
         policy: str = "reference") -> list:
    """The alignments the traceback prints under ``policy``, one a pair."""
    if policy not in POLICIES:
        raise ValueError(f"policy must be one of {POLICIES}")
    sm = np.asarray(score_matrix, dtype=np.int64)
    k = sm.shape[0]
    b_count = len(texts)
    texts = [np.asarray(x, np.int64) for x in texts]
    patterns = [np.asarray(x, np.int64) for x in patterns]
    ns, ms = f.ns, f.ms
    if local:
        score, i, j = dp.best_cells(f)
    else:
        score, i, j = f.last, ms.copy(), ns.copy()
    i, j = i.astype(np.int64), j.astype(np.int64)
    cap = int((ns + ms).max()) + 1
    moves = np.zeros((b_count, cap), dtype=np.int8)
    count = np.zeros(b_count, dtype=np.int64)
    end_i, end_j = i.copy(), j.copy()
    lost = np.zeros(b_count, dtype=bool)
    t_flat = np.concatenate(texts)
    p_flat = np.concatenate(patterns)
    t_off = np.cumsum(ns) - ns
    p_off = np.cumsum(ms) - ms
    # Cursor cell when the walk ends (local mode: where it stops).
    stop_i, stop_j = i.copy(), j.copy()
    active = (score > 0) if local else ((i > 0) | (j > 0))
    while active.any():
        b = np.flatnonzero(active)
        ib, jb = i[b], j[b]
        h_l, in_l = f.value(b, ib, jb - 1)
        h_t, in_t = f.value(b, ib - 1, jb)
        h_d, in_d = f.value(b, ib - 1, jb - 1)
        s = sm[p_flat[p_off[b] + np.clip(ib - 1, 0, None)],
               t_flat[t_off[b] + np.clip(jb - 1, 0, None)]]
        d, best = _pick(h_l - gap, h_t - gap, h_d + s, policy)
        if local:
            outside = ~(in_l & in_t & in_d)
            stop = ~outside & (best <= 0)
        else:
            d = np.where(jb == 0, TOP, np.where(ib == 0, LEFT, d))
            outside = ~(in_l & in_t & in_d) & (ib > 0) & (jb > 0)
            stop = np.zeros(len(b), dtype=bool)
        lost[b[outside]] = True
        active[b[outside | stop]] = False
        go = ~outside & ~stop
        bg = b[go]
        dg = d[go]
        moves[bg, count[bg]] = dg
        count[bg] += 1
        i[bg] -= (dg != LEFT)
        j[bg] -= (dg != TOP)
        if local:
            # Reaching row or column 0 ends the walk with the cursors at
            # the last emitted cell.
            edge = (i[bg] == 0) | (j[bg] == 0)
            stop_i[bg] = np.where(edge, ib[go], i[bg])
            stop_j[bg] = np.where(edge, jb[go], j[bg])
            active[bg[edge]] = False
        else:
            active[bg] = (i[bg] > 0) | (j[bg] > 0)

    out: list = []
    for b in range(b_count):
        if lost[b]:
            out.append(None)
            continue
        mv = moves[b, :count[b]][::-1]
        takes_t = mv != TOP
        takes_p = mv != LEFT
        start_i = end_i[b] - int(takes_p.sum())
        start_j = end_j[b] - int(takes_t.sum())
        ci = start_i + np.cumsum(takes_p)
        cj = start_j + np.cumsum(takes_t)
        at = np.where(takes_t, texts[b][np.clip(cj - 1, 0, None)], k)
        ap = np.where(takes_p, patterns[b][np.clip(ci - 1, 0, None)], k)
        if local:
            st, sp = int(stop_j[b]) - 1, int(stop_i[b]) - 1
        else:
            st = max(0, int(ns[b]) - 1 - int(takes_t.sum()))
            sp = max(0, int(ms[b]) - 1 - int(takes_p.sum()))
        out.append(Alignment(at.astype(np.uint8), ap.astype(np.uint8), st,
                             sp, int(score[b])))
    return out


CONTROLS = ("int16", "flipped")


def control(texts, patterns, placed, score_matrix, gap: int, local: bool,
            kind: str, device="cpu", margin: int = 64) -> list:
    """The control's answers, one a pair, to be judged in the program's
    place: the reference's traceback over a band ``margin`` columns either
    side of the ``placed`` alignments' paths (the program's, which only
    place the band), with

    - ``"int16"``: cells that saturate at 16 bits (``dp.fill``'s
      ``int16``), the precision below the configurations' int32, walked
      under the reference tie policy;
    - ``"flipped"``: exact cells, every tie broken the other way.

    A walk that leaves the band answers None, except under ``"int16"``:
    there the answer keeps the int16 DP's score, exact whatever the band
    (the fill's rows are whole), with no path, since the judge reads the
    score first and any path of the int16 DP carries that score."""
    if kind not in CONTROLS:
        raise ValueError(f"control must be one of {CONTROLS}")
    k = np.asarray(score_matrix).shape[0]
    placed = [_EMPTY if o is None else o for o in placed]
    lo, width = place_band(texts, patterns, placed, local, k, margin=margin)
    f = dp.fill(texts, patterns, score_matrix, gap, local, lo=lo,
                width=width, device=device, int16=kind == "int16")
    answers = walk(texts, patterns, score_matrix, gap, local, f,
                   policy="flipped" if kind == "flipped" else "reference")
    if kind == "int16":
        score = dp.best_cells(f)[0] if local else f.last
        answers = [Alignment(_EMPTY.text, _EMPTY.pattern, 0, 0,
                             int(score[b])) if a is None else a
                   for b, a in enumerate(answers)]
    return answers
