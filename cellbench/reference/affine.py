"""Exact local affine-gap (Gotoh) scores of one query against many
sequences, in plain PyTorch and numpy, row by row.

The recurrence is Smith-Waterman-Gotoh as SSEARCH and CUDASW++ score a
database, with ``gap`` the cost of a one-letter gap (open + extend) and
``extend`` the cost of each further letter, so that a gap of k letters
costs gap + (k - 1) extend (CUDASW++'s open 10, extend 2 is gap 12,
extend 2):

    E[i][j] = max(E[i][j-1] - extend, H[i][j-1] - gap)
    F[i][j] = max(F[i-1][j] - extend, H[i-1][j] - gap)
    H[i][j] = max(0, H[i-1][j-1] + s(query[i-1], seq[j-1]), E[i][j], F[i][j])

with H = 0 on the edges and the score the largest H.  The score is the
same with the two sequences' roles swapped, so a group of sequences
shorter than the query runs a row a letter of theirs against the query's
columns, and the rest a row a letter of the query against their columns:
the fewer rows.  F comes from the row above elementwise.  E needs the
row's own H, but only through a running maximum: with T[j] = max(0,
diagonal, F[i][j]) and T[0] = H[i][0] = 0,

    E[i][j] = max over k < j of T[k] - gap - extend (j - 1 - k),

a prefix maximum (``torch.cummax``) of T[k] + extend k.  Taking T[k] in
place of H[k] leaves out only the terms E[i][k] - gap - ..., and those are
never larger when gap >= extend: such a gap that closes at k and reopens
is beaten by the run from k's own opening, extended through k.  The
configurations' costs hold gap >= extend, and the function refuses any
other.  Every value is an int32 sum of integers: the scores are exact.

The sequences are grouped by length (a group's longest at most four times
its shortest, past 64 letters), so that a group's padding stays bounded and
its rows few.  Past a sequence's end every substitution scores PAST, so
no alignment ends there: a cell there is 0, or a gap from the left or
from above, never above the best cell to its left or above it, and the
maximum over every cell is the sequence's.

Two controls compute what a program in error would: ``saturate=127``
clamps every H, E and F to the int8 range, as cells of 8 bits would
saturate; ``extend=gap`` is the linear gap model (every letter of a gap
costs ``gap``).
"""

from __future__ import annotations

import numpy as np
import torch

# Lengths up to this share one group; past it a group spans a factor 4.
SHORT = 64
# The substitution score past a sequence's end.
PAST = -(1 << 20)


def groups_by_length(lengths) -> list:
    """Indices of the sequences in groups of similar length: lengths up
    to SHORT, then (4^k SHORT, 4^(k+1) SHORT]."""
    lengths = np.asarray(lengths)
    key = np.ceil(np.log(np.maximum(lengths, 1) / SHORT) / np.log(4))
    key = key.clip(min=0)
    return [np.flatnonzero(key == k) for k in np.unique(key)]


def local_scores(seqs, query, score_matrix, gap: int, extend: int,
                 device="cpu", saturate: int | None = None) -> np.ndarray:
    """(len(seqs),) int64 best local scores of ``query`` (rows) against
    each of ``seqs`` (columns): int letter arrays, indices into
    ``score_matrix`` (k, k).  An empty sequence scores 0.  ``saturate``:
    clamp every value to [-saturate - 1, saturate] (the int8 control)."""
    if int(gap) < int(extend):
        raise ValueError("the prefix maximum needs gap >= extend")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = np.zeros(len(seqs), dtype=np.int64)
    lengths = np.array([len(s) for s in seqs], dtype=np.int64)
    sm = torch.as_tensor(np.asarray(score_matrix, dtype=np.int32),
                         device=device)
    q = [int(a) for a in np.asarray(query)]
    for idx in groups_by_length(lengths):
        idx = idx[lengths[idx] > 0]
        if idx.size:
            out[idx] = _group(seqs, idx, lengths[idx], q, sm, int(gap),
                              int(extend), device, saturate)
    return out


def _group(seqs, idx, lengths, query, sm, gap, extend, device, saturate):
    b, longest = idx.shape[0], int(lengths.max())
    text = np.zeros((b, longest), dtype=np.int64)
    for r, i in enumerate(idx):
        text[r, :lengths[r]] = seqs[i]
    text = torch.as_tensor(text, device=device)
    ns = torch.as_tensor(lengths, device=device)[:, None]
    if longest < len(query):
        # A row a letter of the sequences, the query's letters across.
        across = sm[:, torch.as_tensor(query, device=device)]
        rows = (torch.where(r < ns, across[text[:, r]], PAST)
                for r in range(longest))
        width = len(query)
    else:
        # A row a letter of the query, the sequences' letters across.
        inside = torch.arange(longest, device=device)[None, :] < ns
        profile = torch.where(inside, sm[:, text], PAST)
        rows = (profile[a] for a in query)
        width = longest
    return _fill(rows, b, width, gap, extend, device, saturate)


def _fill(rows, b, width, gap, extend, device, saturate):
    """The best H of b pairs whose rows' substitution scores ``rows``
    gives, (b, width) a row."""
    i32 = torch.int32
    ramp = extend * torch.arange(width + 1, device=device, dtype=i32)
    # E[i][j] is the prefix maximum less these: gap + extend (j - 1).
    close = ramp[1:] + gap - extend
    # H of the row above, column 0 (H[i][0] = 0) first.
    h_up = torch.zeros((b, width + 1), dtype=i32, device=device)
    f_up = torch.full((b, width), -(1 << 29), dtype=i32, device=device)
    # T[k] + extend k over the columns k = 0 .. width - 1 (T[0] = 0).
    lifted = torch.zeros((b, width), dtype=i32, device=device)
    best = torch.zeros(b, dtype=i32, device=device)

    def clamp(x):
        return x if saturate is None else x.clamp(-saturate - 1, saturate)

    for sub in rows:
        diag = h_up[:, :-1] + sub
        f_up = clamp(torch.maximum(f_up - extend, h_up[:, 1:] - gap))
        t = clamp(torch.maximum(diag, f_up).clamp_min(0))
        lifted[:, 1:] = t[:, :-1] + ramp[1:width]
        e = clamp(torch.cummax(lifted, dim=1).values - close)
        h_up[:, 1:] = clamp(torch.maximum(t, e))
        best = torch.maximum(best, h_up.amax(dim=1))
    return best.cpu().numpy()
