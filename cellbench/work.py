"""The yardstick's arithmetic: the work a request needs and the card's peaks.

Copied from ``chip_smoke.py``'s bounds, corrected so that the count does
not depend on which kernel fills the cells: every mode counts the
substitution's table index, which ``chip_smoke.py`` counted for K3 and K5
but left out of K1.

A DP cell of the linear-gap recurrence, H = max(diag + s, max(top, left)
- gap), is 4 integer operations, and looking up s in the substitution
table is 1 more: 5 a cell for a score.  An alignment also keeps the cell's
2-bit direction (two compares, two selects, a shift and an or into the
word): 6 more, 11 a cell.  The count is of what the inputs need, m x n
cells a pair, whatever a route fills twice (the checkpoint engine re-fills
the tiles its path crosses) or pads.
"""

from __future__ import annotations

# NVIDIA H100 SXM, from the data sheet at the 700 W limit.  int32: an SM
# has 64 int32 lanes, and a three-operand instruction (add-max, max of
# three) does two operations, as an FMA does: 132 x 64 x 2 x 1.98 GHz.
INT32_OPS_PER_S = 33.5e12
HBM_BYTES_PER_S = 3.35e12

OPS_PER_CELL_SCORE = 5
OPS_PER_CELL_ALIGN = OPS_PER_CELL_SCORE + 6


def cells(n: int, m: int) -> int:
    """DP cells of one pair of lengths n and m."""
    return int(n) * int(m)


def ops(cell_count: int, aligns: bool) -> float:
    """Integer operations the inputs need: ``cell_count`` cells, scored or
    aligned."""
    per = OPS_PER_CELL_ALIGN if aligns else OPS_PER_CELL_SCORE
    return float(cell_count) * per


def roofline_pct(op_count: float, device_seconds: float) -> float | None:
    """Share (%) of the int32 peak that ``op_count`` operations in
    ``device_seconds`` of kernel time reach; None when no kernel ran."""
    if device_seconds <= 0 or op_count <= 0:
        return None
    return 100.0 * op_count / (INT32_OPS_PER_S * device_seconds)
